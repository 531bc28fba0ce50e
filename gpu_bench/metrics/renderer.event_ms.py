"""Device ms a control step in the program's "render: other" span less its
"IK" spans, read from CUDA events over the stamped window."""

from gpu_bench.harness.stamps import record_of, render_event_ms


def read(run):
    record = record_of(run)
    return render_event_ms(record) if record else None
