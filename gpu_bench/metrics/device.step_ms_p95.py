"""p95 of the device ms from a control step's first enter event to its
render's exit event, over the stamped window."""

from gpu_bench.harness.stamps import record_of, step_ms_p95


def read(run):
    record = record_of(run)
    return step_ms_p95(record) if record else None
