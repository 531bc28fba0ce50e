"""p95 of the host ms from entering a control step to leaving its render
(the launch path, before the synchronise), over the stamped window."""

from gpu_bench.harness.stamps import host_ms_p95, record_of


def read(run):
    record = record_of(run)
    return host_ms_p95(record) if record else None
