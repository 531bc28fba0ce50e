"""Host seconds of the build's per-episode resets (the program's "reset"
spans), summed."""

from gpu_bench.harness.stamps import build_resets_s, record_of


def read(run):
    record = record_of(run, "build")
    return build_resets_s(record) if record else None
