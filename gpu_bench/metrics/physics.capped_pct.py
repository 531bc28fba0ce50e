"""Share (%) of the stamped window's env-steps in which one of K3's caps
dropped contact or self-collision work (the program's counters at the
freeze)."""

from gpu_bench.harness.stamps import capped_pct, record_of


def read(run):
    record = record_of(run)
    return capped_pct(record) if record else None
