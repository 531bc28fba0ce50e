"""Share (%) of the leaf spans' device ms in spans whose exit event ran
within 50 us of the host's exit stamp (the card had caught up with the
host), over the stamped window."""

from gpu_bench.harness.stamps import host_paced_pct, record_of


def read(run):
    record = record_of(run)
    return host_paced_pct(record) if record else None
