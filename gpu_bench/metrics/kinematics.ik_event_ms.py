"""Device ms a control step in the program's "IK" spans (both calls), read
from CUDA events over the stamped window of a traced run."""

from gpu_bench.harness.stamps import ik_event_ms, record_of


def read(run):
    record = record_of(run)
    return ik_event_ms(record) if record else None
