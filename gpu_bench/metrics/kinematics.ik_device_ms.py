"""Device ms a control step under the IK spans: the velocity-control
mimic's solve and the render's arm pose (``compose_dyn``), both calls of
the evaluator's ``_ik`` (a CUDA-graph replay on the card)."""

from gpu_bench.harness.trace import stage_ms


def read(run):
    return stage_ms(run, ("IK",))
