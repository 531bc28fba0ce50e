"""Device ms a control step under the physics spans: the grasp machine
and control build (``_env_pre``), the freezes and K3."""

from gpu_bench.harness.trace import stage_ms


def read(run):
    return stage_ms(run, ("grasp + controls", "freezes",
                          "K3 spring_mass_step"))
