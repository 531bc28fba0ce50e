"""K3's share (%) of its roofline: the least time the card could take
for the spring-mass work of a control step, over K3's device time a
traced step.

The least time is the larger of the f32 operations over 67 TFLOP/s and
the bytes over 3.35 TB/s (the H100 SXM's published peaks at 700 W), both
counted from the problem the states pose (``outputs.k3_problem``), not
from the kernel's tables: per substep and lane, each spring's term at
both its ends (30 operations each), each particle's integration (30),
each self-collision pair the state holds at both its ends (45); the
bytes are the particles' positions and velocities read and written once
and each spring's record (16 bytes, both ends) read once. Contacts with
the colliders are not counted, so the share is a lower bound. The
operation costs are ``chip_smoke.py``'s ``K3_OPS``."""

from gpu_bench.harness.trace import stage_ms

PEAK_F32_OPS_S = 67e12
PEAK_BYTES_S = 3.35e12
OPS = {"spring_end": 30, "particle": 30, "self_end": 45}


def least_ms(p: dict) -> float:
    per_substep = p["lanes"] * (2 * p["springs"] * OPS["spring_end"]
                                + p["particles"] * OPS["particle"])
    if p["self_collision"]:
        per_substep += p["self_pairs"] * OPS["self_end"]
    ops = per_substep * p["substeps"]
    n_bytes = p["lanes"] * p["particles"] * 3 * 4 * 4 + 2 * p["springs"] * 16
    return max(ops / PEAK_F32_OPS_S, n_bytes / PEAK_BYTES_S) * 1e3


def read(run):
    k3 = stage_ms(run, ("K3 spring_mass_step",))
    p = run.extra.get("k3_problem")
    if not k3 or p is None:
        return None
    return 100.0 * least_ms(p) / k3
