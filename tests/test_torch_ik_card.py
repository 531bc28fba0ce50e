"""On the card: the IK kernel (``csrc/ik_solve.cu``) against the eager
solve, bitwise, and the evaluator's frames with the kernel against its
frames with the eager solve. Each test skips without a card (decided in
the ``card`` fixture). On a machine with one, from the repository's root:

    python -m pytest tests/test_torch_ik_card.py -m card --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports neither JAX nor the JAX
package.)"""

import numpy as np
import pytest
import torch

from real2sim_eval_tpu_torch.kinematics import KinematicChain, make_ik_fn
from real2sim_eval_tpu_torch.testing import (ik_problems,
                                             write_rail_pusher_urdf)
from real2sim_eval_tpu_torch.utils.urdf import BUILTIN_URDF

# lanes of each arm at 64 (in calls of 64), at 4 and at 1: with both arms
# 10,880 lane-solves
LANES = {64: 5120, 4: 256, 1: 64}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return "cuda"


def arm(name, tmp_path):
    """(chain, eef, q width): the built-in arm as the evaluator solves it,
    or the rail arm with its pusher tip."""
    if name == "builtin":
        chain = KinematicChain.from_urdf_file(BUILTIN_URDF)
        return chain, chain.link_index("link7"), 7
    chain = KinematicChain.from_urdf_file(
        write_rail_pusher_urdf(tmp_path / "rail.urdf"))
    return chain, chain.link_index("pusher_tip"), 8


def unequal_lanes(a, b):
    return torch.nonzero(~((a == b) | (a.isnan() & b.isnan())).all(1))


@pytest.mark.card
@pytest.mark.parametrize("E", [64, 4, 1])
@pytest.mark.parametrize("name", ["builtin", "rail"])
def test_kernel_is_the_eager_solve(card, tmp_path, name, E):
    """LANES[E] problems of ``testing.ik_problems`` (targets 0.003-1 rad
    of joint motion away, every eighth out of reach) solved E at a time:
    the kernel's answer is bitwise the eager one's, fallback lanes
    (answer = q_init) included, and one launch a call."""
    from real2sim_eval_tpu_torch import ext

    chain, eef, width = arm(name, tmp_path)
    solver = make_ik_fn(chain, eef, n_active=7)
    q, t = ik_problems(chain, eef, width, LANES[E], 300 + E, card)
    before = ext.LAUNCHES["ik_solve"]
    bad, fell = [], 0
    for s in range(0, LANES[E], E):
        got = solver(q[s:s + E], t[s:s + E])
        want = solver.eager(q[s:s + E], t[s:s + E])
        bad += (unequal_lanes(got, want)[:, 0] + s).tolist()
        fell += int((want == q[s:s + E]).all(1).sum())
    assert not bad, f"{len(bad)} lanes differ, first {bad[:8]}"
    assert ext.LAUNCHES["ik_solve"] - before == LANES[E] // E
    assert LANES[E] // 16 <= fell < LANES[E]


@pytest.mark.card
@pytest.mark.parametrize("name", ["builtin", "rail"])
def test_kernel_verify_at_the_tolerance(card, tmp_path, name):
    """The verify's comparisons at the ulp: for 8 reached lanes of a batch
    of 64 (final gap above 0 and under 1 mm or 0.001), the solve run again
    with ``pos_tol`` (then ``rot_tol``) set to that lane's own final gap,
    one ulp below it and one above (the other tolerance wide open): the
    lane keeps its answer at and above, falls back below, and the kernel's
    whole batch is bitwise the eager one's each time."""
    chain, eef, width = arm(name, tmp_path)
    q, t = ik_problems(chain, eef, width, 64, 400, card)
    free = make_ik_fn(chain, eef, n_active=7, pos_tol=1e30, rot_tol=1e30)
    qs = free.eager(q, t)
    T = chain.fk_link(qs, eef)
    gaps = {"pos": torch.linalg.vector_norm(T[:, :3, 3] - t[:, :3, 3],
                                            dim=-1),
            "rot": torch.linalg.matrix_norm(T[:, :3, :3] - t[:, :3, :3])}
    for kind, gap in gaps.items():
        lanes = torch.nonzero((gap > 0) & (gap < 1e-3))[:8, 0].tolist()
        assert len(lanes) == 8
        for lane in lanes:
            g = gap[lane].to(torch.float32).cpu().numpy()
            for tol, keeps in ((np.nextafter(g, np.float32(0)), False),
                               (g, True),
                               (np.nextafter(g, np.float32(1)), True)):
                tols = {"pos_tol": 1e30, "rot_tol": 1e30}
                tols[f"{kind}_tol"] = float(tol)
                solver = make_ik_fn(chain, eef, n_active=7, **tols)
                got, want = solver(q, t), solver.eager(q, t)
                assert not len(unequal_lanes(got, want)), (kind, lane, tol)
                assert torch.equal(got[lane], qs[lane] if keeps else q[lane])


@pytest.mark.card
@pytest.mark.parametrize("name", ["builtin", "rail"])
def test_kernel_writes_its_output_alone(card, tmp_path, name):
    """The kernel through the binding, 20 times on 64 problems, its output
    inside a band of 4,096 NaN floats on either side: the bands stay NaN,
    the inputs equal their copies, and every launch gives the same bits
    (what compute-sanitizer's memcheck and racecheck would see, where that
    tool cannot run)."""
    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.kinematics.ik import pack_chain

    chain, eef, width = arm(name, tmp_path)
    q, t = ik_problems(chain, eef, width, 64, 500, card)
    table = torch.as_tensor(pack_chain(chain, eef), device=card)
    copies = [x.clone() for x in (table, q, t)]
    pad, size = 4096, q.numel()
    first = None
    for _ in range(20):
        buf = torch.full((2 * pad + size,), float("nan"), device=card)
        out = buf[pad:pad + size].view(q.shape)
        ext.load().ik_solve(table, q, t, 7, 32, 1e-4, 1.0, 0.01, 0.01, out)
        assert buf[:pad].isnan().all() and buf[pad + size:].isnan().all()
        first = out.clone() if first is None else first
        assert torch.equal(out, first)
    for a, b in zip((table, q, t), copies):
        assert torch.equal(a, b)
    assert torch.equal(first, make_ik_fn(chain, eef, n_active=7).eager(q, t))


def fixture_cfg(root, use_pusher: bool):
    """A fixture configuration of ``testing``'s writers: the rope scene with
    the built-in arm's robot splats, a side and a wrist camera; for the
    pusher the gripper box is the only collider."""
    from real2sim_eval_tpu_torch.testing import (TEST_CAMERAS, full_cfg,
                                                 make_rope_points,
                                                 make_synthetic_scene,
                                                 write_fixture_checkpoint)

    rope = make_rope_points(n=120, length=0.3)
    write_fixture_checkpoint(root, "rope_ik", rope, spring_Y=2e3)
    gs = make_synthetic_scene(root / "scans", rope_pts=rope,
                              ik_urdf=BUILTIN_URDF, n_table=400)
    urdf = None
    if use_pusher:
        urdf = dict(ik_urdf_path=BUILTIN_URDF,
                    collision_urdf_path=BUILTIN_URDF,
                    collision_link_names=["gripper_base_link"])
    return full_cfg(root, "rope_ik", use_pusher=use_pusher, gs=gs,
                    cameras=TEST_CAMERAS, urdf=urdf,
                    physics_over=dict(dt=2e-4, self_collision=True))


def schedule(B: int, steps: int) -> np.ndarray:
    """An open-loop schedule (steps, B, 13): each lane's eef circles 4 cm
    around its own point above the table, pointing down, the gripper
    closing over the second half."""
    rot = np.diag([1.0, -1.0, -1.0]).reshape(-1)
    out = np.zeros((steps, B, 13), np.float32)
    for s in range(steps):
        for b in range(B):
            a = 2 * np.pi * (s / 20.0 + b / B)
            xyz = [0.26 + 0.04 * np.cos(a), 0.02 * b + 0.04 * np.sin(a),
                   0.36 - 0.002 * s]
            out[s, b] = np.concatenate([xyz, rot, [0.8 if s < steps // 2
                                                   else 0.2]])
    return out


@pytest.mark.card
@pytest.mark.parametrize("use_pusher,incremental", [(False, "on"),
                                                   (True, "off")])
def test_evaluator_frames_with_the_kernel_are_the_eager_frames(
        card, tmp_path, use_pusher, incremental):
    """Two evaluators of one fixture configuration (the rope with the
    gripper on the incremental render; the pusher on the full pipeline),
    one solving its IK with the kernel, the other with the eager solve:
    over 40 steps of an open-loop schedule, after every step and render,
    the fixed and wrist frames and depths, ``qpos7`` and the gripper rows
    are bitwise equal, and the kernel ran twice a step."""
    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import RasterConfig

    cfg = fixture_cfg(tmp_path, use_pusher)
    eps = list(range(8))
    evs = [BatchedEvaluator(cfg, eps, RasterConfig(incremental=incremental),
                            device=card) for _ in range(2)]
    evs[1]._ik = evs[1]._ik.eager
    assert evs[0].incremental == (incremental == "on")
    acts = schedule(len(eps), 40)
    before = ext.LAUNCHES["ik_solve"]
    for s, a in enumerate(acts):
        outs = []
        for ev in evs:
            ev.step(a)
            outs.append((ev.render(), ev.state.qpos7, ev.state.grippers))
        (f0, q0, g0), (f1, q1, g1) = outs
        for x, y in zip(f0, f1):
            assert torch.equal(x, y), f"step {s}: frames differ"
        assert torch.equal(q0, q1) and torch.equal(g0, g1), f"step {s}"
    assert ext.LAUNCHES["ik_solve"] - before == 2 * len(acts)
