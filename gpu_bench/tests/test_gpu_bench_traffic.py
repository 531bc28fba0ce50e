"""The traffic generator: deterministic per seed, and each cycle reaches
the object."""

import numpy as np
import pytest

from gpu_bench.harness import cell as cell_mod
from gpu_bench.harness.policy import CyclePolicy, grid_pose


def policy(workload: str, seed: int, lanes: int = 8):
    cell = cell_mod.find(workload)
    spec = cell.spec
    # the object's particles in its own frame: a rope on the x axis, or
    # the T block's footprint, without writing a scene
    if spec["kind"] == "rope":
        n = spec["object"]["particles"]
        L = spec["object"]["length"]
        pts = np.stack([np.linspace(-L / 2, L / 2, n), np.zeros(n),
                        np.zeros(n)], -1)
    else:
        g = np.mgrid[-0.1:0.1:21j, 0.05:0.1:6j].reshape(2, -1).T
        s = np.mgrid[-0.025:0.025:6j, -0.1:0.05:16j].reshape(2, -1).T
        xy = np.concatenate([g, s])
        pts = np.concatenate([xy, np.full((len(xy), 1), 0.015)], 1)
    cfg = {"gs": spec["gs"], "env": spec["env"],
           "physics": {"table_height": 0.0}}
    return CyclePolicy(cell.traffic, cfg, spec, pts, list(range(lanes)),
                       seed), pts, cfg


@pytest.mark.parametrize("workload", ["rope.manipulate64", "pusht.push64"])
def test_deterministic_per_seed(workload):
    a, _, _ = policy(workload, 2**31 + 99)
    b, _, _ = policy(workload, 2**31 + 99)
    c, _, _ = policy(workload, 2**31 + 100)
    xa = np.stack([a.actions() for _ in range(50)])
    xb = np.stack([b.actions() for _ in range(50)])
    xc = np.stack([c.actions() for _ in range(50)])
    assert np.array_equal(xa, xb)
    assert not np.array_equal(xa, xc)


@pytest.mark.parametrize("workload", ["rope.manipulate64", "pusht.push64"])
def test_moves_at_most_5mm_a_step(workload):
    p, _, _ = policy(workload, 5)
    xs = np.stack([p.actions()[:, :3] for _ in range(400)])
    assert np.linalg.norm(np.diff(xs, axis=0), axis=-1).max() <= 0.005 + 1e-6


def test_rope_cycles_grasp_the_rope():
    """In every lane and cycle the fingertips close at the rope (within
    5 mm of a particle in the plane, the tips at or below the table's
    top, since they rise as the fingers swing in) and
    are then lifted with the gripper closed."""
    p, pts, cfg = policy("rope.manipulate64", 11)
    tool = p.tool
    phases = [ph["name"] for ph in p.cycle["phases"]]
    for lane in range(p.lanes):
        world = pts @ grid_pose(cfg, lane)[:3, :3].T + grid_pose(cfg, lane)[:3, 3]
        for c in range(3):
            plan = p._plan(lane, c)
            close = plan[phases.index("close")]
            lift = plan[phases.index("lift_drag")]
            xyz = close[1]
            assert np.min(np.linalg.norm(world[:, :2] - xyz[:2], axis=1)) < 5e-3
            assert xyz[2] - tool <= 0.0
            assert close[3] == 1.0 and lift[3] == 1.0
            assert lift[1][2] - xyz[2] >= 0.04 - 1e-9


def test_push_cycles_cross_the_t():
    """In every lane and cycle the pusher starts clear of the T (over 4
    cm from it in the plane), its push passes within 2 cm of the T, and
    it runs below the T's top."""
    p, pts, cfg = policy("pusht.push64", 13)
    phases = [ph["name"] for ph in p.cycle["phases"]]
    for lane in range(p.lanes):
        P = grid_pose(cfg, lane)
        world = pts @ P[:3, :3].T + P[:3, 3]
        for c in range(3):
            plan = p._plan(lane, c)
            start = plan[phases.index("lower")][1]
            end = plan[phases.index("push")][1]
            assert np.min(np.linalg.norm(world[:, :2] - start[:2], axis=1)) > 0.04
            path = start[:2] + np.linspace(0, 1, 60)[:, None] * (
                end[:2] - start[:2])
            gaps = np.linalg.norm(path[:, None] - world[None, :, :2], axis=-1)
            assert gaps.min() < 0.02
            assert start[2] - p.tool < 0.03
