"""The ``sloth`` configuration and its ``pack`` traffic: a tiny sloth
cell comes out correct on the CPU, the program's old fault (episode 0's
box drawn in every lane) does not, and the scripted policy carries each
lane to its own box and no further."""

import numpy as np
import pytest
import torch

from gpu_bench.harness import cell as cell_mod
from gpu_bench.harness import main
from gpu_bench.harness.policy import CyclePolicy, grid_pose, mesh_pose
from gpu_bench.tests.tiny import args

CELL = "sloth.pack64"
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def short(monkeypatch):
    """Four torch threads, and 3 stabilization and 2 warm-up steps."""
    from gpu_bench.harness import bare

    monkeypatch.setattr(bare, "STABILIZE_STEPS", 3)
    monkeypatch.setattr(bare, "WARMUP_STEPS", 2)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def tiny_sloth(lanes: int = 8):
    """The sloth cell cut to a size the CPU runs in seconds a step: a
    plush of about 250 particles (12 mm grid), 500 body splats, 3,000
    table splats, 50 a link, 300 box splats, 64x128 cameras, 133
    substeps of 0.25 ms (springs softened to Y = 500), 8 lanes: episodes
    0-7 cover two box cells."""
    cell = cell_mod.find(CELL)
    s = cell.spec
    s["object"].update(grid_size=0.012, n_surface=3000, max_neighbours=12,
                       body_splats=500, spring_Y=500.0)
    s["physics"]["dt"] = 2.5e-4
    s["scan"].update(table_splats=3000, splats_per_link=50)
    s["box"]["splats"] = 300
    for cam in s["env"]["cameras"]:
        cam["h"], cam["w"] = 64, 128
        cam["intr"] = [60.0, 0.0, 64.0, 0.0, 60.0, 32.0, 0.0, 0.0, 1.0]
    cell.traffic["lanes"] = lanes
    return cell


def test_config_writes_the_plush():
    """At full size the writer's plush has 3,400 +- 50 particles on every
    seed tried, lies 16 x 8 x 6 cm with its long axis along y, and rests
    above the table."""
    from gpu_bench.reference.plain.physics.topology import connect_springs

    cell = cell_mod.find(CELL)
    w, o = cell.writer(), cell.spec["object"]
    pose = np.array(cell.spec["gs"]["object"]["pose"]).reshape(4, 4)
    for seed in (1, 2**31 + 3, 2**33 + 7):
        s, i = w.sc.rigid_points(w.plush(o["parts_cm"]), o["n_surface"],
                                 o["grid_size"], seed)
        pts = w.to_object_frame(np.concatenate([s, i]), pose.ravel(),
                                o["rest_gap_m"])
        assert abs(len(pts) - 3400) <= 50, len(pts)
        world = pts @ pose[:3, :3].T + pose[:3, 3]
        ext = world.max(0) - world.min(0)
        np.testing.assert_allclose(ext, [0.08, 0.16, 0.06], atol=6e-3)
        assert world[:, 2].min() > 0.0
    springs, _ = connect_springs(pts, o["radius"], o["max_neighbours"])
    assert 45000 < len(springs) < 60000


def test_tiny_sloth_cell_is_correct():
    out = main.execute(args(CELL, seed=SEED), tiny_sloth(), dev="cpu")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"env_steps_per_s", "control_step_ms_p95",
                                   "setup_s"}
    assert out["correct"], out["compared"]


def test_episode0_box_in_every_lane_is_not_correct(monkeypatch):
    """The program's fault before mesh groups: every lane's box drawn at
    episode 0's pose while the physics collides each lane with its own.
    The check's lanes include one of the second box cell (a quarter of
    the batch each), whose frames then differ beyond ``rgb_gap``."""
    from real2sim_eval_tpu_torch.parallel import assets

    orig = assets.assets_tree

    def episode0(*a, **kw):
        tree, rvars, dumps = orig(*a, **kw)
        for k, v in tree.items():
            if k.startswith("mesh_params/"):
                tree[k] = np.ascontiguousarray(np.broadcast_to(v[:1], v.shape))
        return tree, rvars, dumps

    monkeypatch.setattr(assets, "assets_tree", episode0)
    cell = tiny_sloth()
    out = main.execute(args(CELL, seed=SEED), cell, dev="cpu")
    assert not out["correct"]
    assert out["compared"]["rgb_gap"]["value"] > cell.limits["rgb_gap"]
    for k in ("start_gap", "qpos_gap", "eef_gap"):
        assert out["compared"][k]["value"] == 0.0, k


def test_k3_returning_its_input_is_not_correct(monkeypatch):
    """The sloth cell holds positions (rope's cell does not): a
    spring-mass step that hands back its input state, with everything
    else of the control step sound, comes out not correct."""
    import dataclasses

    from real2sim_eval_tpu_torch.physics import fused_step

    orig = fused_step.spring_mass_step

    def unchanged(opts, tab, state, *a, **k):
        out = orig(opts, tab, state, *a, **k)
        return dataclasses.replace(out, x=state.x, v=state.v)

    monkeypatch.setattr(fused_step, "spring_mass_step", unchanged)
    cell = tiny_sloth()
    out = main.execute(args(CELL, seed=SEED), cell, dev="cpu")
    assert not out["correct"]
    assert out["compared"]["x_mean_gap"]["value"] > cell.limits["x_mean_gap"]


def pack_policy(lanes: int = 64, seed: int = 2**31 + 21):
    cell = cell_mod.find(CELL)
    w, o = cell.writer(), cell.spec["object"]
    s, i = w.sc.rigid_points(w.plush(o["parts_cm"]), o["n_surface"],
                             o["grid_size"], 5)
    pts = w.to_object_frame(np.concatenate([s, i]),
                            cell.spec["gs"]["object"]["pose"],
                            o["rest_gap_m"])
    cfg = {"gs": cell.spec["gs"], "env": cell.spec["env"],
           "physics": {"table_height": 0.0}}
    return (CyclePolicy(cell.traffic, cfg, cell.spec, pts,
                        list(range(lanes)), seed), pts, cfg)


def test_pack_carries_each_lane_to_its_own_box():
    """In every lane and cycle the carry, lower, open and rise waypoints
    lie over that lane's own box (its episode's cell by the scene's walk),
    the grasp closes over the plush's torso, and the commanded eef never
    passes the box along the carry's heading."""
    p, pts, cfg = pack_policy()
    phases = [ph["name"] for ph in p.cycle["phases"]]
    boxes = {mesh_pose(cfg, "box-1", ep)[:2, 3].tobytes()
             for ep in range(20)}
    assert len(boxes) == 4
    for lane in range(p.lanes):
        goal = mesh_pose(cfg, "box-1", lane)[:2, 3]
        P = grid_pose(cfg, lane)
        world = pts @ P[:3, :3].T + P[:3, 3]
        for c in range(2):
            plan = p._plan(lane, c)
            for name in ("carry", "lower", "open", "rise"):
                np.testing.assert_allclose(plan[phases.index(name)][1][:2],
                                           goal, atol=1e-9)
            close = plan[phases.index("close")][1]
            near = np.linalg.norm(world[:, :2] - close[:2], axis=1)
            assert near.min() < 5e-3
            assert plan[phases.index("lift")][1][2] - close[2] >= 0.1 - 1e-9
    # the commanded path, projected on each lane's heading from its anchor
    # to its box, never goes past the box
    acts = np.stack([p.actions() for _ in range(2 * p.length)])
    for lane in range(p.lanes):
        goal = mesh_pose(cfg, "box-1", lane)[:2, 3]
        start = p._plan(lane, 0)[phases.index("close")][1][:2]
        d = (goal - start) / np.linalg.norm(goal - start)
        reach = (acts[:, lane, :2] - start) @ d
        assert reach.max() <= np.linalg.norm(goal - start) + 1e-6


def _traced_run(tmp_path, spans, kernels):
    """A Run whose traced window holds ``spans`` (name, start, end; us)
    and ``kernels`` (launch ts, kernel ts, dur) of two control steps."""
    import json

    from gpu_bench.harness import trace as tr
    from gpu_bench.harness.outputs import Run

    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
               "dur": b - a, "pid": 1, "tid": 1} for n, a, b in spans]
    for i, (launch, ts, dur) in enumerate(kernels):
        events += [{"ph": "X", "cat": "cuda_runtime", "name": "launch",
                    "ts": launch, "dur": 1, "pid": 1, "tid": 1,
                    "args": {"correlation": i}},
                   {"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": ts,
                    "dur": dur, "pid": 0, "tid": 7,
                    "args": {"correlation": i}}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    traced = {"table": tr.parse_trace(path), "missing": [], "steps": 2,
              **tr.busy_and_gaps(path, tr.window_of(path))}
    return Run(lanes=2, steps=2, window_s=1e-3, step_ms=[1.0], setup_s=1.0,
               attempted=4, failed=0, memory_peak=0, traced=traced,
               check_lanes=[0], episode_ids=[0, 1], init_state={},
               samples=[], extra={})


def test_mesh_groups_reader(tmp_path):
    """``renderer.mesh_groups_ms`` reads the self device time under the
    program's ``mesh groups`` spans a step, and nothing from a trace
    without that span (one mesh pose, or a program without groups)."""
    read = cell_mod.load_module(
        cell_mod.BENCH / "metrics" / "renderer.mesh_groups_ms.py",
        "renderer.mesh_groups_ms").read
    spans = [("window", 0, 1000), ("render: other", 0, 400),
             ("mesh groups", 100, 150), ("render: other", 500, 900),
             ("mesh groups", 600, 650)]
    run = _traced_run(tmp_path, spans, [(110, 200, 30), (120, 240, 10),
                                        (300, 320, 50), (610, 700, 20)])
    assert read(run) == pytest.approx((30 + 10 + 20) / 2e3)
    plain = _traced_run(tmp_path, [s for s in spans if s[0] != "mesh groups"],
                        [(110, 200, 30)])
    assert read(plain) is None
    plain.traced = None
    assert read(plain) is None
