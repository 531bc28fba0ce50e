"""A scene whose attached meshes are randomized per episode: the
reference draws each lane's meshes at that lane's own episode pose, the
check tells that from episode 0's meshes spread over every lane, and the
traffic generator plans from the poses the scene's grid walk gives. On
the unmodified configurations nothing moves."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_bench.harness import check, main
from gpu_bench.harness import policy as policy_mod
from gpu_bench.harness.policy import grid_pose, mesh_pose
from gpu_bench.tests.test_gpu_bench_traffic import policy
from gpu_bench.tests.tiny import tiny

ROPE = "rope.manipulate64"
SEED = 2**31 + 7
# the clip's grid: 4 one-to-one cells, each moving it by about its width
CLIP_GRID = {"xy": [[0.0, 0.0], [0.03, 0.03], [-0.03, 0.02], [0.02, -0.03]],
             "theta": [0, 20, -20, 45], "one_to_one": True}
# episodes whose object cells are 0-3 and clip cells 0-3 under 9
# one-to-one object cells (episode 0 first, as the check builds)
EPISODES = [0, 10, 20, 30]


def randomized_rope(n_obj: int | None = None):
    """The tiny rope cell with a one-to-one object grid (``theta`` given
    one entry per ``xy`` cell; the first ``n_obj`` cells) and the clip on
    CLIP_GRID."""
    cell = tiny(ROPE)
    gs = cell.spec["gs"]
    g = gs["object"]["grid_randomization"]
    g["xy"] = g["xy"][:n_obj]
    g["theta"] = [g["theta"][i % len(g["theta"])] for i in range(len(g["xy"]))]
    g["one_to_one"] = True
    gs["meshes"][0]["grid_randomization"] = CLIP_GRID
    return cell


def written(cell, root: Path):
    """The cell's scene written under ``root`` from SEED, as a run writes
    it, and its config directory."""
    return main.write_scene(cell, SEED, root), root / "cfg"


def reference(cfg_dir: Path, ids: list, **raster):
    from gpu_bench.reference.plain.config import load_config
    from gpu_bench.reference.plain.parallel import BatchedEvaluator
    from gpu_bench.reference.plain.renderer import RasterConfig

    return BatchedEvaluator(load_config(cfg_dir, "run"), ids,
                            raster_config=RasterConfig(**raster),
                            device="cpu")


def frames(ev) -> list:
    return [f.numpy() for f in ev.render()]


def lane(fr: list, i: int) -> list:
    return [f[i] for f in fr]


def episode0_meshes(ev):
    """The fault of a reference that keeps episode 0's meshes alone (as
    the program's batched path does): every lane's attached meshes are
    episode 0's."""
    a = ev.assets
    return dataclasses.replace(a, mesh_params={
        name: {k: v[:1].expand_as(v) for k, v in pm.items()}
        for name, pm in a.mesh_params.items()})


@pytest.fixture(autouse=True)
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def randomized(tmp_path_factory):
    """The written scene of ``randomized_rope()`` and its reference
    built over EPISODES (``incremental="off"``, as the check builds it)
    with the frames of its initial state."""
    cell = randomized_rope()
    scene, cfg_dir = written(cell, tmp_path_factory.mktemp("randomized"))
    ev = reference(cfg_dir, EPISODES, incremental="off")
    return cell, scene, cfg_dir, ev, frames(ev)


def test_lanes_carry_their_own_episode_meshes(randomized):
    """(a) Each lane's mesh splats are bit for bit those of a one-episode
    build of that lane's episode, and its frames match that build's
    within float32 rounding (the object is posed relative to the build's
    first episode, so its splats differ by rounding: 2.7e-5 found)."""
    _, _, cfg_dir, ev, fr = randomized
    clip = ev.assets.mesh_params["clip"]
    for i, ep in enumerate(EPISODES):
        one = reference(cfg_dir, [ep], incremental="off")
        own = one.assets.mesh_params["clip"]
        for k in clip:
            assert torch.equal(clip[k][i], own[k][0]), (ep, k)
        if i:
            assert not torch.equal(clip["means3D"][i], clip["means3D"][0])
        gaps = check.frame_gaps(lane(frames(one), 0), lane(fr, i))
        assert gaps["rgb_gap"] <= 1e-4 and gaps["depth_share"] == 0.0, gaps


def test_episode0_meshes_fail_the_check(randomized):
    """(b) Every lane drawn with episode 0's meshes, as a reference that
    keeps episode 0's alone and the program's batched path draw them, is
    over rope's ``rgb_gap`` limit in each lane whose clip cell differs
    from episode 0's, and equal in episode 0's own lane."""
    cell, _, _, ev, fr = randomized
    good = ev.assets
    ev.assets = episode0_meshes(ev)
    try:
        bad = frames(ev)
    finally:
        ev.assets = good
    for i, ep in enumerate(EPISODES):
        gaps = check.frame_gaps(lane(fr, i), lane(bad, i))
        if (ep // 9) % len(CLIP_GRID["xy"]) == 0:
            assert gaps["rgb_gap"] == 0.0, (ep, gaps)
        else:
            assert gaps["rgb_gap"] > cell.limits["rgb_gap"], (ep, gaps)


def test_incremental_reference_refuses_differing_meshes(randomized):
    """The incremental branch holds one static scene for all lanes: it
    raises on lanes whose meshes differ instead of drawing episode 0's."""
    _, _, cfg_dir, _, _ = randomized
    with pytest.raises(ValueError, match="differs between lanes"):
        reference(cfg_dir, EPISODES, incremental="on")


def test_per_env_reference_reads_each_lane_meshes(randomized):
    """The per-env branch draws each lane's own meshes: its frames are
    the full pipeline's (equal at this size) over two lanes of different
    clip cells."""
    _, _, cfg_dir, _, fr = randomized
    ev = reference(cfg_dir, EPISODES[:2], backend="reference")
    assert ev.per_env
    gaps = check.frame_gaps([f[:2] for f in fr], frames(ev))
    assert gaps["rgb_gap"] <= 1e-5 and gaps["depth_share"] == 0.0, gaps


def test_grid_walk_matches_the_env_reset(tmp_path):
    """(c) A sloth-shaped grid (5 one-to-one object cells, a mesh of 4
    one-to-one cells): for episodes 0-39 ``grid_pose`` and ``mesh_pose``
    give the poses of the reference copy's env reset, the object's to its
    float32 pose, the mesh's exactly."""
    from gpu_bench.reference.plain import envs
    from gpu_bench.reference.plain.config import load_config
    from gpu_bench.reference.plain.renderer import RasterConfig

    scene, cfg_dir = written(randomized_rope(n_obj=5), tmp_path)
    cfg = load_config(cfg_dir, "run")
    env = envs.make(cfg.env_name, max_episode_steps=10 ** 9, cfg=cfg,
                    randomize=True, exp_root="log",
                    raster_config=RasterConfig(), device="cpu")
    seen = set()
    for ep in range(40):
        env.reset(seed=ep, options={"skip_obs": True})
        rend = env.unwrapped.renderer
        obj = grid_pose(scene["cfg"], ep)
        assert np.array_equal(obj.astype(np.float32), rend.pose_obj_np), ep
        np.testing.assert_allclose(obj, rend.pose_obj_np, rtol=0,
                                   atol=1e-7)
        clip = mesh_pose(scene["cfg"], "clip", ep)
        assert np.array_equal(clip, rend.mesh_poses["clip"]), ep
        seen.add((ep % 5, (ep // 5) % 4))
    assert len(seen) == 20          # every pair of cells, twice


def old_grid_pose(cfg: dict, episode: int) -> np.ndarray:
    """The generator's object pose before one-to-one grids were read."""
    g = cfg["gs"]["object"]["grid_randomization"]
    pose = np.array(cfg["gs"]["object"]["pose"], np.float64).reshape(4, 4)
    cell = episode % (len(g["xy"]) * len(g["theta"]))
    rx, ry = g["xy"][cell // len(g["theta"])]
    a = np.deg2rad(g["theta"][cell % len(g["theta"])])
    p = pose.copy()
    p[:3, 3] += [rx, ry, 0.0]
    p[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0.0],
                          [np.sin(a), np.cos(a), 0.0],
                          [0.0, 0.0, 1.0]]) @ p[:3, :3]
    return p


def base_mesh_pose(cfg: dict, name: str, episode: int) -> np.ndarray:
    """The generator's mesh pose before mesh grids were read."""
    m = next(m for m in cfg["gs"]["meshes"] if m["name"] == name)
    return np.array(m["pose"], np.float64).reshape(4, 4)


@pytest.mark.parametrize("workload", [ROPE, "pusht.push64"])
def test_existing_configs_plan_as_before(monkeypatch, workload):
    """(d) On the unmodified configurations the new helpers give the old
    formulas' poses bit for bit, and so the same actions."""
    new, _, cfg = policy(workload, 2**31 + 5, lanes=64)
    for ep in range(128):
        assert np.array_equal(grid_pose(cfg, ep), old_grid_pose(cfg, ep))
        for m in cfg["gs"]["meshes"]:
            assert np.array_equal(mesh_pose(cfg, m["name"], ep),
                                  base_mesh_pose(cfg, m["name"], ep))
    monkeypatch.setattr(policy_mod, "grid_pose", old_grid_pose)
    monkeypatch.setattr(policy_mod, "mesh_pose", base_mesh_pose)
    old, _, _ = policy(workload, 2**31 + 5, lanes=64)
    for _ in range(300):
        assert np.array_equal(new.actions(), old.actions())


@pytest.mark.parametrize("workload", [ROPE, "pusht.push64"])
def test_existing_configs_compose_as_before(tmp_path, workload):
    """(d) On the unmodified configurations every lane's mesh splats are
    episode 0's, and ``compose`` equals episode 0's splats spread over
    the lanes, bit for bit."""
    _, cfg_dir = written(tiny(workload), tmp_path)
    ev = reference(cfg_dir, [0, 5, 13, 26], incremental="off")
    spread = episode0_meshes(ev)
    for name, pm in ev.assets.mesh_params.items():
        for k, v in pm.items():
            assert torch.equal(v, spread.mesh_params[name][k]), (name, k)
    for dc_only in (False, True):
        got, _ = ev.compose(ev.state, dc_only=dc_only)
        good = ev.assets
        ev.assets = spread
        try:
            want, _ = ev.compose(ev.state, dc_only=dc_only)
        finally:
            ev.assets = good
        for k in want:
            assert torch.equal(got[k], want[k]), (k, dc_only)
