"""Multi-device episode fan-out on the CPU: ``parallel/mesh.py`` over
several devices, and ``eval_policy_parallel`` dealing the batched CLI's
batches to spawned worker processes (``devices=["cpu", "cpu"]``).

The run: a rope of 30 particles (Y = 5e2), a 50-splat table scan, the
test cameras at half size (32x64), the hold policy, 2 episodes in
batches of 1 (one a worker), ``physics.fps`` 10 (10 control steps after
the 30 of stabilization) at dt = 2e-3, on one torch thread a process.
The one-process run and the two-worker run go side by side (the
one-process run in this process), once for the whole module.

Held: the two run directories hold the same files; every file but the
pickles and ``hydra.yaml`` byte for byte (JSONs, JPEGs, videos, the
calibration); the pickled states equal leaf by leaf (torch's pickles of
equal tensors differ in their bytes from process to process);
``hydra.yaml`` equal apart from the run name. A resumed fan-out skips
the finished batch, and a worker that raises fails the run. Also
``visualize_rollouts`` over the two-worker run against the JAX tool's
grids (within 1 level)."""

import copy
import pickle
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_cli_scene import files, one_thread


def test_shard_batch_over_two_devices():
    from real2sim_eval_tpu_torch.parallel import (make_env_mesh, replicate,
                                                  shard_batch)

    mesh = make_env_mesh(devices=["cpu", "cpu"])
    assert len(mesh.devices) == 2
    rng = np.random.default_rng(0)
    tree = {"x": rng.normal(size=(5, 4, 3)).astype(np.float32),
            "g": torch.arange(10).reshape(5, 2), "n": 3,
            "shared": np.ones((7, 2), np.float32), "s": np.float32(2.0)}
    shares = shard_batch(tree, mesh)
    assert len(shares) == 2
    assert [s["x"].shape[0] for s in shares] == [3, 2]
    for key in ("x", "g"):
        np.testing.assert_array_equal(
            torch.cat([torch.as_tensor(s[key]) for s in shares]).numpy(),
            np.asarray(tree[key]))
    for s in shares:
        assert s["n"] == 3 and float(s["s"]) == 2.0
        assert torch.equal(s["shared"], torch.ones((7, 2)))
    copies = replicate(tree, mesh)
    assert len(copies) == 2 and all(torch.equal(c["g"], tree["g"])
                                    for c in copies)


def scene_cfg(root: Path):
    """Write the scene's files under ``root``; its config."""
    from real2sim_eval_tpu_torch import testing as tt

    rope = tt.make_rope_points(n=30, length=0.3)
    tt.write_fixture_checkpoint(root, "fan", rope, spring_Y=5e2)
    gs = tt.make_synthetic_scene(root / "scans", rope_pts=rope, n_table=50)
    cameras = [dict(c, h=32, w=64, intr=[30.0, 0.0, 32.0, 0.0, 30.0, 16.0,
                                         0.0, 0.0, 1.0])
               for c in tt.TEST_CAMERAS]
    cfg = tt.full_cfg(root, "fan", gs=gs, cameras=cameras,
                      physics_over=dict(dt=2e-3, fps=10,
                                        self_collision=False))
    cfg.exp_root = str(root / "log")
    cfg.raster_backend = "auto"
    cfg.env.sim.duration = 1
    cfg.batch_size = 1
    cfg.checkpoint_every = 5
    cfg.telemetry_every = 5
    cfg.policy = dict(builtin="hold", n_episodes=2, inference_cfg_path=None,
                      checkpoint_path=None)
    return cfg


def run_cfg(cfg, timestamp: str, **top):
    from real2sim_eval_tpu_torch.config import ConfigNode

    c = ConfigNode(copy.deepcopy(cfg.to_dict()))
    c.timestamp = timestamp
    for k, v in top.items():
        c[k] = v
    return c


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from real2sim_eval_tpu_torch.experiments import eval_policy_parallel as epp

    root = tmp_path_factory.mktemp("fanout")
    cfg = scene_cfg(root)
    one, two = run_cfg(cfg, "one"), run_cfg(cfg, "two")
    out = {}

    def fan():
        out["two"] = epp.main(two, devices=["cpu", "cpu"])

    with one_thread():
        t = threading.Thread(target=fan)
        t.start()
        try:
            out["one"] = epp.main(one, device="cpu")
        finally:
            t.join(timeout=600)
    assert not t.is_alive() and "two" in out
    return root, cfg, out


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(u, v) for u, v in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def test_two_workers_write_what_one_process_writes(runs):
    _, _, out = runs
    one, two = Path(out["one"]), Path(out["two"])
    names = files(one)
    assert names == files(two)
    assert {"batch_00000.done", "batch_00001.done"} <= set(names)
    assert sum(n.endswith(".pkl") for n in names) == 2 * 10
    for f in names:
        a, b = one / f, two / f
        if f.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert same_tree(pickle.load(fa), pickle.load(fb)), f
        elif f == "hydra.yaml":
            strip = [ln for ln in a.read_text().splitlines()
                     if not ln.startswith("timestamp:")]
            assert strip == [ln for ln in b.read_text().splitlines()
                             if not ln.startswith("timestamp:")]
        else:
            assert a.read_bytes() == b.read_bytes(), f


def test_resume_skips_finished_batches_and_a_failed_worker_fails(runs):
    """Batch 0 done, batch 1's episode path blocked by a file: worker 0
    skips its batch (its files untouched), worker 1 raises, the run fails
    naming it."""
    from real2sim_eval_tpu_torch.experiments import eval_policy_parallel as epp

    root, cfg, out = runs
    run = root / "log" / "output_eval_policy" / "resumed"
    shutil.copytree(out["two"], run)
    shutil.rmtree(run / "episode_0001")
    (run / "batch_00001.done").unlink()
    (run / "episode_0001").write_text("in the way")
    before = {f: (run / f).stat().st_mtime_ns for f in files(run)
              if f.startswith("episode_0000/")}
    with one_thread(), pytest.raises(RuntimeError, match="worker 1 on cpu"):
        epp.cli(["--config-path", str(write_cfg_file(root, cfg)),
                 "--device", "cpu,cpu"])
    assert {f: (run / f).stat().st_mtime_ns for f in before} == before
    assert not (run / "batch_00001.done").exists()


def write_cfg_file(root: Path, cfg) -> Path:
    from real2sim_eval_tpu_torch.config import save_config

    d = root / "cfg_resumed"
    save_config(run_cfg(cfg, "resumed", resume=True),
                d / "eval_policy_batched.yaml")
    return d


def test_visualize_rollouts_grids_match_jax(runs, monkeypatch):
    from PIL import Image

    from real2sim_eval_tpu.experiments.utils import visualize_rollouts as jvr
    from real2sim_eval_tpu_torch.experiments.utils import (
        visualize_rollouts as tvr)

    root, _, out = runs
    grids = {}
    for name, mod in (("jax", jvr), ("port", tvr)):
        run = root / f"rollouts_{name}"
        shutil.copytree(Path(out["two"]) / "start_images",
                        run / "start_images")
        shutil.copytree(Path(out["two"]) / "final_images",
                        run / "final_images")
        if name == "jax":
            monkeypatch.setattr("sys.argv", ["vr", "--data_dir", str(run)])
            mod.main()
        else:
            mod.main(["--data_dir", str(run)])
        grids[name] = {p.name: np.asarray(Image.open(p)).astype(int)
                       for p in run.glob("*_grid_camera_*.jpg")}
    assert sorted(grids["port"]) == [
        f"{w}_grid_camera_{c}.jpg" for w in ("final", "start")
        for c in (0, 1)]
    assert grids["port"].keys() == grids["jax"].keys()
    for k, img in grids["port"].items():
        assert img.shape == grids["jax"][k].shape
        assert np.abs(img - grids["jax"][k]).max() <= 1, k
