"""The whole slice: the port's ``eval_policy_batched.cli`` against the JAX
package's on one saved config, on the CPU.

The config is tests/test_batched_cli.py's (torch_cli_scene.py): 3
lanes, a rope of 100 particles, a 300-splat table scan, the 64x128 test
cameras, duration 1, dt = 2e-4, the hold policy, ``raster_backend:
auto`` (the JAX package's dense reference on the CPU, the port's tile
compositor: K1's plain version).
Each CLI runs once; every frame is recorded before encoding by wrapping
``cv2.imwrite``.

Held: the same files; ``renderer.x`` within 5e-5 at every step
(test_torch_env.py's particle tolerance); robot JSONs within 1e-5;
``random_variables.json`` and the calibration equal; the uint8 frames
within 1 level everywhere (2e-3 rgb x 255 = 0.51, so the truncation may
differ by one step); the success criteria's lists equal over both runs;
the port's ``stats`` (its loop split and marks) consistent with what it
wrote, and the evaluator its marks hand over holding finite particles
after the loop."""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest

from torch_cli_scene import STEPS, files as _files, one_thread, write_cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import cv2

    from real2sim_eval_tpu.experiments import eval_policy_batched as jcli
    from real2sim_eval_tpu_torch.config import save_config
    from real2sim_eval_tpu_torch.experiments import eval_policy_batched as tcli

    root = tmp_path_factory.mktemp("batched_cli")
    cfg = write_cfg(root, timestamp="batchrun", batch_size=3,
                    episode_start=0, checkpoint_every=10, telemetry_every=10,
                    policy=dict(builtin="hold", n_episodes=3,
                                inference_cfg_path=None,
                                checkpoint_path=None))
    save_config(cfg, root / "cfg" / "eval_policy_batched.yaml")

    frames = {}
    imwrite = cv2.imwrite

    def record(path, img):
        frames[path] = np.array(img)
        return imwrite(path, img)

    args = ["--config-path", str(root / "cfg")]
    seen = {}

    def on_mark(name, ev):
        if name == "built":
            seen["batch_size"] = ev.batch_size
        elif name == "looped":
            seen["particles"] = ev.particle_states()

    stats = {"on_mark": on_mark}
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setattr(cv2, "imwrite", record)
        out = {"jax": Path(jcli.cli(args + [f"exp_root={root / 'jax'}"])),
               "port": Path(tcli.cli(args + [f"exp_root={root / 'port'}",
                                             "--device", "cpu"],
                                     stats=stats))}
    by_run = {k: {str(Path(p).relative_to(run)): img
                  for p, img in frames.items()
                  if Path(p).is_relative_to(run)} for k, run in out.items()}
    return out, by_run, stats | seen


def test_same_files(runs):
    out, _, _ = runs
    files = _files(out["jax"])
    assert files == _files(out["port"])
    n_cams = 2
    per_episode = n_cams * (STEPS + 1) + 2 * STEPS + 3 + 1 + n_cams
    assert len(files) == 3 * per_episode + 3 * 2 * n_cams + 2
    assert "batch_00000.done" in files and not any("ckpt" in f for f in files)


def test_particles_within_5e5_at_every_step(runs):
    out, _, _ = runs
    pkls = [f for f in _files(out["jax"]) if f.endswith(".pkl")]
    assert len(pkls) == 3 * STEPS
    for f in pkls:
        a = pickle.load(open(out["jax"] / f, "rb"))
        b = pickle.load(open(out["port"] / f, "rb"))
        assert a.keys() == b.keys() and (
            "physics" in b) == f.endswith("000000.pkl"), f
        xb = b["renderer"]["x"].numpy()
        assert np.isfinite(xb).all(), f
        np.testing.assert_allclose(xb, a["renderer"]["x"].numpy(), atol=5e-5,
                                   err_msg=f)
        if "physics" in b:
            np.testing.assert_array_equal(
                b["physics"]["init_springs"].numpy(),
                a["physics"]["init_springs"].numpy())
            np.testing.assert_allclose(
                b["physics"]["static_meshes"][0]["vertices"].numpy(),
                a["physics"]["static_meshes"][0]["vertices"].numpy(),
                atol=1e-6)


def test_robot_jsons_within_1e5(runs):
    out, _, _ = runs
    jsons = [f for f in _files(out["jax"]) if "/robot/" in f]
    assert len(jsons) == 3 * STEPS
    for f in jsons:
        a = json.load(open(out["jax"] / f))
        b = json.load(open(out["port"] / f))
        assert a.keys() == b.keys(), f
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=f)


def test_random_variables_and_calibration_equal(runs):
    out, _, _ = runs
    for f in _files(out["jax"]):
        if f.endswith("random_variables.json"):
            assert (json.load(open(out["jax"] / f))
                    == json.load(open(out["port"] / f))), f
        elif "/calibration/" in f:
            assert ((out["jax"] / f).read_bytes()
                    == (out["port"] / f).read_bytes()), f


def test_frames_before_encoding_within_one_level(runs):
    out, frames, _ = runs
    jpgs = [f for f in _files(out["jax"]) if f.endswith(".jpg")]
    assert sorted(frames["jax"]) == sorted(frames["port"]) == jpgs
    worst = 0
    for f in jpgs:
        a, b = frames["jax"][f], frames["port"][f]
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, f
        worst = max(worst, int(np.abs(a.astype(int) - b.astype(int)).max()))
    assert worst <= 1
    # the lanes render different randomized scenes
    assert not np.array_equal(frames["port"]["start_images/episode_0000_"
                                             "camera_0.jpg"],
                              frames["port"]["start_images/episode_0001_"
                                             "camera_0.jpg"])


def test_success_lists_equal(runs):
    from real2sim_eval_tpu.experiments.utils import success as jsu
    from real2sim_eval_tpu_torch.experiments.utils import success as tsu

    out, _, _ = runs
    lists = [mod.evaluate_episodes(run, mod.is_rope_success, start_step=0,
                                   frames_required=1)
             for mod in (jsu, tsu) for run in out.values()]
    assert lists == [[False] * 3] * 4


def test_port_stats_match_its_outputs(runs):
    out, _, stats = runs
    assert {"observations", "step", "frames_uint8", "encode_write_images",
            "policy", "copy_policy_images", "write_robot_state",
            "state_dumps"} <= set(stats["ms"])
    assert len(stats["ms"]["step"]) == STEPS
    assert len(stats["ms"]["save_state"]) == STEPS // 10
    assert len(stats["ms"]["check_saturation"]) == STEPS // 10
    assert list(stats["marks"]) == ["start", "built", "stabilized", "looped",
                                    "done"]
    pixels = STEPS * 3 * 2 * 64 * 128       # steps x lanes x cameras x HW
    assert stats["counts"]["frame_bytes"] == pixels * 3
    assert stats["counts"]["policy_image_bytes"] == pixels * 3 * 4
    last = pickle.load(open(out["port"] / "episode_0002/state/000029.pkl",
                            "rb"))["renderer"]["x"].numpy()
    assert stats["particles"].shape == (3,) + last.shape
    assert np.isfinite(stats["particles"]).all()
    assert stats["batch_size"] == 3
