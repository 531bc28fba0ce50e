"""The port's CLI layer against the JAX package's, piece by piece, on the CPU.

Held: ``KinHelper`` (FK within 1e-6, IK within 1e-4, the IK bound of
test_torch_env.py); the CLI helper (overrides, ``--config-name``,
``--device``, the ``raster_backend`` mapping and the value that raises);
``EpisodeWriter`` against the JAX writer on the same observations (the
same files, calibration ``.npy`` bitwise, JSON equal, pickles equal leaf
by leaf, JPEG bytes equal), the batched uint8 conversion bitwise the
per-image numpy path, the raw encoder and its missing-cv2 error; the
policies; the success criteria against the JAX ones on the same dumps
(equal result lists and ``success.txt`` bytes) and the unit cases of
test_cli_e2e.py's ``TestSuccessCriteria``; the one-card mesh. The CLIs
run end to end in test_torch_cli_batched.py, test_torch_cli_single.py,
test_torch_cli_replay.py and test_torch_cli_resume.py."""

import filecmp
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from real2sim_eval_tpu_torch import testing as tt

QPOS = np.array([[0, -45, 0, 30, 0, 75, 0], [10, -30, 5, 40, -5, 70, 3],
                 [-20, -50, 10, 20, 8, 80, -6]]) * np.pi / 180


# ---------------------------------------------------------------------------
# KinHelper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kin_helpers():
    from real2sim_eval_tpu.kinematics import KinHelper as JKin
    from real2sim_eval_tpu_torch.kinematics import KinHelper as TKin

    return JKin(tt.BUILTIN_URDF), TKin(tt.BUILTIN_URDF, device="cpu")


def test_kinhelper_fk_matches_jax(kin_helpers):
    jk, tk = kin_helpers
    assert tk.sapien_eef_idx == jk.sapien_eef_idx
    links = [tk.sapien_eef_idx, 0, 3]
    for q in QPOS:
        for a, b in zip(tk.compute_fk_sapien_links(q, links),
                        jk.compute_fk_sapien_links(q, links)):
            assert a.shape == (4, 4)
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_kinhelper_ik_matches_jax(kin_helpers):
    jk, tk = kin_helpers
    for i, (xyz, rpy) in enumerate((([0.2568, 0.0, 0.4005], [np.pi, 0, 0]),
                                    ([0.3, 0.05, 0.35], [np.pi, 0.1, 0.0]),
                                    ([0.25, -0.05, 0.3], [3.0, 0, 0.2]))):
        cart = np.array(xyz + rpy)
        a = tk.compute_ik_sapien(QPOS[0], cart)
        b = jk.compute_ik_sapien(QPOS[0], cart)
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
        T = tk.compute_fk_sapien_links(a, [tk.sapien_eef_idx])[0]
        np.testing.assert_allclose(T[:3, 3], xyz, atol=1e-3)


def test_ik_damped_ls_is_the_solver(kin_helpers):
    from real2sim_eval_tpu_torch.kinematics import ik_damped_ls, make_ik_fn

    _, tk = kin_helpers
    q0 = torch.as_tensor(QPOS[:2], dtype=torch.float32)
    target = tk.chain.fk_link(torch.as_tensor(QPOS[1:], dtype=torch.float32),
                              tk.sapien_eef_idx)
    a = ik_damped_ls(tk.chain, "link7", q0, target, n_active=7)
    b = make_ik_fn(tk.chain, "link7", n_active=7)(q0, target)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CLI helper
# ---------------------------------------------------------------------------


def test_hydra_like_main_overrides_name_and_device(tmp_path):
    from real2sim_eval_tpu_torch.config import save_config
    from real2sim_eval_tpu_torch.config.node import ConfigNode
    from real2sim_eval_tpu_torch.experiments.cli import (hydra_like_main,
                                                         run_name_for)

    save_config(ConfigNode(dict(a=dict(b=1), timestamp=None)),
                tmp_path / "first.yaml")
    save_config(ConfigNode(dict(a=dict(b=2), timestamp="fixed")),
                tmp_path / "second.yaml")
    seen = []

    @hydra_like_main("first")
    def main(cfg, device="cuda", extra=None):
        seen.append((cfg, device, extra))
        return "ran"

    d = ["--config-path", str(tmp_path)]
    assert main(d + ["a.b=5", "new=[1, 2]"]) == "ran"
    cfg, device, extra = seen[-1]
    assert (cfg.a.b, cfg.new, device, extra) == (5, [1, 2], "cuda", None)
    assert main(d + ["--config-name", "second", "--device", "cpu"],
                extra=7) == "ran"
    cfg, device, extra = seen[-1]
    assert (cfg.a.b, device, extra) == (2, "cpu", 7)
    assert run_name_for(cfg) == "fixed"
    assert len(run_name_for(seen[0][0])) == len("20260101-000000")
    with pytest.raises(SystemExit, match="unrecognized"):
        main(d + ["stray"])
    assert main(d + ["--help"]) is None and len(seen) == 2


@pytest.mark.parametrize("name,backend", [("auto", "tiles"),
                                          ("pallas", "tiles"),
                                          ("reference", "reference"),
                                          (None, "tiles"),
                                          ("interpret", None)])
def test_raster_config_from(name, backend):
    from real2sim_eval_tpu_torch.config.node import ConfigNode
    from real2sim_eval_tpu_torch.experiments.cli import raster_config_from

    cfg = ConfigNode({} if name is None else {"raster_backend": name})
    if backend is None:
        with pytest.raises(ValueError, match="raster_backend"):
            raster_config_from(cfg)
    else:
        assert raster_config_from(cfg).backend == backend


# ---------------------------------------------------------------------------
# the episode writer
# ---------------------------------------------------------------------------

CAMERAS = [tt.TEST_CAMERAS[0],
           dict(tt.TEST_CAMERAS[1]),
           dict(type="side", h=64, w=128, intr=tt.TEST_CAMERAS[0]["intr"],
                w2c=np.linalg.inv(np.array(tt.CAMERAS[1]["c2w"]).reshape(
                    4, 4)).reshape(-1).tolist())]


def _frames(rng, n):
    # values spread over [0, 1] and the exact 8-bit steps
    f = rng.random((n, 3, 64, 128)).astype(np.float32)
    f[:, :, 0, :64] = np.arange(64, dtype=np.float32) * 4 / 255
    f[:, :, 1, :2] = [0.0, 1.0]
    return f


def _state(rng, step):
    return {"renderer": {"x": rng.random((20, 3)).astype(np.float32)},
            "physics": {"static_meshes": [{
                "vertices": rng.random((8, 3)).astype(np.float32),
                "faces": np.arange(12, dtype=np.int64).reshape(4, 3)}],
                "init_springs": np.arange(10, dtype=np.int32).reshape(5, 2),
                "key": np.arange(2, dtype=np.uint32),
                "mask": np.ones(3, np.uint8), "flag": np.ones(2, bool)},
            "step": step}


def _write_episode(writer, obs, rng_state, as_tensor):
    writer.write_calibration()
    writer.write_random_variables([[0.1, 0.2, 3.0], [1, 2]])
    for step in range(2):
        writer.write_images(obs[step], step,
                            start_final="start" if step == 0 else None)
        vals = [np.float32([0.25, 0.0, 0.4 - step]),
                np.float32([0.0, 1.0, 0.0, 0.0]), np.float32([0.4]),
                np.float32([0.3, 0.1, 0.2]), np.float32([0, 0, 1, 0]),
                np.float32([1.0])]
        writer.write_robot(step, *[torch.as_tensor(v) if as_tensor else v
                                   for v in vals])
        writer.write_state(step, rng_state(step))
    writer.write_images(obs[1], 2, start_final="final")


def _obs(frames, step, as_tensor):
    conv = torch.as_tensor if as_tensor else (lambda a: a)
    return {"image_list": [conv(frames[step, 0]), conv(frames[step, 2])],
            "image_wrist_list": [conv(frames[step, 1])]}


@pytest.fixture(scope="module")
def writer_runs(tmp_path_factory):
    from real2sim_eval_tpu.experiments.episode_io import EpisodeWriter as JW
    from real2sim_eval_tpu_torch.experiments.episode_io import (
        EpisodeWriter as TW)

    frames = _frames(np.random.default_rng(0), 6).reshape(2, 3, 3, 64, 128)
    roots = {}
    for name, cls, as_tensor in (("jax", JW, False), ("port", TW, True)):
        root = tmp_path_factory.mktemp(name)
        w = cls(root, 3, CAMERAS)
        _write_episode(w, [_obs(frames, s, as_tensor) for s in range(2)],
                       lambda s: _state(np.random.default_rng(s), s),
                       as_tensor)
        roots[name] = root
    return roots, frames


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def test_writer_files_match_jax(writer_runs):
    (roots, _) = writer_runs
    files = _files(roots["jax"])
    assert files == _files(roots["port"])
    assert len(files) == 3 * 3 + 3 * 2 + 3 + 1 + 2 + 2
    for f in files:
        a, b = roots["jax"] / f, roots["port"] / f
        if f.endswith((".npy", ".jpg")):
            assert filecmp.cmp(a, b, shallow=False), f
        elif f.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), f


def _leaves_equal(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _leaves_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _leaves_equal(x, y, f"{where}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_writer_pickles_match_jax_leaf_by_leaf(writer_runs):
    roots, _ = writer_runs
    pkls = [f for f in _files(roots["jax"]) if f.endswith(".pkl")]
    assert len(pkls) == 2
    for f in pkls:
        a = pickle.load(open(roots["jax"] / f, "rb"))
        b = pickle.load(open(roots["port"] / f, "rb"))
        _leaves_equal(a, b, f)
        assert ("physics" in b) == f.endswith("000000.pkl")
    s0 = pickle.load(open(roots["port"] / pkls[0], "rb"))
    assert isinstance(s0["physics"]["key"], np.ndarray)       # uint32 stays
    assert torch.is_tensor(s0["physics"]["mask"])             # uint8 converts


def test_batched_uint8_frames_bitwise_the_numpy_path():
    from real2sim_eval_tpu_torch.experiments.episode_io import (
        camera_frames, frames_uint8_bgr, step_frames)

    rng = np.random.default_rng(1)
    fixed = torch.as_tensor(_frames(rng, 8).reshape(4, 2, 3, 64, 128))
    wrist = torch.as_tensor(_frames(rng, 4).reshape(4, 1, 3, 64, 128))
    cams = [CAMERAS[0], CAMERAS[1], CAMERAS[2]]
    out = step_frames(cams, fixed, wrist)
    assert len(out) == 3 and out[0].shape == (4, 64, 128, 3)
    for lane in range(4):
        want = camera_frames(cams, fixed[lane].numpy(), wrist[lane].numpy())
        for cam, w in enumerate(want):
            ref = (w.transpose(1, 2, 0) * 255).astype(np.uint8)[:, :, ::-1]
            np.testing.assert_array_equal(out[cam][lane], ref)
            np.testing.assert_array_equal(
                frames_uint8_bgr(torch.as_tensor(w)), ref)
    # cameras of two resolutions: one host copy each
    small = wrist[:, :, :, :32]
    out = step_frames(cams, fixed, small)
    assert out[1].shape == (4, 32, 128, 3)
    np.testing.assert_array_equal(
        out[1][2], (small[2, 0].numpy().transpose(1, 2, 0) * 255).astype(
            np.uint8)[:, :, ::-1])


def test_writer_overlay_missing_cv2_and_videos(tmp_path, monkeypatch):
    import cv2

    from real2sim_eval_tpu_torch.experiments.episode_io import EpisodeWriter

    frames = _frames(np.random.default_rng(2), 3)
    obs = _obs(frames.reshape(1, 3, 3, 64, 128), 0, True)
    seen, written = [], {}
    imwrite = cv2.imwrite

    def overlay(img):
        seen.append(type(img))
        return img * 0.5

    def record(path, img):
        written[str(Path(path).relative_to(tmp_path))] = np.array(img)
        return imwrite(path, img)

    monkeypatch.setattr(cv2, "imwrite", record)
    w = EpisodeWriter(tmp_path / "ov", 0, CAMERAS)
    w.write_images(obs, 0, overlay_fn=overlay, start_final="start")
    assert seen == [np.ndarray] * 3
    np.testing.assert_array_equal(
        written["ov/episode_0000/camera_1/rgb/000000.jpg"],
        (frames[1].transpose(1, 2, 0) * 0.5 * 255).astype(
            np.uint8)[:, :, ::-1])
    assert (tmp_path / "ov/start_images/episode_0000_camera_2.jpg").exists()
    # no cv2: the writer names what is missing and writes nothing
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError, match=r"OpenCV \(cv2\)"):
            w.write_images(obs, 1)
    assert not (tmp_path / "ov/episode_0000/camera_0/rgb/000001.jpg").exists()

    j = EpisodeWriter(tmp_path / "jpg", 0, CAMERAS)
    for step in range(3):
        j.write_images(obs, step)
    j.finalize_videos()
    assert len(list((tmp_path / "jpg").rglob("*.mp4"))) == 3

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        j.write_images(obs, 3)
    with pytest.raises(ImportError, match="ffmpeg"):
        j.finalize_videos()


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------


def test_policies_match_jax(tmp_path):
    from real2sim_eval_tpu.experiments import policy_api as jp
    from real2sim_eval_tpu_torch.experiments import policy_api as tp

    rng = np.random.default_rng(3)
    script = tmp_path / "actions.json"
    json.dump(rng.random((4, 8)).tolist(), open(script, "w"))
    for cfg in ({"builtin": "hold"},
                {"builtin": "scripted", "script_path": str(script)}):
        a, b = tp.load_policy(cfg), jp.load_policy(cfg)
        for state in (rng.random((3, 8)).astype(np.float32),
                      rng.random((2, 2)).astype(np.float32)):
            for _ in range(2):
                np.testing.assert_array_equal(
                    a.inference({"observation.state": state}),
                    b.inference({"observation.state": state}))
        a.reset()
        assert a.visualize_overlay("img") == "img"
    with pytest.raises(ImportError, match="builtin"):
        tp.load_policy({})


# ---------------------------------------------------------------------------
# the success criteria
# ---------------------------------------------------------------------------


def _success_dumps(root):
    """Three tasks' episodes whose frames pass their criterion in some
    episodes and steps only: rope crossings of the clip box, particles in
    the sloth's box, particles on the T target."""
    from real2sim_eval_tpu_torch.experiments.utils import success as su
    from real2sim_eval_tpu_torch.utils.mesh import make_box

    rng = np.random.default_rng(4)
    n = 2 * su.ROPE_CROSSINGS_REQUIRED + 10
    c = su.ROPE_CLIP_CENTER
    springs = np.stack([np.arange(n), np.arange(n) + n], 1)
    box = make_box((0.2, 0.13, 0.27), center=(0.5, 0.1, 0.0))
    target = rng.random((su.SLOTH_POINTS_REQUIRED + 50, 3)) * 0.01
    tasks = {}
    for task in ("rope", "sloth", "T"):
        for ep, good_steps in enumerate((range(0, 40), range(5, 20),
                                         range(0, 0))):
            d = root / task / f"episode_{ep:04d}" / "state"
            d.mkdir(parents=True)
            for step in range(40):
                good = step in good_steps
                if task == "rope":
                    # a good frame's odd segments cross both planes of
                    # the clip box; a bad frame's stop short of the first
                    y = (np.where(np.arange(n) % 2, 0.1, -0.1) if good
                         else np.full(n, -0.05))
                    p0 = np.tile([c[0], c[1] - 0.1, 0.01], (n, 1))
                    p1 = p0.copy()
                    p1[:, 1] = c[1] + y
                    x = np.concatenate([p0, p1]).astype(np.float32)
                    init = {"init_springs": torch.as_tensor(springs),
                            "static_meshes": []}
                elif task == "sloth":
                    x = (box.vertices.mean(0) + (rng.random((len(target), 3))
                         - 0.5) * (0.01 if good else 1.0)).astype(np.float32)
                    init = {"static_meshes": [{
                        "vertices": torch.as_tensor(box.vertices)}]}
                else:
                    x = (target + (0.0 if good else 0.2)).astype(np.float32)
                    init = {"static_meshes": []}
                s = {"renderer": {"x": torch.as_tensor(x)}}
                if step == 0:
                    s["physics"] = init
                with open(d / f"{step:06d}.pkl", "wb") as f:
                    pickle.dump(s, f)
        tasks[task] = root / task
    with open(root / "T_target.pkl", "wb") as f:
        pickle.dump({"renderer": {"x": torch.as_tensor(target)}}, f)
    return tasks


@pytest.mark.parametrize("task", ["rope", "sloth", "T"])
def test_success_calculators_match_jax(task, tmp_path, monkeypatch):
    import importlib

    tasks = _success_dumps(tmp_path)
    argv = ["--data_dir", str(tasks[task]), "--start_step", "2"]
    if task == "T":
        argv += ["--target_state", str(tmp_path / "T_target.pkl")]
    name = f"experiments.utils.calculate_success_{task}"
    port = importlib.import_module(f"real2sim_eval_tpu_torch.{name}")
    results = port.main(argv)
    port_txt = (tasks[task] / "success.txt").read_bytes()
    jax_mod = importlib.import_module(f"real2sim_eval_tpu.{name}")
    monkeypatch.setattr(sys, "argv", ["calc"] + argv)
    jax_mod.main()
    assert (tasks[task] / "success.txt").read_bytes() == port_txt
    assert results == [True, False, False]


def test_load_state_maps_cuda_storages_to_the_cpu(tmp_path, monkeypatch):
    """A dump pickled with CUDA tensors raises in a plain ``pickle.load``
    on a CPU host; ``load_state`` reloads it through the CPU-mapped
    unpickler."""
    from real2sim_eval_tpu_torch.experiments.utils import success as su

    path = tmp_path / "s.pkl"
    with open(path, "wb") as f:
        pickle.dump({"renderer": {"x": torch.ones(3)}}, f)
    orig, calls = pickle.load, []

    def cuda_load(f, *a, **k):   # the first load fails as on a CPU host
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("Attempting to deserialize object on a CUDA "
                               "device")
        return orig(f, *a, **k)

    monkeypatch.setattr(su.pickle, "load", cuda_load)
    out = su.load_state(path)
    assert len(calls) > 1
    assert torch.equal(out["renderer"]["x"], torch.ones(3))


def _rope_crossings():
    from real2sim_eval_tpu_torch.experiments.utils.success import (
        segment_crossings_y_plane)

    p0 = np.tile([[0.62, -0.1, 0.01]], (200, 1))
    p1 = np.tile([[0.62, 0.1, 0.01]], (200, 1))
    assert segment_crossings_y_plane(p0, p1, 0.0, (0.6, 0.64),
                                     (0.0, 0.03)) == 200
    assert segment_crossings_y_plane(p0 + [1, 0, 0], p1 + [1, 0, 0], 0.0,
                                     (0.6, 0.64), (0.0, 0.03)) == 0


def _sloth_obb():
    from real2sim_eval_tpu_torch.experiments.utils.success import (
        minimal_obb, points_in_obb)
    from real2sim_eval_tpu_torch.utils import transforms_np as tnp
    from real2sim_eval_tpu_torch.utils.mesh import make_box

    box = make_box((0.2, 0.13, 0.27), center=(0.5, 0.1, 0.0))
    T = np.eye(4)
    T[:3, :3] = tnp.axis_angle_to_rot(np.array([0.0, 0.0, 0.7]))
    box.transform(T)
    center, axes, extent = minimal_obb(box.vertices)
    np.testing.assert_allclose(sorted(extent), sorted([0.2, 0.13, 0.27]),
                               atol=1e-6)
    inside = box.vertices.mean(0)[None] + np.zeros((4000, 3))
    assert points_in_obb(inside, center, axes, extent) == 4000


def _pusht_mse():
    from real2sim_eval_tpu_torch.experiments.utils.success import (
        is_pusht_success)

    x = np.random.default_rng(0).random((100, 3))
    init = {"physics": {"static_meshes": []}}
    assert is_pusht_success({"renderer": {"x": x}}, x, init)
    assert not is_pusht_success({"renderer": {"x": x + 0.1}}, x, init)


@pytest.mark.parametrize("case", [_rope_crossings, _sloth_obb, _pusht_mse],
                         ids=["rope_crossings", "sloth_obb", "pusht_mse"])
def test_success_criteria(case):
    """test_cli_e2e.py's TestSuccessCriteria on the port's calculators."""
    case()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_one_card_mesh_places_the_batch():
    import dataclasses

    from real2sim_eval_tpu_torch.parallel import (make_env_mesh,
                                                  mean_over_envs,
                                                  replicate, shard_batch)
    from real2sim_eval_tpu_torch.parallel.mesh import EnvMesh

    @dataclasses.dataclass(frozen=True)
    class Lanes:
        x: np.ndarray
        step: int = 0

    cpu = torch.device("cpu")
    mesh = make_env_mesh(devices=[cpu, cpu], n_devices=1)
    assert mesh == EnvMesh((cpu,))
    tree = {"x": np.zeros((4, 3), np.float32), "n": 3,
            "l": [torch.ones(2)], "t": (np.arange(2),)}
    out = shard_batch(tree, mesh)
    assert torch.is_tensor(out["x"]) and out["x"].shape == (4, 3)
    assert out["n"] == 3 and isinstance(out["t"], tuple)
    assert torch.equal(replicate(tree, mesh)["l"][0], torch.ones(2))
    assert float(mean_over_envs(torch.arange(4))) == 1.5
    assert mean_over_envs(np.arange(4)) == 1.5
    lanes = shard_batch(Lanes(np.ones((2, 3)), 4), mesh)
    assert torch.is_tensor(lanes.x) and lanes.step == 4
    # a mesh naming the CPU twice: one share of the envs per entry
    shares = shard_batch(tree, make_env_mesh(devices=[cpu, cpu]))
    assert [s["x"].shape for s in shares] == [(2, 3), (2, 3)]
    assert all(s["n"] == 3 and torch.equal(s["l"][0], torch.ones(2))
               for s in shares)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_env_mesh(devices=[])
