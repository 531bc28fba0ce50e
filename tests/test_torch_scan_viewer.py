"""The port's scan viewer against the JAX package's.

The stdlib MJPEG server (utils/viser_gui.py) as tests/test_aux.py:13-108
holds the JAX one: the stream, the ``/camera`` orbit control, and
``serve_orbit`` on an arbitrary scan at 64x48 (port 0, a free port,
``device="cpu"``). ``render_orbit_views`` and ``visualize_scan.main`` run
at a small camera (``Camera`` patched in both packages' camera modules;
the 640x480 views run on the card only): each view within 2e-3 rgb and
1e-3 depth of the JAX reference backend (tests/test_raster.py:162-169),
the PNGs within one level, the ``--splat`` export byte for byte."""

import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from real2sim_eval_tpu_torch import testing as tt
from test_torch_scene_tools import small_renders


def test_viser_viewer_serves_mjpeg():
    from real2sim_eval_tpu_torch.utils.viser_gui import ViserViewer

    v = ViserViewer(port=0)  # pick a free port
    try:
        frame = np.zeros((32, 48, 3), np.uint8)
        frame[:, :, 0] = 255
        v.set_output({"image": frame})
        v.set_fps(30.0)
        with urllib.request.urlopen(f"http://127.0.0.1:{v.port}/",
                                    timeout=5) as r:
            body = r.read()
        assert b"real2sim" in body
        req = urllib.request.urlopen(f"http://127.0.0.1:{v.port}/stream",
                                     timeout=5)
        chunk = req.read(2000)
        assert b"image/jpeg" in chunk
        assert b"\xff\xd8" in chunk  # JPEG SOI marker
        req.close()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{v.port}/nothing",
                                   timeout=5)
    finally:
        v.close()


def test_encode_jpeg_matches_jax():
    from real2sim_eval_tpu.utils.viser_gui import _encode_jpeg as jenc
    from real2sim_eval_tpu_torch.utils.viser_gui import _encode_jpeg

    frame = (np.random.default_rng(0).random((24, 40, 3)) * 255).astype(
        np.uint8)
    jpg = _encode_jpeg(frame)
    assert jpg[:2] == b"\xff\xd8" and jpg == jenc(frame)


def test_viser_viewer_camera_control():
    """The /camera endpoint drives the orbit camera a renderer reads per
    frame through get_metadata, and lands where the JAX viewer's does."""
    from real2sim_eval_tpu.utils.viser_gui import ViserViewer as JViewer
    from real2sim_eval_tpu_torch.utils.viser_gui import ViserViewer, orbit_w2c

    v, jv = ViserViewer(port=0), JViewer(port=0)
    try:
        k = np.diag([400.0, 400.0, 1.0])
        w2c0 = np.eye(4, dtype=np.float32)
        for viewer in (v, jv):
            viewer.set_metadata(64, 48, k, w2c0)
            urllib.request.urlopen(
                f"http://127.0.0.1:{viewer.port}/camera?az=1.2&el=0.4"
                "&dist=0.8", timeout=5).close()
        meta = v.get_metadata()
        w2c = np.asarray(meta["w2c"])
        np.testing.assert_array_equal(w2c, jv.get_metadata()["w2c"])
        assert not np.allclose(w2c, w2c0)
        R = w2c[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)  # SE(3)
        # camera sits `dist` from the target (initial look-at: 0.7 m on +z)
        eye = -R.T @ w2c[:3, 3]
        np.testing.assert_allclose(np.linalg.norm(eye - [0, 0, 0.7]), 0.8,
                                   atol=1e-5)
        # intrinsics / size preserved for the rasterizer
        assert meta["w"] == 64 and meta["h"] == 48
        # a second request orbits again (live control)
        urllib.request.urlopen(
            f"http://127.0.0.1:{v.port}/camera?az=0.0&el=0.0&dist=1.5",
            timeout=5).close()
        assert not np.allclose(np.asarray(v.get_metadata()["w2c"]), w2c)
        from real2sim_eval_tpu.utils.viser_gui import orbit_w2c as jorbit
        for args in ((0.3, 0.6, 1.2, [0.1, 0.2, 0.0]),
                     (0.0, np.pi / 2, 1.0, [0, 0, 0])):
            np.testing.assert_array_equal(orbit_w2c(*args), jorbit(*args))
    finally:
        v.close()
        jv.close()


def scan_params(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "means3D": rng.normal(scale=0.2, size=(n, 3)).astype(np.float32),
        "sh_colors": rng.normal(scale=0.3, size=(n, 3)).astype(np.float32),
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "log_scales": np.full((n, 3), np.log(0.02), np.float32),
        "logit_opacities": np.full((n, 1), 2.0, np.float32),
    }


def test_serve_orbit_arbitrary_ply():
    """``visualize_scan --serve``: browser-orbit any splat scan with no
    episode running, rendered by the port on the CPU."""
    from real2sim_eval_tpu_torch.experiments.utils.visualize_scan import (
        serve_orbit)

    params = scan_params()
    box = {}

    def run():
        box["viewer"] = serve_orbit(params, port=0, w=64, h=48,
                                    duration=6.0, device="cpu")

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    v = box["viewer"]
    try:
        assert v._frame is not None, "serve loop must render a frame"
        assert v._frame.shape == (48, 64, 3) and v._frame.dtype == np.uint8
        assert v._frame.any()
        # orbiting via /camera changes the pose the next frame renders with
        w2c0 = np.asarray(v.get_metadata()["w2c"])
        v.set_orbit(1.0, 0.3, 1.0)
        assert not np.allclose(np.asarray(v.get_metadata()["w2c"]), w2c0)
    finally:
        v.close()


@pytest.fixture(scope="module")
def scene_ply(tmp_path_factory):
    """A scan PLY: 300 table splats and 40 on each of the arm's links."""
    root = tmp_path_factory.mktemp("scan")
    tt.make_raw_scan(root / "scan.ply", np.eye(4), n_table=300,
                     pts_per_link=40)
    return root / "scan.ply"


def test_render_orbit_views_match_jax(scene_ply, tmp_path, monkeypatch):
    import cv2

    from real2sim_eval_tpu.experiments.utils import visualize_scan as J
    from real2sim_eval_tpu_torch.experiments.utils import visualize_scan as T
    from real2sim_eval_tpu_torch.utils.gs_processor import GSProcessor

    params = GSProcessor().load(scene_ply)
    jax_out, port_out = small_renders(monkeypatch, 8)
    J.render_orbit_views(params, tmp_path / "j", "scan", n_views=3)
    T.render_orbit_views(params, tmp_path / "t", "scan", n_views=3,
                         device="cpu")
    assert len(port_out) == len(jax_out) == 3
    for (_, (im_t, dep_t)), (_, (im_j, dep_j)) in zip(port_out, jax_out):
        assert tuple(im_t.shape) == (3, 60, 80)
        assert im_t.abs().sum() > 0
        np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j),
                                   atol=2e-3)
        np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j),
                                   atol=1e-3)
    for i in range(3):
        a = cv2.imread(str(tmp_path / "t" / f"scan_view{i}.png"))
        b = cv2.imread(str(tmp_path / "j" / f"scan_view{i}.png"))
        assert a.shape == (60, 80, 3)
        assert np.abs(a.astype(int) - b).max() <= 1


def test_visualize_scan_main_matches_jax(scene_ply, tmp_path, monkeypatch):
    """``main`` over two scans with ``--splat``: four views of each and a
    merged .splat byte for byte the JAX tool's."""
    from real2sim_eval_tpu.experiments.utils import visualize_scan as J
    from real2sim_eval_tpu_torch.experiments.utils import visualize_scan as T
    from real2sim_eval_tpu_torch.utils.gs_processor import GSProcessor

    second = tmp_path / "second.ply"
    tt.make_raw_scan(second, np.eye(4), n_table=50, pts_per_link=5, seed=3)
    jax_out, port_out = small_renders(monkeypatch, 8)
    scans = [str(scene_ply), str(second)]
    monkeypatch.setattr(sys, "argv", ["x", *scans, "--out",
                                      str(tmp_path / "j"), "--splat",
                                      str(tmp_path / "j.splat")])
    J.main()
    T.main([*scans, "--out", str(tmp_path / "t"), "--splat",
            str(tmp_path / "t.splat"), "--device", "cpu"])
    assert len(port_out) == len(jax_out) == 8
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 8
    data = (tmp_path / "t.splat").read_bytes()
    assert data == (tmp_path / "j.splat").read_bytes()
    n = sum(len(GSProcessor().load(p)["means3D"]) for p in scans)
    assert len(data) == 32 * n


def test_visualize_scan_refuses_without_the_card(scene_ply, tmp_path,
                                                 monkeypatch):
    """The CLI and its renders run on the card unless ``--device cpu``;
    without a card they raise before writing anything."""
    import torch

    from real2sim_eval_tpu_torch.experiments.utils import visualize_scan as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main([str(scene_ply), "--out", str(tmp_path / "v"), "--splat",
                str(tmp_path / "s.splat")])
    assert not (tmp_path / "v").exists()
    assert not (tmp_path / "s.splat").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.render_orbit_views(scan_params(), tmp_path / "v", "x")
    start = time.time()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.serve_orbit(scan_params(), port=0, duration=5.0)
    assert time.time() - start < 5.0
