"""The port's viewers against the JAX package's, on the CPU.

- ``utils/splat_viewer.py`` (tests/test_splat_viewer.py's two cases): the
  port's bundle, ``index.html`` and every ``.splat``, byte for byte the
  JAX package's on the same PLYs.
- ``GSRenderer`` with ``online: true`` (the viewer on port 0, a free
  port): ``render_online`` on a tiny scene (the built-in arm, a rope of
  40 particles, a 200-splat table scan) through the viewer's camera at
  64x128, the port's frame (K1's plain version) within 1 uint8 level of
  the JAX package's (its dense reference; 2e-3 rgb x 255 = 0.51, so the
  truncation may differ by one step); the viewer's frame changes with
  ``set_orbit``; nothing before the viewer has a camera.
- the debug dump ``reset_state(visualize_image=True)`` at that camera:
  ``test.png`` and ``test_depth.png`` in the working directory, each
  within 1 level of the JAX package's, ``test.png`` bitwise the frame.
``visualize_rollouts`` is held in test_torch_fanout.py, over that file's
run directory."""

import copy

import numpy as np
import pytest

from real2sim_eval_tpu.testing import (BUILTIN_URDF, TEST_CAMERAS, full_cfg,
                                       make_rope_points, make_synthetic_scene,
                                       write_fixture_checkpoint)


def _params(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "means3D": rng.normal(size=(n, 3)).astype(np.float32),
        "sh_colors": rng.normal(size=(n, 3)).astype(np.float32) * 0.3,
        "log_scales": np.log(rng.uniform(0.01, 0.05, (n, 3))
                             ).astype(np.float32),
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32),
    }


def _bundle(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kw", ({}, dict(merged=True, axis_on=True,
                                         transform=True)),
                         ids=("separate", "merged_axis"))
def test_splat_viewer_bundles_match_jax(tmp_path, kw):
    from real2sim_eval_tpu.utils import splat_viewer as jsv
    from real2sim_eval_tpu_torch.utils import splat_viewer as tsv
    from real2sim_eval_tpu_torch.utils.ply import save_gaussian_ply

    save_gaussian_ply(_params(40, 0), tmp_path / "a.ply")
    save_gaussian_ply(_params(60, 1), tmp_path / "b.ply")
    plys = [tmp_path / "a.ply", tmp_path / "b.ply"]
    roots = {name: mod.visualize_gs(plys, out_dir=tmp_path / name,
                                    serve=False, **kw)
             for name, mod in (("jax", jsv), ("port", tsv))}
    port, jax_ = _bundle(roots["port"]), _bundle(roots["jax"])
    assert port == jax_
    assert "index.html" in port and b"webgl2" in port["index.html"]
    splats = [k for k in port if k.endswith(".splat")]
    assert splats == (["merged.splat"] if kw else ["a.splat", "b.splat"])
    assert all(len(port[k]) % 32 == 0 and port[k] for k in splats)


@pytest.fixture(scope="module")
def renderers(tmp_path_factory):
    """Both packages' ``GSRenderer`` after a reset, online, the viewer on
    a free port; their debug camera cut to the first test camera."""
    import real2sim_eval_tpu.envs as jenvs
    from real2sim_eval_tpu.renderer import RasterConfig as JRC
    import real2sim_eval_tpu_torch.envs as tenvs
    from real2sim_eval_tpu_torch.config import ConfigNode

    root = tmp_path_factory.mktemp("viewers")
    rope = make_rope_points(n=40, length=0.3)
    write_fixture_checkpoint(root, "rope_view", rope, spring_Y=2e3)
    gs = make_synthetic_scene(root / "scans", rope_pts=rope,
                              ik_urdf=BUILTIN_URDF, n_table=200)
    cfg = full_cfg(root, "rope_view", gs=gs, cameras=TEST_CAMERAS,
                   physics_over=dict(dt=2e-4))
    cfg.online = True
    cfg.viser_port = 0
    jenv = jenvs.make("BaseEnv-v0", cfg=copy.deepcopy(cfg), randomize=False,
                      raster_config=JRC(backend="reference"))
    tenv = tenvs.make("BaseEnv-v0",
                      cfg=ConfigNode(copy.deepcopy(cfg.to_dict())),
                      randomize=False, device="cpu")
    cam = TEST_CAMERAS[0]
    k = np.asarray(cam["intr"], np.float32).reshape(3, 3)
    w2c = np.linalg.inv(np.asarray(cam["c2w"], np.float32).reshape(4, 4))
    out = {}
    for name, env in (("jax", jenv), ("port", tenv)):
        env.reset(seed=0)
        r = env.unwrapped.renderer if hasattr(env, "unwrapped") else \
            env.renderer
        r.metadata.update(w=cam["w"], h=cam["h"], k=k, w2c=w2c)
        out[name] = r
    yield out, (cam["w"], cam["h"], k, w2c)
    for r in out.values():
        r.viser_viewer.close()


def test_render_online_matches_jax(renderers):
    rs, (w, h, k, w2c) = renderers
    frames = {}
    for name, r in rs.items():
        v = r.viser_viewer
        assert v is not None and v.port > 0
        v.set_metadata(w, h, k, w2c)
        r.render_online()
        frames[name] = v._frame.copy()
        v.set_orbit(0.8, 0.5, 1.0)
        r.render_online()
        frames[name + "_orbit"] = v._frame.copy()
    for key in ("port", "port_orbit"):
        assert frames[key].dtype == np.uint8
        assert frames[key].shape == (h, w, 3)
        gap = np.abs(frames[key].astype(int)
                     - frames[key.replace("port", "jax")].astype(int))
        assert gap.max() <= 1, key
    assert not np.array_equal(frames["port"], frames["port_orbit"])
    port = rs["port"]
    im, _ = port.render(camera=[w, h, k, w2c])
    np.testing.assert_array_equal(
        frames["port"], (im.numpy().transpose(1, 2, 0) * 255).astype(
            np.uint8))


def test_render_online_waits_for_a_camera(renderers):
    rs, _ = renderers
    r = rs["port"]
    v = r.viser_viewer
    meta, frame = v._metadata, v._frame
    v._metadata, v._frame = {}, None
    try:
        r.render_online()
        assert v._frame is None
    finally:
        v._metadata, v._frame = meta, frame


def test_debug_dump_matches_jax(renderers, tmp_path, monkeypatch):
    import cv2

    rs, _ = renderers
    imgs = {}
    for name, r in rs.items():
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        r.reset_state(visualize_image=True)
        imgs[name] = {f: cv2.imread(str(d / f)).astype(int)
                      for f in ("test.png", "test_depth.png")}
    h, w = TEST_CAMERAS[0]["h"], TEST_CAMERAS[0]["w"]
    for f in ("test.png", "test_depth.png"):
        assert imgs["port"][f].shape == (h, w, 3)
    assert np.abs(imgs["port"]["test.png"]
                  - imgs["jax"]["test.png"]).max() <= 1
    frame, depth = rs["port"].render()
    np.testing.assert_array_equal(
        imgs["port"]["test.png"],
        (frame.numpy().transpose(1, 2, 0) * 255).astype(np.uint8)[
            :, :, ::-1])
    dep = imgs["port"]["test_depth.png"]
    assert (dep.sum(-1) > 0).any()
    assert np.abs(dep - imgs["jax"]["test_depth.png"]).max() <= 1
    assert ((dep.sum(-1) == 0)
            == (depth.numpy() >= 15)).mean() > 0.999
