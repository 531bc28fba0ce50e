"""Port vs JAX package: transforms, SH, cameras, preprocess, binning, the
tile compositor K1's plain version and the rasterizer, on the CPU.

Inputs are made with numpy from a seed and handed to both; the JAX Pallas
kernel runs in interpret mode, as the JAX package's own tests run it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.renderer import camera as jcam
from real2sim_eval_tpu.renderer import raster as jraster
from real2sim_eval_tpu.renderer.binning import bin_gaussians as j_bin
from real2sim_eval_tpu.renderer.preprocess import \
    preprocess_gaussians as j_pre
from real2sim_eval_tpu.renderer.tile_kernel import \
    rasterize_tiles_batch as j_tiles
from real2sim_eval_tpu.utils import sh as jsh
from real2sim_eval_tpu.utils import transforms as jtf
from real2sim_eval_tpu_torch.renderer import camera as tcam
from real2sim_eval_tpu_torch.renderer import raster as traster
from real2sim_eval_tpu_torch.renderer.binning import bin_gaussians as t_bin
from real2sim_eval_tpu_torch.renderer.preprocess import \
    preprocess_gaussians as t_pre
from real2sim_eval_tpu_torch.renderer.tile_kernel import (
    composite_tiles_plain, rasterize_tiles_batch)
from real2sim_eval_tpu_torch.utils import sh as tsh
from real2sim_eval_tpu_torch.utils import transforms as ttf


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def npy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def depth_flips(a, b):
    """Median depth is discontinuous in alpha (the T = 0.5 crossing): count
    pixels that flip, as bench.py does."""
    return int((np.abs(npy(a) - npy(b)) > 1e-2).sum())


def flips_ok(n, size):
    return n <= max(5, int(2e-4 * size))


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jtf.quat_to_rot(jnp.asarray(q, jnp.float32)))


# ---------------------------------------------------------------------------
# items 1-3: transforms, SH, cameras (elementwise, 1e-6)
# ---------------------------------------------------------------------------


class TestTransforms:
    def test_quaternion_and_rotation_helpers(self):
        rng = np.random.default_rng(0)
        q1 = rng.normal(size=(64, 4)).astype(np.float32)
        q2 = rng.normal(size=(64, 4)).astype(np.float32)
        aa = (rng.normal(size=(64, 3)) * 1.5).astype(np.float32)
        aa[:4] = 0.0                      # small-angle branch
        R = random_rotations(rng, 64)
        R[:4] = np.diag([1.0, -1.0, -1.0])  # 180-degree pivots
        pairs = [
            (jtf.quat_multiply, ttf.quat_multiply, (q1, q2)),
            (jtf.quat_to_rot, ttf.quat_to_rot, (q1,)),
            (jtf.rot_to_quat, ttf.rot_to_quat, (R,)),
            (jtf.axis_angle_to_rot, ttf.axis_angle_to_rot, (aa,)),
            (jtf.rot_to_axis_angle, ttf.rot_to_axis_angle, (R,)),
        ]
        for jf, tf_, args in pairs:
            want = np.asarray(jf(*[jnp.asarray(a) for a in args]))
            got = npy(tf_(*[T(a) for a in args]))
            np.testing.assert_allclose(got, want, atol=1e-6,
                                       err_msg=jf.__name__)

    def test_se3(self):
        rng = np.random.default_rng(1)
        R = random_rotations(rng, 8)
        t = rng.normal(size=(8, 3)).astype(np.float32)
        Tj = jtf.make_se3(jnp.asarray(R), jnp.asarray(t))
        Tt = ttf.make_se3(T(R), T(t))
        np.testing.assert_allclose(npy(Tt), np.asarray(Tj), atol=1e-6)
        np.testing.assert_allclose(npy(ttf.se3_inverse(Tt)),
                                   np.asarray(jtf.se3_inverse(Tj)), atol=1e-6)


def test_sh_dc_colour():
    rng = np.random.default_rng(2)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    assert tsh.C0 == jsh.C0
    want = np.asarray(jsh.sh_to_rgb_clamped(0, jnp.asarray(sh),
                                            jnp.asarray(dirs)))
    np.testing.assert_allclose(npy(tsh.sh_to_rgb_clamped(0, T(sh))), want,
                               atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_degrees_match_jax(deg):
    rng = np.random.default_rng(10 + deg)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    assert (tsh.C1, tsh.C2, tsh.C3) == (jsh.C1, jsh.C2, jsh.C3)
    np.testing.assert_allclose(npy(tsh.sh_basis(T(dirs), deg)),
                               np.asarray(jsh.sh_basis(jnp.asarray(dirs),
                                                       deg)), atol=1e-6)
    want = np.asarray(jsh.sh_to_rgb_clamped(deg, jnp.asarray(sh),
                                            jnp.asarray(dirs)))
    assert (want == 0).any()           # the clamp at zero is exercised
    np.testing.assert_allclose(npy(tsh.sh_to_rgb_clamped(deg, T(sh), T(dirs))),
                               want, atol=1e-6)


def test_degree3_render_matches_jax_reference():
    """A degree-3 scene seen off-axis, so the colour depends on the view
    direction from the camera centre: the port's tile pipeline and dense
    reference against the JAX package's reference backend."""
    rng = np.random.default_rng(14)
    sc = random_scene(rng, 1, 60)
    sc["shs"] = (rng.normal(size=(1, 60, 16, 3)) * 0.3).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    w2c[:3, 3] = [0.4, 0.1, 0.3]
    bg = (0.1, 0.2, 0.3)
    rgb_j, dep_j = jraster.rasterize(
        simple_cam(jcam, 256, 64, 80.0), jnp.asarray(w2c),
        *[jnp.asarray(sc[k][0]) for k in SCENE_KEYS], 3, bg=bg,
        config=jraster.RasterConfig(backend="reference"))
    rgb_dc, _ = jraster.rasterize(
        simple_cam(jcam, 256, 64, 80.0), jnp.asarray(w2c),
        *[jnp.asarray(sc[k][0]) for k in SCENE_KEYS], 0, bg=bg,
        config=jraster.RasterConfig(backend="reference"))
    assert np.abs(np.asarray(rgb_j) - np.asarray(rgb_dc)).max() > 0.05
    for backend in ("reference", "tiles"):
        rgb_t, dep_t = traster.rasterize(
            simple_cam(tcam, 256, 64, 80.0), T(w2c),
            *[T(sc[k][0]) for k in SCENE_KEYS], 3, bg=bg,
            config=traster.RasterConfig(backend=backend), device="cpu")
        np.testing.assert_allclose(npy(rgb_t), np.asarray(rgb_j), atol=2e-3,
                                   err_msg=backend)
        assert flips_ok(depth_flips(dep_t, dep_j), dep_t.numel())


def test_cameras():
    k = [[427.3, 0, 430.0], [0, 426.8, 242.8], [0, 0, 1]]
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, 0.5]
    cj, wj = jcam.setup_camera(848, 480, k, w2c)
    ct, wt = tcam.setup_camera(848, 480, k, w2c)
    assert (ct.width, ct.height, ct.fx, ct.fy, ct.cx, ct.cy, ct.z_threshold) \
        == (cj.width, cj.height, cj.fx, cj.fy, cj.cx, cj.cy, cj.z_threshold)
    assert ct.tan_fovx == cj.tan_fovx and ct.tan_fovy == cj.tan_fovy
    np.testing.assert_array_equal(wt, wj)
    rng = np.random.default_rng(3)
    eef2c = np.linalg.inv(jtf.make_se3(jnp.asarray(random_rotations(rng, 1)[0]),
                                       jnp.asarray([0.07, 0.0, 0.03])))
    R = random_rotations(rng, 4)
    xyz = rng.normal(size=(4, 3)).astype(np.float32)
    want = np.stack([np.asarray(jcam.wrist_w2c_jax(
        jnp.asarray(eef2c, jnp.float32), jnp.asarray(xyz[i]),
        jnp.asarray(R[i]))) for i in range(4)])
    got = npy(tcam.wrist_w2c(T(eef2c), T(xyz), T(R)))
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# item 4: preprocess (the JAX package's analytic checks + a random scene)
# ---------------------------------------------------------------------------


def simple_cam(mod, w=128, h=64, f=60.0):
    return mod.Camera(width=w, height=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
                      z_threshold=0.05)


def one_gaussian(pos, scale=0.05, opacity=0.9):
    return (T([pos]), torch.full((1, 3), scale), T([[1.0, 0, 0, 0]]),
            T([opacity]), torch.zeros((1, 1, 3)))


class TestPreprocess:
    def test_projection_center(self):
        cam = simple_cam(tcam)
        pre = t_pre(cam, torch.eye(4), *one_gaussian((0.0, 0.0, 2.0)), 0)
        np.testing.assert_allclose(npy(pre["xy"][0]),
                                   [cam.cx - 0.5, cam.cy - 0.5], atol=1e-4)
        np.testing.assert_allclose(float(pre["depth"][0]), 2.0, atol=1e-6)
        assert bool(pre["valid"][0])

    @pytest.mark.parametrize("z", [0.04, -1.0])
    def test_near_and_behind_cull(self, z):
        pre = t_pre(simple_cam(tcam), torch.eye(4),
                    *one_gaussian((0.0, 0.0, z)), 0)
        assert not bool(pre["valid"][0])
        assert float(pre["radius"][0]) == 0.0

    def test_isotropic_cov2d_radius(self):
        cam = simple_cam(tcam, f=100.0)
        s, z = 0.1, 2.0
        pre = t_pre(cam, torch.eye(4), *one_gaussian((0, 0, z), scale=s), 0)
        var = (cam.fx * s / z) ** 2 + 0.3
        np.testing.assert_allclose(float(pre["radius"][0]),
                                   np.ceil(3 * np.sqrt(var)))
        np.testing.assert_allclose(float(pre["conic"][0, 0]), 1 / var,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(pre["conic"][0, 1]), 0.0, atol=1e-6)

    def test_offcenter_principal_point(self):
        cam = tcam.Camera(width=100, height=80, fx=50, fy=50, cx=30, cy=50)
        pre = t_pre(cam, torch.eye(4), *one_gaussian((0.0, 0.0, 1.0)), 0)
        np.testing.assert_allclose(npy(pre["xy"][0]), [29.5, 49.5], atol=1e-4)

    def test_random_scene_matches_jax(self):
        sc = random_scene(np.random.default_rng(4), 1, 200)
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.1
        pj = j_pre(simple_cam(jcam, 256, 64, 80.0), jnp.asarray(w2c),
                   *[jnp.asarray(sc[k][0]) for k in SCENE_KEYS], 0)
        pt = t_pre(simple_cam(tcam, 256, 64, 80.0), T(w2c),
                   *[T(sc[k][0]) for k in SCENE_KEYS], 0)
        np.testing.assert_array_equal(npy(pt["valid"]), np.asarray(pj["valid"]))
        for k in ("xy", "depth", "conic", "opacity", "rgb", "radius"):
            np.testing.assert_allclose(npy(pt[k]), np.asarray(pj[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# items 5-7: binning (bitwise), K1's plain version, the rasterizer
# ---------------------------------------------------------------------------

SCENE_KEYS = ("means3D", "scales", "rotations", "opacities", "shs")


def random_scene(rng, B, n):
    q = rng.normal(size=(B, n, 4))
    return {
        "means3D": np.stack([rng.uniform(-1, 1, (B, n)),
                             rng.uniform(-0.4, 0.4, (B, n)),
                             rng.uniform(0.5, 3.0, (B, n))], -1
                            ).astype(np.float32),
        "scales": rng.uniform(0.01, 0.08, (B, n, 3)).astype(np.float32),
        "rotations": (q / np.linalg.norm(q, axis=-1, keepdims=True)
                      ).astype(np.float32),
        "opacities": rng.uniform(0.1, 1.0, (B, n)).astype(np.float32),
        "shs": rng.uniform(-0.5, 0.5, (B, n, 1, 3)).astype(np.float32),
    }


def jax_pre_instances(rng, n_inst=2, n=80, w=256, h=64):
    """Two instances (two camera offsets) of one random scene, through the
    JAX preprocess; returns the stacked numpy dicts and the tile grid."""
    sc = random_scene(rng, 1, n)
    pres = []
    for i in range(n_inst):
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.12 * i
        p = j_pre(simple_cam(jcam, w, h, 80.0), jnp.asarray(w2c),
                  *[jnp.asarray(sc[k][0]) for k in SCENE_KEYS], 0)
        pres.append({k: np.asarray(v) for k, v in p.items()})
    return ({k: np.stack([p[k] for p in pres]) for k in pres[0]},
            -(-w // 128), -(-h // 8))


def jax_bins(pre_np, i, n_tx, n_ty, n):
    """JAX binning with budgets large enough that nothing drops."""
    b = j_bin({k: jnp.asarray(v[i]) for k, v in pre_np.items()}, n_tx, n_ty,
              128, 8, max_pairs=64 * n, max_tiles_per_gaussian=64,
              small_tiles=4, max_large=n, pack_payloads=False)
    assert int(b["n_large_dropped"]) == 0
    return b


def test_bin_gaussians_bitwise():
    pre_np, n_tx, n_ty = jax_pre_instances(np.random.default_rng(5))
    n = pre_np["xy"].shape[1]
    bt = t_bin({k: torch.as_tensor(v) for k, v in pre_np.items()},
               n_tx, n_ty, 128, 8)
    assert int(bt["n_large_dropped"].sum()) == 0
    off = 0
    for i in range(pre_np["xy"].shape[0]):
        bj = jax_bins(pre_np, i, n_tx, n_ty, n)
        n_p = int(bj["n_pairs"])
        assert n_p == int(bt["n_pairs"][i]) and n_p > 0
        np.testing.assert_array_equal(npy(bt["tile_starts"][i]) - off,
                                      np.asarray(bj["tile_starts"]))
        np.testing.assert_array_equal(npy(bt["tile_ends"][i]) - off,
                                      np.asarray(bj["tile_ends"]))
        np.testing.assert_array_equal(npy(bt["pair_tile"][off:off + n_p]),
                                      np.asarray(bj["pair_tile"][:n_p]))
        lanes_j = np.stack([np.asarray(v[:n_p]) for v in bj["pair_lanes"]])
        np.testing.assert_array_equal(
            npy(bt["pair_attrs"][:, off:off + n_p]), lanes_j)
        off += n_p


def test_composite_plain_matches_jax_kernel():
    """K1's plain version vs the JAX Pallas kernel (interpret mode) on the
    same sorted pair table and tile ranges."""
    from real2sim_eval_tpu.renderer.raster import gather_pair_table

    pre_np, n_tx, n_ty = jax_pre_instances(np.random.default_rng(6))
    n = pre_np["xy"].shape[1]
    datas, starts, ends, attrs = [], [], [], []
    off = 0
    for i in range(pre_np["xy"].shape[0]):
        bj = jax_bins(pre_np, i, n_tx, n_ty, n)
        datas.append(gather_pair_table(None, bj, n))
        rows = datas[-1].shape[0]
        starts.append(np.asarray(bj["tile_starts"]) + off)
        ends.append(np.asarray(bj["tile_ends"]) + off)
        attrs.append(np.asarray(datas[-1]).reshape(rows * 8, 16)[:, :10].T)
        off += rows * 8
    bg = (0.1, 0.2, 0.3)
    rgb_j, dep_j = j_tiles(jnp.concatenate(datas), jnp.asarray(np.stack(starts)),
                           jnp.asarray(np.stack(ends)), n_tx, n_ty, chunk=256,
                           bg=bg, interpret=True)
    pairs = T(np.concatenate(attrs, axis=1))
    rgb_t, dep_t = rasterize_tiles_batch(pairs, T(np.stack(starts), torch.int32),
                                         T(np.stack(ends), torch.int32),
                                         n_tx, n_ty, bg)
    np.testing.assert_allclose(npy(rgb_t), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(depth_flips(dep_t, dep_j), dep_t.numel())
    # the plain version is the function the wrapper took on the CPU
    rgb_p, dep_p = composite_tiles_plain(
        pairs, T(np.stack(starts), torch.int32), T(np.stack(ends), torch.int32),
        n_tx, n_ty, bg)
    np.testing.assert_array_equal(npy(rgb_p), npy(rgb_t))
    np.testing.assert_array_equal(npy(dep_p), npy(dep_t))


def test_rasterize_batch_matches_jax_pallas():
    rng = np.random.default_rng(7)
    B, n = 2, 50
    sc = random_scene(rng, B, n)
    w2c_b = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    w2c_b[1, 0, 3] = 0.15
    cam_b = dict(width=256, height=64, fx=95.0, fy=95.0, cx=120.0, cy=30.0)
    cams_j = [(simple_cam(jcam, 256, 64, 80.0), jnp.asarray(w2c_b)),
              (jcam.Camera(**cam_b), jnp.asarray(w2c_b))]
    cams_t = [(simple_cam(tcam, 256, 64, 80.0), T(w2c_b)),
              (tcam.Camera(**cam_b), T(w2c_b))]
    cfg = jraster.RasterConfig(backend="pallas", interpret=True,
                               max_pairs_factor=16.0,
                               max_tiles_per_gaussian=64, max_large=n,
                               pack_payloads=False)
    rgb_j, dep_j, drop_j = jraster.rasterize_batch(
        cams_j, {k: jnp.asarray(v) for k, v in sc.items()}, 0, config=cfg,
        return_drops=True)
    assert int(np.asarray(drop_j).sum()) == 0
    rgb_t, dep_t, drop_t = traster.rasterize_batch(
        cams_t, {k: T(v) for k, v in sc.items()}, 0, return_drops=True,
        device="cpu")
    assert rgb_t.shape == (2, B, 3, 64, 256)
    assert int(drop_t.sum()) == 0
    np.testing.assert_allclose(npy(rgb_t), np.asarray(rgb_j), atol=2e-3)
    np.testing.assert_allclose(npy(dep_t), np.asarray(dep_j), atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_reference_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sc = random_scene(rng, 1, 60)
    args_j = [jnp.asarray(sc[k][0]) for k in SCENE_KEYS]
    args_t = [T(sc[k][0]) for k in SCENE_KEYS]
    bg = (0.1, 0.2, 0.3)
    rgb_j, dep_j = jraster.rasterize(
        simple_cam(jcam, 256, 64, 80.0), jnp.eye(4), *args_j, 0, bg=bg,
        config=jraster.RasterConfig(backend="reference"))
    rgb_r, dep_r = traster.rasterize(
        simple_cam(tcam, 256, 64, 80.0), torch.eye(4), *args_t, 0, bg=bg,
        config=traster.RasterConfig(backend="reference"), device="cpu")
    np.testing.assert_allclose(npy(rgb_r), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(depth_flips(dep_r, dep_j), dep_r.numel())
    # and the tile pipeline agrees with the dense reference
    rgb_k, dep_k = traster.rasterize(simple_cam(tcam, 256, 64, 80.0),
                                     torch.eye(4), *args_t, 0, bg=bg,
                                     device="cpu")
    np.testing.assert_allclose(npy(rgb_k), npy(rgb_r), atol=2e-3)
    np.testing.assert_allclose(npy(dep_k), npy(dep_r), atol=1e-3)


def test_kernel_wrapper_rejects_bad_inputs():
    pairs = torch.zeros((10, 8))
    s = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        rasterize_tiles_batch(pairs[:9], s, s, 2, 2)
    with pytest.raises(ValueError):
        rasterize_tiles_batch(pairs, s.long(), s, 2, 2)
    with pytest.raises(ValueError):
        rasterize_tiles_batch(pairs, s, s, 3, 2)
