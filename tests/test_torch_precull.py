"""Port vs JAX package: the block frustum pre-cull of the wrist camera, on
the CPU.

The scenes are tests/test_precull.py's (a static scene much wider than the
64x128 view in shuffled order, and a wide dynamic scene), made with numpy
from a seed and handed to both packages. The KD order, the pads, the
visible-block masks and the planned capacities equal JAX's bitwise; culled
renders match JAX's at 2e-3 rgb and a depth flip count, and equal the
port's own unculled renders bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.renderer import precull as jpc
from real2sim_eval_tpu.renderer.camera import setup_camera as j_setup
from real2sim_eval_tpu.renderer.raster import RasterConfig as JRC
from real2sim_eval_tpu.renderer.raster import rasterize_batch as j_raster
from real2sim_eval_tpu_torch.renderer import precull as tpc
from real2sim_eval_tpu_torch.renderer.camera import setup_camera as t_setup
from real2sim_eval_tpu_torch.renderer.raster import rasterize_batch

H, W = 64, 128
JCFG = JRC(backend="pallas", interpret=True, pack_payloads=False,
           max_pairs_factor=8.0, incremental="off")
POSES = {"centre": (np.array([0.0, 0.0, -1.3]), 0.0),
         "side": (np.array([-2.2, 0.3, -0.8]), 15.0)}


def npy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def flips_ok(a, b):
    n = int((np.abs(npy(a) - npy(b)) > 1e-2).sum())
    return n <= max(5, int(2e-4 * npy(a).size))


def camera(setup, pos, yaw_deg=0.0):
    k = np.array([[160.0, 0, W / 2], [0, 160.0, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    a = np.deg2rad(yaw_deg)
    c2w[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]], np.float32)
    c2w[:3, 3] = pos
    cam, w2c = setup(W, H, k, np.linalg.inv(c2w))
    return cam, np.asarray(w2c, np.float32)


def gaussians(rng, n, center, spread, scale=0.02):
    means = (center + rng.normal(scale=spread, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return {
        "means3D": means,
        "scales": rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32) * scale,
        "rotations": quats,
        "opacities": rng.uniform(0.3, 0.9, (n, 1)).astype(np.float32),
        "shs": rng.normal(scale=0.3, size=(n, 1, 3)).astype(np.float32),
    }


def concat(parts):
    return {k: np.concatenate([p[k] for p in parts], 0) for k in parts[0]}


def per_env(one, shifts):
    d = {k: np.stack([v] * len(shifts)) for k, v in one.items()}
    d["means3D"] = d["means3D"] + np.asarray(shifts, np.float32)[:, None]
    return d


@pytest.fixture(scope="module")
def wide_scene():
    """tests/test_precull.py's wide static scene in shuffled order (three
    clusters and a sparse sheet) with a small dynamic set, B = 2."""
    rng = np.random.default_rng(17)
    static = concat([
        gaussians(rng, 800, np.array([0.0, 0.0, 0.4]), 0.25),
        gaussians(rng, 800, np.array([2.5, 0.0, 0.4]), 0.25),
        gaussians(rng, 800, np.array([-2.5, 0.3, 0.6]), 0.25),
        gaussians(rng, 700, np.array([0.0, -1.5, 0.5]), 1.2)])
    perm = rng.permutation(static["means3D"].shape[0])
    static = {k: v[perm] for k, v in static.items()}
    dyn = per_env(gaussians(rng, 72, np.array([0.1, 0.0, 0.2]), 0.06),
                  [[0.0, 0.0, 0.0], [-0.12, 0.1, 0.02]])
    return static, dyn


@pytest.fixture(scope="module")
def wide_dyn_scene():
    """tests/test_precull.py's dynamic scene wider than the view over a
    small static backdrop, B = 2."""
    rng = np.random.default_rng(23)
    dyn = per_env(concat([
        gaussians(rng, 400, np.array([0.0, 0.0, 0.3]), 0.15),
        gaussians(rng, 400, np.array([2.8, 0.1, 0.5]), 0.2),
        gaussians(rng, 300, np.array([-2.6, -0.2, 0.4]), 0.2)]),
        [[0.0, 0.0, 0.0], [0.15, -0.1, 0.05]])
    static = gaussians(rng, 300, np.array([0.0, 0.4, 0.6]), 0.5)
    return static, dyn


def T(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def J(d):
    return {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}


def w2c_batch(w2c, B=2):
    return np.broadcast_to(w2c[None], (B, 4, 4)).copy()


def port_render(cam, w2c_b, first, second):
    """The port's full pipeline on [first; second] (second (N, ...) is
    shared by the envs, or (B, N, ...))."""
    B = w2c_b.shape[0]
    scene = {}
    for k in first:
        b = torch.as_tensor(np.asarray(second[k]))
        if b.dim() == torch.as_tensor(np.asarray(first[k])).dim() - 1:
            b = b[None].expand((B,) + b.shape)
        scene[k] = torch.cat([torch.as_tensor(np.asarray(first[k])), b], 1)
    return rasterize_batch([(cam, torch.as_tensor(w2c_b))], scene, 0,
                           device="cpu")


def test_spatial_sort_and_pads_equal_jax(wide_scene):
    static, dyn = wide_scene
    j_sorted = jpc.spatial_sort_scene(J(static))
    t_sorted = tpc.spatial_sort_scene(T(static))
    for k in static:
        np.testing.assert_array_equal(npy(t_sorted[k]), np.asarray(
            j_sorted[k]), err_msg=k)
    j_pad = jpc.pad_static_scene(j_sorted)
    t_pad = tpc.pad_static_scene(t_sorted)
    assert t_pad["means3D"].shape[0] % tpc.BLOCK == 0
    assert t_pad["means3D"].shape[0] > static["means3D"].shape[0]
    j_dpad = jpc.pad_dynamic_scene(J(dyn))
    t_dpad = tpc.pad_dynamic_scene(T(dyn))
    for k in static:
        np.testing.assert_array_equal(npy(t_pad[k]), np.asarray(j_pad[k]))
        np.testing.assert_array_equal(npy(t_dpad[k]), np.asarray(j_dpad[k]))


@pytest.mark.parametrize("pose", list(POSES))
def test_blocks_masks_and_plans_equal_jax(wide_scene, wide_dyn_scene, pose):
    """Block spheres, per-env visibility and the JAX package's planned
    capacities, static and dynamic, bitwise."""
    static = tpc.pad_static_scene(tpc.spatial_sort_scene(T(wide_scene[0])))
    c_t, r_t = tpc.block_bounds(static["means3D"], static["scales"])
    c_j, r_j = jpc.block_bounds(J(static)["means3D"], J(static)["scales"])
    np.testing.assert_array_equal(npy(c_t), np.asarray(c_j))
    np.testing.assert_array_equal(npy(r_t), np.asarray(r_j))
    cam_t, w2c = camera(t_setup, *POSES[pose])
    cam_j, _ = camera(j_setup, *POSES[pose])
    _, w2c_other = camera(t_setup, np.array([2.5, 0.0, -1.0]), 10.0)
    w2c_b = np.stack([w2c, w2c_other])
    ok_t = tpc.visible_mask(cam_t, torch.as_tensor(w2c_b), c_t[None],
                            r_t[None])
    for b in range(2):
        ok_j = jpc.visible_mask(cam_j, w2c_b[b], c_j, r_j)
        np.testing.assert_array_equal(npy(ok_t[b]), np.asarray(ok_j))
    assert tpc.plan_static_cull([(cam_t, torch.as_tensor(w2c_b))], c_t,
                                r_t) == jpc.plan_static_cull(
        [(cam_j, jnp.asarray(w2c_b))], c_j, r_j)
    dyn = wide_dyn_scene[1]
    assert tpc.plan_dynamic_cull(
        [(cam_t, torch.as_tensor(w2c_b))], tpc.pad_dynamic_scene(T(dyn)),
        margin=1.15) == jpc.plan_dynamic_cull(
        [(cam_j, jnp.asarray(w2c_b))], jpc.pad_dynamic_scene(J(dyn)),
        margin=1.15)


@pytest.mark.parametrize("pose", list(POSES))
def test_static_cull_render(wide_scene, pose):
    """[dyn; culled static]: bitwise the port's unculled render, and the
    JAX package's culled render at the compositor tolerances; each env
    keeps exactly its visible blocks, fewer than all."""
    static, dyn = wide_scene
    cam_t, w2c = camera(t_setup, *POSES[pose])
    cam_j, _ = camera(j_setup, *POSES[pose])
    w2c_b = w2c_batch(w2c)
    st_t = tpc.pad_static_scene(tpc.spatial_sort_scene(T(static)))
    c_t, r_t = tpc.block_bounds(st_t["means3D"], st_t["scales"])
    culled, n_vis = tpc.cull_static_blocks(cam_t, torch.as_tensor(w2c_b),
                                           st_t, c_t, r_t)
    g = st_t["means3D"].shape[0] // tpc.BLOCK
    assert 0 < int(n_vis.max()) < g
    assert culled["means3D"].shape[1] == int(n_vis.max()) * tpc.BLOCK
    rgb_c, dep_c = port_render(cam_t, w2c_b, dyn, culled)
    rgb_f, dep_f = port_render(cam_t, w2c_b, dyn, st_t)
    np.testing.assert_array_equal(npy(rgb_c), npy(rgb_f))
    np.testing.assert_array_equal(npy(dep_c), npy(dep_f))

    st_j = jpc.pad_static_scene(jpc.spatial_sort_scene(J(static)))
    c_j, r_j = jpc.block_bounds(st_j["means3D"], st_j["scales"])
    cap = jpc.plan_static_cull([(cam_j, jnp.asarray(w2c_b))], c_j, r_j,
                               margin=1.0)
    culled_j, ovf = jpc.cull_static_blocks(cam_j, jnp.asarray(w2c_b), st_j,
                                           c_j, r_j, cap)
    assert int(np.asarray(ovf).max()) == 0
    comp = {k: jnp.concatenate([jnp.asarray(dyn[k]), culled_j[k]], axis=1)
            for k in dyn}
    rgb_j, dep_j = j_raster([(cam_j, jnp.asarray(w2c_b))], comp, 0,
                            config=JCFG)
    np.testing.assert_allclose(npy(rgb_c), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(dep_c, dep_j)


def test_static_cull_per_env_poses(wide_scene):
    """Each env is culled against its own pose; padding rows of the env
    with fewer visible blocks carry opacity 0."""
    static, dyn = wide_scene
    cam, w2c0 = camera(t_setup, np.array([0.0, 0.0, -1.3]))
    _, w2c1 = camera(t_setup, np.array([2.5, 0.0, -1.0]), 10.0)
    w2c_b = np.stack([w2c0, w2c1])
    st = tpc.pad_static_scene(tpc.spatial_sort_scene(T(static)))
    c, r = tpc.block_bounds(st["means3D"], st["scales"])
    culled, n_vis = tpc.cull_static_blocks(cam, torch.as_tensor(w2c_b), st,
                                           c, r)
    lo = int(n_vis.argmin())
    assert n_vis[0] != n_vis[1]
    pad_rows = culled["opacities"][lo, int(n_vis[lo]) * tpc.BLOCK:]
    assert pad_rows.numel() > 0 and (pad_rows == 0).all()
    rgb_c, dep_c = port_render(cam, w2c_b, dyn, culled)
    rgb_f, dep_f = port_render(cam, w2c_b, dyn, st)
    np.testing.assert_array_equal(npy(rgb_c), npy(rgb_f))
    np.testing.assert_array_equal(npy(dep_c), npy(dep_f))


def test_dynamic_cull_render(wide_dyn_scene):
    """[culled dyn; static] from per-env posed blocks: bitwise the port's
    unculled render, and the JAX package's at the compositor tolerances."""
    static, dyn = wide_dyn_scene
    cam_t, w2c0 = camera(t_setup, np.array([0.0, 0.0, -1.3]))
    cam_j, _ = camera(j_setup, np.array([0.0, 0.0, -1.3]))
    _, w2c1 = camera(t_setup, np.array([2.8, 0.0, -1.0]), 12.0)
    w2c_b = np.stack([w2c0, w2c1])
    dyn_t = tpc.pad_dynamic_scene(T(dyn))
    dyn_c, n_vis = tpc.cull_dynamic_blocks(cam_t, torch.as_tensor(w2c_b),
                                           dyn_t)
    g = dyn_t["means3D"].shape[1] // tpc.BLOCK
    assert 0 < int(n_vis.max()) < g
    rgb_c, dep_c = port_render(cam_t, w2c_b, dyn_c, static)
    rgb_f, dep_f = port_render(cam_t, w2c_b, dyn, static)
    np.testing.assert_array_equal(npy(rgb_c), npy(rgb_f))
    np.testing.assert_array_equal(npy(dep_c), npy(dep_f))

    dyn_j = jpc.pad_dynamic_scene(J(dyn))
    cap = jpc.plan_dynamic_cull([(cam_j, jnp.asarray(w2c_b))], dyn_j,
                                margin=1.0)
    culled_j, ovf = jpc.cull_dynamic_blocks(cam_j, jnp.asarray(w2c_b), dyn_j,
                                            cap)
    assert int(np.asarray(ovf).max()) == 0
    comp = {k: jnp.concatenate([culled_j[k], jnp.broadcast_to(
        jnp.asarray(static[k])[None], (2,) + static[k].shape)], axis=1)
        for k in static}
    rgb_j, dep_j = j_raster([(cam_j, jnp.asarray(w2c_b))], comp, 0,
                            config=JCFG)
    np.testing.assert_allclose(npy(rgb_c), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(dep_c, dep_j)
