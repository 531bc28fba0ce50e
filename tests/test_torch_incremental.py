"""Port vs JAX package: the incremental (dirty-tile) render of the fixed
cameras, its static build and the plain versions of the dirty-tile
compositors K2 and K6, on the CPU.

The scene is tests/test_incremental.py's (64x128 camera, 400 static and 40
dynamic gaussians, 3 envs), made with numpy from a seed and handed to both
packages. The JAX side runs its Pallas kernels in interpret mode, unpacked,
with budgets that cover demand. The port is held to JAX at 2e-3 rgb and a
depth flip count, and to its own full pipeline on the [dynamic; static]
scene bitwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.renderer import incremental as jinc
from real2sim_eval_tpu.renderer.binning import bin_gaussians as j_bin
from real2sim_eval_tpu.renderer.camera import setup_camera as j_setup
from real2sim_eval_tpu.renderer.preprocess import \
    preprocess_gaussians as j_pre
from real2sim_eval_tpu.renderer.raster import RasterConfig as JRC
from real2sim_eval_tpu_torch.renderer import incremental as tinc
from real2sim_eval_tpu_torch.renderer.binning import bin_gaussians as t_bin
from real2sim_eval_tpu_torch.renderer.camera import setup_camera as t_setup
from real2sim_eval_tpu_torch.renderer.preprocess import \
    preprocess_gaussians as t_pre
from real2sim_eval_tpu_torch.renderer.raster import RasterConfig as TRC
from real2sim_eval_tpu_torch.renderer.raster import rasterize_batch
from real2sim_eval_tpu_torch.renderer.tile_kernel import (
    composite_tiles_plain, merge_segments, rasterize_tiles_batch,
    rasterize_tiles_sparse, rasterize_tiles_sparse_merge)

H, W = 64, 128
MERGES = ("sort", "stream")
SCENE_KEYS = ("means3D", "scales", "rotations", "opacities", "shs")
# the JAX package's exactness config (tests/test_incremental.py CFG)
JCFG = JRC(backend="pallas", interpret=True, max_pairs_factor=10.0,
           max_tiles_per_gaussian=32, max_large=4096, pack_payloads=False)


def npy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def flips_ok(a, b):
    n = int((np.abs(npy(a) - npy(b)) > 1e-2).sum())
    return n <= max(5, int(2e-4 * npy(a).size))


def cameras(setup):
    k = np.array([[160.0, 0, W / 2], [0, 160.0, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -1.2]
    cam, w2c = setup(W, H, k, np.linalg.inv(c2w))
    w2c2 = np.array(w2c, np.float32).copy()
    w2c2[0, 3] += 0.15
    return cam, np.asarray(w2c, np.float32), w2c2


def gaussians(rng, n, center, spread, scale=0.02):
    means = (center + rng.normal(scale=spread, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return {
        "means3D": means,
        "scales": np.full((n, 3), scale, np.float32),
        "rotations": quats,
        "opacities": rng.uniform(0.3, 0.9, (n, 1)).astype(np.float32),
        "shs": rng.normal(scale=0.3, size=(n, 1, 3)).astype(np.float32),
    }


def stack_envs(one, shifts):
    dyn = {k: np.stack([v] * len(shifts)) for k, v in one.items()}
    dyn["means3D"] = dyn["means3D"] + np.asarray(shifts, np.float32)[:, None]
    return dyn


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    static = gaussians(rng, 400, np.array([0.0, 0.0, 0.3]), 0.45)
    dyn = stack_envs(gaussians(rng, 40, np.array([0.05, 0.0, 0.1]), 0.05),
                     [[0.0, 0.0, 0.0], [-0.15, 0.2, 0.0],
                      [0.12, -0.25, 0.05]])
    return static, dyn


def flat_plane_scene(dyn_z: float):
    """tests/test_incremental.py:118's flat static plane (every static pair
    at one depth), with the dynamic splats at height ``dyn_z``: below the
    plane (deeper than every static pair) or on it (coplanar ties)."""
    rng = np.random.default_rng(9)
    nx, ny = 40, 10
    gx, gy = np.meshgrid(np.linspace(-0.35, 0.35, nx),
                         np.linspace(-0.18, 0.18, ny))
    static = gaussians(rng, nx * ny, np.zeros(3), 0.0)
    static["means3D"] = np.stack([gx.ravel(), gy.ravel(), np.zeros(nx * ny)],
                                 -1).astype(np.float32)
    dyn1 = gaussians(rng, 30, np.zeros(3), 0.04)
    dyn1["means3D"][:, 2] = dyn_z
    return static, stack_envs(dyn1, [[0.0, 0.0, 0.0], [0.1, 0.05, 0.0]])


def saturating_scene():
    """A static layer dense and opaque enough that most tiles saturate
    before their last pair: the saturation cut removes pairs."""
    rng = np.random.default_rng(5)
    n = 1200
    static = gaussians(rng, n, np.zeros(3), 0.0, scale=0.04)
    static["means3D"] = np.stack(
        [rng.uniform(-0.6, 0.6, n), rng.uniform(-0.32, 0.32, n),
         rng.uniform(0.2, 0.4, n)], -1).astype(np.float32)
    static["opacities"][:] = 0.95
    return static


def torch_scene(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def port_static(static, w2c):
    cam, _, _ = cameras(t_setup)
    return tinc.build_static_raster(cam, w2c, torch_scene(static), 0)


def port_render(static, dyn, merge, two_cams=False):
    cam, w2c, w2c2 = cameras(t_setup)
    cams = [(cam, port_static(static, w2c), w2c)]
    if two_cams:
        cams.append((cam, port_static(static, w2c2), w2c2))
    return tinc.render_incremental(cams, torch_scene(dyn), 0,
                                   TRC(merge_kernel=merge))


def port_full(static, dyn, w2c):
    """The port's full pipeline on the [dynamic; static] concatenation."""
    cam, _, _ = cameras(t_setup)
    B = dyn["means3D"].shape[0]
    scenes = {k: torch.as_tensor(np.concatenate(
        [dyn[k], np.broadcast_to(static[k][None], (B,) + static[k].shape)],
        axis=1)) for k in static}
    return rasterize_batch([(cam, torch.as_tensor(w2c)[None].expand(B, 4, 4))],
                           scenes, 0, device="cpu")


@pytest.fixture(scope="module")
def jax_static(scene):
    static, _ = scene
    cam, w2c, _ = cameras(j_setup)
    return jinc.build_static_raster(
        cam, w2c, {k: jnp.asarray(v) for k, v in static.items()}, 0, JCFG)


# ---------------------------------------------------------------------------
# the static build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_static_raster_matches_jax(scene, jax_static, kind):
    """Tile ranges and the saturation cut k_sat bitwise; the cached frame
    at the compositor tolerances."""
    static, js = scene[0], jax_static
    cam, w2c, _ = cameras(j_setup)
    if kind == "saturating":
        static = saturating_scene()
        js = jinc.build_static_raster(
            cam, w2c, {k: jnp.asarray(v) for k, v in static.items()}, 0,
            JCFG)
    st = port_static(static, w2c)
    np.testing.assert_array_equal(npy(st.starts), np.asarray(js.starts))
    k_sat = npy(st.ends - st.starts)
    np.testing.assert_array_equal(k_sat,
                                  np.asarray(js.ends) - np.asarray(js.starts))
    assert st.max_seg == js.max_seg > 0
    hp = st.n_tiles_y * 8
    np.testing.assert_allclose(npy(st.rgb_cache),
                               np.asarray(js.rgb_cache)[:, :hp], atol=2e-3)
    assert flips_ok(st.depth_cache, np.asarray(js.depth_cache)[:hp])


def test_static_cutoff_is_exact():
    """k_sat cuts pairs that cannot contribute: compositing only the cut
    ranges gives the frame of the full ranges bitwise."""
    static = saturating_scene()
    cam, w2c, _ = cameras(t_setup)
    st = port_static(static, w2c)
    pre = t_pre(cam, torch.as_tensor(w2c)[None],
                *[torch.as_tensor(static[k])[None] for k in SCENE_KEYS], 0)
    bins = t_bin(pre, st.n_tiles_x, st.n_tiles_y, 128, 8)
    # the cut is real: some tile saturates before its last static pair
    assert (npy(st.ends) < npy(bins["tile_ends"][0])).any()
    rgb_cut, dep_cut = composite_tiles_plain(
        st.pairs, st.starts[None], st.ends[None], st.n_tiles_x,
        st.n_tiles_y)
    np.testing.assert_array_equal(npy(rgb_cut[0]), npy(st.rgb_cache))
    np.testing.assert_array_equal(npy(dep_cut[0]), npy(st.depth_cache))


# ---------------------------------------------------------------------------
# the per-step render
# ---------------------------------------------------------------------------


def test_dirty_tiles_match_jax(scene):
    """The dirty-tile set (tiles holding >= 1 dynamic pair), bitwise."""
    static, dyn = scene
    cam_t, w2c, _ = cameras(t_setup)
    cam_j, _, _ = cameras(j_setup)
    st = port_static(static, w2c)
    _, starts, ends, _ = tinc.bin_dynamic([(cam_t, st, w2c)],
                                          torch_scene(dyn), 0)
    inst, tile = tinc.dirty_tiles(starts, ends)
    n_tiles = st.n_tiles_x * st.n_tiles_y
    for b in range(dyn["means3D"].shape[0]):
        pre = j_pre(cam_j, jnp.asarray(w2c),
                    *[jnp.asarray(dyn[k][b]) for k in SCENE_KEYS], 0)
        n = dyn["means3D"].shape[1]
        bj = j_bin(pre, st.n_tiles_x, st.n_tiles_y, 128, 8,
                   max_pairs=64 * n, max_tiles_per_gaussian=64,
                   small_tiles=4, max_large=n, pack_payloads=False)
        cnt = np.asarray(bj["tile_ends"]) - np.asarray(bj["tile_starts"])
        want = np.nonzero(cnt > 0)[0]
        assert 0 < want.size < n_tiles
        np.testing.assert_array_equal(npy(tile[npy(inst) == b]), want)


@pytest.mark.parametrize("merge", MERGES)
def test_render_matches_jax(scene, jax_static, merge):
    static, dyn = scene
    cam, w2c, _ = cameras(j_setup)
    rgb_j, dep_j, tele_j = jinc.render_incremental(
        [(cam, jax_static, w2c)], {k: jnp.asarray(v) for k, v in dyn.items()},
        0, dataclasses.replace(JCFG, merge_kernel=merge), t_budget=96,
        p_mix=8192)
    assert (np.asarray(tele_j)[..., 1:] == 0).all()
    rgb_t, dep_t, tele_t = port_render(static, dyn, merge)
    assert tele_t.shape == (1, 3, 4)
    np.testing.assert_array_equal(npy(tele_t), np.asarray(tele_j))
    np.testing.assert_allclose(npy(rgb_t), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(dep_t, dep_j)


@pytest.mark.parametrize("two_cams", [False, True], ids=["one_cam",
                                                         "two_cams"])
@pytest.mark.parametrize("merge", MERGES)
def test_bitwise_vs_full_pipeline(scene, merge, two_cams):
    static, dyn = scene
    _, w2c, w2c2 = cameras(t_setup)
    rgb_i, dep_i, tele = port_render(static, dyn, merge, two_cams)
    n_dirty = npy(tele[..., 0])
    assert (n_dirty > 0).all() and (n_dirty < 8).all()
    assert (npy(tele[..., 1:]) == 0).all()
    for c, m in enumerate([w2c, w2c2][:1 + two_cams]):
        rgb_f, dep_f = port_full(static, dyn, m)
        np.testing.assert_array_equal(npy(rgb_i[c]), npy(rgb_f[0]))
        np.testing.assert_array_equal(npy(dep_i[c]), npy(dep_f[0]))


@pytest.mark.parametrize("dyn_z", [0.03, 0.0],
                         ids=["dyn_deeper_than_all_static", "coplanar_tie"])
@pytest.mark.parametrize("merge", MERGES)
def test_merge_edge_cases_bitwise(merge, dyn_z):
    """A flat static plane, every static pair at one depth, with the
    dynamic splats sunk below it (they merge after every static pair of
    their tiles: tests/test_incremental.py:118,
    tests/test_incremental_stream.py:130) or on it (equal dynamic and
    static depths: the dynamic pair goes first)."""
    static, dyn = flat_plane_scene(dyn_z)
    _, w2c, _ = cameras(t_setup)
    st = port_static(static, w2c)
    data_d, starts, ends, _ = tinc.bin_dynamic(
        [(cameras(t_setup)[0], st, w2c)], torch_scene(dyn), 0)
    d_depth = set(npy(data_d[9]).tolist())
    s_depth = set(npy(st.pairs[9]).tolist())
    if dyn_z == 0.0:
        assert d_depth & s_depth, "the fixture should tie depths"
    else:
        assert min(d_depth) > max(s_depth)
    rgb_i, dep_i, _ = port_render(static, dyn, merge)
    rgb_f, dep_f = port_full(static, dyn, w2c)
    np.testing.assert_array_equal(npy(rgb_i[0]), npy(rgb_f[0]))
    np.testing.assert_array_equal(npy(dep_i[0]), npy(dep_f[0]))


@pytest.mark.parametrize("merge", MERGES)
def test_clean_tiles_keep_cache(scene, merge):
    static, dyn = scene
    _, w2c, _ = cameras(t_setup)
    st = port_static(static, w2c)
    cache = np.clip(npy(st.rgb_cache)[:, :H, :W], 0, 1)
    rgb, _, tele = port_render(static, dyn, merge)
    tiles_changed = (npy(rgb[0]) != cache).any(axis=1).reshape(
        3, H // 8, 8, 1, W).any(axis=(2, 3, 4))
    assert (tiles_changed.sum(1) <= npy(tele[0, :, 0])).all()
    assert tiles_changed.any()
    # the object out of view: no dirty tile, the cached frame as it is
    far = dict(dyn, means3D=dyn["means3D"] + np.float32([5.0, 5.0, 0.0]))
    rgb, _, tele = port_render(static, far, merge)
    assert (npy(tele[..., 0]) == 0).all()
    np.testing.assert_array_equal(npy(rgb[0, 0]), cache)


def test_stream_equals_sort(scene):
    static, dyn = scene
    outs = [port_render(static, dyn, m, two_cams=True) for m in MERGES]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(npy(a), npy(b))


# ---------------------------------------------------------------------------
# K2 and K6 wrappers, the merge order
# ---------------------------------------------------------------------------


def test_k2_over_every_tile_is_k1():
    """K2's plain version listing every tile of a random table is K1's
    plain version bitwise, whatever the cache held."""
    rng = np.random.default_rng(1)
    n_tx, n_ty, n_inst, per_tile = 2, 3, 2, 6
    n_tiles = n_tx * n_ty
    P = n_inst * n_tiles * per_tile
    pairs = np.zeros((10, P), np.float32)
    tiles = np.tile(np.repeat(np.arange(n_tiles), per_tile), n_inst)
    pairs[0] = (tiles % n_tx) * 128 + rng.uniform(0, 128, P)
    pairs[1] = (tiles // n_tx) * 8 + rng.uniform(0, 8, P)
    pairs[2], pairs[4] = rng.uniform(1e-3, 5e-2, (2, P))
    pairs[3] = rng.uniform(-1e-3, 1e-3, P)
    pairs[5] = rng.uniform(0.2, 1.0, P)
    pairs[6:9] = rng.uniform(0, 1, (3, P))
    pairs[9] = np.sort(rng.uniform(0.5, 3.0, P))
    starts = torch.arange(0, P, per_tile, dtype=torch.int32).reshape(
        n_inst, n_tiles)
    pairs = torch.as_tensor(pairs)
    rgb1, dep1 = rasterize_tiles_batch(pairs, starts, starts + per_tile,
                                       n_tx, n_ty, (0.1, 0.2, 0.3))
    inst = torch.arange(n_inst, dtype=torch.int32).repeat_interleave(n_tiles)
    tile = torch.arange(n_tiles, dtype=torch.int32).repeat(n_inst)
    cache = torch.full((n_inst, 3, 24, 256), 7.0)
    rgb2, dep2 = rasterize_tiles_sparse(
        pairs, inst, tile, starts.reshape(-1), starts.reshape(-1) + per_tile,
        cache, cache[:, 0], n_tx, n_ty, (0.1, 0.2, 0.3))
    np.testing.assert_array_equal(npy(rgb2), npy(rgb1))
    np.testing.assert_array_equal(npy(dep2), npy(dep1))


def test_merge_segments_order():
    """Per entry: ascending depth, a dynamic pair before a static one of
    equal depth, each stream in its own order; empty segments allowed."""
    data_s = torch.zeros((10, 6))
    data_s[9] = torch.tensor([1.0, 2.0, 2.0, 5.0, 0.5, 0.7])
    data_s[0] = torch.arange(6.0)                 # static row id
    data_d = torch.zeros((10, 4))
    data_d[9] = torch.tensor([2.0, 2.0, 6.0, 0.1])
    data_d[0] = 100.0 + torch.arange(4.0)         # dynamic row id
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    merged, st, en = merge_segments(data_s, i32([0, 4, 6]), i32([4, 6, 6]),
                                    data_d, i32([0, 3, 3]), i32([3, 3, 4]))
    np.testing.assert_array_equal(npy(st), [0, 7, 9])
    np.testing.assert_array_equal(npy(en), [7, 9, 10])
    np.testing.assert_array_equal(
        npy(merged[0]), [0, 100, 101, 1, 2, 3, 102, 4, 5, 103])


def test_sparse_wrappers_reject_malformed_tables():
    pairs = torch.zeros((10, 8))
    ids = torch.zeros(2, dtype=torch.int32)
    rgb, dep = torch.zeros((1, 3, 8, 128)), torch.zeros((1, 8, 128))
    good = (pairs, ids, ids, ids, ids, rgb, dep, 1, 1)
    rasterize_tiles_sparse(*good)
    bad = [
        (pairs[:9],) + good[1:],                                # 9 lanes
        (pairs.double(),) + good[1:],                           # f64 table
        good[:1] + (ids.long(),) + good[2:],                    # i64 ids
        good[:4] + (ids[:1],) + good[5:],                       # short ends
        good[:5] + (rgb[:, :2],) + good[6:],                    # rgb planes
        good[:6] + (torch.zeros((1, 16, 128)),) + good[7:],     # depth rows
        good[:7] + (2, 1),                                      # tile grid
    ]
    for args in bad:
        with pytest.raises(ValueError):
            rasterize_tiles_sparse(*args)
    good6 = (pairs, pairs, ids, ids, ids, ids, ids, ids, rgb, dep, 1, 1)
    rasterize_tiles_sparse_merge(*good6)
    bad6 = [
        (pairs[:9],) + good6[1:],
        good6[:1] + (pairs.double(),) + good6[2:],
        good6[:5] + (ids[:1],) + good6[6:],
        good6[:7] + (ids.long(),) + good6[8:],
        good6[:8] + (torch.zeros((1, 3, 8, 256)),) + good6[9:],
    ]
    for args in bad6:
        with pytest.raises(ValueError):
            rasterize_tiles_sparse_merge(*args)
