"""Port vs JAX package: the fine-tile render on the CPU. The fine binning,
the plain versions of the fine compositors K4 and K5, the fine full
pipeline, the saturation cut on 8x16 tiles and the fine incremental render.

The scenes are the JAX suite's (tests/test_fine_binning.py: a 256x64
camera, 80 gaussians; tests/test_incremental_fine.py: a 64x128 camera, 400
static and 40 dynamic gaussians, 3 envs), made with numpy from a seed and
handed to both packages. The JAX side runs its Pallas kernels in interpret
mode, unpacked, with budgets that drop nothing. Pair tables, tile ranges,
the saturation cut and the telemetry are held to JAX bitwise; frames at
2e-3 rgb and a depth flip count (the compositor tolerances of
tests/test_raster.py); the fine incremental render to the port's own fine
full pipeline on the [dynamic; static] scene bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.renderer import incremental as jinc
from real2sim_eval_tpu.renderer import incremental_fine as jincf
from real2sim_eval_tpu.renderer import raster as jraster
from real2sim_eval_tpu.renderer.binning_fine import \
    bin_gaussians_fine as j_bin_fine
from real2sim_eval_tpu.renderer.camera import Camera as JCamera
from real2sim_eval_tpu.renderer.camera import setup_camera as j_setup
from real2sim_eval_tpu.renderer.fine_kernel import pack_attr_major
from real2sim_eval_tpu.renderer.fine_kernel import \
    rasterize_fine_batch as j_fine_batch
from real2sim_eval_tpu.renderer.preprocess import \
    preprocess_gaussians as j_pre
from real2sim_eval_tpu_torch.renderer import fine_kernel as tfk
from real2sim_eval_tpu_torch.renderer import incremental as tinc
from real2sim_eval_tpu_torch.renderer import incremental_fine as tincf
from real2sim_eval_tpu_torch.renderer import raster as traster
from real2sim_eval_tpu_torch.renderer.binning import bin_gaussians_fine
from real2sim_eval_tpu_torch.renderer.camera import Camera as TCamera
from real2sim_eval_tpu_torch.renderer.camera import setup_camera as t_setup

H, W = 64, 128
SCENE_KEYS = ("means3D", "scales", "rotations", "opacities", "shs")
# the JAX suite's fine exactness config (tests/test_incremental_fine.py CFG)
JCFG = jraster.RasterConfig(backend="pallas", kernel="fine", interpret=True,
                            fine_pairs_factor=40.0, fine_small_tiles=6,
                            fine_max_tiles=128, max_large=4096,
                            pack_payloads=False)
TCFG = traster.RasterConfig(kernel="fine")


def npy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def flips_ok(a, b):
    n = int((np.abs(npy(a) - npy(b)) > 1e-2).sum())
    return n <= max(5, int(2e-4 * npy(a).size))


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def binning_pre(seed: int, n: int = 80, invalid: bool = False) -> dict:
    """tests/test_fine_binning.py's scene through the JAX preprocess (numpy
    arrays); ``invalid`` forges its test_invalid_gaussians_do_not_shift_
    streams case: five invalid gaussians with an in-image 1x1 rect."""
    rng = np.random.default_rng(seed)
    cam = JCamera(width=256, height=64, fx=80.0, fy=80.0, cx=128.0, cy=32.0,
                  z_threshold=0.05)
    means = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(0.4, 3.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    quats = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    opac = rng.uniform(0.1, 1.0, n).astype(np.float32)
    shs = rng.uniform(-0.5, 0.5, (n, 1, 3)).astype(np.float32)
    pre = {k: np.asarray(v) for k, v in j_pre(
        cam, jnp.eye(4), *[jnp.asarray(a) for a in (means, scales, quats,
                                                    opac, shs)], 0).items()}
    if invalid:
        bad = np.zeros(n, bool)
        bad[:5] = True
        pre["valid"] = pre["valid"] & ~bad
        pre["xy"] = np.where(bad[:, None], np.float32([[40.0, 20.0]]),
                             pre["xy"])
        pre["radius"] = np.where(bad, np.float32(1.0), pre["radius"])
        pre["depth"] = np.where(bad, np.float32(0.01), pre["depth"])
    return pre


def jax_fine_bins(pre: dict, nsx: int, nsy: int) -> dict:
    """JAX fine binning with budgets that drop nothing."""
    n = pre["xy"].shape[0]
    b = j_bin_fine({k: jnp.asarray(v) for k, v in pre.items()}, nsx, nsy,
                   max_pairs=16384, small_tiles=6, max_tiles_per_gaussian=128,
                   max_large=n, pack_payloads=False)
    assert int(b["n_large_dropped"]) == 0
    return b


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


def cameras(setup):
    k = np.array([[160.0, 0, W / 2], [0, 160.0, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -1.2]
    cam, w2c = setup(W, H, k, np.linalg.inv(c2w))
    w2c2 = np.array(w2c, np.float32).copy()
    w2c2[0, 3] += 0.15
    return cam, np.asarray(w2c, np.float32), w2c2


@pytest.fixture(scope="module")
def scene():
    """tests/test_incremental_fine.py's scene: 400 static gaussians, 40
    dynamic ones in 3 envs (shifted per env)."""
    rng = np.random.default_rng(7)
    static = gaussians(rng, 400, np.array([0.0, 0.0, 0.3]), 0.45)
    one = gaussians(rng, 40, np.array([0.05, 0.0, 0.1]), 0.05)
    dyn = {k: np.stack([v] * 3) for k, v in one.items()}
    dyn["means3D"] = dyn["means3D"] + np.float32(
        [[0.0, 0.0, 0.0], [-0.15, 0.2, 0.0], [0.12, -0.25, 0.05]])[:, None]
    return static, dyn


def saturating_scene():
    """A static layer dense and opaque enough that most fine tiles saturate
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


def jax_scene(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def jax_static(scene):
    cam, w2c, _ = cameras(j_setup)
    return jincf.build_static_raster_fine(cam, w2c, jax_scene(scene[0]), 0,
                                          JCFG)


def port_static(static, w2c):
    return tincf.build_static_raster_fine(cameras(t_setup)[0], w2c,
                                          torch_scene(static), 0)


def port_render(static, dyn, two_cams=False, stats=None):
    cam, w2c, w2c2 = cameras(t_setup)
    cams = [(cam, port_static(static, w2c), w2c)]
    if two_cams:
        cams.append((cam, port_static(static, w2c2), w2c2))
    return tincf.render_incremental_fine(cams, torch_scene(dyn), 0, TCFG,
                                         stats=stats)


def with_static(static, dyn):
    B = dyn["means3D"].shape[0]
    return {k: np.concatenate(
        [dyn[k], np.broadcast_to(static[k][None], (B,) + static[k].shape)],
        axis=1) for k in static}


def port_full(static, dyn, w2c):
    """The port's fine full pipeline on the [dynamic; static] scene."""
    cam = cameras(t_setup)[0]
    B = dyn["means3D"].shape[0]
    return traster.rasterize_batch(
        [(cam, torch.as_tensor(w2c)[None].expand(B, 4, 4))],
        torch_scene(with_static(static, dyn)), 0, config=TCFG, device="cpu")


# ---------------------------------------------------------------------------
# the fine binning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,invalid", [(0, False), (3, False), (7, True)],
                         ids=["seed0", "seed3", "invalid_gaussians"])
def test_fine_binning_matches_jax(seed, invalid):
    """Pair tiles, fine tile ranges and the ten lanes bitwise JAX's
    bin_gaussians_fine on the same preprocess output (two instances: the
    port bins a batch), invalid gaussians included."""
    pres = [binning_pre(seed, invalid=invalid), binning_pre(seed + 100)]
    nsx, nsy = 2, 8
    bt = bin_gaussians_fine(
        {k: torch.as_tensor(np.stack([p[k] for p in pres])) for k in pres[0]},
        nsx, nsy)
    assert bt["tile_starts"].shape == (2, nsx * 8 * nsy)
    assert int(bt["n_large_dropped"].sum()) == 0
    off = 0
    for i, pre in enumerate(pres):
        bj = jax_fine_bins(pre, nsx, nsy)
        n_p = int(bj["n_pairs"])
        assert n_p == int(bt["n_pairs"][i]) > 0
        np.testing.assert_array_equal(npy(bt["tile_starts"][i]) - off,
                                      np.asarray(bj["fine_starts"]))
        np.testing.assert_array_equal(npy(bt["tile_ends"][i]) - off,
                                      np.asarray(bj["fine_ends"]))
        np.testing.assert_array_equal(npy(bt["pair_tile"][off:off + n_p]),
                                      np.asarray(bj["pair_tile"][:n_p]))
        lanes_j = np.stack([np.asarray(v[:n_p]) for v in bj["pair_lanes"]])
        np.testing.assert_array_equal(
            npy(bt["pair_attrs"][:, off:off + n_p]), lanes_j)
        off += n_p


# ---------------------------------------------------------------------------
# K4's plain version and the fine full pipeline
# ---------------------------------------------------------------------------


def test_k4_plain_matches_jax_kernel():
    """K4's plain version against the JAX fine kernel (interpret mode) on
    the same pair lanes and fine tile ranges, two instances; the wrapper
    on the CPU is the plain version bitwise."""
    pres = [binning_pre(1), binning_pre(2)]
    nsx, nsy = 2, 8
    datas, starts, ends, lanes = [], [], [], []
    off = 0
    for pre in pres:
        bj = jax_fine_bins(pre, nsx, nsy)
        datas.append(pack_attr_major(bj["pair_lanes"]))
        starts.append(np.asarray(bj["fine_starts"]) + off)
        ends.append(np.asarray(bj["fine_ends"]) + off)
        lanes.append(np.stack([np.asarray(v) for v in bj["pair_lanes"]]))
        off += lanes[-1].shape[1]
    bg = (0.1, 0.2, 0.3)
    rgb_j, dep_j = j_fine_batch(jnp.concatenate(datas),
                                jnp.asarray(np.stack(starts)),
                                jnp.asarray(np.stack(ends)), nsx, nsy, bg,
                                interpret=True)
    pairs = torch.as_tensor(np.concatenate(lanes, axis=1))
    s = torch.as_tensor(np.stack(starts), dtype=torch.int32)
    e = torch.as_tensor(np.stack(ends), dtype=torch.int32)
    rgb_t, dep_t = tfk.rasterize_fine_batch(pairs, s, e, nsx, nsy, bg)
    assert rgb_t.shape == (2, 3, 64, 256)
    np.testing.assert_allclose(npy(rgb_t), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(dep_t, dep_j)
    rgb_p, dep_p = tfk.composite_fine_plain(pairs, s, e, nsx, nsy, bg)
    np.testing.assert_array_equal(npy(rgb_p), npy(rgb_t))
    np.testing.assert_array_equal(npy(dep_p), npy(dep_t))


def test_fine_rasterize_batch_matches_jax():
    """The port's fine rasterize_batch (two cameras, two envs) against
    JAX's fine rasterize_batch and the port's dense reference gated at
    8x16 (``rasterize(backend="reference", kernel="fine")``), which
    matches JAX's own."""
    rng = np.random.default_rng(11)
    B, n = 2, 60
    q = rng.normal(size=(B, n, 4))
    sc = {"means3D": np.stack([rng.uniform(-1, 1, (B, n)),
                               rng.uniform(-0.4, 0.4, (B, n)),
                               rng.uniform(0.5, 3.0, (B, n))], -1),
          "scales": rng.uniform(0.01, 0.08, (B, n, 3)),
          "rotations": q / np.linalg.norm(q, axis=-1, keepdims=True),
          "opacities": rng.uniform(0.1, 1.0, (B, n)),
          "shs": rng.uniform(-0.5, 0.5, (B, n, 1, 3))}
    sc = {k: v.astype(np.float32) for k, v in sc.items()}
    w2c_b = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    w2c_b[1, 0, 3] = 0.15
    cam_a = dict(width=256, height=64, fx=80.0, fy=80.0, cx=128.0, cy=32.0)
    cam_b = dict(width=256, height=64, fx=95.0, fy=95.0, cx=120.0, cy=30.0)
    bg = (0.1, 0.2, 0.3)
    rgb_j, dep_j, drop_j = jraster.rasterize_batch(
        [(JCamera(**c), jnp.asarray(w2c_b)) for c in (cam_a, cam_b)],
        jax_scene(sc), 0, bg=bg, config=JCFG, return_drops=True)
    assert int(np.asarray(drop_j).sum()) == 0
    rgb_t, dep_t, drop_t = traster.rasterize_batch(
        [(TCamera(**c), torch.as_tensor(w2c_b)) for c in (cam_a, cam_b)],
        torch_scene(sc), 0, bg=bg, config=TCFG, return_drops=True,
        device="cpu")
    assert rgb_t.shape == (2, B, 3, 64, 256) and int(drop_t.sum()) == 0
    np.testing.assert_allclose(npy(rgb_t), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(dep_t, dep_j)
    # env 0 of camera a against the dense references gated at 8x16
    args_t = [torch.as_tensor(sc[k][0]) for k in SCENE_KEYS]
    ref = traster.RasterConfig(backend="reference", kernel="fine")
    rgb_r, dep_r = traster.rasterize(TCamera(**cam_a), torch.eye(4), *args_t,
                                     0, bg=bg, config=ref, device="cpu")
    rgb_jr, dep_jr = jraster.rasterize(
        JCamera(**cam_a), jnp.eye(4), *[jnp.asarray(sc[k][0])
                                        for k in SCENE_KEYS], 0, bg=bg,
        config=jraster.RasterConfig(backend="reference", kernel="fine"))
    np.testing.assert_allclose(npy(rgb_r), np.asarray(rgb_jr), atol=2e-3)
    assert flips_ok(dep_r, dep_jr)
    np.testing.assert_allclose(np.clip(npy(rgb_r), 0, 1), npy(rgb_t[0, 0]),
                               atol=2e-3)
    np.testing.assert_allclose(npy(dep_r), npy(dep_t[0, 0]), atol=1e-3)
    # the wide kernel gates at 8x128: the fine frames differ, within the
    # JAX suite's bound between the families (test_incremental_fine.py:174)
    rgb_w, dep_w = traster.rasterize_batch(
        [(TCamera(**cam_a), torch.as_tensor(w2c_b))], torch_scene(sc), 0,
        bg=bg, device="cpu")
    d_rgb = float((rgb_w[0] - rgb_t[0]).abs().max())
    assert 0.0 < d_rgb < 2e-2
    assert float((dep_w[0] - dep_t[0]).abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# the static build and the saturation cut on fine tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_static_raster_fine_matches_jax(scene, jax_static, kind):
    """``static_cutoff`` on 8x16 tiles: k_sat bitwise JAX's
    ``_static_cutoff(..., tile_w=16, tile_h=8)`` on the same pair table,
    and the whole static build (fine ranges, k_sat, max_seg) bitwise JAX's
    build_static_raster_fine; the cached frame at the compositor
    tolerances."""
    static, js = scene[0], jax_static
    cam_j, w2c, _ = cameras(j_setup)
    if kind == "saturating":
        static = saturating_scene()
        js = jincf.build_static_raster_fine(cam_j, w2c, jax_scene(static),
                                            0, JCFG)
    st = port_static(static, w2c)
    assert (st.n_super_x, st.n_super_y) == (js.n_super_x, js.n_super_y)
    np.testing.assert_array_equal(npy(st.starts), np.asarray(js.starts))
    np.testing.assert_array_equal(npy(st.ends - st.starts),
                                  np.asarray(js.ends) - np.asarray(js.starts))
    assert st.max_seg == js.max_seg > 0
    hp = st.n_tiles_y * 8
    np.testing.assert_allclose(npy(st.rgb_cache),
                               np.asarray(js.rgb_cache)[:, :hp], atol=2e-3)
    assert flips_ok(st.depth_cache, np.asarray(js.depth_cache)[:hp])
    # the cut on the port's own table, through JAX's scan directly
    pre = tinc.preprocess_static(cameras(t_setup)[0], w2c,
                                 torch_scene(static), 0)
    bins = bin_gaussians_fine(pre, st.n_super_x, st.n_super_y)
    s0, e0 = bins["tile_starts"][0], bins["tile_ends"][0]
    max_seg = int((e0 - s0).max())
    rows = np.zeros((bins["pair_attrs"].shape[1], 16), np.float32)
    rows[:, :10] = npy(bins["pair_attrs"]).T
    k_j = jinc._static_cutoff(jnp.asarray(rows), jnp.asarray(npy(s0)),
                              jnp.asarray(npy(e0)), st.n_tiles_x,
                              st.n_tiles_y, max_seg, tile_w=16, tile_h=8)
    k_t = tinc.static_cutoff(bins["pair_attrs"], s0, e0, st.n_tiles_x,
                             st.n_tiles_y, max_seg, tile_w=16, tile_h=8)
    np.testing.assert_array_equal(npy(k_t), np.asarray(k_j))
    if kind == "saturating":
        # the cut is real, and compositing only the cut ranges gives the
        # frame of the full ranges bitwise
        assert (npy(k_t) < npy(e0 - s0)).any()
        rgb_cut, dep_cut = tfk.composite_fine_plain(
            st.pairs, st.starts[None], st.ends[None], st.n_super_x,
            st.n_super_y)
        np.testing.assert_array_equal(npy(rgb_cut[0]), npy(st.rgb_cache))
        np.testing.assert_array_equal(npy(dep_cut[0]), npy(st.depth_cache))


# ---------------------------------------------------------------------------
# the fine incremental render
# ---------------------------------------------------------------------------


def test_render_incremental_fine_matches_jax(scene, jax_static):
    """Frames at 2e-3 of JAX's render_incremental_fine, telemetry bitwise:
    lane 0 counts the dirty supertiles, lanes 1-3 are 0."""
    static, dyn = scene
    cam, w2c, _ = cameras(j_setup)
    js = jax_static
    rgb_j, dep_j, tele_j = jincf.render_incremental_fine(
        [(cam, js, w2c)], jax_scene(dyn), 0, JCFG, t_budget=32, p_mix=8192)
    assert (np.asarray(tele_j)[..., 1:] == 0).all()
    stats = {}
    rgb_t, dep_t, tele_t = port_render(static, dyn, stats=stats)
    assert tele_t.shape == (1, 3, 4)
    np.testing.assert_array_equal(npy(tele_t), np.asarray(tele_j))
    np.testing.assert_allclose(npy(rgb_t), np.asarray(rgb_j), atol=2e-3)
    assert flips_ok(dep_t, dep_j)
    # every dirty supertile holds 1 to 8 dirty fine tiles
    n_fine = npy(stats["dirty_fine_tiles"])
    n_sup = npy(tele_t[..., 0])
    assert ((n_sup <= n_fine) & (n_fine <= 8 * n_sup)).all()
    assert stats["merged_pairs"] > 0


@pytest.mark.parametrize("two_cams", [False, True], ids=["one_cam",
                                                         "two_cams"])
def test_fine_incremental_bitwise_vs_full(scene, two_cams):
    static, dyn = scene
    _, w2c, w2c2 = cameras(t_setup)
    rgb_i, dep_i, tele = port_render(static, dyn, two_cams)
    n_dirty = npy(tele[..., 0])
    assert (n_dirty > 0).all() and (n_dirty < 8).all()
    assert (npy(tele[..., 1:]) == 0).all()
    for c, m in enumerate([w2c, w2c2][:1 + two_cams]):
        rgb_f, dep_f = port_full(static, dyn, m)
        np.testing.assert_array_equal(npy(rgb_i[c]), npy(rgb_f[0]))
        np.testing.assert_array_equal(npy(dep_i[c]), npy(dep_f[0]))


def test_fine_clean_supertiles_keep_cache(scene):
    """Only dirty fine tiles change; moving the object out of frame keeps
    every cached pixel (tests/test_incremental_fine.py's
    test_fine_clean_supertiles_keep_cache)."""
    static, dyn = scene
    _, w2c, _ = cameras(t_setup)
    cache = np.clip(npy(port_static(static, w2c).rgb_cache)[:, :H, :W], 0, 1)
    stats = {}
    rgb, _, _ = port_render(static, dyn, stats=stats)
    fine_changed = (npy(rgb[0]) != cache).any(axis=1).reshape(
        3, H // 8, 8, W // 16, 16).any(axis=(2, 4))
    assert fine_changed.any()
    assert (fine_changed.sum(axis=(1, 2))
            <= npy(stats["dirty_fine_tiles"][0])).all()
    far = dict(dyn, means3D=dyn["means3D"] + np.float32([5.0, 5.0, 0.0]))
    rgb, _, tele = port_render(static, far)
    assert (npy(tele[..., 0]) == 0).all()
    np.testing.assert_array_equal(npy(rgb[0, 0]), cache)


# ---------------------------------------------------------------------------
# the K4 / K5 wrappers
# ---------------------------------------------------------------------------


def test_k5_over_every_tile_is_k4():
    """K5's plain version listing every fine tile of a random table is
    K4's plain version bitwise, whatever the cache held; listing only
    some fine tiles changes only those."""
    rng = np.random.default_rng(1)
    nsx, nsy, n_inst, per_tile = 1, 2, 2, 6
    n_fx = nsx * 8
    n_tiles = n_fx * nsy
    P = n_inst * n_tiles * per_tile
    pairs = np.zeros((10, P), np.float32)
    tiles = np.tile(np.repeat(np.arange(n_tiles), per_tile), n_inst)
    pairs[0] = (tiles % n_fx) * 16 + rng.uniform(0, 16, P)
    pairs[1] = (tiles // n_fx) * 8 + rng.uniform(0, 8, P)
    pairs[2], pairs[4] = rng.uniform(1e-2, 2e-1, (2, P))
    pairs[3] = rng.uniform(-1e-3, 1e-3, P)
    pairs[5] = rng.uniform(0.2, 1.0, P)
    pairs[6:9] = rng.uniform(0, 1, (3, P))
    pairs[9] = np.sort(rng.uniform(0.5, 3.0, P))
    starts = torch.arange(0, P, per_tile, dtype=torch.int32).reshape(
        n_inst, n_tiles)
    pairs = torch.as_tensor(pairs)
    bg = (0.1, 0.2, 0.3)
    rgb4, dep4 = tfk.rasterize_fine_batch(pairs, starts, starts + per_tile,
                                          nsx, nsy, bg)
    inst = torch.arange(n_inst, dtype=torch.int32).repeat_interleave(n_tiles)
    tile = torch.arange(n_tiles, dtype=torch.int32).repeat(n_inst)
    cache = torch.full((n_inst, 3, 16, 128), 7.0)
    rgb5, dep5 = tfk.rasterize_fine_sparse(
        pairs, inst, tile, starts.reshape(-1), starts.reshape(-1) + per_tile,
        cache, cache[:, 0], nsx, nsy, bg)
    np.testing.assert_array_equal(npy(rgb5), npy(rgb4))
    np.testing.assert_array_equal(npy(dep5), npy(dep4))
    # one fine tile (instance 1, fine tile 9: rows 8-15, columns 16-31)
    one = torch.tensor([1], dtype=torch.int32)
    rgb1, dep1 = tfk.rasterize_fine_sparse(
        pairs, one, torch.tensor([9], dtype=torch.int32),
        starts[1, 9:10], starts[1, 9:10] + per_tile, cache, cache[:, 0], nsx,
        nsy, bg)
    mask = torch.zeros((n_inst, 16, 128), dtype=torch.bool)
    mask[1, 8:16, 16:32] = True
    assert bool((rgb1.transpose(0, 1)[:, ~mask] == 7.0).all())
    assert bool((dep1[~mask] == 7.0).all())
    np.testing.assert_array_equal(npy(rgb1[1][:, 8:16, 16:32]),
                                  npy(rgb4[1][:, 8:16, 16:32]))
    np.testing.assert_array_equal(npy(dep1[1, 8:16, 16:32]),
                                  npy(dep4[1, 8:16, 16:32]))


def test_fine_wrappers_reject_malformed_tables():
    pairs = torch.zeros((10, 8))
    s = torch.zeros((1, 8), dtype=torch.int32)
    tfk.rasterize_fine_batch(pairs, s, s, 1, 1)
    for args in ((pairs[:9], s, s, 1, 1), (pairs, s.long(), s, 1, 1),
                 (pairs, s, s, 2, 1), (pairs, s[:, :4], s[:, :4], 1, 1)):
        with pytest.raises(ValueError):
            tfk.rasterize_fine_batch(*args)
    ids = torch.zeros(2, dtype=torch.int32)
    rgb, dep = torch.zeros((1, 3, 8, 128)), torch.zeros((1, 8, 128))
    good = (pairs, ids, ids, ids, ids, rgb, dep, 1, 1)
    tfk.rasterize_fine_sparse(*good)
    bad = [
        (pairs.double(),) + good[1:],                           # f64 table
        good[:1] + (ids.long(),) + good[2:],                    # i64 ids
        good[:4] + (ids[:1],) + good[5:],                       # short ends
        good[:5] + (rgb[:, :2],) + good[6:],                    # rgb planes
        good[:7] + (2, 1),                                      # tile grid
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tfk.rasterize_fine_sparse(*args)


def test_raster_config_kernel_fields():
    assert (TCFG.kernel, TCFG.wrist_kernel) == ("fine", "inherit")
    assert traster.RasterConfig().kernel == "wide"
    for bad in ({"kernel": "narrow"}, {"wrist_kernel": "fine8"}):
        with pytest.raises(ValueError):
            traster.RasterConfig(**bad)
