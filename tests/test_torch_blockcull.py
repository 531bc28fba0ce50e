"""K1's block cull on the CPU: the test each warp of the tile compositor
applies to its 8x16 block before it blends a pair (``block_keep`` in
csrc/tile_blend.cuh; ``tile_kernel.block_cull_keep`` is the same test in
PyTorch) may drop only pairs that change no pixel of the block, so K1's
frames stay bitwise those of its plain version.

Inputs are made with numpy from a seed; the small scene also goes through
the JAX package's Pallas rasterizer in interpret mode, as its own tests
run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from real2sim_eval_tpu.renderer import camera as jcam
from real2sim_eval_tpu.renderer import raster as jraster
from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
from real2sim_eval_tpu_torch.renderer.binning import bin_gaussians
from real2sim_eval_tpu_torch.renderer.camera import Camera
from real2sim_eval_tpu_torch.renderer.preprocess import preprocess_gaussians

W, H = 256, 64
N_TX, N_TY = W // tk.TILE_W, H // tk.TILE_H
N_BLOCKS = tk.TILE_W // tk.BLOCK_W
BG = (0.1, 0.2, 0.3)


def scene(seed: int, n: int = 300):
    """A random scene (numpy, seeded) as the render tests make one, with a
    few large opaque splats so that some pixels saturate."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    scales = rng.uniform(0.01, 0.08, (n, 3))
    scales[:20] = rng.uniform(0.08, 0.15, (20, 3))
    opac = rng.uniform(0.1, 1.0, n)
    opac[:20] = 1.0
    return {
        "means3D": np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.4, 0.4, n),
                             rng.uniform(0.5, 3.0, n)], -1).astype(np.float32),
        "scales": scales.astype(np.float32),
        "rotations": (q / np.linalg.norm(q, axis=-1, keepdims=True)
                      ).astype(np.float32),
        "opacities": opac.astype(np.float32),
        "shs": rng.uniform(-0.5, 0.5, (n, 1, 3)).astype(np.float32),
    }


KEYS = ("means3D", "scales", "rotations", "opacities", "shs")


def wide_bins(sc):
    """Two instances (two camera offsets) of the scene, preprocessed and
    binned on 8x128 tiles as the render tests bin them."""
    w2c = torch.eye(4).repeat(2, 1, 1)
    w2c[1, 0, 3] = 0.12
    cam = Camera(width=W, height=H, fx=80.0, fy=80.0, cx=W / 2, cy=H / 2)
    pre = preprocess_gaussians(cam, w2c, *[
        torch.as_tensor(sc[k])[None].expand((2,) + sc[k].shape) for k in KEYS],
        0)
    return bin_gaussians(pre, N_TX, N_TY, tk.TILE_W, tk.TILE_H), w2c


def reaches(attrs, px, py):
    """power <= 0 and alpha >= ALPHA_MIN, as ``_blend_tiles_plain`` computes
    them, of the pairs ``attrs`` (10, ...) at pixels (px, py)."""
    dx = attrs[0] - px
    dy = attrs[1] - py
    power = (-0.5 * (attrs[2] * dx * dx + attrs[4] * dy * dy)
             - attrs[3] * dx * dy)
    alpha = torch.minimum(torch.full_like(power, tk.ALPHA_MAX),
                          attrs[5] * torch.exp(power))
    return (power <= 0.0) & (alpha >= tk.ALPHA_MIN)


def block_pixels(bx0: float, by0: float):
    """(px, py), each (8, 16) f32, of the block whose first pixel is
    (bx0, by0)."""
    px = bx0 + torch.arange(tk.BLOCK_W, dtype=torch.float32)[None, :]
    py = by0 + torch.arange(tk.TILE_H, dtype=torch.float32)[:, None]
    return px.expand(tk.TILE_H, -1), py.expand(-1, tk.BLOCK_W)


def blocks_of(bins):
    """Per (instance, tile, block): the tile's pair indices, the block's
    first pixel and its keep mask. Yields (g, w, idx, bx0, by0, keep)."""
    starts = bins["tile_starts"].reshape(-1)
    ends = bins["tile_ends"].reshape(-1)
    pairs = bins["pair_attrs"]
    for g in range(starts.shape[0]):
        t = g % (N_TX * N_TY)
        tx, ty = t % N_TX, t // N_TX
        idx = torch.arange(int(starts[g]), int(ends[g]))
        for w in range(N_BLOCKS):
            bx0 = float(tx * tk.TILE_W + w * tk.BLOCK_W)
            by0 = float(ty * tk.TILE_H)
            keep = tk.block_cull_keep(pairs[:, idx], torch.tensor(bx0),
                                      torch.tensor(by0))
            yield g, w, idx, bx0, by0, keep


@pytest.mark.parametrize("seed", [0, 1])
def test_dropped_pairs_reach_no_pixel(seed):
    """Every (8x16 block, pair) of the small scene's wide pair table that
    the cull drops has power > 0 or alpha < ALPHA_MIN at every pixel of
    the block; the cull drops something."""
    bins, _ = wide_bins(scene(seed))
    pairs = bins["pair_attrs"]
    dropped = tested = 0
    for _, _, idx, bx0, by0, keep in blocks_of(bins):
        tested += keep.numel()
        if bool(keep.all()):
            continue
        gone = idx[~keep]
        px, py = block_pixels(bx0, by0)
        hit = reaches(pairs[:, gone][:, :, None, None], px, py)
        assert not bool(hit.any()), (bx0, by0, gone[hit.flatten(1).any(1)])
        dropped += gone.numel()
    assert tested > 0 and 0 < dropped < tested


@pytest.mark.parametrize("seed", [0, 1])
def test_culled_blend_is_bitwise_plain(seed):
    """The plain blend of each 8x16 block over its kept pairs only (the
    walk of a K1 warp) is bitwise ``composite_tiles_plain`` of the whole
    tiles, and within the render tests' tolerance of the JAX package's
    Pallas rasterizer (interpret mode) on the same scene."""
    sc = scene(seed)
    bins, w2c = wide_bins(sc)
    pairs = bins["pair_attrs"]
    rows, b_starts, b_ends, off = [], [], [], 0
    for _, _, idx, _, _, keep in blocks_of(bins):
        rows.append(idx[keep])
        b_starts.append(off)
        off += int(keep.sum())
        b_ends.append(off)
    kept = pairs[:, torch.cat(rows)]
    shape = (2, N_TY * N_TX * N_BLOCKS)
    # blocks in tile order are the 8x16 grid's row-major order
    rgb_b, dep_b = tk.composite_tiles_plain(
        kept, torch.tensor(b_starts, dtype=torch.int32).reshape(shape),
        torch.tensor(b_ends, dtype=torch.int32).reshape(shape),
        N_TX * N_BLOCKS, N_TY, BG, tile_w=tk.BLOCK_W)
    rgb_p, dep_p = tk.composite_tiles_plain(
        pairs, bins["tile_starts"], bins["tile_ends"], N_TX, N_TY, BG)
    assert kept.shape[1] < N_BLOCKS * pairs.shape[1]     # (block, pair)s
    assert torch.equal(rgb_b, rgb_p) and torch.equal(dep_b, dep_p)

    cam = jcam.Camera(width=W, height=H, fx=80.0, fy=80.0, cx=W / 2,
                      cy=H / 2)
    cfg = jraster.RasterConfig(backend="pallas", interpret=True,
                               max_pairs_factor=16.0,
                               max_tiles_per_gaussian=64, max_large=300,
                               pack_payloads=False)
    rgb_j, dep_j = jraster.rasterize_batch(
        [(cam, jnp.asarray(w2c.numpy()))],
        {k: jnp.asarray(np.broadcast_to(v, (2,) + v.shape)) for k, v in
         sc.items()}, 0, bg=BG, config=cfg)
    # the JAX rasterizer returns its frames clipped to [0, 1]
    np.testing.assert_allclose(np.clip(rgb_b.numpy(), 0.0, 1.0),
                               np.asarray(rgb_j)[0], atol=2e-3)
    flips = int((np.abs(dep_b.numpy() - np.asarray(dep_j)[0]) > 1e-2).sum())
    assert flips <= max(5, int(2e-4 * dep_b.numel()))


def thin_conic(s_long: float, s_short: float, theta: float):
    """f32 conic (a, b, c) of a 2D gaussian with standard deviations
    (s_long, s_short) px rotated by theta, dilated by 0.3 px^2 as the
    preprocess dilates."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    cov = R @ np.diag([s_long ** 2, s_short ** 2]) @ R.T + 0.3 * np.eye(2)
    inv = np.linalg.inv(cov)
    return np.float32(inv[0, 0]), np.float32(inv[0, 1]), np.float32(inv[1, 1])


@settings(max_examples=300, deadline=None, derandomize=True)
@given(s_long=st.floats(2.0, 60.0), s_short=st.floats(0.0, 1.0),
       theta=st.floats(0.0, float(np.pi)),
       op=st.one_of(st.floats(1.0 / 255.0, 1.0001 / 255.0),
                    st.floats(1.0 / 255.0, 1.0)),
       side=st.sampled_from(("left", "right", "top", "bottom")),
       out=st.floats(0.0, 40.0), along=st.floats(-8.0, 24.0),
       scale=st.sampled_from((1.0, 64.0, 4096.0)))
def test_adversarial_splats(s_long, s_short, theta, op, side, out, along,
                            scale):
    """Thin, rotated splats of opacity just above 1/255, centred just
    outside an edge of the block at (512, 256) (a frame offset, so the
    pixel offsets round as far from the origin): wherever the cull drops
    one, no pixel of the block passes power <= 0 and the alpha floor.
    ``scale`` sharpens the conic as a far splat's would be."""
    bx0, by0 = 512.0, 256.0
    ca, cb, cc = (np.float32(v * scale) for v in thin_conic(
        s_long, s_short, theta))
    gx = {"left": bx0 - out, "right": bx0 + 15 + out}.get(side, bx0 + along)
    gy = {"top": by0 - out, "bottom": by0 + 7 + out}.get(side, by0 + along)
    attrs = torch.tensor([gx, gy, ca, cb, cc, op, 0.5, 0.5, 0.5, 1.0],
                         dtype=torch.float32)
    keep = tk.block_cull_keep(attrs, torch.tensor(bx0), torch.tensor(by0))
    if not bool(keep):
        px, py = block_pixels(bx0, by0)
        assert not bool(reaches(attrs[:, None, None], px, py).any())


def test_dense_random_splats():
    """200,000 random splats around one block, thin and round, faint and
    opaque: the cull drops only splats that reach no pixel, and drops
    most of the far ones."""
    rng = np.random.default_rng(3)
    n = 200_000
    cov_long = rng.uniform(0.0, 40.0, n) ** 2
    cov_short = rng.uniform(0.0, 2.0, n) ** 2
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    a = c * c * cov_long + s * s * cov_short + 0.3
    b = c * s * (cov_long - cov_short)
    d = s * s * cov_long + c * c * cov_short + 0.3
    det = a * d - b * b
    bx0, by0 = 128.0, 64.0
    op = np.where(rng.random(n) < 0.5, rng.uniform(1 / 255, 1.001 / 255, n),
                  rng.uniform(1 / 255, 1.0, n))
    attrs = torch.tensor(np.stack([
        bx0 + rng.uniform(-60, 76, n), by0 + rng.uniform(-60, 68, n),
        d / det, -b / det, a / det, op, np.zeros(n), np.zeros(n),
        np.zeros(n), np.ones(n)]), dtype=torch.float32)
    keep = tk.block_cull_keep(attrs, torch.tensor(bx0), torch.tensor(by0))
    px, py = block_pixels(bx0, by0)
    gone = attrs[:, ~keep]
    hit = reaches(gone[:, :, None, None], px, py).flatten(1).any(1)
    assert not bool(hit.any()), gone[:, hit][:, :5].T
    assert int((~keep).sum()) > n // 2


def culled_sparse(pairs, inst_ids, tile_ids, starts, ends, rgb_cache,
                  depth_cache, n_tx, n_ty, bg=(0.0, 0.0, 0.0)):
    """K2's walk with K1's block cull in plain PyTorch: each dirty 8x128
    tile split into its eight 8x16 blocks, each block blending only the
    pairs of the tile's range that ``block_cull_keep`` keeps for it (the
    walk of a K2 warp), through the fine-tile plain blend."""
    n_b = tk.TILE_W // tk.BLOCK_W
    rows, b_inst, b_tile, b_starts, b_ends, off = [], [], [], [], [], 0
    for k in range(inst_ids.shape[0]):
        t = int(tile_ids[k])
        tx, ty = t % n_tx, t // n_tx
        idx = torch.arange(int(starts[k]), int(ends[k]))
        for w in range(n_b):
            keep = tk.block_cull_keep(
                pairs[:, idx], torch.tensor(float(tx * tk.TILE_W
                                                  + w * tk.BLOCK_W)),
                torch.tensor(float(ty * tk.TILE_H)))
            rows.append(idx[keep])
            b_inst.append(int(inst_ids[k]))
            b_tile.append(ty * n_tx * n_b + tx * n_b + w)
            b_starts.append(off)
            off += int(keep.sum())
            b_ends.append(off)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    kept = pairs[:, torch.cat(rows)] if rows else pairs[:, :0]
    out = tk.composite_sparse_plain(
        kept, i32(b_inst), i32(b_tile), i32(b_starts), i32(b_ends),
        rgb_cache, depth_cache, n_tx * n_b, n_ty, bg, tile_w=tk.BLOCK_W)
    return out, kept.shape[1]


def split_scene(seed: int):
    """scene(seed) split into 260 static and 40 dynamic splats (two envs,
    the dynamic ones a cluster that moves between them), in numpy, the
    camera's intrinsics, and the port's incremental-render inputs: the
    fixed camera with its static raster, and the dynamic splats."""
    from real2sim_eval_tpu_torch.renderer import incremental as tinc
    from real2sim_eval_tpu_torch.renderer.camera import setup_camera

    sc = scene(seed)
    static = {k: v[:260] for k, v in sc.items()}
    dyn = {k: np.stack([v[260:]] * 2) for k, v in sc.items()}
    # a cluster over a few tiles, further left and nearer in env 1
    rng = np.random.default_rng(seed + 10)
    dyn["means3D"] = (np.float32([0.2, 0.0, 1.5]) + rng.normal(
        scale=0.05, size=(2, 40, 3))).astype(np.float32)
    dyn["means3D"][1] += np.float32([-0.4, 0.05, -0.3])
    dyn["opacities"] = dyn["opacities"][..., None]
    static["opacities"] = static["opacities"][:, None]
    k = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    cam, w2c = setup_camera(W, H, k, np.eye(4, dtype=np.float32))
    st = tinc.build_static_raster(
        cam, torch.as_tensor(np.asarray(w2c)),
        {key: torch.as_tensor(v) for key, v in static.items()}, 0, BG)
    cams = [(cam, st, torch.as_tensor(np.asarray(w2c)))]
    dyn_t = {key: torch.as_tensor(v) for key, v in dyn.items()}
    return static, dyn, k, cams, dyn_t


@pytest.mark.parametrize("seed", [0, 1])
def test_culled_dirty_tiles_are_bitwise_plain(seed, monkeypatch):
    """K2's block cull on the CPU: ``split_scene`` rendered incrementally
    (sort merge). The block-culled plain blend over the step's dirty-tile
    list is bitwise ``composite_sparse_plain`` (K2's plain version) on the
    same inputs, and the incremental frames it gives are within the render
    tests' tolerance of the JAX package's incremental render (its
    ``rasterize_tiles_sparse`` in interpret mode, as its own tests run
    it)."""
    from real2sim_eval_tpu.renderer import incremental as jinc
    from real2sim_eval_tpu.renderer.camera import setup_camera as j_setup
    from real2sim_eval_tpu_torch.renderer import RasterConfig
    from real2sim_eval_tpu_torch.renderer import incremental as tinc

    static, dyn, k, cams, dyn_t = split_scene(seed)
    seen = {}
    plain = tinc.rasterize_tiles_sparse

    def culled(*args):
        seen["args"] = args
        out, seen["kept"] = culled_sparse(*args)
        return out

    monkeypatch.setattr(tinc, "rasterize_tiles_sparse", culled)
    rgb_c, dep_c, tele = tinc.render_incremental(
        cams, dyn_t, 0, RasterConfig(merge_kernel="sort"), bg=BG)
    monkeypatch.setattr(tinc, "rasterize_tiles_sparse", plain)
    rgb_p, dep_p, _ = tinc.render_incremental(
        cams, dyn_t, 0, RasterConfig(merge_kernel="sort"), bg=BG)
    args = seen["args"]
    n_dirty, rows = int(args[1].numel()), int((args[4] - args[3]).sum())
    assert 0 < n_dirty < 2 * N_TX * N_TY
    assert seen["kept"] < tk.TILE_W // tk.BLOCK_W * rows  # the cull cuts
    frames_c = culled_sparse(*args)[0]
    frames_p = tk.composite_sparse_plain(*args)
    assert torch.equal(frames_c[0], frames_p[0])
    assert torch.equal(frames_c[1], frames_p[1])
    assert torch.equal(rgb_c, rgb_p) and torch.equal(dep_c, dep_p)

    jcam, jw2c = j_setup(W, H, k, np.eye(4, dtype=np.float32))
    cfg = jraster.RasterConfig(backend="pallas", interpret=True,
                               max_pairs_factor=16.0,
                               max_tiles_per_gaussian=64, max_large=300,
                               pack_payloads=False)
    js = jinc.build_static_raster(
        jcam, jw2c, {key: jnp.asarray(v) for key, v in static.items()}, 0,
        cfg, bg=BG)
    rgb_j, dep_j, tele_j = jinc.render_incremental(
        [(jcam, js, jw2c)], {key: jnp.asarray(v) for key, v in dyn.items()},
        0, cfg, t_budget=2 * N_TX * N_TY, p_mix=8192, bg=BG)
    assert (np.asarray(tele_j)[..., 1:] == 0).all()
    np.testing.assert_array_equal(tele.numpy()[..., 0],
                                  np.asarray(tele_j)[..., 0])
    np.testing.assert_allclose(rgb_c.numpy(), np.asarray(rgb_j), atol=2e-3)
    flips = int((np.abs(dep_c.numpy() - np.asarray(dep_j)) > 1e-2).sum())
    assert flips <= max(5, int(2e-4 * dep_c.numel()))


@pytest.mark.parametrize("seed", [0, 1])
def test_culled_merged_dirty_tiles_are_bitwise_plain(seed, monkeypatch):
    """K6's walk on the CPU: ``split_scene`` rendered incrementally with
    the stream merge. The block-culled plain blend over each dirty tile's
    merged static and dynamic segments (the order of ``merge_segments``:
    a dynamic pair first on equal depth) is bitwise
    ``composite_sparse_merge_plain`` (K6's plain version) on the same
    inputs, and the frames it gives are bitwise those of the plain stream
    render and of the sort render."""
    from real2sim_eval_tpu_torch.renderer import RasterConfig
    from real2sim_eval_tpu_torch.renderer import incremental as tinc

    _, _, _, cams, dyn_t = split_scene(seed)
    seen = {}

    def culled_merge(data_s, data_d, inst, tile, ss, se, ds, de, rgb_c,
                     dep_c, n_tx, n_ty, bg):
        seen["args"] = (data_s, data_d, inst, tile, ss, se, ds, de, rgb_c,
                        dep_c, n_tx, n_ty, bg)
        merged, m_st, m_en = tk.merge_segments(data_s, ss, se, data_d, ds,
                                               de)
        seen["rows"] = int((m_en - m_st).sum())
        out, seen["kept"] = culled_sparse(merged, inst, tile, m_st, m_en,
                                          rgb_c, dep_c, n_tx, n_ty, bg)
        return out

    stream = RasterConfig(merge_kernel="stream")
    monkeypatch.setattr(tinc, "rasterize_tiles_sparse_merge", culled_merge)
    rgb_c, dep_c, _ = tinc.render_incremental(cams, dyn_t, 0, stream, bg=BG)
    monkeypatch.undo()
    rgb_p, dep_p, _ = tinc.render_incremental(cams, dyn_t, 0, stream, bg=BG)
    rgb_s, dep_s, _ = tinc.render_incremental(
        cams, dyn_t, 0, RasterConfig(merge_kernel="sort"), bg=BG)
    args = seen["args"]
    n_dirty = int(args[2].numel())
    assert 0 < n_dirty < 2 * N_TX * N_TY
    # both streams feed the dirty tiles, and the cull cuts
    assert int((args[5] - args[4]).sum()) and int((args[7] - args[6]).sum())
    assert seen["kept"] < tk.TILE_W // tk.BLOCK_W * seen["rows"]
    frames_c = culled_merge(*args)
    frames_p = tk.composite_sparse_merge_plain(*args)
    assert torch.equal(frames_c[0], frames_p[0])
    assert torch.equal(frames_c[1], frames_p[1])
    assert torch.equal(rgb_c, rgb_p) and torch.equal(dep_c, dep_p)
    assert torch.equal(rgb_c, rgb_s) and torch.equal(dep_c, dep_s)


# K8's per-pair table against its plain version: the same per-pixel
# operations, each pair's sums over a tile's pixels in another order
# (chip_smoke.py K8_PLAIN_TOL, of each lane's largest |gradient|)
K8_PLAIN_TOL = 1e-4


def kept_table(pairs, starts, ends, w: int):
    """The pairs ``block_cull_keep`` keeps for block w of every tile, in
    order: (table (10, P_w), starts, ends shaped as ``starts``, source
    index of each row, source index of each dropped pair)."""
    rows, k_st, k_en, off = [], [], [], 0
    for g in range(starts.numel()):
        t = g % (N_TX * N_TY)
        tx, ty = t % N_TX, t // N_TX
        idx = torch.arange(int(starts.reshape(-1)[g]),
                           int(ends.reshape(-1)[g]))
        keep = tk.block_cull_keep(
            pairs[:, idx], torch.tensor(float(tx * tk.TILE_W
                                              + w * tk.BLOCK_W)),
            torch.tensor(float(ty * tk.TILE_H)))
        rows.append((idx[keep], idx[~keep]))
        k_st.append(off)
        off += int(keep.sum())
        k_en.append(off)
    src = torch.cat([r[0] for r in rows])
    i32 = lambda v: torch.tensor(v, dtype=torch.int32).reshape(  # noqa: E731
        starts.shape)
    return (pairs[:, src], i32(k_st), i32(k_en), src,
            torch.cat([r[1] for r in rows]))


@pytest.mark.parametrize("case", ["random", "opaque"])
def test_culled_backward_matches_plain(case):
    """K8's walk on the CPU: per 8x16 block w, the plain backward
    (``composite_backward_plain``) with the cotangents of the other blocks'
    pixels zeroed gives exactly 0 for every pair the block cull drops, and
    over the kept pairs alone gives bitwise the same rows; the blocks'
    rows summed in block order (the kernel's per-warp sums, then the sum
    over warps) are within K8_PLAIN_TOL of the whole-tile plain backward.
    "opaque" stacks splats of opacity 0.95-1 that drive pixels through
    the T < 1e-4 freeze and the 0.99 clamp."""
    sc = scene(4 if case == "random" else 5)
    if case == "opaque":
        sc["opacities"] = np.random.default_rng(6).uniform(
            0.95, 1.0, sc["opacities"].shape).astype(np.float32)
    bins, _ = wide_bins(sc)
    pairs, starts, ends = (bins["pair_attrs"], bins["tile_starts"],
                           bins["tile_ends"])
    rgb, _, t_fin = tk.composite_tiles_plain(pairs, starts, ends, N_TX, N_TY,
                                             BG, with_t=True)
    c_fin = rgb - t_fin[:, None] * torch.tensor(BG)[None, :, None, None]
    rng = np.random.default_rng(8)
    dl_rgb = torch.tensor(rng.normal(size=rgb.shape), dtype=torch.float32)
    dl_dep = torch.tensor(rng.normal(size=t_fin.shape), dtype=torch.float32)
    full = tk.composite_backward_plain(pairs, starts, ends, dl_rgb, dl_dep,
                                       c_fin, t_fin, BG)
    block = (torch.arange(W) % tk.TILE_W) // tk.BLOCK_W
    total = torch.zeros_like(pairs)
    dropped = 0
    for w in range(N_BLOCKS):
        on = (block == w).float()
        dl_w = (dl_rgb * on, dl_dep * on)
        unculled = tk.composite_backward_plain(pairs, starts, ends, *dl_w,
                                               c_fin, t_fin, BG)
        table, k_st, k_en, src, gone = kept_table(pairs, starts, ends, w)
        culled = tk.composite_backward_plain(table, k_st, k_en, *dl_w, c_fin,
                                             t_fin, BG)
        assert torch.equal(unculled[:, gone], torch.zeros_like(
            unculled[:, gone]))
        assert torch.equal(culled, unculled[:, src])
        total[:, src] = total[:, src] + culled
        dropped += gone.numel()
    assert 0 < dropped < N_BLOCKS * pairs.shape[1]
    lane_max = full.abs().amax(dim=1).clamp(min=1e-30)
    gap = float(((total - full).abs().amax(dim=1) / lane_max).max())
    assert gap <= K8_PLAIN_TOL, gap
    if case == "opaque":
        assert float(t_fin.min()) < tk.T_EPS * 100
