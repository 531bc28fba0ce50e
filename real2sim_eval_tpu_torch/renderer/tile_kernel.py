"""Tile compositors: front-to-back splat blending per (instance, tile).

Counterparts of five TPU kernels of the JAX package (renderer/
tile_kernel.py and renderer/diff.py), each a wrapper that launches a
hand-written CUDA kernel for tensors on the card and runs the plain
PyTorch version of the same function for tensors on the CPU:

  - K1 ``rasterize_tiles_batch`` (``csrc/tile_composite.cu``): every tile
    of every instance over a sorted pair table, each warp skipping the
    pairs that cannot reach its 8x16 block (``block_cull_keep`` is that
    test in PyTorch);
  - K7 ``rasterize_tiles_batch_t`` (``csrc/tile_composite.cu``): K1 with
    the final transmittance, the forward of the differentiable render;
  - K8 ``composite_backward`` (``csrc/tile_backward.cu``): the per-pair
    gradients of K7's outputs, its backward (renderer/diff.py);
  - K2 ``rasterize_tiles_sparse`` (``csrc/tile_sparse.cu``): only the
    dirty tiles of a list, over a merged pair table, on top of a copy of
    cached frames;
  - K6 ``rasterize_tiles_sparse_merge`` (``csrc/tile_sparse_merge.cu``):
    as K2, merging each dirty tile's static and dynamic pair segments
    inside the kernel (``merge_segments`` is that merge in PyTorch).

Semantics (renderCUDA / the TPU kernel's ``_composite_scoped``):
alpha = min(0.99, o * exp(power)), skipped unless power <= 0 and
alpha >= 1/255; a pixel freezes when T would fall below 1e-4; the median
depth is the pair depth at the T = 0.5 crossing, else 15.0; out = C + T*bg.
"""

from __future__ import annotations

import torch

from .. import ext
from ..utils.profiling import spanned

TILE_H = 8
TILE_W = 128
# the fine tiles of renderer/fine_kernel.py: 8 of them span one 8x128 tile
FINE_W = 16
GROUPS = TILE_W // FINE_W
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
MEDIAN_DEPTH_DEFAULT = 15.0
DEPTH_LANE = 9
# K1's warp block (8 x 16 pixels) and its cull's margin, absolute and
# relative to |a| dx^2 + 2 |b dx dy| + |c| dy^2 at the block's far corner
# (derived in csrc/tile_blend.cuh)
BLOCK_W = 16
CULL_ABS = 1e-4
CULL_REL = 1e-5


def _check_table(name, t):
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 10:
        raise ValueError(f"{name} must be (10, P) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check(pairs, starts, ends):
    _check_table("pairs", pairs)
    for name, t in (("tile_starts", starts), ("tile_ends", ends)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be (I, n_tiles) int32")
        if t.device != pairs.device:
            raise ValueError(f"{name} is on {t.device}, pairs on "
                             f"{pairs.device}")
    if starts.shape != ends.shape:
        raise ValueError("tile_starts and tile_ends differ in shape")


def _check_dirty(device, tables: dict) -> int:
    """The (n_dirty,) int32 tables of a dirty-tile list; returns n_dirty."""
    n = next(iter(tables.values())).shape[0]
    for name, t in tables.items():
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be (n_dirty,) int32 like the other "
                             f"dirty-tile tables, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pairs on {device}")
    return n


def _check_caches(device, rgb_cache, depth_cache, n_tiles_x, n_tiles_y,
                  tile_w: int = TILE_W):
    """Cached frames (..., 3, Hp, Wp) and (..., Hp, Wp) f32, leading dims
    alike."""
    h_pad, w_pad = n_tiles_y * TILE_H, n_tiles_x * tile_w
    for name, t, tail in (("rgb_cache", rgb_cache, (3, h_pad, w_pad)),
                          ("depth_cache", depth_cache, (h_pad, w_pad))):
        if t.dtype != torch.float32 or tuple(t.shape[-len(tail):]) != tail:
            raise ValueError(f"{name} must be (..., {tail}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pairs on {device}")
    if rgb_cache.shape[:-3] != depth_cache.shape[:-2]:
        raise ValueError("rgb_cache and depth_cache differ in leading dims")


def longest_first(starts, ends):
    """The order in which a kernel's CTAs take its tiles (K8, K4) or
    dirty-list entries (K5): by falling pair count, ties in index order,
    as an i32 permutation of the flattened ranges. Sorted on the ranges'
    device, so it adds no host synchronisation."""
    return torch.argsort((ends - starts).reshape(-1), descending=True,
                         stable=True).to(torch.int32)


@spanned("cache copy")
def copy_frames(rgb_cache, depth_cache, index=None):
    """(I, 3, Hp, Wp), (I, Hp, Wp) contiguous copies of the cached frames,
    whose leading dims may be broadcast views (one frame per camera).
    ``index`` (I,) i64: instance i copies cached frame ``index[i]`` of
    the caches' flattened leading dims (one frame per camera and mesh
    group), in one gather."""
    if index is not None:
        return (torch.index_select(
                    rgb_cache.reshape((-1,) + rgb_cache.shape[-3:]), 0, index),
                torch.index_select(
                    depth_cache.reshape((-1,) + depth_cache.shape[-2:]), 0,
                    index))
    rgb = torch.empty(rgb_cache.shape, dtype=torch.float32,
                      device=rgb_cache.device).copy_(rgb_cache)
    depth = torch.empty(depth_cache.shape, dtype=torch.float32,
                        device=depth_cache.device).copy_(depth_cache)
    return (rgb.reshape((-1,) + rgb.shape[-3:]),
            depth.reshape((-1,) + depth.shape[-2:]))


# ---------------------------------------------------------------------------
# K1: every tile
# ---------------------------------------------------------------------------


def rasterize_tiles_batch(pairs, tile_starts, tile_ends, n_tiles_x: int,
                          n_tiles_y: int, bg=(0.0, 0.0, 0.0)):
    """Composite every (instance, tile) of a sorted pair table.

    pairs: (10, P) f32 [x, y, conic a/b/c, opacity, r, g, b, depth];
    tile_starts / tile_ends: (I, n_tiles) i32 pair ranges into P.
    Returns (rgb (I, 3, 8*n_tiles_y, 128*n_tiles_x), depth (I, Hp, Wp))."""
    return _composite_all(pairs, tile_starts, tile_ends, n_tiles_x,
                          n_tiles_y, bg, with_t=False)


def _composite_all(pairs, tile_starts, tile_ends, n_tiles_x: int,
                   n_tiles_y: int, bg, with_t: bool):
    """K1 (``tile_composite``) or, with ``with_t``, K7
    (``tile_composite_t``, which also returns the final transmittance)."""
    _check(pairs, tile_starts, tile_ends)
    if tile_starts.shape[1] != n_tiles_x * n_tiles_y:
        raise ValueError("tile_starts does not cover n_tiles_x * n_tiles_y")
    bg = tuple(float(b) for b in bg)
    if pairs.device.type != "cuda":
        return composite_tiles_plain(pairs, tile_starts, tile_ends,
                                     n_tiles_x, n_tiles_y, bg, with_t=with_t)
    n_inst = tile_starts.shape[0]
    h_pad, w_pad = n_tiles_y * TILE_H, n_tiles_x * TILE_W
    args = (pairs.contiguous(), tile_starts.contiguous(),
            tile_ends.contiguous(), n_tiles_x, n_tiles_y, bg[0], bg[1], bg[2])
    rgb = torch.empty((n_inst, 3, h_pad, w_pad), dtype=torch.float32,
                      device=pairs.device)
    depth = torch.empty((n_inst, h_pad, w_pad), dtype=torch.float32,
                        device=pairs.device)
    if not with_t:
        ext.load().tile_composite(*args, rgb, depth)
        ext.LAUNCHES["tile_composite"] += 1
        return rgb, depth
    t_fin = torch.empty_like(depth)
    ext.load().tile_composite_t(*args, rgb, depth, t_fin)
    ext.LAUNCHES["tile_composite_t"] += 1
    return rgb, depth, t_fin


def _tile_pixels(tiles, n_tiles_x: int, tile_w: int = TILE_W):
    """f32 pixel coordinates (px, py), each (n_g, 8, tile_w), of tiles[g]
    of a grid n_tiles_x tiles wide."""
    dev, tiles = tiles.device, tiles.long()
    shape = (tiles.shape[0], TILE_H, tile_w)
    px = ((tiles % n_tiles_x) * tile_w)[:, None, None] + torch.arange(
        tile_w, device=dev)[None, None, :]
    py = ((tiles // n_tiles_x) * TILE_H)[:, None, None] + torch.arange(
        TILE_H, device=dev)[None, :, None]
    return (px.to(torch.float32).expand(shape),
            py.to(torch.float32).expand(shape))


def _blend_tiles_plain(pairs, starts, ends, tiles, n_tiles_x: int,
                      tile_w: int = TILE_W):
    """The front-to-back blend of K1, K2, K6 (8x128 tiles) and K4, K5
    (``tile_w`` 16) in plain PyTorch: tile ``tiles[g]`` over pair range
    [starts[g], ends[g]) for every g at once, one tensor op per pair slot
    across all (g, 8, tile_w) pixels.
    Returns (Cr, Cg, Cb, T, D), each (n_g, 8, tile_w)."""
    dev = pairs.device
    starts, ends = starts.long(), ends.long()
    n_g = starts.shape[0]
    px, py = _tile_pixels(tiles, n_tiles_x, tile_w)

    shape = (n_g, TILE_H, tile_w)
    T = torch.ones(shape, dtype=torch.float32, device=dev)
    Cr = torch.zeros(shape, dtype=torch.float32, device=dev)
    Cg = torch.zeros_like(Cr)
    Cb = torch.zeros_like(Cr)
    D = torch.full(shape, MEDIAN_DEPTH_DEFAULT, dtype=torch.float32,
                   device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_max = int((ends - starts).max()) if n_g else 0
    for j in range(n_max):
        idx = starts + j
        in_range = idx < ends
        a = pairs[:, torch.where(in_range, idx, torch.zeros_like(idx))]
        a = a[:, :, None, None]                        # (10, n_g, 1, 1)
        dx = a[0] - px
        dy = a[1] - py
        power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
        alpha = torch.minimum(torch.full_like(power, ALPHA_MAX),
                              a[5] * torch.exp(power))
        alpha = torch.where((power <= 0.0) & in_range[:, None, None], alpha,
                            zero)
        alpha_ok = alpha >= ALPHA_MIN
        test_T = T * (1.0 - alpha)
        would_done = alpha_ok & (test_T < T_EPS)
        contrib = alpha_ok & ~would_done & ~done
        aT = torch.where(contrib, alpha * T, zero)
        Cr = Cr + aT * a[6]
        Cg = Cg + aT * a[7]
        Cb = Cb + aT * a[8]
        D = torch.where(contrib & (T > 0.5) & (test_T < 0.5),
                        a[9].expand(shape), D)
        T = torch.where(contrib, test_T, T)
        done = done | would_done
    return Cr, Cg, Cb, T, D


def _to_image(v, n_inst: int, n_tiles_x: int, n_tiles_y: int,
              tile_w: int = TILE_W):
    """(I * n_tiles, 8, tile_w) tiles -> (I, Hp, Wp) frames."""
    return (v.reshape(n_inst, n_tiles_y, n_tiles_x, TILE_H, tile_w)
            .permute(0, 1, 3, 2, 4)
            .reshape(n_inst, n_tiles_y * TILE_H, n_tiles_x * tile_w))


def _to_tiles(v, n_tiles_x: int, n_tiles_y: int):
    """(I, Hp, Wp) frames -> (I * n_tiles, 8, 128) tiles."""
    return (v.reshape(-1, n_tiles_y, TILE_H, n_tiles_x, TILE_W)
            .permute(0, 1, 3, 2, 4).reshape(-1, TILE_H, TILE_W))


def composite_tiles_plain(pairs, tile_starts, tile_ends, n_tiles_x: int,
                          n_tiles_y: int, bg=(0.0, 0.0, 0.0),
                          with_t: bool = False, tile_w: int = TILE_W):
    """Plain PyTorch version of K1, of K7 with ``with_t`` (the final
    transmittance as a third output), and of K4 with ``tile_w`` 16 (a grid
    of n_tiles_x fine tiles). Differentiable in ``pairs`` by autograd."""
    n_inst, n_tiles = tile_starts.shape
    tiles = torch.arange(n_inst * n_tiles, device=pairs.device) % n_tiles
    Cr, Cg, Cb, T, D = _blend_tiles_plain(pairs, tile_starts.reshape(-1),
                                          tile_ends.reshape(-1), tiles,
                                          n_tiles_x, tile_w)

    def to_image(v):
        return _to_image(v, n_inst, n_tiles_x, n_tiles_y, tile_w)

    rgb = torch.stack([to_image(Cr + T * bg[0]), to_image(Cg + T * bg[1]),
                       to_image(Cb + T * bg[2])], dim=1)
    if with_t:
        return rgb, to_image(D), to_image(T)
    return rgb, to_image(D)


def block_cull_keep(attrs, bx0, by0, box_w: int = BLOCK_W,
                    box_h: int = TILE_H):
    """The block test of K1, K2, K6, K7, K8 (8x16 blocks) and K4, K5 (their
    warp boxes) in PyTorch (``block_keep`` of csrc/tile_blend.cuh, the same
    operations in f32), for the tests and chip_smoke.py: False only where
    the pair of ``attrs`` ((10, ...) f32 lanes [x, y, conic a/b/c, opacity,
    ...]) adds nothing to any pixel of the box of box_h rows x box_w
    columns whose first pixel is (bx0, by0) (f32 tensors broadcast against
    attrs[0]): the binning's exact conic cull on the box
    (``binning._exact_cull_keep``) against 2 ln(255 op) + CULL_ABS +
    CULL_REL * |a| X^2 + 2 |b| X Y + |c| Y^2, (X, Y) the box's far corner
    from the splat. A conic that is not positive definite, a non-finite
    attribute or a negative opacity is always kept."""
    gx, gy, ca, cb, cc, op = (attrs[i] for i in range(6))
    regular = ((ca >= 1e-20) & (cc >= 1e-20) & (ca * cc - cb * cb > 0.0)
               & (op >= 0.0) & torch.isfinite(gx + gy + ca + cb + cc + op))
    lx = bx0 - gx
    ux = lx + float(box_w - 1)
    ly = by0 - gy
    uy = ly + float(box_h - 1)
    ica, icc = 1.0 / ca, 1.0 / cc

    def q(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def cl(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    zero = torch.zeros_like(lx)
    q0 = q(cl(zero, lx, ux), cl(zero, ly, uy))
    q1 = q(lx, cl(-cb * lx * icc, ly, uy))
    q2 = q(ux, cl(-cb * ux * icc, ly, uy))
    q3 = q(cl(-cb * ly * ica, lx, ux), ly)
    q4 = q(cl(-cb * uy * ica, lx, ux), uy)
    qmin = torch.minimum(torch.minimum(torch.minimum(q0, q1),
                                       torch.minimum(q2, q3)), q4)
    X = torch.maximum(lx.abs(), ux.abs())
    Y = torch.maximum(ly.abs(), uy.abs())
    mag = ca * X * X + 2.0 * cb.abs() * X * Y + cc * Y * Y
    thr = (2.0 * torch.log(255.0 * torch.clamp(op, min=1e-12)) + CULL_ABS
           + CULL_REL * mag)
    return ~regular | ~(qmin > thr)


# ---------------------------------------------------------------------------
# K7: every tile, with the final transmittance
# ---------------------------------------------------------------------------


def rasterize_tiles_batch_t(pairs, tile_starts, tile_ends, n_tiles_x: int,
                            n_tiles_y: int, bg=(0.0, 0.0, 0.0)):
    """``rasterize_tiles_batch`` plus the final transmittance: returns
    (rgb (I, 3, Hp, Wp), depth (I, Hp, Wp), t_fin (I, Hp, Wp)), rgb and
    depth bitwise K1's. t_fin is the backward's residual (renderer/
    diff.py)."""
    return _composite_all(pairs, tile_starts, tile_ends, n_tiles_x,
                          n_tiles_y, bg, with_t=True)


# ---------------------------------------------------------------------------
# K8: the per-pair gradients of K7's outputs
# ---------------------------------------------------------------------------


def _check_frame(name, t, device, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape} float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, pairs on {device}")


def composite_backward(pairs, tile_starts, tile_ends, dl_rgb, dl_depth,
                       c_fin, t_fin, bg=(0.0, 0.0, 0.0)):
    """Per-pair gradients of K7's (rgb, depth) by one front-to-back re-walk
    of every tile (the suffix identity, csrc/tile_backward.cu).

    pairs, tile_starts, tile_ends: K7's inputs; dl_rgb (I, 3, Hp, Wp) and
    dl_depth (I, Hp, Wp): the cotangents of its outputs; c_fin: the
    bg-free colour rgb - t_fin * bg, and t_fin: K7's transmittance.
    Returns (10, P) f32 in the pair table's lane order [x, y, conic a/b/c,
    opacity, r, g, b, depth]; a pair its tile never reaches (every pixel
    frozen before it) has zero gradient."""
    _check(pairs, tile_starts, tile_ends)
    n_inst, n_tiles = tile_starts.shape
    h_pad, w_pad = tuple(dl_depth.shape[-2:])
    n_tiles_x, n_tiles_y = w_pad // TILE_W, h_pad // TILE_H
    if n_tiles != n_tiles_x * n_tiles_y or h_pad % TILE_H or w_pad % TILE_W:
        raise ValueError("the frames do not match the tile ranges")
    for name, t, shape in (("dl_rgb", dl_rgb, (n_inst, 3, h_pad, w_pad)),
                           ("dl_depth", dl_depth, (n_inst, h_pad, w_pad)),
                           ("c_fin", c_fin, (n_inst, 3, h_pad, w_pad)),
                           ("t_fin", t_fin, (n_inst, h_pad, w_pad))):
        _check_frame(name, t, pairs.device, shape)
    bg = tuple(float(b) for b in bg)
    if pairs.device.type != "cuda":
        return composite_backward_plain(pairs, tile_starts, tile_ends,
                                        dl_rgb, dl_depth, c_fin, t_fin, bg)
    grads = torch.zeros_like(pairs)
    ext.load().tile_backward(pairs.contiguous(), tile_starts.contiguous(),
                             tile_ends.contiguous(),
                             longest_first(tile_starts, tile_ends), n_tiles_x,
                             n_tiles_y, dl_rgb.contiguous(),
                             dl_depth.contiguous(), c_fin.contiguous(),
                             t_fin.contiguous(), bg[0], bg[1], bg[2], grads)
    ext.LAUNCHES["tile_backward"] += 1
    return grads


def _alpha_grad_gate(araw):
    """Where d(alpha)/d(opacity, power) passes: the 0.99 clamp inactive."""
    return araw < ALPHA_MAX


def composite_backward_plain(pairs, tile_starts, tile_ends, dl_rgb,
                             dl_depth, c_fin, t_fin, bg=(0.0, 0.0, 0.0)):
    """Plain PyTorch version of K8: the forward's walk of
    ``_blend_tiles_plain`` recomputing T and the prefix colour, one tensor
    op per pair slot across all (tile, 8, 128) pixels, each pair's ten
    gradient terms summed over its tile's pixels."""
    dev = pairs.device
    n_inst, n_tiles = tile_starts.shape
    h_pad, w_pad = tuple(dl_depth.shape[-2:])
    n_tiles_x, n_tiles_y = w_pad // TILE_W, h_pad // TILE_H
    starts = tile_starts.reshape(-1).long()
    ends = tile_ends.reshape(-1).long()
    n_g = starts.shape[0]
    px, py = _tile_pixels(torch.arange(n_g, device=dev) % n_tiles, n_tiles_x)

    def tiles_of(v):
        return _to_tiles(v, n_tiles_x, n_tiles_y)

    dl = [tiles_of(dl_rgb[:, c]) for c in range(3)]
    dld = tiles_of(dl_depth)
    tf = tiles_of(t_fin)
    cf = [tiles_of(c_fin[:, c]) + bg[c] * tf for c in range(3)]

    shape = (n_g, TILE_H, TILE_W)
    T = torch.ones(shape, dtype=torch.float32, device=dev)
    P = [torch.zeros(shape, dtype=torch.float32, device=dev)
         for _ in range(3)]
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    grads = torch.zeros_like(pairs)
    n_max = int((ends - starts).max()) if n_g else 0
    for j in range(n_max):
        idx = starts + j
        in_range = idx < ends
        a = pairs[:, torch.where(in_range, idx, torch.zeros_like(idx))]
        a = a[:, :, None, None]                        # (10, n_g, 1, 1)
        dx = a[0] - px
        dy = a[1] - py
        power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
        gexp = torch.exp(power)
        araw = a[5] * gexp
        alpha = torch.minimum(torch.full_like(power, ALPHA_MAX), araw)
        alpha = torch.where((power <= 0.0) & in_range[:, None, None], alpha,
                            zero)
        alpha_ok = alpha >= ALPHA_MIN
        test_T = T * (1.0 - alpha)
        would_done = alpha_ok & (test_T < T_EPS)
        contrib = alpha_ok & ~would_done & ~done
        aT = torch.where(contrib, alpha * T, zero)
        P = [P[c] + aT * a[6 + c] for c in range(3)]
        inv1 = 1.0 / (1.0 - alpha)
        dal = torch.where(
            contrib,
            dl[0] * (a[6] * T - (cf[0] - P[0]) * inv1)
            + dl[1] * (a[7] * T - (cf[1] - P[1]) * inv1)
            + dl[2] * (a[8] * T - (cf[2] - P[2]) * inv1), zero)
        gate = _alpha_grad_gate(araw)
        dpow = torch.where(gate, dal * araw, zero)
        dop = torch.where(gate, dal * gexp, zero)
        crossing = contrib & (T > 0.5) & (test_T < 0.5)
        terms = torch.stack([
            dpow * (-(a[2] * dx + a[3] * dy)),
            dpow * (-(a[4] * dy + a[3] * dx)),
            dpow * (-0.5 * dx * dx),
            dpow * (-dx * dy),
            dpow * (-0.5 * dy * dy),
            dop, dl[0] * aT, dl[1] * aT, dl[2] * aT,
            torch.where(crossing, dld, zero)])         # (10, n_g, 8, 128)
        g = terms.sum(dim=(2, 3))
        grads[:, idx[in_range]] = g[:, in_range]
        T = torch.where(contrib, test_T, T)
        done = done | would_done
    return grads


# ---------------------------------------------------------------------------
# K2: the dirty tiles of a list, over a merged pair table
# ---------------------------------------------------------------------------


def rasterize_tiles_sparse(pairs, inst_ids, tile_ids, starts, ends,
                           rgb_cache, depth_cache, n_tiles_x: int,
                           n_tiles_y: int, bg=(0.0, 0.0, 0.0),
                           cache_index=None):
    """Re-composite the dirty tiles of a list on top of cached frames.

    pairs: (10, P) f32 merged pair table; inst_ids / tile_ids / starts /
    ends: (n_dirty,) i32, entry k re-composites tile tile_ids[k] of
    instance inst_ids[k] from pairs[starts[k]:ends[k]]; rgb_cache
    (..., 3, Hp, Wp) and depth_cache (..., Hp, Wp): the cached frames of
    the I instances (leading dims flatten to I; broadcast views are fine),
    or with ``cache_index`` (I,) i64 a table of frames of which instance i
    takes frame ``cache_index[i]`` (``copy_frames``).
    Returns new (rgb (I, 3, Hp, Wp), depth (I, Hp, Wp)): a copy of the
    caches with the listed tiles re-composited, every other pixel kept."""
    _check_table("pairs", pairs)
    _check_dirty(pairs.device, {"inst_ids": inst_ids, "tile_ids": tile_ids,
                                "starts": starts, "ends": ends})
    _check_caches(pairs.device, rgb_cache, depth_cache, n_tiles_x,
                  n_tiles_y)
    bg = tuple(float(b) for b in bg)
    if pairs.device.type != "cuda":
        return composite_sparse_plain(pairs, inst_ids, tile_ids, starts,
                                      ends, rgb_cache, depth_cache,
                                      n_tiles_x, n_tiles_y, bg,
                                      cache_index=cache_index)
    rgb, depth = copy_frames(rgb_cache, depth_cache, cache_index)
    if inst_ids.shape[0]:
        ext.load().tile_sparse(pairs.contiguous(), inst_ids.contiguous(),
                               tile_ids.contiguous(), starts.contiguous(),
                               ends.contiguous(), n_tiles_x, n_tiles_y,
                               bg[0], bg[1], bg[2], rgb, depth)
        ext.LAUNCHES["tile_sparse"] += 1
    return rgb, depth


def composite_sparse_plain(pairs, inst_ids, tile_ids, starts, ends,
                           rgb_cache, depth_cache, n_tiles_x: int,
                           n_tiles_y: int, bg=(0.0, 0.0, 0.0),
                           tile_w: int = TILE_W, cache_index=None):
    """Plain PyTorch version of K2, and of K5 with ``tile_w`` 16 (a grid of
    n_tiles_x fine tiles): K1's blend over the listed tiles only, written
    into a copy of the cached frames."""
    rgb, depth = copy_frames(rgb_cache, depth_cache, cache_index)
    if not inst_ids.shape[0]:
        return rgb, depth
    Cr, Cg, Cb, T, D = _blend_tiles_plain(pairs, starts, ends, tile_ids,
                                          n_tiles_x, tile_w)
    inst, tiles = inst_ids.long(), tile_ids.long()
    ty, tx = tiles // n_tiles_x, tiles % n_tiles_x
    rgb6 = rgb.view(rgb.shape[0], 3, n_tiles_y, TILE_H, n_tiles_x, tile_w)
    dep5 = depth.view(depth.shape[0], n_tiles_y, TILE_H, n_tiles_x, tile_w)
    rgb6[inst, :, ty, :, tx, :] = torch.stack(
        [Cr + T * bg[0], Cg + T * bg[1], Cb + T * bg[2]], dim=1)
    dep5[inst, ty, :, tx, :] = D
    return rgb, depth


# ---------------------------------------------------------------------------
# K6: the dirty tiles, merging static and dynamic segments in the kernel
# ---------------------------------------------------------------------------


def _depth_order_key(depth):
    """int64 in [0, 2^32) ordered as the f32 depths are."""
    b = depth.contiguous().view(torch.int32).long()
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b) + (1 << 31)


def merge_segments(data_s, s_starts, s_ends, data_d, d_starts, d_ends):
    """Merge, per dirty-list entry k, the depth-sorted static segment
    data_s[:, s_starts[k]:s_ends[k]] and dynamic segment
    data_d[:, d_starts[k]:d_ends[k]] into one depth order: a dynamic pair
    goes before a static pair of equal depth, and each stream keeps its
    own order (the full pipeline's stable depth sort of the [dynamic;
    static] scene). One stable sort of the rows of all entries by
    (entry, depth), the dynamic rows first in its input.

    Returns (merged (10, P_m) f32, starts (n_dirty,) i32, ends (n_dirty,)
    i32 ranges of each entry in ``merged``)."""
    dev = data_s.device
    ls = (s_ends - s_starts).clamp(min=0).long()
    ld = (d_ends - d_starts).clamp(min=0).long()
    entry = torch.arange(ls.shape[0], device=dev)

    def rows(seg_starts, lens):
        total = int(lens.sum())
        e = torch.repeat_interleave(entry, lens, output_size=total)
        first = torch.cumsum(lens, 0) - lens
        return e, seg_starts.long()[e] + torch.arange(total, device=dev) \
            - first[e]

    e_d, src_d = rows(d_starts, ld)
    e_s, src_s = rows(s_starts, ls)
    key = (torch.cat([e_d, e_s]) << 32) | _depth_order_key(torch.cat(
        [data_d[DEPTH_LANE, src_d], data_s[DEPTH_LANE, src_s]]))
    perm = torch.sort(key, stable=True).indices
    merged = torch.cat([data_d[:, src_d], data_s[:, src_s]], dim=1)[:, perm]
    ends = torch.cumsum(ls + ld, 0)
    return (merged.contiguous(), (ends - ls - ld).to(torch.int32),
            ends.to(torch.int32))


def rasterize_tiles_sparse_merge(data_s, data_d, inst_ids, tile_ids,
                                 s_starts, s_ends, d_starts, d_ends,
                                 rgb_cache, depth_cache, n_tiles_x: int,
                                 n_tiles_y: int, bg=(0.0, 0.0, 0.0),
                                 cache_index=None):
    """As ``rasterize_tiles_sparse``, but entry k blends the merge of the
    static segment data_s[:, s_starts[k]:s_ends[k]] and the dynamic segment
    data_d[:, d_starts[k]:d_ends[k]] (both (10, P) f32 tables whose
    segments are depth-sorted), without materializing the merged table:
    a dynamic pair goes first on equal depth."""
    _check_table("data_s", data_s)
    _check_table("data_d", data_d)
    if data_d.device != data_s.device:
        raise ValueError(f"data_d is on {data_d.device}, data_s on "
                         f"{data_s.device}")
    _check_dirty(data_s.device, {
        "inst_ids": inst_ids, "tile_ids": tile_ids, "s_starts": s_starts,
        "s_ends": s_ends, "d_starts": d_starts, "d_ends": d_ends})
    _check_caches(data_s.device, rgb_cache, depth_cache, n_tiles_x,
                  n_tiles_y)
    bg = tuple(float(b) for b in bg)
    if data_s.device.type != "cuda":
        return composite_sparse_merge_plain(
            data_s, data_d, inst_ids, tile_ids, s_starts, s_ends, d_starts,
            d_ends, rgb_cache, depth_cache, n_tiles_x, n_tiles_y, bg,
            cache_index=cache_index)
    rgb, depth = copy_frames(rgb_cache, depth_cache, cache_index)
    if inst_ids.shape[0]:
        ext.load().tile_sparse_merge(
            data_s.contiguous(), data_d.contiguous(), inst_ids.contiguous(),
            tile_ids.contiguous(), s_starts.contiguous(), s_ends.contiguous(),
            d_starts.contiguous(), d_ends.contiguous(), n_tiles_x, n_tiles_y,
            bg[0], bg[1], bg[2], rgb, depth)
        ext.LAUNCHES["tile_sparse_merge"] += 1
    return rgb, depth


def composite_sparse_merge_plain(data_s, data_d, inst_ids, tile_ids,
                                 s_starts, s_ends, d_starts, d_ends,
                                 rgb_cache, depth_cache, n_tiles_x: int,
                                 n_tiles_y: int, bg=(0.0, 0.0, 0.0),
                                 cache_index=None):
    """Plain PyTorch version of K6: the merged order built by
    ``merge_segments``, then K2's plain blend."""
    merged, starts, ends = merge_segments(data_s, s_starts, s_ends, data_d,
                                          d_starts, d_ends)
    return composite_sparse_plain(merged, inst_ids, tile_ids, starts, ends,
                                  rgb_cache, depth_cache, n_tiles_x,
                                  n_tiles_y, bg, cache_index=cache_index)
