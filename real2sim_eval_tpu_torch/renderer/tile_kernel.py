"""Tile compositor K1: front-to-back splat blending per (instance, tile).

Counterpart of the TPU kernel ``rasterize_tiles_batch``
(the JAX package's renderer/tile_kernel.py). ``rasterize_tiles_batch``
launches the hand-written CUDA kernel (``csrc/tile_composite.cu``) for
tensors on the card and runs ``composite_tiles_plain``, the plain PyTorch
version of the same function, for tensors on the CPU.

Semantics (renderCUDA / the TPU kernel's ``_composite_scoped``):
alpha = min(0.99, o * exp(power)), skipped unless power <= 0 and
alpha >= 1/255; a pixel freezes when T would fall below 1e-4; the median
depth is the pair depth at the T = 0.5 crossing, else 15.0; out = C + T*bg.
"""

from __future__ import annotations

import torch

from .. import ext

TILE_H = 8
TILE_W = 128
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
MEDIAN_DEPTH_DEFAULT = 15.0


def _check(pairs, starts, ends):
    if pairs.dtype != torch.float32 or pairs.dim() != 2 or pairs.shape[0] != 10:
        raise ValueError(f"pairs must be (10, P) float32, got "
                         f"{tuple(pairs.shape)} {pairs.dtype}")
    for name, t in (("tile_starts", starts), ("tile_ends", ends)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be (I, n_tiles) int32")
        if t.device != pairs.device:
            raise ValueError(f"{name} is on {t.device}, pairs on "
                             f"{pairs.device}")
    if starts.shape != ends.shape:
        raise ValueError("tile_starts and tile_ends differ in shape")


def rasterize_tiles_batch(pairs, tile_starts, tile_ends, n_tiles_x: int,
                          n_tiles_y: int, bg=(0.0, 0.0, 0.0)):
    """Composite every (instance, tile) of a sorted pair table.

    pairs: (10, P) f32 [x, y, conic a/b/c, opacity, r, g, b, depth];
    tile_starts / tile_ends: (I, n_tiles) i32 pair ranges into P.
    Returns (rgb (I, 3, 8*n_tiles_y, 128*n_tiles_x), depth (I, Hp, Wp))."""
    _check(pairs, tile_starts, tile_ends)
    if tile_starts.shape[1] != n_tiles_x * n_tiles_y:
        raise ValueError("tile_starts does not cover n_tiles_x * n_tiles_y")
    bg = tuple(float(b) for b in bg)
    if pairs.device.type != "cuda":
        return composite_tiles_plain(pairs, tile_starts, tile_ends,
                                     n_tiles_x, n_tiles_y, bg)
    n_inst = tile_starts.shape[0]
    h_pad, w_pad = n_tiles_y * TILE_H, n_tiles_x * TILE_W
    pairs = pairs.contiguous()
    starts = tile_starts.contiguous()
    ends = tile_ends.contiguous()
    rgb = torch.empty((n_inst, 3, h_pad, w_pad), dtype=torch.float32,
                      device=pairs.device)
    depth = torch.empty((n_inst, h_pad, w_pad), dtype=torch.float32,
                        device=pairs.device)
    ext.load().tile_composite(pairs, starts, ends, n_tiles_x, n_tiles_y,
                              bg[0], bg[1], bg[2], rgb, depth)
    ext.LAUNCHES["tile_composite"] += 1
    return rgb, depth


def composite_tiles_plain(pairs, tile_starts, tile_ends, n_tiles_x: int,
                          n_tiles_y: int, bg=(0.0, 0.0, 0.0)):
    """Plain PyTorch version of the compositor: the same front-to-back blend
    over a padded pair index, one tensor op per pair slot across all
    (tile, 8, 128) pixels at once."""
    dev = pairs.device
    n_inst, n_tiles = tile_starts.shape
    starts = tile_starts.reshape(-1).long()
    ends = tile_ends.reshape(-1).long()
    n_g = starts.shape[0]
    t = torch.arange(n_g, device=dev) % n_tiles
    px = ((t % n_tiles_x) * TILE_W)[:, None, None] + torch.arange(
        TILE_W, device=dev)[None, None, :]
    py = ((t // n_tiles_x) * TILE_H)[:, None, None] + torch.arange(
        TILE_H, device=dev)[None, :, None]
    px = px.to(torch.float32).expand(n_g, TILE_H, TILE_W)
    py = py.to(torch.float32).expand(n_g, TILE_H, TILE_W)

    shape = (n_g, TILE_H, TILE_W)
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

    def to_image(v):            # (n_g, 8, 128) -> (I, Hp, Wp)
        return (v.reshape(n_inst, n_tiles_y, n_tiles_x, TILE_H, TILE_W)
                .permute(0, 1, 3, 2, 4)
                .reshape(n_inst, n_tiles_y * TILE_H, n_tiles_x * TILE_W))

    rgb = torch.stack([to_image(Cr + T * bg[0]), to_image(Cg + T * bg[1]),
                       to_image(Cb + T * bg[2])], dim=1)
    return rgb, to_image(D)
