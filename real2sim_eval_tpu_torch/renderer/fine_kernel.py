"""Fine-tile compositors: front-to-back splat blending per 8x16 fine tile.

Counterparts of the two remaining TPU kernels of the JAX package, each a
wrapper that launches a hand-written CUDA kernel for tensors on the card
and runs the plain PyTorch version of the same function for tensors on the
CPU:

  - K4 ``rasterize_fine_batch`` (``csrc/fine_composite.cu``; JAX
    renderer/fine_kernel.py): every fine tile of every instance over a
    pair table sorted by [instance | fine tile | depth rank]
    (binning.bin_gaussians_fine);
  - K5 ``rasterize_fine_sparse`` (``csrc/fine_sparse.cu``; JAX
    renderer/incremental_fine.py): only the dirty fine tiles of a list,
    over a merged pair table, on top of a copy of cached frames.

A frame is n_sup_x x n_sup_y wide 8x128 tiles ("supertiles"), each cut
into GROUPS = 8 fine tiles of 8x16 pixels; fine tile f = ty * (8 n_sup_x)
+ tx covers pixels [16 tx, 16 tx + 16) x [8 ty, 8 ty + 8), so f // 8 is
its supertile. The blend is the wide compositors' (tile_kernel.py): only
the tile, and so the 3-sigma rect a splat is cut at, is smaller. Both
kernels give each warp a QUAD_H x QUAD_W quadrant of the fine tile and let
it blend only the pairs that ``tile_kernel.block_cull_keep`` keeps for the
quadrant (the fine binning does not cull by the conic), and their CTAs take
the fine tiles longest first (``tile_kernel.longest_first``); their frames
are bitwise the plain versions'.

What the TPU kernel does for its vector unit is not carried over: eight
fine streams walked in lockstep per program, grouped by length and
scattered back, the attribute-major pair packing and its matrix-unit
expansion, the scalar-prefetch instance split and the DMA over-read pad.
"""

from __future__ import annotations

import torch

from .. import ext
from .tile_kernel import (FINE_W, GROUPS, TILE_H, TILE_W, _check,
                          _check_caches, _check_dirty, _check_table,
                          composite_sparse_plain, composite_tiles_plain,
                          copy_frames, longest_first)

FINE_H = TILE_H
# a warp's quadrant of the fine tile in K4 and K5 (csrc/tile_blend.cuh
# kQuadH, kQuadW)
QUAD_H = 4
QUAD_W = 8


def rasterize_fine_batch(pairs, fine_starts, fine_ends, n_sup_x: int,
                         n_sup_y: int, bg=(0.0, 0.0, 0.0)):
    """Composite every (instance, fine tile) of a sorted pair table.

    pairs: (10, P) f32 [x, y, conic a/b/c, opacity, r, g, b, depth];
    fine_starts / fine_ends: (I, 8 * n_sup_x * n_sup_y) i32 pair ranges
    into P. Returns (rgb (I, 3, 8 * n_sup_y, 128 * n_sup_x), depth (I, Hp,
    Wp))."""
    _check(pairs, fine_starts, fine_ends)
    n_fine_x = n_sup_x * GROUPS
    if fine_starts.shape[1] != n_fine_x * n_sup_y:
        raise ValueError("fine_starts does not cover 8 * n_sup_x * n_sup_y "
                         "fine tiles")
    bg = tuple(float(b) for b in bg)
    if pairs.device.type != "cuda":
        return composite_fine_plain(pairs, fine_starts, fine_ends, n_sup_x,
                                    n_sup_y, bg)
    n_inst = fine_starts.shape[0]
    rgb = torch.empty((n_inst, 3, n_sup_y * TILE_H, n_sup_x * TILE_W),
                      dtype=torch.float32, device=pairs.device)
    depth = torch.empty((n_inst, n_sup_y * TILE_H, n_sup_x * TILE_W),
                        dtype=torch.float32, device=pairs.device)
    ext.load().fine_composite(pairs.contiguous(), fine_starts.contiguous(),
                              fine_ends.contiguous(),
                              longest_first(fine_starts, fine_ends), n_fine_x,
                              n_sup_y, bg[0], bg[1], bg[2], rgb, depth)
    ext.LAUNCHES["fine_composite"] += 1
    return rgb, depth


def composite_fine_plain(pairs, fine_starts, fine_ends, n_sup_x: int,
                         n_sup_y: int, bg=(0.0, 0.0, 0.0)):
    """Plain PyTorch version of K4: the wide compositors' plain blend on
    8x16 tiles."""
    return composite_tiles_plain(pairs, fine_starts, fine_ends,
                                 n_sup_x * GROUPS, n_sup_y, bg,
                                 tile_w=FINE_W)


def rasterize_fine_sparse(pairs, inst_ids, tile_ids, starts, ends,
                          rgb_cache, depth_cache, n_sup_x: int, n_sup_y: int,
                          bg=(0.0, 0.0, 0.0), cache_index=None):
    """Re-composite the dirty fine tiles of a list on top of cached frames.

    pairs: (10, P) f32 merged pair table; inst_ids / tile_ids / starts /
    ends: (n_dirty,) i32, entry k re-composites fine tile tile_ids[k] of
    instance inst_ids[k] from pairs[starts[k]:ends[k]]; rgb_cache
    (..., 3, Hp, Wp) and depth_cache (..., Hp, Wp): the cached frames of
    the I instances (leading dims flatten to I; broadcast views are fine),
    or with ``cache_index`` a table of frames as ``tile_kernel.
    rasterize_tiles_sparse`` takes it.
    Returns new (rgb (I, 3, Hp, Wp), depth (I, Hp, Wp)): a copy of the
    caches with the listed fine tiles re-composited, every other pixel
    kept."""
    n_fine_x = n_sup_x * GROUPS
    _check_table("pairs", pairs)
    _check_dirty(pairs.device, {"inst_ids": inst_ids, "tile_ids": tile_ids,
                                "starts": starts, "ends": ends})
    _check_caches(pairs.device, rgb_cache, depth_cache, n_fine_x, n_sup_y,
                  FINE_W)
    bg = tuple(float(b) for b in bg)
    if pairs.device.type != "cuda":
        return composite_fine_sparse_plain(pairs, inst_ids, tile_ids, starts,
                                           ends, rgb_cache, depth_cache,
                                           n_sup_x, n_sup_y, bg,
                                           cache_index=cache_index)
    rgb, depth = copy_frames(rgb_cache, depth_cache, cache_index)
    if inst_ids.shape[0]:
        ext.load().fine_sparse(pairs.contiguous(), inst_ids.contiguous(),
                               tile_ids.contiguous(), starts.contiguous(),
                               ends.contiguous(), longest_first(starts, ends),
                               n_fine_x, n_sup_y, bg[0], bg[1], bg[2], rgb,
                               depth)
        ext.LAUNCHES["fine_sparse"] += 1
    return rgb, depth


def composite_fine_sparse_plain(pairs, inst_ids, tile_ids, starts, ends,
                                rgb_cache, depth_cache, n_sup_x: int,
                                n_sup_y: int, bg=(0.0, 0.0, 0.0),
                                cache_index=None):
    """Plain PyTorch version of K5: K4's plain blend over the listed fine
    tiles only, written into a copy of the cached frames."""
    return composite_sparse_plain(pairs, inst_ids, tile_ids, starts, ends,
                                  rgb_cache, depth_cache, n_sup_x * GROUPS,
                                  n_sup_y, bg, tile_w=FINE_W,
                                  cache_index=cache_index)
