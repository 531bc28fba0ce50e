"""Tile binning with exactly sized pair buffers.

Counterpart of the JAX package's renderer/binning.py (``bin_gaussians``)
and renderer/binning_fine.py (``bin_gaussians_fine``), batched over
instances. The TPU version fits every pair into static budgets (a
per-gaussian rect clamp, a dense slot block plus grant tiers, a cropped
pair buffer) and reports what those budgets drop. Here the buffers are
sized from the data, as the CUDA rasterizer's prefix sum does: count each
gaussian's tile rect, prefix-sum, emit every (gaussian, tile) slot, drop
the slots the exact conic cull proves blank, then one sort by the unique
key [instance | tile | depth rank] (the depth rank comes from a stable
depth sort, so equal depths tie-break by gaussian index, as in the TPU
version). Nothing is ever dropped: ``n_large_dropped`` keeps the TPU
telemetry's shape and is always 0.

The fine binning cuts the frame into 8x16 fine tiles, 8 to a wide 8x128
tile, and has no conic cull: the JAX fine binner counts every cell of a
gaussian's fine rect (its stream bounds are analytic), so its pair table
holds the slots the cull would drop. The pixels are the same either way
(such a pair is rejected per pixel by the alpha floor); the pair table is
not, and the port's is held to JAX's bitwise. With budgets that cover
every rect, the JAX fine binner's centred rect clamp is the identity, so
the two agree slot for slot.

Pair attributes are structure-of-arrays, (10, P) f32 in the order
[x, y, conic a, conic b, conic c, opacity, r, g, b, depth]; the TPU's
8-pairs-per-128-lane packing is a DMA device the card does not need.
"""

from __future__ import annotations

import torch

from .preprocess import tile_rect
from .tile_kernel import FINE_W, GROUPS, TILE_H

N_ATTR = 10


def pair_attr_table(pre: dict) -> torch.Tensor:
    """(10, ..., N) per-gaussian attribute lanes in the pair-table order."""
    return torch.stack([
        pre["xy"][..., 0], pre["xy"][..., 1],
        pre["conic"][..., 0], pre["conic"][..., 1], pre["conic"][..., 2],
        pre["opacity"], pre["rgb"][..., 0], pre["rgb"][..., 1],
        pre["rgb"][..., 2], pre["depth"],
    ]).to(torch.float32)


def _exact_cull_keep(attrs, tx, ty, q_thr, tile_w, tile_h):
    """True where the (gaussian, tile) slot can reach alpha >= 1/255 at
    some pixel of the tile: the minimum of the conic quadratic over the
    tile's pixel box (clamped optimum or one of four edge stationary
    points) against the per-gaussian threshold. Same formulas, same
    evaluation order as the TPU binning's cull."""
    gx, gy, ca, cb, cc0 = attrs[0], attrs[1], attrs[2], attrs[3], attrs[4]
    cc = torch.clamp(cc0, min=1e-12)
    caf = torch.clamp(ca, min=1e-12)
    lx = (tx * tile_w).to(torch.float32) - gx
    ux = lx + (tile_w - 1)
    ly = (ty * tile_h).to(torch.float32) - gy
    uy = ly + (tile_h - 1)

    def q(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def cl(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    zero = torch.zeros_like(lx)
    q0 = q(cl(zero, lx, ux), cl(zero, ly, uy))
    q1 = q(lx, cl(-cb * lx / cc, ly, uy))
    q2 = q(ux, cl(-cb * ux / cc, ly, uy))
    q3 = q(cl(-cb * ly / caf, lx, ux), ly)
    q4 = q(cl(-cb * uy / caf, lx, ux), uy)
    qmin = torch.minimum(torch.minimum(torch.minimum(q0, q1),
                                       torch.minimum(q2, q3)), q4)
    return qmin <= q_thr


def bin_gaussians(pre: dict, n_tiles_x: int, n_tiles_y: int, tile_w: int,
                  tile_h: int, cull: bool = True) -> dict:
    """Depth-sorted per-tile pair tables for I instances.

    Args:
      pre: preprocess_gaussians output with leading (I, N) dims.
      cull: drop the (gaussian, tile) slots the exact conic cull proves
        blank (the wide binning); False keeps every cell of each valid
        gaussian's tile rect (the fine binning).
    Returns dict with:
      pair_attrs: (10, P) f32 sorted pair attributes, instance-major;
      pair_tile: (P,) i32 tile id per sorted pair;
      tile_starts / tile_ends: (I, n_tiles) i32 ranges into the P axis;
      n_pairs: (I,) i32 pairs per instance;
      n_large_dropped: (I,) i32, always 0 (buffers are exact).
    """
    xy, radius, valid = pre["xy"], pre["radius"], pre["valid"]
    n_inst, n = valid.shape
    dev = xy.device
    n_tiles = n_tiles_x * n_tiles_y

    # depth rank per gaussian; invalid sink to the end, equal depths keep
    # gaussian order (stable sort)
    depth_key = torch.where(valid, pre["depth"].to(torch.float32),
                            torch.full_like(pre["depth"], float("inf")))
    order = torch.sort(depth_key, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=dev).expand(n_inst, n))

    x0, y0, x1, y1 = tile_rect(xy, radius, n_tiles_x, n_tiles_y,
                               tile_w, tile_h)
    rect_w = (x1 - x0).reshape(-1).long()
    counts = torch.where(valid, (x1 - x0) * (y1 - y0),
                         torch.zeros_like(x0)).reshape(-1).long()
    total = int(counts.sum())

    # emit every rect slot: gaussian id (flat over instances) + slot index
    gid = torch.repeat_interleave(torch.arange(n_inst * n, device=dev),
                                  counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    d = torch.arange(total, device=dev) - first[gid]
    rw = torch.clamp(rect_w[gid], min=1)
    tx = x0.reshape(-1).long()[gid] + d % rw
    ty = y0.reshape(-1).long()[gid] + d // rw

    attrs = pair_attr_table(pre).reshape(N_ATTR, -1)          # (10, I*N)
    tile = ty * n_tiles_x + tx
    if cull:
        opac = attrs[5]
        q_thr = (2.0 * torch.log(255.0 * torch.clamp(opac, min=1e-12))
                 + 1e-3)
        keep = _exact_cull_keep(attrs[:, gid], tx, ty, q_thr[gid],
                                tile_w, tile_h)
        gid, tile = gid[keep], tile[keep]

    inst = gid // n
    gtile = inst * n_tiles + tile                  # global (instance, tile)
    key = (gtile << 32) | rank.reshape(-1)[gid]
    perm = torch.sort(key).indices                 # keys are unique
    gid, gtile = gid[perm], gtile[perm]

    per_tile = torch.bincount(gtile, minlength=n_inst * n_tiles)
    ends = torch.cumsum(per_tile, 0)
    starts = ends - per_tile
    return {
        "pair_attrs": attrs[:, gid].contiguous(),
        "pair_tile": (gtile % n_tiles).to(torch.int32),
        "tile_starts": starts.reshape(n_inst, n_tiles).to(torch.int32),
        "tile_ends": ends.reshape(n_inst, n_tiles).to(torch.int32),
        "n_pairs": torch.bincount(gid // n, minlength=n_inst).to(
            torch.int32),
        "n_large_dropped": torch.zeros(n_inst, dtype=torch.int32,
                                       device=dev),
    }


def bin_gaussians_fine(pre: dict, n_sup_x: int, n_sup_y: int) -> dict:
    """``bin_gaussians`` on the 8x16 fine tiles of a frame n_sup_x wide
    8x128 tiles by n_sup_y high, without the conic cull. Fine tile ids
    follow the JAX fine binner: f = ty * (8 n_sup_x) + tx, so f // 8 is the
    8x128 supertile (supertile-major). Same keys as ``bin_gaussians``; the
    tile ranges are the JAX binner's ``fine_starts`` / ``fine_ends``."""
    return bin_gaussians(pre, n_sup_x * GROUPS, n_sup_y, FINE_W, TILE_H,
                         cull=False)
