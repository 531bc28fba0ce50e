"""Differentiable Gaussian-splat rasterization.

Counterpart of the JAX package's renderer/diff.py: the forward is the
tile pipeline of ``rasterize`` (preprocess, exact binning) with K7, the
compositor that also writes the final transmittance, and the backward is
K8, one front-to-back re-walk per tile that yields every pair's gradient
from the suffix identity

    dC/dalpha_i = c_i T_i - (C_fin + bg T_fin - P_i) / (1 - alpha_i)

(P_i the prefix colour including pair i). Both run inside one
``torch.autograd.Function`` over the sorted pair table; the per-pair
gradients reach the gaussians through the binning's gather
``attrs[:, gid]`` (renderer/binning.py), whose autograd backward is the
segment sum the JAX package does with its gaussian-id lane, and through
the preprocess by autograd.

Subgradient conventions (those of the JAX package and of autograd through
the dense compositor): gradients flow only through contributing pairs;
the 0.99 alpha clamp zeroes d(alpha)/d(opacity, power) where active; the
median depth's cotangent flows to the one pair that crossed T = 0.5;
binning order, tile assignment and radius are locally constant.

The JAX package's chunk alignment of the pair table (``_align_pairs``)
and its ``max_pairs``/``chunk``/``interpret`` parameters have no
counterpart: each CTA of K8 writes only its own pair range, and the
buffers are sized from the data, so nothing is ever dropped.
"""

from __future__ import annotations

import torch

from .binning import bin_gaussians
from .camera import Camera
from .preprocess import preprocess_gaussians
from .raster import RasterConfig, _check_device, bg_tuple
from .tile_kernel import (TILE_H, TILE_W, composite_backward,
                          rasterize_tiles_batch_t)


class _CompositeDiff(torch.autograd.Function):
    """(10, P) sorted pair table -> (rgb (I, 3, Hp, Wp), depth (I, Hp,
    Wp)) by K7; the backward is K8."""

    @staticmethod
    def forward(ctx, pairs, starts, ends, n_tiles_x, n_tiles_y, bg):
        rgb, depth, t_fin = rasterize_tiles_batch_t(pairs, starts, ends,
                                                    n_tiles_x, n_tiles_y, bg)
        ctx.save_for_backward(pairs, starts, ends, rgb, t_fin)
        ctx.bg = bg
        return rgb, depth

    @staticmethod
    def backward(ctx, g_rgb, g_depth):
        pairs, starts, ends, rgb, t_fin = ctx.saved_tensors
        bg = torch.tensor(ctx.bg, dtype=torch.float32, device=rgb.device)
        c_fin = rgb - t_fin[:, None] * bg[None, :, None, None]
        g_rgb = torch.zeros_like(rgb) if g_rgb is None else g_rgb
        g_depth = torch.zeros_like(t_fin) if g_depth is None else g_depth
        grads = composite_backward(pairs, starts, ends, g_rgb, g_depth,
                                   c_fin, t_fin, ctx.bg)
        return grads, None, None, None, None, None


def rasterize_diff_views(cam: Camera, w2cs, means3d, scales, quats,
                         opacities, shs, sh_degree: int, bg=(0.0, 0.0, 0.0),
                         config: RasterConfig = RasterConfig(),
                         return_drops: bool = False, device="cuda"):
    """Differentiable render of ONE scene from C views in one K7 launch
    (and one K8 launch in the backward): (rgb (C, 3, H, W), depth (C, H,
    W)[, drops (C,) i32, always 0]). All views share ``cam``'s
    intrinsics; the rgb is not clipped.

    The scene tensors (N, ...) are broadcast over the views before the
    preprocess, so autograd sums the per-view gradients into them. Of
    ``config`` only ``backend="tiles"`` applies (the incremental and
    wrist-cull fields concern the evaluator)."""
    _check_device(means3d, device)
    if config.backend != "tiles":
        raise ValueError("the differentiable render runs the tile pipeline")
    dev = means3d.device
    w2cs = torch.as_tensor(w2cs, dtype=torch.float32, device=dev)
    n_views = w2cs.shape[0]

    def per_view(t):
        return t[None].expand((n_views,) + t.shape)

    shs = shs if sh_degree > 0 else shs[:, :1]
    pre = preprocess_gaussians(cam, w2cs, per_view(means3d), per_view(scales),
                               per_view(quats),
                               per_view(opacities.reshape(-1)),
                               per_view(shs), sh_degree)
    n_tx, n_ty = -(-cam.width // TILE_W), -(-cam.height // TILE_H)
    bins = bin_gaussians(pre, n_tx, n_ty, TILE_W, TILE_H)
    rgb, depth = _CompositeDiff.apply(bins["pair_attrs"], bins["tile_starts"],
                                      bins["tile_ends"], n_tx, n_ty,
                                      bg_tuple(bg))
    rgb = rgb[:, :, :cam.height, :cam.width]
    depth = depth[:, :cam.height, :cam.width]
    if return_drops:
        return rgb, depth, bins["n_large_dropped"]
    return rgb, depth


def rasterize_diff(cam: Camera, w2c, means3d, scales, quats, opacities, shs,
                   sh_degree: int, bg=(0.0, 0.0, 0.0),
                   config: RasterConfig = RasterConfig(),
                   return_drops: bool = False, device="cuda"):
    """Differentiable render of one camera: (rgb (3, H, W), depth (H, W)
    [, drops () i32, always 0]), pixel-identical to ``rasterize`` and
    differentiable in means, scales, quats, opacities and SH. The rgb is
    not clipped to [0, 1]: clipping is the caller's loss-side choice."""
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=means3d.device)
    out = rasterize_diff_views(cam, w2c[None], means3d, scales, quats,
                               opacities, shs, sh_degree, bg, config,
                               return_drops, device)
    return tuple(o[0] for o in out)
