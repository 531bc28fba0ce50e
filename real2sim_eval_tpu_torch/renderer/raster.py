"""Gaussian-splat rasterization: forward RGB + median depth.

Counterpart of the JAX package's renderer/raster.py with two backends of
identical semantics:

  - ``reference``: the dense O(N*H*W) compositor (``_composite_reference``),
    for tests and tiny scenes;
  - ``tiles``: preprocess + exact binning + the tile compositor K1
    (``tile_kernel.rasterize_tiles_batch``) over (instance, 8x128 tile),
    or, with ``kernel="fine"``, the fine binning + the fine compositor K4
    (``fine_kernel.rasterize_fine_batch``) over (instance, 8x16 fine
    tile): the CUDA kernel on the card, its plain PyTorch version on the
    CPU.

The tile gating is semantics, not a performance choice: a gaussian only
reaches the tiles of its 3-sigma rect, in both backends, so the fine
kernel's frames differ from the wide one's (PARITY.md §16) and the
reference gates at the configured kernel's tile.
"""

from __future__ import annotations

import dataclasses

import torch

from .binning import bin_gaussians, bin_gaussians_fine
from .camera import Camera
from .fine_kernel import rasterize_fine_batch
from .preprocess import preprocess_gaussians, tile_rect
from .tile_kernel import (ALPHA_MAX, ALPHA_MIN, FINE_W, MEDIAN_DEPTH_DEFAULT,
                          T_EPS, TILE_H, TILE_W, rasterize_tiles_batch)
from ..utils.device import resolve_device
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Render settings, with the JAX package's values.

    ``incremental``: the fixed cameras of ``BatchedEvaluator`` render only
    the tiles the moving splats touch, on top of a static frame built once
    (renderer/incremental.py); "auto" turns it on when the evaluator runs
    on the card, "off" renders every camera with the full pipeline.
    ``merge_kernel``: how a dirty tile's static and dynamic pairs merge:
    "sort" (a PyTorch sort, then K2) or "stream" (inside K6).
    ``wrist_precull``: block frustum cull of the scene for the wrist
    camera (renderer/precull.py); "auto" culls where the JAX package's
    evaluator would.
    ``kernel``: the compositor family, "wide" (8x128 tiles: K1, and K2/K6
    for the dirty tiles) or "fine" (8x16 tiles: K4, and K5 for the dirty
    fine tiles, renderer/incremental_fine.py, which always merges by
    sort).
    ``wrist_kernel``: the wrist camera's family on the incremental branch,
    "inherit" taking ``kernel``; the full-pipeline branch renders every
    camera with ``kernel``.

    The JAX package's budgets (``dirty_budget``, ``mix_pairs``,
    ``merge_mem_budget``, ``auto_budgets``, the pair-buffer factors, the
    fine budgets ``fine_small_tiles``/``fine_max_tiles``/
    ``fine_pairs_factor``/``fine_pairs_override``) and ``pack_payloads``
    have no counterpart: the port sizes every buffer from the data, so
    nothing is ever dropped, and never packs payloads."""

    backend: str = "tiles"             # tiles | reference
    incremental: str = "auto"          # auto | on | off
    merge_kernel: str = "sort"         # sort | stream
    wrist_precull: str = "auto"        # auto | on | off
    kernel: str = "wide"               # wide | fine
    wrist_kernel: str = "inherit"      # inherit | wide | fine

    def __post_init__(self):
        for name, allowed in (("backend", ("tiles", "reference")),
                              ("incremental", ("auto", "on", "off")),
                              ("merge_kernel", ("sort", "stream")),
                              ("wrist_precull", ("auto", "on", "off")),
                              ("kernel", ("wide", "fine")),
                              ("wrist_kernel", ("inherit", "wide", "fine"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}")


def bg_tuple(bg) -> tuple:
    return tuple(float(b) for b in torch.as_tensor(bg).reshape(-1).tolist())


def _check_device(t: torch.Tensor, device):
    dev = resolve_device(device)
    if t.device.type != dev.type:
        raise ValueError(f"inputs live on {t.device}, the call asked for "
                         f"{dev}")


def rasterize(cam: Camera, w2c, means3d, scales, quats, opacities, shs,
              sh_degree: int, bg=(0.0, 0.0, 0.0),
              config: RasterConfig = RasterConfig(), device="cuda"):
    """Render one camera. Returns (rgb (3, H, W), depth (H, W))."""
    _check_device(means3d, device)
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=means3d.device)
    if config.backend == "reference":
        with span("wrist preprocess"):
            pre = preprocess_gaussians(cam, w2c, means3d, scales, quats,
                                       opacities, shs, sh_degree)
        bin_w = FINE_W if config.kernel == "fine" else TILE_W
        return _composite_reference(cam, pre, bg_tuple(bg), bin_w=bin_w)
    scenes = {"means3D": means3d[None], "scales": scales[None],
              "rotations": quats[None], "opacities": opacities[None],
              "shs": shs[None]}
    rgb, depth = rasterize_batch([(cam, w2c[None])], scenes, sh_degree, bg,
                                 config, clip=False, device=device)
    return rgb[0, 0], depth[0, 0]


def rasterize_batch(cam_w2c_list, scenes, sh_degree: int, bg=(0.0, 0.0, 0.0),
                    config: RasterConfig = RasterConfig(),
                    return_drops: bool = False, clip: bool = True,
                    device="cuda"):
    """Render B environments x n_cams cameras with ONE compositor launch:
    K1 over (instance, 8x128 tile), or K4 over (instance, 8x16 fine tile)
    with ``config.kernel == "fine"`` (the JAX package's
    ``_rasterize_batch_fine``, without its memory chunking).

    Args:
      cam_w2c_list: list over cameras of (Camera, w2c (B, 4, 4)); all
        cameras share width/height.
      scenes: dict of stacked (B, N, ...) gaussian tensors (means3D,
        scales, rotations, opacities, shs), on ``device`` (the card unless
        the caller passes "cpu", which runs the compositor's plain
        version).
    Returns:
      (rgb (n_cams, B, 3, H, W) clipped to [0, 1], depth (n_cams, B, H, W));
      with ``return_drops`` also an (n_cams, B) i32 of binning drops, always
      0: pair buffers are sized exactly.
    """
    if not cam_w2c_list:
        raise ValueError("need at least one camera")
    _check_device(scenes["means3D"], device)
    if config.backend != "tiles":
        raise ValueError("rasterize_batch runs the tile pipeline; use "
                         "rasterize() for the reference backend")
    cam0 = cam_w2c_list[0][0]
    h, w = cam0.height, cam0.width
    for cam, _ in cam_w2c_list:
        if (cam.height, cam.width) != (h, w):
            raise ValueError("batched render needs uniform camera resolution")
    B = scenes["means3D"].shape[0]
    n_tx = -(-w // TILE_W)
    n_ty = -(-h // TILE_H)
    fine = config.kernel == "fine"
    shs = scenes["shs"] if sh_degree > 0 else scenes["shs"][:, :, :1]
    dev = scenes["means3D"].device

    pair_parts, starts, ends, drops = [], [], [], []
    offset = 0
    for cam, w2c_b in cam_w2c_list:
        w2c_b = torch.as_tensor(w2c_b, dtype=torch.float32, device=dev)
        with span("wrist preprocess"):
            pre = preprocess_gaussians(cam, w2c_b, scenes["means3D"],
                                       scenes["scales"], scenes["rotations"],
                                       scenes["opacities"], shs, sh_degree)
        if fine:
            with span("wrist binning (fine)"):
                bins = bin_gaussians_fine(pre, n_tx, n_ty)
        else:
            with span("wrist binning"):
                bins = bin_gaussians(pre, n_tx, n_ty, TILE_W, TILE_H)
        pair_parts.append(bins["pair_attrs"])
        starts.append(bins["tile_starts"] + offset)
        ends.append(bins["tile_ends"] + offset)
        drops.append(bins["n_large_dropped"])
        offset += bins["pair_attrs"].shape[1]
    pairs = torch.cat(pair_parts, dim=1)
    composite = rasterize_fine_batch if fine else rasterize_tiles_batch
    starts, ends, bg = torch.cat(starts), torch.cat(ends), bg_tuple(bg)
    with span("K4 fine_composite" if fine else "K1 tile_composite"):
        rgb, depth = composite(pairs, starts, ends, n_tx, n_ty, bg)
    n_cams = len(cam_w2c_list)
    rgb = rgb[:, :, :h, :w].reshape(n_cams, B, 3, h, w)
    if clip:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    depth = depth[:, :h, :w].reshape(n_cams, B, h, w)
    if return_drops:
        return rgb, depth, torch.stack(drops)
    return rgb, depth


def _composite_reference(cam: Camera, pre: dict, bg: tuple,
                         bin_w: int = TILE_W, bin_h: int = TILE_H):
    """Dense reference compositor: every gaussian over every pixel, in
    stable depth order, with the same tile-rect gating as the tile path."""
    h, w = cam.height, cam.width
    dev = pre["xy"].device
    n_tiles_x = -(-w // bin_w)
    n_tiles_y = -(-h // bin_h)
    key = torch.where(pre["valid"], pre["depth"],
                      torch.full_like(pre["depth"], float("inf")))
    order = torch.sort(key, stable=True).indices
    xy = pre["xy"][order]
    conic = pre["conic"][order]
    opac = torch.where(pre["valid"], pre["opacity"],
                       torch.zeros_like(pre["opacity"]))[order]
    rgb = pre["rgb"][order]
    depth = pre["depth"][order]
    x0, y0, x1, y1 = (v[order] for v in tile_rect(
        pre["xy"], pre["radius"], n_tiles_x, n_tiles_y, bin_w, bin_h))

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    tile_x = (torch.arange(w, device=dev) // bin_w)[None, :]
    tile_y = (torch.arange(h, device=dev) // bin_h)[:, None]

    T = torch.ones((h, w), dtype=torch.float32, device=dev)
    C = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    D = torch.full((h, w), MEDIAN_DEPTH_DEFAULT, dtype=torch.float32,
                   device=dev)
    done = torch.zeros((h, w), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for g in range(xy.shape[0]):
        dx = xy[g, 0] - xs
        dy = xy[g, 1] - ys
        power = (-0.5 * (conic[g, 0] * dx * dx + conic[g, 2] * dy * dy)
                 - conic[g, 1] * dx * dy)
        alpha = torch.minimum(torch.full_like(power, ALPHA_MAX),
                              opac[g] * torch.exp(power))
        inside = ((tile_x >= x0[g]) & (tile_x < x1[g])
                  & (tile_y >= y0[g]) & (tile_y < y1[g]))
        alpha = torch.where((power <= 0.0) & inside, alpha, zero)
        alpha_ok = alpha >= ALPHA_MIN
        test_T = T * (1.0 - alpha)
        would_done = alpha_ok & (test_T < T_EPS)
        contrib = alpha_ok & ~would_done & ~done
        aT = torch.where(contrib, alpha * T, zero)
        C = C + aT[..., None] * rgb[g]
        D = torch.where(contrib & (T > 0.5) & (test_T < 0.5), depth[g], D)
        T = torch.where(contrib, test_T, T)
        done = done | would_done
    img = C + T[..., None] * torch.tensor(bg, dtype=torch.float32, device=dev)
    return img.permute(2, 0, 1), D
