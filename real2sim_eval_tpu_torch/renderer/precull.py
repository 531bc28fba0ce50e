"""Block-level conservative frustum pre-cull for moving (wrist) cameras.

Counterpart of the JAX package's renderer/precull.py. The wrist camera
moves with the eef, so it runs the full pipeline every step; culling the
scene to the blocks its frustum can see first makes preprocess and binning
scale with the visible count, as the CUDA rasterizer's prefix-sum binning
does for culled gaussians.

  1. Static gaussians (meshes + mask-0 scan) are KD-ordered once on the
     host (``spatial_sort_scene``) so that contiguous blocks of ``BLOCK``
     (= 64) are spatially tight, padded to a block multiple, and given one
     bounding sphere per block (circumradius of the means + 3x the largest
     member scale).
  2. Per step and env: each sphere against the camera's four side planes,
     padded by ``PAD_PX`` pixels, and the z_threshold near plane.
  3. Order-preserving compaction of the visible blocks. The TPU version
     compacts to a calibrated fixed capacity and reports overflow; here
     every env keeps exactly its visible blocks, ascending, padded to the
     largest count over the envs of this step with opacity-0 rows (invalid
     in preprocess: zero pairs), so nothing overflows.

The dynamic splats cull the same way from per-step posed block spheres
(``cull_dynamic_blocks``). Because blocks keep their relative order and
culled blocks emit no pair, the culled scene's sorted pair stream is the
full scene's, and the render is pixel-exact against the unculled one.
``plan_static_cull``/``plan_dynamic_cull`` measure the capacity the JAX
package would plan; the evaluator uses it only for the JAX package's
"auto" rule (no cull where the capacity is >= 0.9 of all blocks).
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import Camera
from ..utils.profiling import spanned

BLOCK = 64
# side-plane padding in pixels: covers the EWA +0.3px low-pass, the ceil
# on the 3-sigma radius, tile-rect dilation granularity, and linearization
# slack between the projected ellipsoid and the conic screen footprint
PAD_PX = 32.0
# margin over measured init visibility (the JAX package's capacity rule)
CULL_MARGIN = 1.5

SCENE_KEYS = ("means3D", "scales", "rotations", "opacities", "shs")


def pad_to_block(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def spatial_sort_scene(scene: dict) -> dict:
    """Reorder an (N, ...) scene dict by a balanced KD median split:
    recursively split along the widest axis at a BLOCK-multiple rank, so
    every leaf is one compact cell of exactly BLOCK points (bar the tail).
    One-time host numpy step, the JAX package's step for step; everything
    that uses the static order afterwards must use the same permuted
    scene."""
    m = scene["means3D"].detach().cpu().numpy().astype(np.float64)
    leaves = []

    def split(idx):
        if len(idx) <= BLOCK:
            leaves.append(idx)
            return
        pts = m[idx]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        k = max(BLOCK, (len(idx) // 2 // BLOCK) * BLOCK)
        part = np.argpartition(pts[:, ax], k)
        split(idx[part[:k]])
        split(idx[part[k:]])

    split(np.arange(len(m)))
    idx = torch.as_tensor(np.concatenate(leaves),
                          device=scene["means3D"].device)
    return {k: v[idx] for k, v in scene.items()}


def _pad_axis(scene: dict, axis: int) -> dict:
    """Pad along ``axis`` to a BLOCK multiple: means clone the last real
    row (keeps the tail block's sphere tight), every other attribute is 0
    (opacity 0: invalid in preprocess, zero pairs)."""
    n = scene["means3D"].shape[axis]
    pad = pad_to_block(n) - n
    if pad == 0:
        return scene
    out = {}
    for k, v in scene.items():
        if k == "means3D":
            tail = v.narrow(axis, n - 1, 1)
            tail = tail.expand(*v.shape[:axis], pad, *v.shape[axis + 1:])
        else:
            tail = v.new_zeros(v.shape[:axis] + (pad,) + v.shape[axis + 1:])
        out[k] = torch.cat([v, tail], dim=axis)
    return out


def pad_static_scene(scene: dict) -> dict:
    """Pad an (N, ...) static scene dict to a BLOCK multiple."""
    return _pad_axis(scene, 0)


def pad_dynamic_scene(scene_b: dict) -> dict:
    """Pad a posed (B, N, ...) dynamic scene dict to a BLOCK multiple
    along axis 1."""
    return _pad_axis(scene_b, 1)


def block_bounds(means, scales):
    """(..., N, 3) means + scales -> ((..., G, 3) centers, (..., G) radii),
    N a multiple of BLOCK. Radius = circumradius of the block's means + 3 x
    the largest member scale; pad rows carry a real mean and scale 0."""
    lead = means.shape[:-2]
    m = means.reshape(*lead, -1, BLOCK, 3)
    c = 0.5 * (m.amin(dim=-2) + m.amax(dim=-2))
    d = m - c[..., None, :]
    d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
    r = torch.sqrt(d2.amax(dim=-1))
    r = r + 3.0 * scales.reshape(*lead, -1, BLOCK * 3).amax(dim=-1)
    return c, r


def visible_mask(cam: Camera, w2c, centers, radii, pad_px: float = PAD_PX):
    """(..., G) conservative per-block visibility; w2c (..., 4, 4) with the
    leading dims of centers (..., G, 3)."""
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=centers.device)
    W = w2c[..., None, :, :]
    cx, cy, cz = centers.unbind(-1)

    def row(r):
        return (W[..., r, 0] * cx + W[..., r, 1] * cy + W[..., r, 2] * cz
                + W[..., r, 3])

    x, y, z = row(0), row(1), row(2)
    # near plane: preprocess keeps depth > z_threshold only
    ok = (z + radii) > cam.z_threshold
    # side planes of the pyramid through the padded image rect; each
    # half-space {sgn*v + tan*z >= 0} contains the visible frustum; a
    # sphere survives while its signed distance > -r
    for v, tans in ((x, ((1.0, (cam.cx + pad_px) / cam.fx),
                         (-1.0, (cam.width - cam.cx + pad_px) / cam.fx))),
                    (y, ((1.0, (cam.cy + pad_px) / cam.fy),
                         (-1.0, (cam.height - cam.cy + pad_px) / cam.fy)))):
        for sgn, tan in tans:
            # the square root in f32, as the JAX package takes it
            slack = float(np.sqrt(np.float32(1.0 + tan * tan)))
            ok = ok & ((sgn * v + tan * z) > -radii * slack)
    return ok


def _compact(blocks: dict, ok, rows=None):
    """Keep each env's visible blocks, ascending, padded to the largest
    visible count over the envs with opacity-0 rows.

    blocks: dict of (B or 1, G, BLOCK, ...) tensors, or with ``rows`` (B,)
    i64 of (R, G, BLOCK, ...) tensors of which env b reads row
    ``rows[b]``; ok (B, G).
    Returns ((B, n_keep * BLOCK, ...) scene, visible blocks (B,) i32)."""
    B, g = ok.shape
    n_vis = ok.sum(1)
    n_keep = int(n_vis.max()) if B else 0
    key = torch.where(ok, torch.arange(g, device=ok.device), g)
    sel = torch.sort(key, dim=1).values[:, :n_keep]
    real = sel < g
    sel = torch.clamp(sel, max=g - 1)
    env = (torch.arange(B, device=ok.device) if rows is None
           else rows)[:, None]
    out = {}
    for k, v in blocks.items():
        v = v[env if (v.shape[0] > 1 or rows is not None) else 0, sel]
        out[k] = v.reshape((B, n_keep * BLOCK) + v.shape[3:])
    op = out["opacities"]
    mask = real.repeat_interleave(BLOCK, dim=1)
    out["opacities"] = torch.where(
        mask.reshape(mask.shape + (1,) * (op.dim() - 2)), op,
        torch.zeros((), dtype=op.dtype, device=op.device))
    return out, n_vis.to(torch.int32)


@spanned("precull static")
def cull_static_blocks(cam: Camera, w2c_b, static_padded: dict, centers,
                       radii, pad_px: float = PAD_PX, rows=None):
    """Compact a shared (N, ...) static scene to the blocks visible from a
    per-env camera pose.

    Args:
      w2c_b: (B, 4, 4) world-to-camera per env.
      static_padded / centers / radii: from ``pad_static_scene`` +
        ``block_bounds``, computed once at build.
      rows: (B,) i64 where the envs' static scenes differ (attached meshes
        posed per episode): ``static_padded`` then holds one (R, N, ...)
        scene per mesh group, ``centers`` / ``radii`` each env's own
        group's blocks (B, G, 3) / (B, G), and env b keeps the blocks of
        scene ``rows[b]``.
    Returns (culled scene dict with (B, n_keep * BLOCK, ...) leaves,
    visible blocks per env (B,) i32)."""
    lead = 1 if rows is None else static_padded["means3D"].shape[0]
    per = static_padded["means3D"].shape[-2]
    g = per // BLOCK
    if rows is None:
        centers, radii = centers[None], radii[None]
    ok = visible_mask(cam, torch.as_tensor(w2c_b), centers, radii, pad_px)
    blocks = {k: static_padded[k].reshape(
                  (lead, g, BLOCK)
                  + static_padded[k].shape[(1 if rows is None else 2):])
              for k in SCENE_KEYS}
    return _compact(blocks, ok, rows)


@spanned("precull dynamic")
def cull_dynamic_blocks(cam: Camera, w2c_b, dyn_padded: dict,
                        pad_px: float = PAD_PX):
    """Per-env block cull of a posed (B, N, ...) dynamic scene: the block
    spheres re-derive each step from the posed means. Blocks are contiguous
    slices of the compose order (object splats, then robot splats by link),
    so posed blocks stay spatially tight. Returns (culled (B, n_keep *
    BLOCK, ...) scene, visible blocks per env (B,) i32)."""
    B, n = dyn_padded["means3D"].shape[:2]
    g = n // BLOCK
    centers, radii = block_bounds(dyn_padded["means3D"], dyn_padded["scales"])
    ok = visible_mask(cam, torch.as_tensor(w2c_b), centers, radii,
                      pad_px)
    blocks = {k: dyn_padded[k].reshape((B, g, BLOCK) + dyn_padded[k].shape[2:])
              for k in SCENE_KEYS}
    return _compact(blocks, ok)


def _capacity(mx: int, g: int, margin: float) -> int:
    cap = int(-(-mx * margin // 8) * 8) + 8
    return max(8, min(cap, g))


def plan_static_cull(cam_w2c_list, centers, radii, pad_px: float = PAD_PX,
                     margin: float = CULL_MARGIN) -> int:
    """The JAX package's static cull capacity: the most blocks visible
    over (cameras x envs), x margin, rounded up to 8, clamped to the block
    count."""
    mx = 0
    for cam, w2c_b in cam_w2c_list:
        ok = visible_mask(cam, torch.as_tensor(w2c_b),
                          centers[None], radii[None], pad_px)
        mx = max(mx, int(ok.sum(1).max()))
    return _capacity(mx, int(centers.shape[0]), margin)


def plan_dynamic_cull(cam_w2c_list, dyn_padded: dict, pad_px: float = PAD_PX,
                      margin: float = CULL_MARGIN) -> int:
    """The JAX package's dynamic cull capacity, from the posed (B, N, ...)
    dynamic scene of the init state."""
    centers, radii = block_bounds(dyn_padded["means3D"], dyn_padded["scales"])
    mx = 0
    for cam, w2c_b in cam_w2c_list:
        ok = visible_mask(cam, torch.as_tensor(w2c_b), centers,
                          radii, pad_px)
        mx = max(mx, int(ok.sum(1).max()))
    return _capacity(mx, int(dyn_padded["means3D"].shape[1]) // BLOCK,
                     margin)
