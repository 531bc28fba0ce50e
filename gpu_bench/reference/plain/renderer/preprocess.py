"""Per-Gaussian rasterization preprocessing, batched over instances.

Counterpart of the JAX package's renderer/preprocess.py (the
``preprocessCUDA`` semantics): z-threshold near cull, 3D covariance from
scale + quaternion, EWA projection with the 1.3*tanfov clamp and the
+0.3 px low-pass, 3-sigma radius with the 0.1 floor under the sqrt, SH ->
clamped RGB along the ray from the camera centre. Every input may carry
leading batch dims; ``w2c`` is (..., 4, 4) with the same leading dims.

Differentiable by autograd end to end (renderer/diff.py chains through
it): no in-place op touches a tensor that may require grad. The clamps on
depth, the frustum and the view-direction norm pass the whole cotangent
at an exact tie where the JAX package passes half; those ties need a
splat exactly at a clamp value, and the tests have none.
"""

from __future__ import annotations

import torch

from ..utils.sh import sh_to_rgb_clamped
from .camera import Camera


def preprocess_gaussians(cam: Camera, w2c: torch.Tensor, means3d, scales,
                         quats, opacities, shs, sh_degree: int,
                         scale_modifier: float = 1.0) -> dict:
    """means3d (..., N, 3), scales (..., N, 3), quats (..., N, 4) wxyz,
    opacities (..., N) or (..., N, 1), shs (..., N, K, 3); w2c (..., 4, 4).
    Returns a dict of per-Gaussian raster quantities + validity mask."""
    opacities = opacities.reshape(means3d.shape[:-1])
    w2c = w2c.to(means3d.dtype)
    W = w2c[..., None, :, :]                     # broadcast over gaussians

    def wrow(r, c):
        return W[..., r, c]

    mx, my, mz = means3d.unbind(-1)
    pv0 = wrow(0, 0) * mx + wrow(0, 1) * my + wrow(0, 2) * mz + wrow(0, 3)
    pv1 = wrow(1, 0) * mx + wrow(1, 1) * my + wrow(1, 2) * mz + wrow(1, 3)
    depth = wrow(2, 0) * mx + wrow(2, 1) * my + wrow(2, 2) * mz + wrow(2, 3)
    visible = depth > cam.z_threshold

    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    w, h = cam.width, cam.height
    zs = torch.clamp(depth, min=1e-7)
    ndc_x = (2.0 * fx / w) * pv0 / zs - (w - 2.0 * cx) / w
    ndc_y = (2.0 * fy / h) * pv1 / zs - (h - 2.0 * cy) / h
    xy = torch.stack([((ndc_x + 1.0) * w - 1.0) * 0.5,
                      ((ndc_y + 1.0) * h - 1.0) * 0.5], dim=-1)

    qn = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=-1,
                                                      keepdim=True), min=1e-12)
    qw, qx, qy, qz = qn.unbind(-1)
    sx = scales[..., 0] * scale_modifier
    sy = scales[..., 1] * scale_modifier
    sz = scales[..., 2] * scale_modifier
    m = (
        ((1 - 2 * (qy * qy + qz * qz)) * sx,
         2 * (qx * qy - qw * qz) * sy,
         2 * (qx * qz + qw * qy) * sz),
        (2 * (qx * qy + qw * qz) * sx,
         (1 - 2 * (qx * qx + qz * qz)) * sy,
         2 * (qy * qz - qw * qx) * sz),
        (2 * (qx * qz - qw * qy) * sx,
         2 * (qy * qz + qw * qx) * sy,
         (1 - 2 * (qx * qx + qy * qy)) * sz),
    )
    c3 = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a, 3):
            c3[a][b] = c3[b][a] = (m[a][0] * m[b][0] + m[a][1] * m[b][1]
                                   + m[a][2] * m[b][2])

    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    txtz = torch.clamp(pv0 / zs, -limx, limx)
    tytz = torch.clamp(pv1 / zs, -limy, limy)
    tz = zs
    j00 = fx / tz
    j02 = -fx * txtz / tz
    j11 = fy / tz
    j12 = -fy * tytz / tz
    t0 = [j00 * wrow(0, k) + j02 * wrow(2, k) for k in range(3)]
    t1 = [j11 * wrow(1, k) + j12 * wrow(2, k) for k in range(3)]

    def quad(ta, tb):
        u = [ta[0] * c3[0][l] + ta[1] * c3[1][l] + ta[2] * c3[2][l]
             for l in range(3)]
        return u[0] * tb[0] + u[1] * tb[1] + u[2] * tb[2]

    cov_a = quad(t0, t0) + 0.3
    cov_b = quad(t0, t1)
    cov_c = quad(t1, t1) + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cov_c * det_inv, -cov_b * det_inv,
                         cov_a * det_inv], dim=-1)

    mid = 0.5 * (cov_a + cov_c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    dirs = None
    if sh_degree > 0:
        # view directions from the camera centre -R^T t (forward.cu:20-71)
        R, t = w2c[..., :3, :3], w2c[..., :3, 3]
        cam_pos = -(R[..., 0, :] * t[..., 0:1] + R[..., 1, :] * t[..., 1:2]
                    + R[..., 2, :] * t[..., 2:3])
        dirs = means3d - cam_pos[..., None, :]
        dirs = dirs / torch.clamp(torch.linalg.vector_norm(
            dirs, dim=-1, keepdim=True), min=1e-9)
    rgb = sh_to_rgb_clamped(sh_degree, shs, dirs)

    valid = visible & det_ok & (opacities > 0.0)
    return {
        "xy": xy,
        "depth": depth,
        "conic": conic,
        "opacity": opacities,
        "rgb": rgb,
        "radius": torch.where(valid, radius, torch.zeros_like(radius)),
        "valid": valid,
    }


def tile_rect(xy, radius, n_tiles_x, n_tiles_y, tile_w, tile_h):
    """Tile-bounding rect per Gaussian (getRect semantics): returns x0, y0,
    x1, y1 (exclusive upper) as int32, clamped to the grid."""
    def trunc(v, hi):
        # saturate before the cast (XLA's f32->s32 conversion saturates;
        # an out-of-range torch cast is undefined)
        v = torch.clamp(v, -float(1 << 30), float(1 << 30))
        return torch.clamp(v.to(torch.int32), 0, hi)

    x0 = trunc((xy[..., 0] - radius) / tile_w, n_tiles_x)
    y0 = trunc((xy[..., 1] - radius) / tile_h, n_tiles_y)
    x1 = trunc((xy[..., 0] + radius + tile_w - 1) / tile_w, n_tiles_x)
    y1 = trunc((xy[..., 1] + radius + tile_h - 1) / tile_h, n_tiles_y)
    return x0, y0, x1, y1
