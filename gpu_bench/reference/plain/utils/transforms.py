"""SE(3) / quaternion / axis-angle math on torch tensors.

Counterpart of the JAX package's utils/transforms.py: same formulas, same
**wxyz** quaternion convention, broadcasting over leading batch dims.
"""

from __future__ import annotations

import functools

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz. Broadcasts over batch dims."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3). Normalizes internally."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_to_quat(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, branch-free Shepperd's method: all four
    candidate solutions, keeping the one with the largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=eps))

    sw = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                      (m10 - m01) / sw], -1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                      (m02 + m20) / sx], -1)
    sy = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                      (m12 + m21) / sy], -1)
    sz = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz,
                      0.25 * sz], -1)

    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)      # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx).squeeze(-2)
    return quat_normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    return (quat_to_rot(q) @ v[..., None])[..., 0]


def axis_angle_to_rot(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) rotation vector -> (..., 3, 3) via Rodrigues, small-angle
    safe."""
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    small = theta < eps
    axis = aa / torch.where(small, torch.ones_like(theta), theta)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], dim=-2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    R_small = eye + K * t
    return torch.where(small[..., None], R_small, R)


def rot_to_axis_angle(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vector (via quaternion log)."""
    q = rot_to_quat(R)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    scale = torch.where(n < eps, torch.full_like(n, 2.0),
                        theta / torch.clamp(n, min=eps))
    return xyz * scale[..., None]


def axis_angle_to_quat(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta[..., 0] < eps
    sinc = torch.where(small[..., None], torch.full_like(theta, 0.5),
                       torch.sin(half) / torch.clamp(theta, min=eps))
    return torch.cat([torch.cos(half), aa * sinc], dim=-1)


def euler_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) roll/pitch/yaw about fixed x, y, z axes -> (..., 3, 3).

    R = Rz(yaw) @ Ry(pitch) @ Rx(roll), the URDF ``rpy`` convention.
    """
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_to_euler(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) static-xyz Euler angles (gimbal-safe clamp)."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    p = torch.arcsin(sp)
    safe = torch.abs(torch.cos(p)) > eps
    r = torch.where(safe, torch.atan2(R[..., 2, 1], R[..., 2, 2]),
                    torch.atan2(-R[..., 1, 2], R[..., 1, 1]))
    y = torch.where(safe, torch.atan2(R[..., 1, 0], R[..., 0, 0]),
                    torch.zeros_like(p))
    return torch.stack([r, p, y], dim=-1)


@functools.lru_cache(maxsize=None)
def _se3_bottom(dtype, device) -> torch.Tensor:
    """The constant row [0, 0, 0, 1], made on ``device`` once."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = _se3_bottom(R.dtype, R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_se3(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def xyzrpy_to_se3(xyz, rpy) -> torch.Tensor:
    return make_se3(euler_to_rot(torch.as_tensor(rpy)), torch.as_tensor(xyz))
