"""Camera models for the splat renderer.

Counterpart of the JAX package's renderer/camera.py: intrinsics ->
rasterizer settings and eef-mounted wrist cameras, with plain (4, 4) w2c
math: p_view = w2c @ [p; 1].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import transforms as tf


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera spec."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    near: float = 0.01
    far: float = 100.0
    z_threshold: float = 0.05   # near-cull plane

    @property
    def tan_fovx(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fovy(self) -> float:
        return self.height / (2.0 * self.fy)


def setup_camera(w, h, k, w2c=None, near=0.01, far=100.0,
                 z_threshold=0.05) -> tuple[Camera, np.ndarray]:
    """Build a Camera from an intrinsic matrix. Returns (camera, w2c)."""
    k = np.asarray(k, np.float32)
    cam = Camera(width=int(w), height=int(h),
                 fx=float(k[0][0]), fy=float(k[1][1]),
                 cx=float(k[0][2]), cy=float(k[1][2]),
                 near=float(near), far=float(far),
                 z_threshold=float(z_threshold))
    w2c = (np.eye(4, dtype=np.float32) if w2c is None
           else np.asarray(w2c, np.float32))
    return cam, w2c


def wrist_w2c(eef2c: torch.Tensor, eef_xyz: torch.Tensor,
              eef_rot: torch.Tensor) -> torch.Tensor:
    """eef-mounted camera: eef->cam composed with world->eef. Batched over
    the leading dims of ``eef_xyz`` (..., 3) / ``eef_rot`` (..., 3, 3)."""
    return eef2c @ tf.se3_inverse(tf.make_se3(eef_rot, eef_xyz))
