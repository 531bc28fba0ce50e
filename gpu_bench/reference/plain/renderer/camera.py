"""Camera models for the splat renderer.

Counterpart of the JAX package's renderer/camera.py: intrinsics ->
rasterizer settings and eef-mounted wrist cameras, with plain (4, 4) w2c
math: p_view = w2c @ [p; 1].
"""

from __future__ import annotations

import dataclasses
import math

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


def Rt_to_w2c(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """c2w (R, t) -> w2c."""
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = np.asarray(t).reshape(3)
    return np.linalg.inv(c2w).astype(np.float32)


def orbit_camera_w2c(center=(0, 0, 0), distance=0.8, elevation=20.0,
                     azimuth=160.0) -> np.ndarray:
    """The renderer's custom orbit camera: on a sphere around ``center``,
    a z-up look-at with x = right, y = -up, z = look."""
    target = np.asarray(center, np.float64)
    theta = 90.0 + azimuth
    z = distance * math.sin(math.radians(elevation))
    y = (math.cos(math.radians(theta)) * distance
         * math.cos(math.radians(elevation)))
    x = (math.sin(math.radians(theta)) * distance
         * math.cos(math.radians(elevation)))
    origin = target + np.array([x, y, z])
    look_at = target - origin
    look_at /= np.linalg.norm(look_at)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(look_at, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, look_at)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = -up
    c2w[:3, 2] = look_at
    c2w[:3, 3] = origin
    return np.linalg.inv(c2w).astype(np.float32)


def default_orbit_intrinsics(w: int = 848, h: int = 480) -> np.ndarray:
    """Intrinsics of the orbit camera."""
    return np.array([[w / 2, 0.0, w / 2],
                     [0.0, w / 2, h / 2],
                     [0.0, 0.0, 1.0]], np.float32)


def wrist_w2c_np(eef2c: np.ndarray, eef_xyz: np.ndarray,
                 eef_rot: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of ``wrist_w2c`` for one eef pose."""
    e2b = np.eye(4)
    e2b[:3, :3] = np.asarray(eef_rot)
    e2b[:3, 3] = np.asarray(eef_xyz).reshape(3)
    return (np.asarray(eef2c) @ np.linalg.inv(e2b)).astype(np.float32)


def wrist_w2c(eef2c: torch.Tensor, eef_xyz: torch.Tensor,
              eef_rot: torch.Tensor) -> torch.Tensor:
    """eef-mounted camera: eef->cam composed with world->eef. Batched over
    the leading dims of ``eef_xyz`` (..., 3) / ``eef_rot`` (..., 3, 3)."""
    return eef2c @ tf.se3_inverse(tf.make_se3(eef_rot, eef_xyz))
