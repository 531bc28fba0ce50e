"""Signed-distance-field collision geometry.

Counterpart of the JAX package's physics/sdf.py: a dense SDF grid per
collision mesh, voxelized once on the host, queried with a trilinear
interpolant and its exact gradient. The TPU package's 4^3 patch packing
(``blocks4``) exists only for the Pallas step's gather-free contact path;
the CUDA step samples the full grid from global memory, so it is not
carried.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.mesh import TriMesh


@dataclasses.dataclass(frozen=True)
class SdfGrid:
    """Dense SDF sampled on a regular grid; ``corners`` packs each cell's
    eight corner values contiguously, ((nx-1)*(ny-1)*(nz-1), 8)."""

    origin: torch.Tensor       # (3,) position of voxel (0, 0, 0)
    inv_spacing: torch.Tensor  # () 1 / voxel size
    values: torch.Tensor       # (nx, ny, nz) f32
    corners: torch.Tensor      # (cells, 8) f32

    @property
    def shape(self):
        return tuple(self.values.shape)

    @staticmethod
    def from_values(origin, inv_spacing, values, device) -> "SdfGrid":
        values = np.asarray(values, np.float32)
        return SdfGrid(
            origin=torch.as_tensor(np.asarray(origin, np.float32),
                                   device=device),
            inv_spacing=torch.as_tensor(np.float32(inv_spacing),
                                        device=device),
            values=torch.as_tensor(values, device=device),
            corners=torch.as_tensor(pack_corners(values), device=device))


def pack_corners(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values)
    c = np.stack([
        v[:-1, :-1, :-1], v[:-1, :-1, 1:], v[:-1, 1:, :-1], v[:-1, 1:, 1:],
        v[1:, :-1, :-1], v[1:, :-1, 1:], v[1:, 1:, :-1], v[1:, 1:, 1:],
    ], axis=-1)
    return c.reshape(-1, 8).astype(np.float32)


def build_sdf_grid(mesh: TriMesh, voxel_size: float = 0.0025,
                   padding: float = 0.015, n_surface_samples: int = 60000,
                   max_dim: int = 96, device="cpu") -> SdfGrid:
    """Voxelize a mesh's signed distance on the host: unsigned distance
    from a KD-tree over dense surface samples and vertices, sign from the
    nearest sample's face normal."""
    from scipy.spatial import cKDTree

    lo, hi = mesh.bounds()
    lo = lo - padding
    hi = hi + padding
    extent = hi - lo
    dims = np.maximum(np.ceil(extent / voxel_size).astype(int) + 1, 2)
    if dims.max() > max_dim:
        voxel_size = float(extent.max() / (max_dim - 1))
        dims = np.maximum(np.ceil(extent / voxel_size).astype(int) + 1, 2)

    pts, normals = mesh.sample_surface(n_surface_samples,
                                       np.random.default_rng(0),
                                       return_normals=True)
    pts = np.concatenate([pts, mesh.vertices.astype(np.float32)], axis=0)
    normals = np.concatenate([normals, _vertex_normals(mesh)], axis=0)

    gx, gy, gz = [np.arange(d) * voxel_size + lo[i]
                  for i, d in enumerate(dims)]
    grid = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    dist, idx = cKDTree(pts).query(grid, k=1, workers=-1)
    delta = grid - pts[idx]
    sign = np.where(np.einsum("nd,nd->n", delta, normals[idx]) >= 0.0,
                    1.0, -1.0)
    sdf = (dist * sign).astype(np.float32).reshape(tuple(dims))
    return SdfGrid.from_values(lo, 1.0 / voxel_size, sdf, device)


def _vertex_normals(mesh: TriMesh) -> np.ndarray:
    fn = mesh.face_normals()
    vn = np.zeros_like(mesh.vertices, dtype=np.float64)
    for k in range(3):
        np.add.at(vn, mesh.faces[:, k], fn)
    n = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(n, 1e-12)).astype(np.float32)


def trilinear(corners8: torch.Tensor, f: torch.Tensor, s):
    """Trilinear value + gradient from the 8 cell corners (..., 8) at the
    in-cell fraction f (..., 3), gradient scaled by ``s`` (1/voxel)."""
    c000, c001, c010, c011, c100, c101, c110, c111 = corners8.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    val = c0 * (1 - fx) + c1 * fx
    gx = (c1 - c0) * s
    gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) * s
    gz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx)
          + ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx) * s
    grad = torch.stack([gx, gy, gz], dim=-1)
    gl = torch.sqrt((grad * grad).sum(-1, keepdim=True))
    return val, grad / torch.clamp(gl, min=1e-9)


@functools.lru_cache(maxsize=None)
def _grid_hi(shape: tuple, dtype, device) -> torch.Tensor:
    """(3,) last voxel index of a grid, made on ``device`` once per shape
    (a query copies nothing from the host)."""
    return torch.tensor([n - 1 for n in shape], dtype=dtype, device=device)


def sdf_query(grid: SdfGrid, pts: torch.Tensor):
    """Trilinear SDF value + unit gradient at (..., 3) query points in the
    grid's frame. Points outside the grid get distance 1e3 (no contact)."""
    nx, ny, nz = grid.shape
    hi = _grid_hi(grid.shape, pts.dtype, pts.device)
    u = (pts - grid.origin) * grid.inv_spacing
    inside = ((u >= 0.0) & (u <= hi)).all(-1)
    u = torch.minimum(torch.clamp(u, min=0.0), hi - 1e-4)
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0.to(u.dtype)
    cell = (i0[..., 0] * (ny - 1) + i0[..., 1]) * (nz - 1) + i0[..., 2]
    val, normal = trilinear(grid.corners[cell], f, grid.inv_spacing)
    return torch.where(inside, val, torch.full_like(val, 1e3)), normal
