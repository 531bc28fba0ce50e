"""Stacked multi-collider SDF query.

Counterpart of the JAX package's physics/multi_sdf.py: the collider grids
(fingers first, then statics) concatenated into one corner table with
per-collider cell offsets, queried for all colliders at once. The CUDA
step reads the same table (``physics/fused_step.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .sdf import trilinear


def combine_grids(grids) -> dict:
    """Concatenate collider grids into one query table."""
    dims = np.array([g.shape for g in grids], np.int32)           # (C, 3)
    cells = (dims[:, 0] - 1) * (dims[:, 1] - 1) * (dims[:, 2] - 1)
    offsets = np.concatenate([[0], np.cumsum(cells)[:-1]]).astype(np.int64)
    dev = grids[0].corners.device
    return {
        "corners": torch.cat([g.corners for g in grids], dim=0),
        "origin": torch.stack([g.origin for g in grids]),         # (C, 3)
        "inv_spacing": torch.stack([g.inv_spacing for g in grids]),
        "dims": dims,                                              # numpy
        "cell_offset": torch.as_tensor(offsets, device=dev),
    }


def multi_sdf_query(combo: dict, pts_local: torch.Tensor):
    """Query colliders at once.

    pts_local: (..., C', N, 3) points already in each collider's frame,
    for the first C' colliders of the table.
    Returns dist (..., C', N), normal_local (..., C', N, 3)."""
    c = pts_local.shape[-3]
    dims = combo["dims"][:c]
    dev, dt = pts_local.device, pts_local.dtype
    ny1 = torch.as_tensor(dims[:, 1] - 1, device=dev)[:, None]
    nz1 = torch.as_tensor(dims[:, 2] - 1, device=dev)[:, None]
    hi = torch.as_tensor(dims - 1, dtype=dt, device=dev)[:, None, :]
    origin = combo["origin"][:c][:, None]
    isp = combo["inv_spacing"][:c]

    u = (pts_local - origin) * isp[:, None, None]
    inside = ((u >= 0.0) & (u <= hi)).all(-1)
    u = torch.minimum(torch.clamp(u, min=0.0), hi - 1e-4)
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0.to(dt)
    cell = ((i0[..., 0] * ny1 + i0[..., 1]) * nz1 + i0[..., 2]
            + combo["cell_offset"][:c][:, None])
    val, normal = trilinear(combo["corners"][cell], f, isp[:, None])
    return torch.where(inside, val, torch.full_like(val, 1e3)), normal
