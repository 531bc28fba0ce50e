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


# the last table combine_grids built, with the grids it was built from
_last = ((), None)


def combine_grids(grids) -> dict:
    """Concatenate collider grids into one query table. The table of the
    same grids (the same objects, as every control step of an evaluator
    passes) is built once and returned again: it holds the grids' device
    copies of their dims, so no query copies from the host."""
    global _last
    grids = tuple(grids)
    if len(grids) == len(_last[0]) and all(
            a is b for a, b in zip(grids, _last[0])):
        return _last[1]
    dims = np.array([g.shape for g in grids], np.int32)           # (C, 3)
    cells = (dims[:, 0] - 1) * (dims[:, 1] - 1) * (dims[:, 2] - 1)
    offsets = np.concatenate([[0], np.cumsum(cells)[:-1]]).astype(np.int64)
    dev = grids[0].corners.device
    combo = {
        "corners": torch.cat([g.corners for g in grids], dim=0),
        "origin": torch.stack([g.origin for g in grids]),         # (C, 3)
        "inv_spacing": torch.stack([g.inv_spacing for g in grids]),
        "dims": dims,                                              # numpy
        "dims_i32": torch.as_tensor(dims, device=dev),             # (C, 3)
        "hi": torch.as_tensor(dims - 1, dtype=torch.float32,
                              device=dev),                         # (C, 3)
        "cell_offset": torch.as_tensor(offsets, device=dev),
    }
    _last = (grids, combo)
    return combo


def multi_sdf_query(combo: dict, pts_local: torch.Tensor):
    """Query colliders at once.

    pts_local: (..., C', N, 3) points already in each collider's frame,
    for the first C' colliders of the table.
    Returns dist (..., C', N), normal_local (..., C', N, 3)."""
    c = pts_local.shape[-3]
    dt = pts_local.dtype
    hi = combo["hi"][:c].to(dt)
    ny1 = hi[:, 1:2].to(torch.int64)
    nz1 = hi[:, 2:3].to(torch.int64)
    hi = hi[:, None, :]
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
