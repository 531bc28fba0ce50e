"""Batched forward kinematics on torch tensors.

Counterpart of the JAX package's kinematics/chain.py: flat numpy tables
from the URDF (document-order links, every non-fixed joint one DOF), FK as
a fixed sequence of 4x4 composes over leading batch dims.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.urdf import UrdfModel, load_urdf


@dataclass(frozen=True)
class KinematicChain:
    """Flat FK tables (numpy); FK itself runs on torch tensors."""

    link_names: tuple
    parent: np.ndarray        # (L,) int, -1 for root links
    joint_type: np.ndarray    # (L,) 0 fixed, 1 revolute/continuous, 2 prismatic
    origins: np.ndarray       # (L, 4, 4) parent->joint frame
    axes: np.ndarray          # (L, 3)
    dof_index: np.ndarray     # (L,) int, -1 if fixed
    n_dof: int
    topo_order: np.ndarray    # (L,) evaluation order (parents first)
    lower: np.ndarray
    upper: np.ndarray
    # (device, dtype) -> (origins (L, 4, 4), axes (L, 3)) on that device,
    # made once (``device_tables``)
    _device: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def from_urdf(model: UrdfModel) -> "KinematicChain":
        names = model.link_names
        idx = {n: i for i, n in enumerate(names)}
        L = len(names)
        parent = np.full(L, -1, np.int32)
        jtype = np.zeros(L, np.int32)
        origins = np.tile(np.eye(4), (L, 1, 1))
        axes = np.tile(np.array([1.0, 0.0, 0.0]), (L, 1))
        dof_index = np.full(L, -1, np.int32)
        lower, upper = [], []
        dof = 0
        for j in model.joints:
            c = idx[j.child]
            parent[c] = idx[j.parent]
            origins[c] = j.origin
            axes[c] = j.axis
            jtype[c] = {"revolute": 1, "continuous": 1,
                        "prismatic": 2}.get(j.type, 0)
            if jtype[c]:
                dof_index[c] = dof
                lower.append(j.lower)
                upper.append(j.upper)
                dof += 1
        emitted = np.zeros(L, bool)
        order = []
        for _ in range(L):
            for i in range(L):
                if not emitted[i] and (parent[i] < 0 or emitted[parent[i]]):
                    emitted[i] = True
                    order.append(i)
        if len(order) != L:
            raise ValueError("URDF kinematic graph has a cycle")
        return KinematicChain(
            link_names=tuple(names), parent=parent, joint_type=jtype,
            origins=origins, axes=axes, dof_index=dof_index, n_dof=dof,
            topo_order=np.array(order, np.int32),
            lower=np.array(lower, np.float64),
            upper=np.array(upper, np.float64))

    @staticmethod
    def from_urdf_file(path) -> "KinematicChain":
        return KinematicChain.from_urdf(load_urdf(path))

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    def device_tables(self, device, dtype):
        """(origins (L, 4, 4), axes (L, 3)) as ``dtype`` tensors on
        ``device``, copied from the numpy tables on the first call for
        that (device, dtype) and reused after: FK reads its constants
        without a copy from the host (which would synchronise the card)."""
        key = (torch.device(device), dtype)
        if key not in self._device:
            self._device[key] = (
                torch.as_tensor(self.origins, dtype=dtype, device=device),
                torch.as_tensor(self.axes, dtype=dtype, device=device))
        return self._device[key]

    def _local(self, i: int, qpos: torch.Tensor) -> torch.Tensor:
        origins, axes = self.device_tables(qpos.device, qpos.dtype)
        local = origins[i]
        jt = int(self.joint_type[i])
        if jt == 0:
            return local
        q = qpos[..., int(self.dof_index[i])]
        axis = axes[i]
        motion = (_rot_about_axis(axis, q) if jt == 1
                  else _prismatic(axis, q))
        return local @ motion

    def fk(self, qpos: torch.Tensor) -> torch.Tensor:
        """(..., n_dof) -> (..., L, 4, 4) world pose of every link."""
        batch = qpos.shape[:-1]
        poses = [None] * len(self.link_names)
        for i in self.topo_order:
            i = int(i)
            p = int(self.parent[i])
            local = self._local(i, qpos)
            poses[i] = local if p < 0 else poses[p] @ local
        return torch.stack([poses[i].expand(batch + (4, 4))
                            for i in range(len(poses))], dim=-3)

    def fk_link(self, qpos: torch.Tensor, link) -> torch.Tensor:
        """(..., n) -> (..., 4, 4) pose of one link (its ancestor path)."""
        if isinstance(link, str):
            link = self.link_index(link)
        path = []
        i = int(link)
        while i >= 0:
            path.append(i)
            i = int(self.parent[i])
        pose = None
        for i in reversed(path):
            local = self._local(i, qpos)
            pose = local if pose is None else pose @ local
        return pose.expand(qpos.shape[:-1] + (4, 4))

    def fk_numpy(self, qpos: np.ndarray) -> np.ndarray:
        """All link poses (L, 4, 4) in float64 numpy (host precompute)."""
        poses = np.zeros((len(self.link_names), 4, 4))
        q = np.asarray(qpos, np.float64)
        for i in self.topo_order:
            i = int(i)
            p = int(self.parent[i])
            local = self.origins[i].copy()
            jt = int(self.joint_type[i])
            if jt == 1:
                local = local @ _rot4_np(self.axes[i],
                                         q[int(self.dof_index[i])])
            elif jt == 2:
                t = np.eye(4)
                t[:3, 3] = self.axes[i] * q[int(self.dof_index[i])]
                local = local @ t
            poses[i] = local if p < 0 else poses[p] @ local
        return poses


def _rot_about_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rotation about a unit axis, batched over ``angle``."""
    x, y, z = axis.unbind(0)
    c = torch.cos(angle)
    s = torch.sin(angle)
    C = 1.0 - c
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    rows = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s, zero],
        [x * y * C + z * s, c + y * y * C, y * z * C - x * s, zero],
        [x * z * C - y * s, y * z * C + x * s, c + z * z * C, zero],
        [zero, zero, zero, one],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _prismatic(axis: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(disp)
    one = torch.ones_like(disp)
    t = axis * disp[..., None]
    rows = [[one, zero, zero, t[..., 0]], [zero, one, zero, t[..., 1]],
            [zero, zero, one, t[..., 2]], [zero, zero, zero, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rot4_np(axis: np.ndarray, angle: float) -> np.ndarray:
    x, y, z = axis / max(np.linalg.norm(axis), 1e-12)
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    T = np.eye(4)
    T[:3, :3] = [[c + x * x * C, x * y * C - z * s, x * z * C + y * s],
                 [x * y * C + z * s, c + y * y * C, y * z * C - x * s],
                 [x * z * C - y * s, y * z * C + x * s, c + z * z * C]]
    return T
