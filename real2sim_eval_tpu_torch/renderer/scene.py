"""Robot-splat articulation and grid pose randomization.

Counterpart of ``RobotArticulation`` and ``grid_random_values`` in
the JAX package's renderer/scene.py: scan gaussians carry a URDF
document-order link id; per frame the delta transform
FK(q) @ offset @ inv(FK(q0) @ offset) is gathered per gaussian by that id.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kinematics.chain import KinematicChain
from ..utils import transforms as tf


def grid_random_values(true_index: int, xy_list, theta_list,
                       one_to_one: bool):
    """Deterministic grid cell -> (x, y, z, azimuth_rad)."""
    if one_to_one:
        rx, ry = xy_list[true_index]
        ra = theta_list[true_index] * np.pi / 180.0
    else:
        rx, ry = xy_list[true_index // len(theta_list)]
        ra = theta_list[true_index % len(theta_list)] * np.pi / 180.0
    return float(rx), float(ry), 0.0, float(ra)


@dataclasses.dataclass(frozen=True)
class RobotArticulation:
    """Precomputed tables to re-pose scene-scan gaussians with the robot."""

    chain: KinematicChain
    link_ids: tuple            # document-order link ids with splats
    base_inv: torch.Tensor     # (L, 4, 4) inverse base mesh pose
    offsets: torch.Tensor      # (L, 4, 4) collision origin per link
    active: torch.Tensor       # (L,) bool: link participates
    use_pusher: bool = False

    @staticmethod
    def build(chain: KinematicChain, link_ids, base_qpos_full: np.ndarray,
              link_offsets: dict, device, use_pusher: bool = False):
        """link_offsets: link name -> (4, 4) collision origin."""
        L = len(chain.link_names)
        base_fk = chain.fk_numpy(base_qpos_full)
        base_inv = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        offsets = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        active = np.zeros(L, bool)
        for lid in link_ids:
            off = link_offsets.get(chain.link_names[lid], np.eye(4))
            offsets[lid] = off
            base_inv[lid] = np.linalg.inv(base_fk[lid] @ off)
            active[lid] = True
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return RobotArticulation(chain=chain,
                                 link_ids=tuple(int(i) for i in link_ids),
                                 base_inv=t(base_inv), offsets=t(offsets),
                                 active=t(active), use_pusher=use_pusher)

    def full_qpos(self, arm_qpos: torch.Tensor, gripper_openness_counts):
        """(E, 7) arm qpos + (E,) gripper counts -> (E, n_dof). Finger
        joints get (800 - counts) * 0.001 rad."""
        n_extra = self.chain.n_dof - 7
        if n_extra == 0:
            return arm_qpos
        ang = (800.0 - gripper_openness_counts) * 0.001
        return torch.cat([arm_qpos, ang[:, None].expand(-1, n_extra)
                          .to(arm_qpos.dtype)], dim=-1)

    def link_deltas(self, qpos_full: torch.Tensor) -> torch.Tensor:
        """(E, L, 4, 4) world-space delta per link (identity if inactive)."""
        fk = self.chain.fk(qpos_full)                          # (E, L, 4, 4)
        delta = (fk @ self.offsets) @ self.base_inv
        eye = torch.eye(4, dtype=delta.dtype, device=delta.device)
        return torch.where(self.active[:, None, None], delta, eye)

    def apply(self, qpos_full, means, quats, mask):
        """Re-pose gaussians under per-link deltas gathered by mask id.
        qpos_full (E, n_dof); means (N, 3), quats (N, 4), mask (N,) shared.
        Returns (E, N, 3), (E, N, 4)."""
        delta = self.link_deltas(qpos_full)
        # the rotation->quaternion of each gathered delta only depends on
        # its link, so it is computed per link and then gathered
        dq = tf.rot_to_quat(delta[..., :3, :3])                # (E, L, 4)
        idx = torch.clamp(mask.long(), 0, delta.shape[1] - 1)
        D = delta[:, idx]                                      # (E, N, 4, 4)
        means_new = ((D[..., :3, :3] * means[None, :, None, :]).sum(-1)
                     + D[..., :3, 3])
        quats_new = tf.quat_multiply(dq[:, idx], quats[None])
        return means_new, quats_new
