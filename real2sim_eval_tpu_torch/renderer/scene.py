"""Scene assembly: colour correction, pose randomization, robot-splat
articulation.

Counterpart of the JAX package's renderer/scene.py. Scan gaussians carry a
URDF document-order link id; per frame the delta transform
FK(q) @ offset @ inv(FK(q0) @ offset) is gathered per gaussian by that id.
The host-side helpers (colour correction, randomization, rigid posing of
splat parameters) are numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kinematics.chain import KinematicChain
from ..kinematics.robot import RobotModel
from ..utils import transforms as tf
from ..utils.profiling import spanned
from ..utils.sh import C0

# link-id lists of the xArm URDF variants
XARM_GRIPPER_LINK_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15, 16)
XARM_PUSHER_LINK_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 10)


def correct_sh_colors(shs: np.ndarray, A: np.ndarray,
                      b: np.ndarray) -> np.ndarray:
    """Apply a fitted linear (A: 3x3) or quadratic (A: 3x6 = [A2|A1]) RGB
    transform to SH coefficients, band by band.

    The DC band absorbs the affine bias so that the *decoded* colour
    C0*sh+0.5 maps through colour' = A@colour + b; higher bands only see
    the linear part.
    """
    shs = np.asarray(shs, np.float32)          # (n, K, 3)
    A = np.asarray(A, np.float32).reshape(3, -1)
    b = np.asarray(b, np.float32).reshape(3)
    max_deg = int(np.sqrt(shs.shape[1])) - 1
    out = []
    ones = np.ones(3, np.float32)
    if A.shape[1] == 3:
        for si in range(max_deg + 1):
            band = shs[:, si ** 2:(si + 1) ** 2, :]
            if si == 0:
                bias = (1.0 / C0) * ((0.5 * ones) @ A.T + b - 0.5 * ones)
                out.append((band[:, 0] @ A.T + bias)[:, None])
            else:
                out.append(band @ A.T)
    elif A.shape[1] == 6:
        A2, A1 = A[:, :3], A[:, 3:]
        for si in range(max_deg + 1):
            band = shs[:, si ** 2:(si + 1) ** 2, :]
            if si == 0:
                dc = band[:, 0]
                corr = dc @ A1.T + (dc + C0 * dc ** 2) @ A2.T
                bias = (1.0 / C0) * ((0.25 * ones) @ A2.T
                                     + (0.5 * ones) @ A1.T + b - 0.5 * ones)
                out.append((corr + bias)[:, None])
            else:
                out.append(band @ A1.T)
    else:
        raise ValueError(f"color_A must be 3x3 or 3x6, got {A.shape}")
    return np.concatenate(out, axis=1)


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


def uniform_random_values(rng: np.random.RandomState, translation_range,
                          azimuth_range):
    """Uniform ranges, drawn from ``rng`` in the reference's order (x, y,
    z, azimuth). A ``RandomState(seed)`` gives the draws the reference's
    ``np.random.seed(seed)`` followed by ``np.random.uniform`` gives."""
    tr = np.asarray(translation_range, np.float64)
    az = np.asarray(azimuth_range, np.float64)
    rx = rng.uniform(tr[0], tr[1])
    ry = rng.uniform(tr[2], tr[3])
    rz = rng.uniform(tr[4], tr[5])
    ra = rng.uniform(az[0], az[1]) * np.pi / 180.0
    return float(rx), float(ry), float(rz), float(ra)


def apply_random_pose(pose: np.ndarray, rand) -> np.ndarray:
    """pose[:3, 3] += t; pose[:3, :3] = Rz(a) @ pose[:3, :3]."""
    rx, ry, rz, ra = rand
    pose = np.array(pose, np.float64)
    pose[:3, 3] += [rx, ry, rz]
    c, s = np.cos(ra), np.sin(ra)
    pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ pose[:3, :3]
    return pose


def transform_params_by_pose(params: dict, pose: np.ndarray) -> dict:
    """Rigidly move activated splat params (means + orientations)."""
    R = np.asarray(pose[:3, :3], np.float32)
    t = np.asarray(pose[:3, 3], np.float32)
    out = dict(params)
    out["means3D"] = params["means3D"] @ R.T + t
    q = params["rotations"]
    w = np.sqrt(np.maximum(1 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    w1, x1, y1, z1 = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                               (R[0, 2] - R[2, 0]) / (4 * w),
                               (R[1, 0] - R[0, 1]) / (4 * w)], np.float32)
    w2, x2, y2, z2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    out["rotations"] = np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)
    return out


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
    def build(robot: RobotModel, link_ids, base_qpos_full: np.ndarray,
              use_pusher: bool = False, device="cpu"):
        """Tables of ``robot``'s links ``link_ids`` at the base pose, with
        each link's collision origin (``robot.offsets``) as its offset."""
        chain = robot.chain
        link_offsets = robot.offsets
        L = len(chain.link_names)
        base_fk = robot.fk_numpy(base_qpos_full)
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

    @spanned("articulation")
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
