"""xArm-specific splat and eef-point transforms: the reference's
sim/utils/robot/robot_pc_transformations.py function surface.

Counterpart of the JAX package's kinematics/xarm_transforms.py. The splat
re-posing runs the port's ``RobotArticulation`` on the device that
``device`` names (the card by default) and returns torch tensors there;
the eef-point functions are host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..renderer.scene import (RobotArticulation, XARM_GRIPPER_LINK_IDS,
                              XARM_PUSHER_LINK_IDS)
from ..utils import transforms_np as tnp
from ..utils.device import resolve_device
from .robot import RobotModel

INIT_QPOS_DEG = [0, -45, 0, 30, 0, 75, 0]


def _articulation(sample_robot: RobotModel, use_pusher: bool,
                  init_qpos_deg, init_gripper_counts: float, device):
    ids = XARM_PUSHER_LINK_IDS if use_pusher else XARM_GRIPPER_LINK_IDS
    ids = tuple(i for i in ids if i < len(sample_robot.chain.link_names))
    q7 = np.asarray(init_qpos_deg, np.float64) * np.pi / 180
    n_extra = sample_robot.chain.n_dof - 7
    base_q = (np.concatenate(
        [q7, np.full(n_extra, (800 - init_gripper_counts) * 0.001)])
        if n_extra else q7)
    return RobotArticulation.build(sample_robot, ids, base_q, use_pusher,
                                   device=device)


def _repose(art: RobotArticulation, q_full: torch.Tensor, params,
            total_mask, dev):
    """One pose's (1, n_dof) ``q_full`` applied to the splats of
    ``params`` (activated arrays: means3D, rotations or
    unnorm_rotations); returns a copy of ``params`` with both moved."""
    rot_key = "rotations" if "rotations" in params else "unnorm_rotations"
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=dev)
    mask = torch.as_tensor(np.maximum(np.asarray(total_mask), 0), device=dev)
    means, quats = art.apply(q_full, f32(params["means3D"]),
                             f32(params[rot_key]), mask)
    out = dict(params)
    out["means3D"] = means[0]
    out[rot_key] = quats[0]
    return out


def transform_gs_xarm_gripper(qpos, gripper_openness, params, total_mask,
                              init_qpos=INIT_QPOS_DEG, init_gripper=750,
                              sample_robot: RobotModel = None,
                              device="cuda"):
    """Re-pose scene-scan gaussians for a qpos + gripper openness (counts).
    ``params`` holds activated arrays (means3D / rotations); a copy is
    returned whose two moved entries are (N, 3) and (N, 4) tensors on
    ``device``."""
    dev = resolve_device(device)
    art = _articulation(sample_robot, False, init_qpos, init_gripper, dev)
    q7 = torch.as_tensor(np.asarray(qpos, np.float32)[:7], device=dev)
    counts = torch.tensor([float(gripper_openness)], dtype=torch.float32,
                          device=dev)
    return _repose(art, art.full_qpos(q7[None], counts), params, total_mask,
                   dev)


def transform_gs_xarm_pusher(qpos, params, total_mask,
                             init_qpos=INIT_QPOS_DEG,
                             sample_robot: RobotModel = None,
                             device="cuda"):
    """The pusher's re-pose: the arm's seven joints, any finger joints at
    800 counts (closed)."""
    dev = resolve_device(device)
    art = _articulation(sample_robot, True, init_qpos, 800, dev)
    q_full = torch.as_tensor(np.asarray(qpos, np.float32)[:7],
                             device=dev)[None]
    if sample_robot.chain.n_dof > 7:
        q_full = art.full_qpos(q_full, torch.zeros(1, device=dev))
    return _repose(art, q_full, params, total_mask, dev)


def transform_eef_pts_xarm_gripper(robot: RobotModel, qpos, gripper_openness,
                                   device=None, init_qpos=INIT_QPOS_DEG,
                                   init_gripper=750, sample_robot=None):
    """World-frame gripper-mesh vertices at qpos + openness counts."""
    openness = 1.0 - (800.0 - float(gripper_openness)) / 800.0
    meshes = robot.get_gripper_meshes(
        gripper_openness=openness,
        arm_qpos=np.asarray(qpos, np.float64)[:7])
    return np.concatenate([m.vertices for m in meshes],
                          axis=0).astype(np.float32)


def transform_eef_pts_xarm_pusher(robot: RobotModel, qpos, device=None,
                                  init_qpos=INIT_QPOS_DEG, sample_robot=None):
    meshes = robot.get_pusher_meshes(arm_qpos=np.asarray(qpos, np.float64)[:7])
    return np.concatenate([m.vertices for m in meshes],
                          axis=0).astype(np.float32)


def _ik_to_qpos(kin_helper, eef_xyz, eef_quat, qpos_curr):
    R = tnp.quat_to_rot(np.asarray(eef_quat))
    rpy = _mat_to_euler(R)
    cart = np.concatenate([np.asarray(eef_xyz).reshape(3), rpy])
    return kin_helper.compute_ik_sapien(np.asarray(qpos_curr), cart)


def _mat_to_euler(R):
    sp = -np.clip(R[2, 0], -1, 1)
    p = np.arcsin(sp)
    cp = np.cos(p)
    if abs(cp) > 1e-7:
        r = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(R[1, 0], R[0, 0])
    else:
        r = np.arctan2(-R[1, 2], R[1, 1])
        y = 0.0
    return np.array([r, p, y])


def get_eef_pts_xarm_gripper(eef_xyz, eef_quat, eef_gripper, robot,
                             sample_robot, kin_helper, qpos_curr_xarm,
                             device=None):
    """Current eef points + an interpolation function over openness on the
    101-sample table: it returns world-frame (P, 3) vertices at an
    openness in [0, 1]."""
    qpos = _ik_to_qpos(kin_helper, eef_xyz, eef_quat, qpos_curr_xarm)
    table = robot.eef_points_table()          # (101, P, 3) in the eef frame
    fk = robot.fk_numpy(robot.full_qpos(np.asarray(qpos)[:7], openness=1.0))
    T_we = fk[robot.chain.link_index(robot.eef_link_name())]

    def eef_pts_func(openness: float) -> np.ndarray:
        o = float(np.clip(openness, 0.0, 1.0)) * 100.0
        i0 = int(min(np.floor(o), 99))
        frac = o - i0
        pts = (1 - frac) * table[i0] + frac * table[i0 + 1]
        return pts @ T_we[:3, :3].T + T_we[:3, 3]

    g = float(np.asarray(eef_gripper).reshape(-1)[0])
    return eef_pts_func(g), eef_pts_func


def get_eef_pts_xarm_pusher(eef_xyz, eef_quat, robot, sample_robot,
                            kin_helper, qpos_curr_xarm, device=None):
    """The pusher's eef points: no openness dependence, the table is
    constant."""
    qpos = _ik_to_qpos(kin_helper, eef_xyz, eef_quat, qpos_curr_xarm)
    fk = robot.fk_numpy(robot.full_qpos(np.asarray(qpos)[:7]))
    T_we = fk[robot.chain.link_index(robot.eef_link_name())]
    verts_local = robot.eef_points_table(n_samples=2)[0]

    def eef_pts_func(openness: float = 1.0) -> np.ndarray:
        return verts_local @ T_we[:3, :3].T + T_we[:3, 3]

    return eef_pts_func(1.0), eef_pts_func
