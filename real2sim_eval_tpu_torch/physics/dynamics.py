"""Grasp heuristic and per-env control construction, batched over envs.

Counterpart of ``GraspState``, ``grasp_update`` and ``make_ctrl_builder``
in the JAX package's physics/dynamics.py: the branch-free gripper
openness hysteresis and the SubstepControls the step consumes.
"""

from __future__ import annotations

import dataclasses

import torch

from .spring_mass import (MeshColliderSet, PhysicsOptions, SpringMassState,
                          SubstepControls, interp_finger_pose)


@dataclasses.dataclass(frozen=True)
class GraspState:
    """Gripper openness hysteresis, (B,) each."""

    current_openness: torch.Tensor
    grasped: torch.Tensor
    initialized: torch.Tensor


def grasp_update(state: GraspState, openness_cmd, finger_forces,
                 force_threshold: float, release_threshold: float = 100.0):
    """Returns (openness_start (B,), openness_end (B,), new_state)."""
    current = torch.where(state.initialized, state.current_openness,
                          openness_cmd)
    force_norm = torch.sqrt((finger_forces * finger_forces).sum(-1))
    grasped = torch.where((force_norm < release_threshold).all(-1),
                          torch.zeros_like(state.grasped), state.grasped)
    closing = openness_cmd < current
    strong = (force_norm > force_threshold).all(-1)
    hold = closing & strong
    slip = closing & ~strong & grasped
    new_current = torch.where(
        hold, current,
        torch.where(slip, torch.maximum(openness_cmd, current - 0.05),
                    openness_cmd))
    new_state = GraspState(current_openness=new_current,
                           grasped=hold | grasped,
                           initialized=torch.ones_like(state.initialized))
    return (torch.clamp(current, 0.0, 1.0), torch.clamp(new_current, 0.0, 1.0),
            new_state)


def make_ctrl_builder(opts: PhysicsOptions, force_threshold: float):
    """builder(colliders, sm_state, grasp_state, eef_xyz, eef_rot, eef_vel,
    eef_rot_vel, openness_cmd, finger_centroids)
      -> (SubstepControls, new GraspState, openness_end), all batched."""
    n_sub = opts.num_substeps
    dt = opts.dt

    def build(colliders: MeshColliderSet, sm_state: SpringMassState,
              grasp_state: GraspState, eef_xyz, eef_rot, eef_vel,
              eef_rot_vel, openness_cmd, finger_centroids):
        B = eef_xyz.shape[0]
        if opts.use_pusher:
            one = torch.ones((B,), dtype=eef_xyz.dtype, device=eef_xyz.device)
            o_start = o_end = one
            new_grasp = GraspState(current_openness=one,
                                   grasped=torch.zeros_like(one, dtype=bool),
                                   initialized=torch.ones_like(one,
                                                               dtype=bool))
            closing_vel = torch.zeros((B, opts.n_fingers, 3),
                                      dtype=eef_xyz.dtype,
                                      device=eef_xyz.device)
        else:
            o_start, o_end, new_grasp = grasp_update(
                grasp_state, openness_cmd, sm_state.finger_forces,
                force_threshold)
            T0 = interp_finger_pose(colliders.finger_pose_table, o_start)
            T1 = interp_finger_pose(colliders.finger_pose_table, o_end)
            c0 = (torch.einsum("bfij,fj->bfi", T0[..., :3, :3],
                               finger_centroids) + T0[..., :3, 3])
            c1 = (torch.einsum("bfij,fj->bfi", T1[..., :3, :3],
                               finger_centroids) + T1[..., :3, 3])
            delta_world = (c1 - c0) @ eef_rot.transpose(-1, -2)
            closing_vel = delta_world / (2.0 * dt * n_sub)
        ctrl = SubstepControls(
            eef_xyz=eef_xyz, eef_vel=eef_vel, eef_rot=eef_rot,
            eef_rot_vel=eef_rot_vel, openness_start=o_start,
            openness_end=o_end,
            dyn_lin_vel=eef_vel[:, None] * 0.5 + closing_vel,
            dyn_omega=-eef_rot_vel * 0.5)
        return ctrl, new_grasp, o_end

    return build
