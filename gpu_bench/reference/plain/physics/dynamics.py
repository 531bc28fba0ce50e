"""PhysTwin dynamics: grasp heuristic, control construction, and the
single-env facade that loads a checkpoint and steps it.

Counterpart of the JAX package's physics/dynamics.py: the branch-free
gripper openness hysteresis and the SubstepControls the step consumes
(batched over envs), ``make_control_core`` (one control step: controls,
then the fused step K3) and ``PhysTwinDynamics`` (``reset`` from a
checkpoint, ``step``, ``compute_fk``, ``get_state``). The single env runs
the batched step at B = 1, as the JAX package runs its Pallas step.

Frames: the public state dicts live in the data/world frame; internally
physics runs in the model frame shifted by (0, 0, -table_height).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..utils import transforms as tf
from ..utils.device import resolve_device
from . import checkpoints as ckpt_io
from .fused_step import make_fused_step_fn
from .sdf import build_sdf_grid
from .spring_mass import (MeshColliderSet, PhysicsOptions, SpringMassParams,
                          SpringMassState, SubstepControls,
                          interp_finger_pose)
from .topology import build_neighbor_tables, connect_springs


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


def make_control_core(opts: PhysicsOptions, force_threshold: float,
                      has_colliders: bool = True, device="cuda"):
    """One control step, batched over envs.

    core(params, colliders, sm_state, grasp_state, eef_xyz, eef_rot,
         eef_vel, eef_rot_vel, openness_cmd, finger_centroids)
      -> (sm_state, grasp_state, openness_end)

    Every eef quantity is in the model frame with a leading env dim B;
    ``colliders.static_pose`` is (B, n_statics, 4, 4). The substeps run
    ``make_fused_step_fn`` (K3 on the card)."""
    step_fn = make_fused_step_fn(opts, has_colliders=has_colliders,
                                 device=device)
    build = make_ctrl_builder(opts, force_threshold)

    def core(params, colliders, sm_state, grasp_state, eef_xyz, eef_rot,
             eef_vel, eef_rot_vel, openness_cmd, finger_centroids):
        ctrl, new_grasp, o_end = build(
            colliders, sm_state, grasp_state, eef_xyz, eef_rot, eef_vel,
            eef_rot_vel, openness_cmd, finger_centroids)
        rest_x = params.rest_x
        if rest_x.dim() == 2:
            rest_x = rest_x.expand(eef_xyz.shape[0], -1, -1)
        new_sm = step_fn(params, colliders, sm_state, ctrl, rest_x)
        return new_sm, new_grasp, o_end

    return core


def _grid_on(grid, dev: torch.device):
    """An SdfGrid's tensors on ``dev`` (the caches hold host grids)."""
    return dataclasses.replace(
        grid, **{f.name: getattr(grid, f.name).to(dev)
                 for f in dataclasses.fields(grid)})


class PhysTwinDynamics:
    """Stateful single-env facade: ``reset(state, ...) -> aligned points``,
    ``step(state, action) -> next_state``, ``get_state()``,
    ``compute_fk``.

    State dicts hold tensors on ``device`` (world frame); actions are
    (n_grippers, 13) cartesian [xyz, rot9, gripper] or (n_grippers, 8)
    joint [qpos7, gripper]."""

    # class-level caches shared by every instance of a process, keyed as
    # the JAX package keys them; they hold host (CPU) grids and topology
    _sdf_cache: dict = {}
    _topology_cache: dict = {}

    def __init__(self, cfg, exp_root=None, ckpt_path=None, case_name=None,
                 local_rank: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ckpt_path = ckpt_path or cfg.get("ckpt_path")
        self.case_name = case_name or cfg.get("case_name")
        self._kin_chain = None

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- reset ----------------------------------------------------------

    def reset(self, state, init_meshes_dict, mesh_poses, robot=None,
              eef_pts_func=None, kin_helper=None, init_eef_xyz=None,
              pose_obj=None):
        """Build the episode's params, colliders and state.

        ``init_meshes_dict`` holds canonical meshes and ``mesh_poses``
        (name -> 4x4) their world poses, so each asset's SDF grid is built
        once and shared across randomized episodes."""
        phys = self.cfg.physics
        dev = self.device
        T = self._tensor
        table_height = float(phys.table_height)
        self.global_translation = np.array([0.0, 0.0, -table_height],
                                           np.float32)
        if kin_helper is not None:
            self._kin_chain = kin_helper.chain
        self.kin_helper = kin_helper
        self.init_eef_xyz = (np.zeros((1, 3), np.float32)
                             if init_eef_xyz is None
                             else np.asarray(init_eef_xyz, np.float32))

        # --- checkpoint load -------------------------------------------
        data = ckpt_io.load_final_data(f"{self.ckpt_path}/data",
                                       self.case_name)
        object_pts = np.concatenate(
            [np.asarray(data["object_points"])[0],
             np.asarray(data["surface_points"]),
             np.asarray(data["interior_points"])], axis=0).astype(np.float64)
        pose_np = (np.asarray(pose_obj, np.float64) if pose_obj is not None
                   else np.eye(4))
        init_pts_aligned = object_pts @ pose_np[:3, :3].T + pose_np[:3, 3]

        optimal = ckpt_io.load_optimal_params(
            f"{self.ckpt_path}/experiments_optimization", self.case_name)
        ckpt_io.apply_optimal_params(phys, optimal)
        phys.num_substeps = round(1.0 / phys.fps / phys.dt)

        # topology is pose-invariant: the connection is cached across the
        # randomized episodes of one checkpoint; rest lengths come from
        # the aligned points
        topo_key = (str(self.ckpt_path), str(self.case_name),
                    float(phys.object_radius),
                    int(phys.object_max_neighbours))
        if topo_key not in PhysTwinDynamics._topology_cache:
            PhysTwinDynamics._topology_cache[topo_key] = connect_springs(
                object_pts, phys.object_radius, phys.object_max_neighbours,
                rest_points=init_pts_aligned)
        springs, _ = PhysTwinDynamics._topology_cache[topo_key]
        rest_lengths = np.linalg.norm(
            init_pts_aligned[springs[:, 0]] - init_pts_aligned[springs[:, 1]],
            axis=-1).astype(np.float32)

        first = ckpt_io.load_first_order(f"{self.ckpt_path}/experiments",
                                         self.case_name)
        num_object_springs = int(first["num_object_springs"])
        if springs.shape[0] != num_object_springs:
            raise ValueError(f"spring count mismatch: built {springs.shape[0]}"
                             f", checkpoint {num_object_springs}")
        spring_Y = np.asarray(first["spring_Y"])[:num_object_springs]

        use_pusher = bool(self.cfg.env["robot"]["use_pusher"])
        if use_pusher:
            phys.collide_eef_fric = 0.2

        # --- model frame shift -----------------------------------------
        init_pts_model = (init_pts_aligned
                          + self.global_translation).astype(np.float32)

        # --- colliders --------------------------------------------------
        self.robot = robot
        fingers, finger_table = (), None
        finger_centroids = np.zeros((1, 3), np.float32)
        n_fingers = 0
        if robot is not None:
            finger_links = robot.finger_link_names()
            n_fingers = len(finger_links)
            fingers = tuple(_grid_on(self._finger_sdf(robot, n), dev)
                            for n in finger_links)
            finger_table = robot.finger_pose_table(finger_links)
            finger_centroids = np.stack(
                [robot.meshes[n].vertices.mean(0) for n in finger_links]
            ).astype(np.float32)

        statics, static_poses = [], []
        T_shift = np.eye(4, dtype=np.float32)
        T_shift[:3, 3] = self.global_translation
        for name, mesh in init_meshes_dict.items():
            statics.append(_grid_on(self._static_sdf(name, mesh), dev))
            static_poses.append(
                (T_shift @ np.asarray(mesh_poses[name], np.float64)
                 ).astype(np.float32))
        self.init_meshes = {
            k: m.copy().transform(np.asarray(mesh_poses[k]))
            .translated(self.global_translation)
            for k, m in init_meshes_dict.items()}

        np_static_pose = (np.stack(static_poses) if static_poses
                          else np.zeros((0, 4, 4), np.float32))
        self.colliders = MeshColliderSet(
            fingers=fingers,
            finger_pose_table=(T(finger_table, torch.float32)
                               if finger_table is not None
                               else torch.zeros((1, 101, 4, 4), device=dev)),
            statics=tuple(statics), static_pose=T(np_static_pose))
        # host copies for the batched evaluator's asset build
        self.host_cache = {"rest_x": init_pts_model,
                           "static_pose": np_static_pose}
        self.finger_centroids = T(finger_centroids)

        # --- params / options ------------------------------------------
        n = len(init_pts_model)
        coll_mask_np = np.arange(n, dtype=np.int32)
        y_log = np.log(np.maximum(spring_Y, 1e-12))
        nbr_idx, nbr_rest, nbr_Y = build_neighbor_tables(
            springs, rest_lengths, y_log, n)
        # same-group exclusion from collision_mask equality, as the
        # fallback in spring_mass.static_candidate_invalid defines it
        cand_invalid = ((np.linalg.norm(init_pts_model[:, None]
                                        - init_pts_model[None], axis=-1)
                         < float(phys.collision_dist) * 5.0)
                        | (coll_mask_np[:, None] == coll_mask_np[None]))

        def scalar(v):
            return T(np.float32(np.asarray(v).ravel()[0]))

        self.params = SpringMassParams(
            springs=T(springs), rest_lengths=T(rest_lengths),
            spring_Y_log=T(y_log, torch.float32),
            masses=torch.ones((n,), dtype=torch.float32, device=dev),
            nbr_idx=T(nbr_idx), nbr_rest=T(nbr_rest), nbr_Y_log=T(nbr_Y),
            collision_mask=T(coll_mask_np), rest_x=T(init_pts_model),
            collide_elas=scalar(first["collide_elas"]),
            collide_fric=scalar(first["collide_fric"]),
            collide_eef_elas=scalar(float(phys.collide_eef_elas)),
            collide_eef_fric=scalar(float(phys.collide_eef_fric)),
            collide_self_elas=scalar(first["collide_object_elas"]),
            collide_self_fric=scalar(first["collide_object_fric"]),
            cand_invalid=T(cand_invalid))
        self.opts = PhysicsOptions(
            dt=float(phys.dt), num_substeps=int(phys.num_substeps),
            fps=float(phys.fps),
            dashpot_damping=float(phys.dashpot_damping),
            drag_damping=float(phys.drag_damping),
            spring_Y_min=float(phys.spring_Y_min),
            spring_Y_max=float(phys.spring_Y_max),
            collision_dist=float(phys.collision_dist),
            reverse_factor=-1.0 if phys.reverse_z else 1.0,
            self_collision=bool(phys.self_collision),
            use_pusher=use_pusher, n_fingers=max(n_fingers, 1))
        self.sm_state = SpringMassState(
            x=T(init_pts_model)[None],
            v=torch.zeros((1, n, 3), dtype=torch.float32, device=dev),
            finger_forces=torch.zeros((1, self.opts.n_fingers, 3),
                                      dtype=torch.float32, device=dev),
            telemetry=torch.zeros((1, 4), dtype=torch.int32, device=dev))
        self.grasp_state = GraspState(
            current_openness=torch.ones((1,), device=dev),
            grasped=torch.zeros((1,), dtype=torch.bool, device=dev),
            initialized=torch.zeros((1,), dtype=torch.bool, device=dev))
        self._core = make_control_core(
            self.opts, float(phys.grasp_force_threshold),
            has_colliders=bool(fingers or statics), device=dev)

        # kept for get_state
        self.init_springs = self.params.springs
        self.init_rest_lengths = self.params.rest_lengths
        self.init_spring_Y = T(spring_Y, torch.float32)
        return T(init_pts_aligned, torch.float32)

    def _finger_sdf(self, robot, link_name):
        key = (str(robot.urdf_path), link_name)
        if key not in PhysTwinDynamics._sdf_cache:
            PhysTwinDynamics._sdf_cache[key] = build_sdf_grid(
                robot.meshes[link_name])
        return PhysTwinDynamics._sdf_cache[key]

    def _static_sdf(self, name, mesh):
        key = ("static", name,
               hashlib.md5(np.ascontiguousarray(mesh.vertices)).hexdigest())
        if key not in PhysTwinDynamics._sdf_cache:
            PhysTwinDynamics._sdf_cache[key] = build_sdf_grid(mesh)
        return PhysTwinDynamics._sdf_cache[key]

    # -- step -----------------------------------------------------------

    def step(self, state, action):
        """One control step at ``fps``."""
        T = self._tensor
        fps = self.opts.fps
        action = torch.as_tensor(action, dtype=torch.float32,
                                 device=self.device)
        eef_xyz = T(state["eef_xyz"], torch.float32)         # (n_g, 3)
        eef_quat = T(state["eef_quat"], torch.float32)       # (n_g, 4)
        eef_rot = tf.quat_to_rot(eef_quat)

        if action.shape[-1] == 13:
            mode = "xyz_rot"
            eef_xyz_next = action[..., :3]
            eef_rot_next = action[..., 3:12].reshape(-1, 3, 3)
            eef_gripper_next = action[..., 12:]
            eef_quat_next = tf.rot_to_quat(eef_rot_next)
        elif action.shape[-1] == 8:
            mode = "joint"
            eef_xyz_next, eef_quat_next = self.compute_fk(action[:, :-1])
            eef_gripper_next = 1.0 - action[:, -1:]
            eef_rot_next = tf.quat_to_rot(eef_quat_next)
        else:
            raise NotImplementedError(f"action dim {action.shape[-1]}")

        g = T(self.global_translation)
        exyz = eef_xyz + g
        exyz_next = eef_xyz_next + g
        eef_vel = (exyz_next - exyz) * fps
        eef_rot_delta = eef_rot @ torch.linalg.inv_ex(eef_rot_next)[0]
        eef_rot_vel = tf.rot_to_axis_angle(eef_rot_delta) * fps  # (n_g, 3)

        x0 = self.sm_state.x
        colliders = self.colliders.replace(
            static_pose=self.colliders.static_pose[None])
        self.sm_state, self.grasp_state, openness_end = self._core(
            self.params, colliders, self.sm_state, self.grasp_state,
            exyz[:1], eef_rot[:1], eef_vel[:1], eef_rot_vel[:1],
            eef_gripper_next.reshape(-1)[:1], self.finger_centroids)

        next_state = {
            "current_openness": openness_end.reshape(1),
            "x": self.sm_state.x[0] - g,
            "v": (self.sm_state.x[0] - x0[0]) * fps,
            "eef_xyz": eef_xyz_next,
            "eef_vel": eef_vel,
            "eef_quat": eef_quat_next,
            "eef_quat_vel": eef_rot_vel,
            "eef_gripper": eef_gripper_next,
        }
        if mode == "joint":
            next_state["qpos"] = action
        return next_state

    def compute_fk(self, joint_commands):
        """(n_g, 7) joint positions -> eef xyz + wxyz quat."""
        if self._kin_chain is None:
            raise RuntimeError("reset() with a kin_helper first")
        chain = self._kin_chain
        T = chain.fk_link(torch.as_tensor(joint_commands, dtype=torch.float32,
                                          device=self.device),
                          chain.link_index("link7"))
        return T[:, :3, 3], tf.rot_to_quat(T[:, :3, :3])

    def get_state(self):
        static_meshes = [{"vertices": m.vertices, "faces": m.faces}
                         for m in self.init_meshes.values()]
        return {
            "init_springs": self.init_springs,
            "init_rest_lengths": self.init_rest_lengths,
            "init_spring_Y": self.init_spring_Y,
            "static_meshes": static_meshes,
        }

    @property
    def current_points(self):
        return self.sm_state.x[0]
