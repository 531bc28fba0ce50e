"""Batched episode evaluation: B envs step and render in lockstep.

Counterpart of the JAX package's parallel/batched.py. One control step:

  1. the velocity-control mimic: batched IK toward the action pose, a
     clamped joint step, FK of the new pose (``step`` with velocity control);
  2. the grasp machine and the per-env control build;
  3. the spring-mass step: freezes in PyTorch, then all substeps in the
     CUDA kernel K3 (physics/fused_step.py);

and one render, on one of the JAX package's three branches:

  - incremental (``RasterConfig(incremental="auto")`` on the card, "on"
    anywhere; the JAX package's flagship branch): LBS of the object splats
    plus the robot-link rows, one IK (``compose_dyn``); the fixed cameras
    re-composite only their dirty tiles on top of static frames built once
    (renderer/incremental.py: sort merge + K2, or K6; with
    ``kernel="fine"`` renderer/incremental_fine.py: dirty 8x16 fine tiles,
    sort merge + K5); the wrist camera runs the full pipeline (K1, or K4
    for the fine family, picked by ``wrist_kernel``) on [dynamic; static],
    the static part (and the dynamic part, where it pays) first culled to
    the blocks its frustum can see (renderer/precull.py), under the JAX
    package's rules;
  - full pipeline (``incremental="off"``, and "auto" on the CPU): LBS plus
    robot articulation of the whole scene (``compose``), per-camera
    preprocess and exact binning, then ONE launch of K1 (K4 with
    ``kernel="fine"``) over every (env, camera, tile);
  - per env (``RasterConfig(backend="reference")``, or cameras of more
    than one resolution): the whole scene of each env through
    ``rasterize``, one camera at a time.

The evaluator is built from a config and episode ids, as the JAX one is
(``parallel/assets.py`` resets one ``BaseEnv`` per episode), or from
ready ``BatchedAssets`` (convert.py, testing.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kinematics import KinematicChain, make_ik_fn
from ..physics.dynamics import GraspState, make_ctrl_builder
from ..physics.fused_step import make_fused_step_fn
from ..physics.spring_mass import (MeshColliderSet, PhysicsOptions,
                                   SpringMassParams, SpringMassState)
from ..renderer import lbs as lbs_mod
from ..renderer import precull as pc
from ..renderer.camera import Camera, setup_camera, wrist_w2c
from ..renderer.incremental import (build_static_raster, group_statics,
                                    render_incremental)
from ..renderer.incremental_fine import (build_static_raster_fine,
                                         render_incremental_fine)
from ..renderer.raster import RasterConfig, rasterize, rasterize_batch
from ..renderer.scene import RobotArticulation
from ..utils import transforms as tf
from ..utils.device import resolve_device
from ..utils.profiling import count, host_span, span, spanned


SPLAT_KEYS = ("means3D", "scales", "rotations", "opacities", "shs")
# eef offsets (m) of the wrist poses the cull capacity is planned over,
# beside the init pose (the JAX package's swept_wlist)
WRIST_SWEEP = ((0, 0, 0.1), (0, 0, 0.2), (0, 0, -0.1), (0.15, 0, 0),
               (-0.15, 0, 0), (0, 0.15, 0), (0, -0.15, 0))


@dataclasses.dataclass(frozen=True)
class BatchedState:
    sm: SpringMassState           # leaves (B, ...)
    grasp: GraspState             # leaves (B,)
    grippers: torch.Tensor        # (B, 14) [xyz, vel, quat, rot vel, open]
    qpos7: torch.Tensor           # (B, 7) current IK arm pose
    rel_pose: torch.Tensor        # (B, 4, 4) object pose delta vs env 0
    static_pose: torch.Tensor     # (B, M, 4, 4)
    rest_x: torch.Tensor          # (B, N, 3)
    step: int = 0

    def replace(self, **kw) -> "BatchedState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BatchedAssets:
    """Everything the evaluator needs: shared scene assets + initial state."""

    params: SpringMassParams
    opts: PhysicsOptions
    colliders: MeshColliderSet     # static_pose rides in the state
    finger_centroids: torch.Tensor  # (n_fingers, 3)
    global_translation: torch.Tensor  # (3,)
    force_threshold: float
    obj: dict                      # canonical object splats (env-0 frame)
    bones0: torch.Tensor           # (n_bones, 3) rest sim particles
    table: dict                    # scene scan splats
    mask: torch.Tensor             # (N_table,) i32 link id per scan splat
    # name -> attached-mesh splats: per lane (B, N_m, ...), each lane's
    # at its own episode's mesh pose (a config build), or shared (N_m, ...)
    mesh_params: dict
    qpos0: torch.Tensor            # (7,)
    cameras: list                  # [(w, h, K (3, 3), w2c (4, 4))]
    wrist_cameras: list            # [(w, h, K (3, 3), eef2c (4, 4))]
    chain: KinematicChain
    articulation: RobotArticulation
    use_shs: bool
    fps: float
    do_velocity_control: bool
    state: BatchedState            # initial state
    # per episode, from a config build: randomization draws and the
    # world-posed static meshes (the success calculators' schema)
    random_variables: list | None = None
    static_mesh_dumps: list | None = None


def mesh_groups(mesh_params: dict, batch: int):
    """The lanes grouped by their attached meshes: lanes whose splats of
    every mesh are equal bit for bit (the same mesh poses) share a group,
    numbered in order of their first lane. A mesh's leaves are per lane
    (B, N_m, ...), or shared (N_m, ...) by every lane. Returns (per group,
    its first lane's {name: {attr: (N_m, ...)}}, each lane's group (B,)
    i64 on the leaves' device)."""
    lanes = {name for name, pm in mesh_params.items()
             if pm["means3D"].dim() == 3}
    dev = next((pm["means3D"].device for pm in mesh_params.values()),
               torch.device("cpu"))
    first, lane_group = {}, [0] * batch
    if lanes:
        key = torch.cat([v.reshape(batch, -1).contiguous().view(torch.int32)
                         for name in sorted(lanes)
                         for v in mesh_params[name].values()],
                        dim=1).cpu().numpy()
        lane_group = [first.setdefault(key[b].tobytes(), len(first))
                      for b in range(batch)]
    reps = [lane_group.index(g) for g in range(max(lane_group) + 1)]
    groups = [{name: {k: v[lane] if name in lanes else v
                      for k, v in pm.items()}
               for name, pm in mesh_params.items()} for lane in reps]
    return groups, torch.as_tensor(lane_group, dtype=torch.int64, device=dev)


class BatchedEvaluator:
    """Build once from a config (or ready BatchedAssets) and the episode
    ids, then step/render all envs batched."""

    def __init__(self, cfg_or_assets, episode_ids,
                 raster_config: RasterConfig | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = None
        if isinstance(cfg_or_assets, BatchedAssets):
            assets = cfg_or_assets
        else:
            from .assets import build_assets

            self.cfg = cfg_or_assets
            assets = build_assets(self.cfg, list(episode_ids), raster_config,
                                  self.device)
        if assets.bones0.device.type != self.device.type:
            raise ValueError(f"assets live on {assets.bones0.device}, the "
                             f"evaluator runs on {self.device}")
        # f32 products stay true f32 (physics, IK and LBS carry real
        # values through small matmuls); "highest" is also the default
        torch.set_float32_matmul_precision("highest")
        self.assets = assets
        self.episode_ids = list(episode_ids)
        if len(self.episode_ids) != assets.state.sm.x.shape[0]:
            raise ValueError("episode_ids do not match the assets' batch")
        self.raster_config = raster_config or RasterConfig()
        self.state = assets.state
        self.random_variables = assets.random_variables
        self.render_telemetry = None

        a = assets
        self.relations = lbs_mod.knn_relations(a.bones0)
        self.weights, self.weights_idx = lbs_mod.knn_weights(
            a.bones0, a.obj["means3D"])
        self.sh_deg = (int(np.sqrt(a.obj["shs"].shape[1]) - 1)
                       if a.use_shs else 0)
        self._eef_idx = a.chain.link_index("link7")
        self._ik = make_ik_fn(a.chain, self._eef_idx, n_active=7)
        has_coll = bool(a.colliders.fingers or a.colliders.statics)
        self._step_fn = make_fused_step_fn(a.opts, has_colliders=has_coll,
                                           device=self.device)
        self._build_ctrl = make_ctrl_builder(a.opts, a.force_threshold)
        # extrinsics made on the device once: a render copies nothing from
        # the host for them
        self._fixed_cams = [(cam, torch.as_tensor(w2c, device=self.device))
                            for cam, w2c in (setup_camera(w, h, k, w2c)
                                             for w, h, k, w2c in a.cameras)]
        self._wrist_cams = [
            (Camera(width=int(w), height=int(h), fx=float(k[0][0]),
                    fy=float(k[1][1]), cx=float(k[0][2]), cy=float(k[1][2])),
             torch.as_tensor(np.asarray(e, np.float32), device=self.device))
            for w, h, k, e in a.wrist_cameras]
        # the JAX package's branch rule (batched.py:341-346): the dense
        # reference, or cameras of more than one resolution, render env by
        # env and camera by camera
        self.per_env = (self.raster_config.backend == "reference" or len(
            {(c.height, c.width)
             for c, _ in self._fixed_cams + self._wrist_cams}) > 1)
        mask = a.mask.cpu().numpy()
        self._robot_rows = torch.as_tensor(np.where(mask > 0)[0],
                                           device=self.device)
        self._static_rows = torch.as_tensor(np.where(mask <= 0)[0],
                                            device=self.device)
        # the lanes grouped by their attached meshes' poses: one static
        # raster and one set of wrist pre-cull blocks per group
        self._mesh_groups, self.lane_group = mesh_groups(
            a.mesh_params, len(self.episode_ids))
        self.n_mesh_groups = len(self._mesh_groups)
        count("mesh_groups", self.n_mesh_groups)
        self.render_stats = {}
        self.wrist_cull = None
        self.incremental = False
        self._setup_incremental()

    def _setup_incremental(self):
        """The JAX package's use-rules for the incremental render
        (batched.py:358-362) and the wrist pre-cull (batched.py:449-512),
        and the one-time builds they need: the static frame of every fixed
        camera and, where the cull may run, the KD-ordered static blocks."""
        rc = self.raster_config
        n_static = (int(self._static_rows.shape[0])
                    + sum(int(pm["means3D"].shape[0])
                          for pm in self._mesh_groups[0].values()))
        self.incremental = (not self.per_env and bool(self._fixed_cams)
                            and n_static > 0 and rc.incremental != "off"
                            and (rc.incremental == "on"
                                 or self.device.type == "cuda"))
        if not self.incremental:
            return
        n_groups = self.n_mesh_groups
        scenes = [self.static_scene(g) for g in range(n_groups)]
        fine = rc.kernel == "fine"
        build = build_static_raster_fine if fine else build_static_raster
        self._render_fixed = (render_incremental_fine if fine
                              else render_incremental)
        # the wrist family may take the other compositor (the JAX rule,
        # batched.py:513-519); only on this branch
        self._wrist_config = rc
        if rc.wrist_kernel not in ("inherit", rc.kernel):
            self._wrist_config = dataclasses.replace(rc,
                                                     kernel=rc.wrist_kernel)
        # one raster per camera and mesh group; with more than one group
        # they are stacked once, and each lane reads its group's
        with host_span("static rasters (mesh groups)"):
            rasters = [[build(cam, w2c, sc, self.sh_deg) for sc in scenes]
                       for cam, w2c in self._fixed_cams]
            self._fixed_kw = ({} if n_groups == 1 else {
                "groups": group_statics(rasters, self.lane_group)})
        self._cam_static = [(cam, per_group[0], w2c) for (cam, w2c), per_group
                            in zip(self._fixed_cams, rasters)]
        if self.sh_deg == 0:
            scenes = [dict(sc, shs=sc["shs"][:, :1]) for sc in scenes]
        self._static = (scenes[0] if n_groups == 1 else
                        {k: torch.stack([sc[k] for sc in scenes])
                         for k in SPLAT_KEYS})
        self._wrist_flags = (False, False)
        if (not self._wrist_cams or rc.wrist_precull == "off"
                or scenes[0]["means3D"].shape[0] < 16 * pc.BLOCK):
            return

        st0 = self.state
        eef_rot0 = tf.quat_to_rot(st0.grippers[:, 6:10])

        def poses(offset):
            xyz = st0.grippers[:, :3] + torch.tensor(
                offset, dtype=torch.float32, device=self.device)
            return [(cam, wrist_w2c(eef2c, xyz, eef_rot0))
                    for cam, eef2c in self._wrist_cams]

        init = poses((0.0, 0.0, 0.0))
        sweep = [cw for off in WRIST_SWEEP for cw in poses(off)]
        cap = 0
        culls = []
        with host_span("static rasters (mesh groups)"):
            for grp, sc in enumerate(scenes):
                st_w = pc.pad_static_scene(pc.spatial_sort_scene(sc))
                centers, radii = pc.block_bounds(st_w["means3D"],
                                                 st_w["scales"])
                culls.append((st_w, centers, radii))
                # each group's blocks against its own lanes' poses
                own = (slice(None) if n_groups == 1 else
                       torch.nonzero(self.lane_group == grp)[:, 0])
                # a capacity near the whole scene wins nothing (the JAX
                # rule)
                cap = max(cap, pc.plan_static_cull(
                    [(c, w[own]) for c, w in init], centers, radii),
                    pc.plan_static_cull([(c, w[own]) for c, w in init + sweep],
                                        centers, radii, margin=1.15))
        # with more than one group: the groups' blocks stacked, and each
        # lane's own group's block bounds (B, G, ...)
        self._cull_rows = {}
        self._cull_static = culls[0]
        if n_groups > 1:
            st_ws, cs, rs = zip(*culls)
            self._cull_static = ({k: torch.stack([t[k] for t in st_ws])
                                  for k in pc.SCENE_KEYS},
                                 torch.stack(cs)[self.lane_group],
                                 torch.stack(rs)[self.lane_group])
            self._cull_rows = {"rows": self.lane_group}
        g = int(culls[0][1].shape[0])
        static_on = rc.wrist_precull == "on" or cap < int(0.9 * g)
        dyn0 = self.compose_dyn(st0, dc_only=True)[0]
        dyn_cap = g_dyn = None
        dyn_on = False
        if static_on and dyn0["means3D"].shape[1] >= 16 * pc.BLOCK:
            dyn0 = pc.pad_dynamic_scene(dyn0)
            dyn_cap = max(pc.plan_dynamic_cull(init, dyn0),
                          pc.plan_dynamic_cull(sweep, dyn0, margin=1.15))
            g_dyn = int(dyn0["means3D"].shape[1]) // pc.BLOCK
            dyn_on = rc.wrist_precull == "on" or dyn_cap < int(0.9 * g_dyn)
        self._wrist_flags = (static_on, dyn_on)
        self.wrist_cull = {"static": static_on, "cap_blocks": cap,
                           "total_blocks": g, "dynamic": dyn_on,
                           "dyn_cap_blocks": dyn_cap,
                           "dyn_total_blocks": g_dyn}

    @property
    def batch_size(self) -> int:
        return len(self.episode_ids)

    # ------------------------------------------------------------------
    # control step
    # ------------------------------------------------------------------

    @spanned("grasp + controls")
    def _env_pre(self, state: BatchedState, actions: torch.Tensor):
        """Per-env eef bookkeeping + grasp machine -> SubstepControls."""
        a = self.assets
        B = actions.shape[0]
        g = state.grippers
        eef_rot = tf.quat_to_rot(g[:, 6:10])
        eef_xyz_next = actions[:, :3]
        eef_rot_next = actions[:, 3:12].reshape(B, 3, 3)
        exyz = g[:, :3] + a.global_translation
        eef_vel = (eef_xyz_next + a.global_translation - exyz) * a.fps
        rot_delta = eef_rot @ torch.linalg.inv_ex(eef_rot_next)[0]
        eef_rot_vel = tf.rot_to_axis_angle(rot_delta) * a.fps
        colliders = a.colliders.replace(static_pose=state.static_pose)
        ctrl, grasp, o_end = self._build_ctrl(
            colliders, state.sm, state.grasp, exyz, eef_rot, eef_vel,
            eef_rot_vel, actions[:, 12], a.finger_centroids)
        grippers = torch.cat([eef_xyz_next, eef_vel,
                              tf.rot_to_quat(eef_rot_next), eef_rot_vel,
                              o_end[:, None]], dim=1)
        return ctrl, grasp, grippers, colliders

    def _physics_step(self, state: BatchedState, actions) -> BatchedState:
        ctrl, grasp, grippers, colliders = self._env_pre(state, actions)
        sm = self._step_fn(self.assets.params, colliders, state.sm, ctrl,
                           state.rest_x)
        return state.replace(sm=sm, grasp=grasp, grippers=grippers,
                             step=state.step + 1)

    @spanned("mimic (IK + FK)")
    def _mimic(self, actions, qpos7, gripper_counts):
        """Velocity-control mimic: IK toward the action pose, a joint step
        clamped to 0.1 rad, FK of the new pose."""
        chain = self.assets.chain
        B = actions.shape[0]
        target = tf.make_se3(actions[:, 3:12].reshape(B, 3, 3), actions[:, :3])
        q_sol = self._ik(qpos7, target)[:, :7]
        delta = q_sol - qpos7
        norm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
        delta = torch.where(norm > 0.10,
                            delta / torch.clamp(norm, min=1e-9) * 0.10, delta)
        new_q = qpos7 + (delta / 0.02 * 0.15) / 30.0
        q_full = new_q
        if chain.n_dof > 7:
            q_full = torch.cat([new_q, new_q.new_zeros(
                (B, chain.n_dof - 7))], dim=1)
        T = chain.fk_link(q_full, self._eef_idx)
        cur_g = gripper_counts / 800.0
        dg = torch.clamp(actions[:, 12] - cur_g, -2.0 / 30.0, 2.0 / 30.0)
        out = torch.cat([T[:, :3, 3], T[:, :3, :3].reshape(B, 9),
                         (cur_g + dg)[:, None]], dim=1)
        return out, new_q

    def step_mimic(self, state: BatchedState, actions) -> BatchedState:
        acts, new_q = self._mimic(actions, state.qpos7,
                                  state.grippers[:, 13] * 800.0)
        return self._physics_step(state.replace(qpos7=new_q), acts)

    @spanned("step: other", new_step=True)
    def step(self, actions, do_velocity_control: bool | None = None):
        """actions: (B, 13) cartesian [xyz, rot9, gripper]."""
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.device)
        dvc = (self.assets.do_velocity_control if do_velocity_control is None
               else do_velocity_control)
        if dvc:
            self.state = self.step_mimic(self.state, actions)
        else:
            self.state = self._physics_step(self.state, actions)
        return self.state

    # ------------------------------------------------------------------
    # render
    # ------------------------------------------------------------------

    def _posed_object(self, state: BatchedState):
        """LBS of the object splats on the particle state: (B, N_obj, 3)
        means and (B, N_obj, 4) rotations."""
        a = self.assets
        R = state.rel_pose[:, :3, :3]
        t = state.rel_pose[:, :3, 3]
        means = a.obj["means3D"][None] @ R.transpose(-1, -2) + t[:, None]
        quats = tf.quat_multiply(tf.rot_to_quat(R)[:, None],
                                 a.obj["rotations"][None])
        bones = a.bones0[None] @ R.transpose(-1, -2) + t[:, None]
        xyz = lbs_mod.interpolate_motions(
            bones, state.sm.x - bones, self.relations, self.weights,
            self.weights_idx, means)
        return xyz, quats

    def _arm_pose(self, state: BatchedState):
        """IK arm pose for the current eef (B, 7) and the full joint
        vector (B, n_dof) the robot splats are posed with."""
        eef_rot = tf.quat_to_rot(state.grippers[:, 6:10])
        target = tf.make_se3(eef_rot, state.grippers[:, :3])
        qpos7 = self._ik(state.qpos7, target)[:, :7]
        q_full = self.assets.articulation.full_qpos(
            qpos7, state.grippers[:, 13] * 800.0)
        return qpos7, q_full

    def compose(self, state: BatchedState, dc_only: bool = False):
        """Full-scene gaussians per env in [object, meshes, table] order,
        dict of (B, N, ...) tensors, and the IK arm pose for the current
        eef."""
        a = self.assets
        B = state.rel_pose.shape[0]
        xyz, quats = self._posed_object(state)
        qpos7, q_full = self._arm_pose(state)
        t_means, t_quats = a.articulation.apply(
            q_full, a.table["means3D"], a.table["rotations"], a.mask)

        def shared(v):
            v = v[:, :1] if (dc_only and v.dim() == 3) else v
            return v[None].expand((B,) + v.shape)

        parts = {"means3D": [xyz], "rotations": [quats]}
        for k in ("shs", "opacities", "scales"):
            parts[k] = [shared(a.obj[k])]
        # each lane's meshes at its own episode's pose (with one group,
        # the group's splats spread over the lanes)
        for name, pm in a.mesh_params.items():
            for k in parts:
                if self.n_mesh_groups == 1 or pm["means3D"].dim() == 2:
                    parts[k].append(shared(self._mesh_groups[0][name][k]))
                else:
                    v = pm[k]
                    parts[k].append(v[:, :, :1] if (dc_only and v.dim() == 4)
                                    else v)
        parts["means3D"].append(t_means)
        parts["rotations"].append(t_quats)
        for k in ("shs", "opacities", "scales"):
            parts[k].append(shared(a.table[k]))
        return {k: torch.cat(v, dim=1) for k, v in parts.items()}, qpos7

    @spanned("compose_dyn")
    def compose_dyn(self, state: BatchedState, dc_only: bool = False):
        """The gaussians that move, per env: the LBS'd object splats, then
        the articulated robot-link rows of the scan (mask > 0), dict of
        (B, N_dyn, ...) tensors, and the IK arm pose (one IK call)."""
        a = self.assets
        B = state.rel_pose.shape[0]
        xyz, quats = self._posed_object(state)
        qpos7, q_full = self._arm_pose(state)

        def shared(v):
            v = v[:, :1] if (dc_only and v.dim() == 3) else v
            return v[None].expand((B,) + v.shape)

        parts = {"means3D": [xyz], "rotations": [quats]}
        for k in ("shs", "opacities", "scales"):
            parts[k] = [shared(a.obj[k])]
        rows = self._robot_rows
        if rows.shape[0]:
            r_means, r_quats = a.articulation.apply(
                q_full, a.table["means3D"][rows], a.table["rotations"][rows],
                a.mask[rows])
            parts["means3D"].append(r_means)
            parts["rotations"].append(r_quats)
            for k in ("shs", "opacities", "scales"):
                parts[k].append(shared(a.table[k][rows]))
        return ({k: torch.cat(v, dim=1) if len(v) > 1 else v[0]
                 for k, v in parts.items()}, qpos7)

    def static_scene(self, group: int = 0) -> dict:
        """The gaussians that never move in the lanes of mesh group
        ``group``, (N_s, ...) tensors in [meshes..., mask-0 scan rows]
        order."""
        a = self.assets
        parts = {k: [pm[k] for pm in self._mesh_groups[group].values()]
                 for k in SPLAT_KEYS}
        if self._static_rows.shape[0]:
            for k in SPLAT_KEYS:
                parts[k].append(a.table[k][self._static_rows])
        return {k: torch.cat(v, dim=0) for k, v in parts.items()}

    def compose_scenes(self):
        """Full-scene gaussians per env (diagnostics / golden checks)."""
        return self.compose(self.state)[0]

    @spanned("render: other")
    def render(self):
        """Returns (images (B, C_fixed, 3, H, W), depths (B, C_fixed, H, W),
        wrist images, wrist depths) and updates the cached IK qpos. Render
        telemetry lands in ``self.render_telemetry`` as a (fixed, wrist)
        pair: fixed (n_fixed, B, 4) i32 [n_dirty, dropped_tiles,
        dropped_pairs, binning_dropped] (n_dirty counts 8x128 tiles on
        either kernel family: the dirty supertiles on the fine one), wrist
        (n_wrist, B) i32. On the incremental branch ``self.render_stats``
        holds the merged pair count, on the fine family the dirty fine
        tiles per (fixed camera, env), and, where this render culled the
        wrist, the wrist cull's kept blocks per (wrist camera, env)."""
        st = self.state
        if self.incremental:
            dyn, qpos_new = self.compose_dyn(st, dc_only=self.sh_deg == 0)
            rgb, depth, tele = self._render_fixed(
                self._cam_static, dyn, self.sh_deg, config=self.raster_config,
                stats=self.render_stats, **self._fixed_kw)
            wims, wdepths, wdrops = self.render_wrist(st, dyn,
                                                      *self._wrist_flags)
            self.render_telemetry = (tele, wdrops)
            self.state = st.replace(qpos7=qpos_new)
            return (rgb.transpose(0, 1), depth.transpose(0, 1), wims,
                    wdepths)
        if self.per_env:
            return self._render_per_env(st)
        B = st.rel_pose.shape[0]
        scenes, qpos_new = self.compose(st, dc_only=self.sh_deg == 0)
        cam_list = [(cam, w2c[None].expand(B, 4, 4))
                    for cam, w2c in self._fixed_cams]
        eef_rot = tf.quat_to_rot(st.grippers[:, 6:10])
        for cam, eef2c in self._wrist_cams:
            cam_list.append((cam, wrist_w2c(eef2c, st.grippers[:, :3],
                                            eef_rot)))
        rgb, depth, drops = rasterize_batch(cam_list, scenes, self.sh_deg,
                                            config=self.raster_config,
                                            return_drops=True,
                                            device=self.device)
        nf = len(self._fixed_cams)
        ims = rgb[:nf].transpose(0, 1)
        depths = depth[:nf].transpose(0, 1)
        wims = rgb[nf:].transpose(0, 1)
        wdepths = depth[nf:].transpose(0, 1)
        tele = torch.zeros((nf, B, 4), dtype=torch.int32, device=self.device)
        tele[:, :, 3] = drops[:nf]
        self.render_telemetry = (tele, drops[nf:])
        self.state = st.replace(qpos7=qpos_new)
        return ims, depths, wims, wdepths

    def _render_per_env(self, st: BatchedState):
        """The per-env branch (the JAX package's batched.py:768-795): the
        full scene of each env through ``rasterize`` (the configured
        backend and kernel family), one camera at a time, frames clipped
        to [0, 1]. A camera list that is empty gives (B, 0, 1, 1) frames
        and depths."""
        B = st.rel_pose.shape[0]
        scenes, qpos_new = self.compose(st, dc_only=self.sh_deg == 0)
        eef_rot = tf.quat_to_rot(st.grippers[:, 6:10])
        wrist = [(cam, wrist_w2c(eef2c, st.grippers[:, :3], eef_rot))
                 for cam, eef2c in self._wrist_cams]
        ims, depths, wims, wdepths = [], [], [], []
        for b in range(B):
            scene = [scenes[k][b] for k in SPLAT_KEYS]
            for cams, out_rgb, out_dep in (
                    (self._fixed_cams, ims, depths),
                    ([(c, w2c[b]) for c, w2c in wrist], wims, wdepths)):
                frames = [rasterize(cam, w2c, *scene, self.sh_deg,
                                    config=self.raster_config,
                                    device=self.device) for cam, w2c in cams]
                out_rgb.append(torch.stack([torch.clamp(f[0], 0.0, 1.0)
                                            for f in frames])
                               if frames else None)
                out_dep.append(torch.stack([f[1] for f in frames])
                               if frames else None)

        def batch(frames):
            if frames[0] is None:
                return torch.zeros((B, 0, 1, 1), device=self.device)
            return torch.stack(frames)

        self.render_telemetry = (
            torch.zeros((len(self._fixed_cams), B, 4), dtype=torch.int32,
                        device=self.device),
            torch.zeros((len(self._wrist_cams), B), dtype=torch.int32,
                        device=self.device))
        self.state = st.replace(qpos7=qpos_new)
        return batch(ims), batch(depths), batch(wims), batch(wdepths)

    @spanned("wrist pipeline")
    def render_wrist(self, state: BatchedState, dyn: dict,
                     static_cull: bool, dyn_cull: bool):
        """The wrist cameras of the incremental branch: the full pipeline
        of the wrist family's kernel on [dynamic; static], each part first
        culled to the blocks the camera can see where asked (one render per
        camera, since culled scenes differ), else one render of all wrist
        cameras. ``dyn`` is ``compose_dyn``'s scene. Returns (images (B,
        n_wrist, 3, H, W), depths, binning drops (n_wrist, B) i32)."""
        B = state.rel_pose.shape[0]
        # the kept-block counts are this render's: a render that does not
        # cull leaves none behind
        for key in ("wrist_static_blocks", "wrist_dynamic_blocks"):
            self.render_stats.pop(key, None)
        eef_rot = tf.quat_to_rot(state.grippers[:, 6:10])
        cams = [(cam, wrist_w2c(eef2c, state.grippers[:, :3], eef_rot))
                for cam, eef2c in self._wrist_cams]
        if not cams:
            c = self._fixed_cams[0][0]
            empty = torch.zeros((B, 0, 3, c.height, c.width),
                                device=self.device)
            return (empty, empty[:, :, 0],
                    torch.zeros((0, B), dtype=torch.int32,
                                device=self.device))
        if not static_cull:
            if self.n_mesh_groups == 1:
                static = {k: v[None].expand((B,) + v.shape)
                          for k, v in self._static.items()}
            else:
                with span("mesh groups", traced=True):
                    static = {k: v[self.lane_group]
                              for k, v in self._static.items()}
            scenes = {k: torch.cat([dyn[k], static[k]], dim=1)
                      for k in SPLAT_KEYS}
            rgb, depth, drops = rasterize_batch(
                cams, scenes, self.sh_deg, config=self._wrist_config,
                return_drops=True, device=self.device)
            return rgb.transpose(0, 1), depth.transpose(0, 1), drops
        st_w, centers, radii = self._cull_static
        dyn_pad = pc.pad_dynamic_scene(dyn) if dyn_cull else dyn
        outs, kept_s, kept_d = [], [], []
        for cam, w2c_b in cams:
            culled, n_s = pc.cull_static_blocks(cam, w2c_b, st_w, centers,
                                                radii, **self._cull_rows)
            kept_s.append(n_s)
            dyn_c = dyn
            if dyn_cull:
                dyn_c, n_d = pc.cull_dynamic_blocks(cam, w2c_b, dyn_pad)
                kept_d.append(n_d)
            scene = {k: torch.cat([dyn_c[k], culled[k]], dim=1)
                     for k in SPLAT_KEYS}
            outs.append(rasterize_batch([(cam, w2c_b)], scene, self.sh_deg,
                                        config=self._wrist_config,
                                        return_drops=True,
                                        device=self.device))
        self.render_stats["wrist_static_blocks"] = torch.stack(kept_s)
        if kept_d:
            self.render_stats["wrist_dynamic_blocks"] = torch.stack(kept_d)
        rgb, depth, drops = (torch.cat(v) for v in zip(*outs))
        return rgb.transpose(0, 1), depth.transpose(0, 1), drops

    def render_drops(self) -> dict:
        """Named drop counters of the last render; any nonzero value means
        a render budget clipped real pairs. Always 0 here: pair buffers are
        sized exactly."""
        if self.render_telemetry is None:
            return {}
        fixed, wrist = (t.cpu().numpy() for t in self.render_telemetry)
        return {
            "fixed_dropped_tiles": int(fixed[..., 1].sum()),
            "fixed_dropped_pairs": int(fixed[..., 2].sum()),
            "fixed_binning_dropped": int(fixed[..., 3].sum()),
            "wrist_binning_dropped": int(wrist.sum()),
        }

    def observations(self):
        """Batched policy observations."""
        ims, depths, wims, wdepths = self.render()
        g = self.state.grippers
        return {
            "observation.state": torch.cat(
                [g[:, :3], g[:, 6:10], 1.0 - g[:, 13:14]], dim=1),
            "observation.images.front": ims[:, 0],
            "observation.images.wrist": (wims[:, 0] if wims.shape[1] > 0
                                         else None),
            "images": ims, "depths": depths,
            "wrist_images": wims, "wrist_depths": wdepths,
        }

    def telemetry(self) -> dict:
        """Physics saturation counters of the last control step."""
        t = self.state.sm.telemetry
        t = (np.zeros((self.batch_size, 4), np.int32) if t is None
             else t.cpu().numpy())
        return {
            "self_candidates_dropped": t[:, 0],
            "self_particles_dropped": t[:, 1],
            "contact_particles_dropped": t[:, 2],
            "patch_escapes": t[:, 3],
        }

    def particle_states(self) -> np.ndarray:
        """(B, N, 3) world-frame particles (for success metrics)."""
        return (self.state.sm.x - self.assets.global_translation).cpu().numpy()

    def get_state_dumps(self):
        """Per-env state dicts in the success calculators' schema."""
        xs = self.particle_states()
        springs = self.assets.params.springs.cpu().numpy()
        dumps = (self.assets.static_mesh_dumps
                 or [[] for _ in range(self.batch_size)])
        return [{"renderer": {"x": xs[i]},
                 "physics": {"static_meshes": dumps[i],
                             "init_springs": springs}}
                for i in range(self.batch_size)]

    # ------------------------------------------------------------------
    # snapshot / resume mid-episode
    # ------------------------------------------------------------------

    def save_state(self, path, extra: dict | None = None):
        """Snapshot the batched state to ``path`` as a pickle of numpy
        arrays, atomically (write, then rename). ``extra`` rides along
        for the caller's bookkeeping."""
        import os
        import pickle

        tmp = str(path) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"episode_ids": self.episode_ids,
                         "state": _state_to_numpy(self.state),
                         "extra": extra or {}}, f)
        os.replace(tmp, path)

    def load_state(self, path) -> dict:
        """Restore a snapshot of ``save_state`` (same episode ids and
        config); returns its ``extra`` dict."""
        import pickle

        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob["episode_ids"] != self.episode_ids:
            raise ValueError("snapshot belongs to different episodes")
        self.state = _state_from_numpy(blob["state"], self.device)
        return blob.get("extra", {})


def _state_to_numpy(state: BatchedState) -> dict:
    """BatchedState -> {"sm/x": array, ..., "step": int}."""
    out = {"step": int(state.step)}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                t = getattr(v, g.name)
                if t is not None:
                    out[f"{f.name}/{g.name}"] = t.cpu().numpy()
        elif torch.is_tensor(v):
            out[f.name] = v.cpu().numpy()
    return out


def _state_from_numpy(tree: dict, device) -> BatchedState:
    def sub(prefix):
        return {k.split("/", 1)[1]: torch.as_tensor(v, device=device)
                for k, v in tree.items() if k.startswith(prefix + "/")}
    return BatchedState(
        sm=SpringMassState(**sub("sm")), grasp=GraspState(**sub("grasp")),
        step=int(tree["step"]),
        **{k: torch.as_tensor(v, device=device) for k, v in tree.items()
           if "/" not in k and k != "step"})
