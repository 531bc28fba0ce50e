"""GSRenderer: scene state, splat loading, per-frame composition, rendering.

Counterpart of the JAX package's renderer/renderer.py for one env:

  - splat loading, colour correction and randomization -> scene.py helpers
    (host numpy, as in the JAX package);
  - LBS sim->gaussian motion transfer -> lbs.py (weights built once);
  - robot splat articulation -> scene.RobotArticulation;
  - rasterization -> raster.rasterize (K1 on the card);
  - IK / FK -> kinematics (the IK solve is ``make_ik_fn``'s, at E = 1).

State layout: x / v in the world frame (tensors on ``device``), 14-wide
gripper rows on the host (xyz, vel, quat, quat_vel, openness). Randomized
draws come from the ``RandomState`` the caller passes, never from numpy's
global generator. With ``online: true`` the renderer serves a live view
(``utils/viser_gui.ViserViewer`` on ``viser_port``): ``render_online``
renders the viewer's camera and hands it the frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kinematics import make_ik_fn
from ..kinematics.robot import CANONICAL_ARM_QPOS, RobotModel
from ..utils import transforms_np as tnp
from ..utils.device import resolve_device, to_numpy
from ..utils.gs_processor import GSProcessor, activate_params
from ..utils.mesh import load_mesh
from ..utils.ply import sh_colors_to_coeffs
from ..utils.sh import C0
from . import lbs as lbs_mod
from .camera import (Rt_to_w2c, default_orbit_intrinsics, orbit_camera_w2c,
                     setup_camera, wrist_w2c_np)
from .raster import RasterConfig, rasterize
from .scene import (XARM_GRIPPER_LINK_IDS, XARM_PUSHER_LINK_IDS,
                    RobotArticulation, apply_random_pose, correct_sh_colors,
                    grid_random_values, transform_params_by_pose,
                    uniform_random_values)

N_SIM_PARTICLES = 1000   # downsampled sim-particle count
SPLAT_KEYS = ("means3D", "shs", "rotations", "opacities", "scales")


class GSRenderer:

    def __init__(self, cfg, local_rank: int = 0,
                 raster_config: RasterConfig | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.online = bool(cfg.get("online", False))
        self.raster_config = raster_config or RasterConfig()

        self.metadata: dict = {}
        self.metadata_wrist: dict = {}
        self.state = {"x": None, "v": None, "x_his": None, "v_his": None,
                      "color": None}
        self.rendervar: dict = {}
        self.rendervar_full: dict = {}
        self.table_rendervar: dict = {}
        self.params_meshes: dict = {}
        self.meshes: dict = {}
        self.grippers = np.zeros((0, 14), np.float32)
        self.random_variables: list = []

        self.qpos_curr_xarm = CANONICAL_ARM_QPOS.copy()
        self.gripper_openness_curr_xarm = 800.0

        self.cameras: list = []
        self.wrist_cameras: list = []

        self.sp = GSProcessor()
        self.relations = None
        self.weights = None
        self.articulation = None
        self._dev_scene = None

        urdf_cfg = cfg.env["urdf"]
        self.sample_robot = RobotModel(urdf_cfg["ik_urdf_path"])
        self.robot = RobotModel(
            urdf_cfg["collision_urdf_path"],
            link_names=list(urdf_cfg["collision_link_names"]))
        self.use_pusher = bool(cfg.env["robot"]["use_pusher"])
        # pusher configs set this to null; only the gripper path reads it
        self.init_gripper_openness_xarm = float(
            cfg.env["robot"].get("init_gripper_openness") or 0.0)

        chain = self.sample_robot.chain
        self._eef_idx = chain.link_index(
            "link7" if "link7" in chain.link_names else chain.link_names[-1])
        self._ik = make_ik_fn(chain, self._eef_idx, n_active=7)

        self.viser_viewer = None
        if self.online:
            from ..utils.viser_gui import ViserViewer

            self.viser_viewer = ViserViewer(
                port=int(cfg.get("viser_port", 6789)))

    # ------------------------------------------------------------------
    # cameras
    # ------------------------------------------------------------------

    def set_all_cameras(self):
        self.cameras = []
        self.wrist_cameras = []
        for camera_cfg in self.cfg.env.cameras:
            h, w = int(camera_cfg.h), int(camera_cfg.w)
            intr = np.array(camera_cfg.intr, np.float32).reshape(3, 3)
            if "c2w" in camera_cfg:
                extr = np.linalg.inv(
                    np.array(camera_cfg.c2w, np.float32).reshape(4, 4))
            else:
                extr = np.array(camera_cfg.w2c, np.float32).reshape(4, 4)
            if camera_cfg.type == "side":
                self.cameras.append([w, h, intr, extr])
            else:
                if camera_cfg.type != "wrist":
                    raise ValueError(f"camera type {camera_cfg.type!r}")
                self.wrist_cameras.append([w, h, intr, extr])

        rcfg = self.cfg.renderer
        self.set_camera_custom(tuple(rcfg.gs_center), float(rcfg.gs_distance),
                               float(rcfg.gs_elevation),
                               float(rcfg.gs_azimuth))
        if self.wrist_cameras:
            w, h, intr, eef2c = self.wrist_cameras[0]
            self.set_wrist_camera(w, h, intr, eef2c)

    def set_camera_custom(self, center=(0, 0, 0), distance=0.8,
                          elevation=20.0, azimuth=160.0, near=0.01,
                          far=100.0):
        w, h = 848, 480
        self.metadata = {"w": w, "h": h, "k": default_orbit_intrinsics(w, h),
                         "w2c": orbit_camera_w2c(center, distance, elevation,
                                                 azimuth),
                         "near": near, "far": far}

    def set_wrist_camera(self, w, h, intr, eef2c=None, R=None, t=None,
                         near=0.01, far=100.0):
        if eef2c is None:
            eef2c = Rt_to_w2c(R, t)
        self.metadata_wrist = {"w": w, "h": h, "k": intr, "eef2c": eef2c,
                               "near": near, "far": far}

    # ------------------------------------------------------------------
    # scene loading
    # ------------------------------------------------------------------

    def _load_corrected(self, path, color_cfg) -> dict:
        """Load a splat PLY, apply colour correction, activate."""
        raw = self.sp.load(path)
        coeffs = sh_colors_to_coeffs(raw["sh_colors"])
        if color_cfg is not None and "color_A" in color_cfg:
            coeffs = correct_sh_colors(coeffs, color_cfg["color_A"],
                                       color_cfg["color_b"])
        return activate_params(dict(raw, sh_colors=coeffs))

    def load_scaniverse(self, rng, randomize=False, index=None):
        """Load the scene of episode ``index``. Uniform randomization draws
        from ``rng`` (``BaseEnv.reset`` passes ``RandomState(seed)``: the
        draws of the reference's ``np.random.seed(seed)``)."""
        cfg = self.cfg
        self.random_variables = []
        self._dev_scene = None

        use_grid = bool(cfg.gs.get("use_grid_randomization", False))
        true_index = index
        true_index_mesh = None
        if randomize and use_grid:
            obj_grid = cfg.gs.object.grid_randomization
            n_obj = (len(obj_grid.xy) if obj_grid.one_to_one
                     else len(obj_grid.xy) * len(obj_grid.theta))
            if index is None:
                raise ValueError("grid randomization needs an episode index")
            true_index_mesh = index // n_obj
            true_index = index % n_obj

        # --- attached meshes + their splats ----------------------------
        params_meshes, meshes = {}, {}
        self.meshes_canonical = {}
        self.mesh_poses = {}
        for mesh_obj in cfg.gs.get("meshes", []):
            name = mesh_obj["name"]
            mesh = load_mesh(mesh_obj["mesh_path"])
            pose = np.array(mesh_obj["pose"], np.float64).reshape(4, 4)
            if randomize and use_grid and mesh_obj.get("grid_randomization"):
                g = mesh_obj.grid_randomization
                n_this = (len(g.xy) if g.one_to_one
                          else len(g.xy) * len(g.theta))
                idx_this = true_index_mesh % n_this
                true_index_mesh = true_index_mesh // n_this
                rand = grid_random_values(idx_this, g.xy, g.theta,
                                          g.one_to_one)
                pose = apply_random_pose(pose, rand)
                self.random_variables.append(list(rand))
            elif randomize and not use_grid:
                rand = uniform_random_values(
                    rng, mesh_obj["translation_range"],
                    mesh_obj["azimuth_range"])
                pose = apply_random_pose(pose, rand)
                self.random_variables.append(list(rand))

            params = self._load_corrected(mesh_obj["splat_path"], mesh_obj)
            params = transform_params_by_pose(params, pose)
            self.meshes_canonical[name] = mesh.copy()
            self.mesh_poses[name] = pose
            mesh.transform(pose)
            params_meshes[name] = params
            meshes[name] = mesh
        self.params_meshes = params_meshes
        self.meshes = meshes

        # --- scene (table + robot) splats + link mask -------------------
        scene_cfg = cfg.gs["scene"]
        self.table_rendervar = self._load_corrected(
            scene_cfg["table_splat_path"], scene_cfg)
        self.total_mask_full = np.load(
            scene_cfg["total_mask_path"]).astype(np.int32)

        # --- robot init + eef tables ------------------------------------
        robot_cfg = cfg.env["robot"]
        init_quat = list(robot_cfg.get("init_quat", [0, 1, 0, 0]))
        init_gripper = list(robot_cfg.get("init_gripper", [1.0]))
        eef_xyz = np.array(robot_cfg["init_eef_xyz"],
                           np.float32).reshape(-1, 3)
        eef_quat = np.array(init_quat, np.float32).reshape(-1, 4)
        eef_gripper = np.array(init_gripper, np.float32).reshape(-1, 1)
        self.set_eef(eef_xyz, eef_quat, eef_gripper,
                     eef_xyz_next=eef_xyz, eef_quat_next=eef_quat)
        self.init_eef_xyz = eef_xyz.copy()
        self.init_eef_quat = eef_quat.copy()

        # eef point table in the eef frame, and the world-frame lerp
        self._eef_table = self.robot.eef_points_table()   # (101, P, 3)
        R_init = tnp.quat_to_rot(eef_quat[0])
        t_init = eef_xyz[0]

        def eef_pts_func(openness: float) -> np.ndarray:
            o = float(np.clip(openness, 0.0, 1.0)) * 100.0
            i0 = int(min(np.floor(o), 99))
            frac = o - i0
            pts = ((1 - frac) * self._eef_table[i0]
                   + frac * self._eef_table[i0 + 1])
            return pts @ R_init.T + t_init

        self.eef_pts_func = eef_pts_func
        self.eef_pts = eef_pts_func(float(eef_gripper[0, 0]))

        # --- object splats ----------------------------------------------
        obj_cfg = cfg.gs["object"]
        obj = self._load_corrected(obj_cfg["path"], obj_cfg)
        pose_obj = np.array(obj_cfg["pose"], np.float64).reshape(4, 4)
        if randomize and use_grid:
            g = cfg.gs.object.grid_randomization
            rand = grid_random_values(true_index, g.xy, g.theta,
                                      g.one_to_one)
            pose_obj = apply_random_pose(pose_obj, rand)
            self.random_variables.append(list(rand))
        elif randomize:
            rand = uniform_random_values(rng, obj_cfg["translation_range"],
                                         obj_cfg["azimuth_range"])
            pose_obj = apply_random_pose(pose_obj, rand)
            self.random_variables.append(list(rand))
        self.pose_obj_np = np.asarray(pose_obj, np.float32)
        self.pose_obj = self.pose_obj_np
        self.rendervar = transform_params_by_pose(obj, pose_obj)

        # --- articulation tables (urdf + init gripper only: built once) --
        self.relations = None
        self.weights = None
        if self.articulation is not None:
            return
        link_ids = (XARM_PUSHER_LINK_IDS if self.use_pusher
                    else XARM_GRIPPER_LINK_IDS)
        link_ids = tuple(i for i in link_ids
                         if i < len(self.sample_robot.chain.link_names))
        n_extra = self.sample_robot.chain.n_dof - 7
        if n_extra > 0:
            # default init gripper 750 counts; counts -> rad (800-g)*0.001
            init_g = (self.init_gripper_openness_xarm
                      if self.init_gripper_openness_xarm > 0 else 750.0)
            base_q = np.concatenate([CANONICAL_ARM_QPOS,
                                     np.full(n_extra, (800.0 - init_g) * 0.001)])
        else:
            base_q = CANONICAL_ARM_QPOS.copy()
        self.articulation = RobotArticulation.build(
            self.sample_robot, link_ids, base_q, use_pusher=self.use_pusher,
            device=self.device)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def reset_state(self, visualize_image: bool = False,
                    skip_compose: bool = False):
        xyz0 = np.asarray(self.rendervar["means3D"])
        color0 = np.asarray(self.rendervar["shs"])[:, 0] * C0 + 0.5
        n = min(N_SIM_PARTICLES, len(xyz0))
        dev = self.device
        self.state["x"] = torch.as_tensor(xyz0[:n], device=dev)
        self.state["v"] = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        self.state["color"] = torch.as_tensor(color0[:n], device=dev)
        if skip_compose:
            return   # the batched evaluator composes its own frames
        self.update_rendervar()
        if visualize_image:
            self._dump_debug_images(*self.render())

    @staticmethod
    def _dump_debug_images(im, depth):
        """``test.png`` (the frame) and ``test_depth.png`` (depths under
        15 m, JET-coloured, the rest black) in the working directory."""
        import cv2

        im_vis = (to_numpy(im).transpose(1, 2, 0) * 255).astype(
            np.uint8)[:, :, ::-1]
        cv2.imwrite("test.png", im_vis)
        d = to_numpy(depth)
        mask = d < 15
        if mask.any():
            dv = cv2.applyColorMap(
                cv2.convertScaleAbs(d, alpha=255 / d[mask].max()),
                cv2.COLORMAP_JET)
            dv[~mask] = 0
            cv2.imwrite("test_depth.png", dv)

    def get_state(self):
        g = self.grippers
        return {
            "x": self.state["x"],
            "v": self.state["v"],
            "eef_xyz": g[:, :3].copy(),
            "eef_vel": g[:, 3:6].copy(),
            "eef_quat": g[:, 6:10].copy(),
            "eef_quat_vel": g[:, 10:13].copy(),
            "eef_gripper": g[:, 13:].copy(),
            "color": self.state["color"],
        }

    def set_eef(self, eef_xyz, eef_quat, eef_gripper, eef_xyz_next=None,
                eef_vel=None, eef_quat_next=None, eef_quat_vel=None):
        fps = float(self.cfg.physics.fps)
        eef_xyz = np.asarray(eef_xyz, np.float32).reshape(-1, 3)
        eef_quat = np.asarray(eef_quat, np.float32).reshape(-1, 4)
        eef_gripper = np.asarray(eef_gripper, np.float32).reshape(-1, 1)
        if eef_xyz_next is not None:
            eef_vel = (np.asarray(eef_xyz_next, np.float32).reshape(-1, 3)
                       - eef_xyz) * fps
        if eef_quat_next is not None:
            R_this = tnp.quat_to_rot(eef_quat)
            R_next = tnp.quat_to_rot(
                np.asarray(eef_quat_next, np.float32).reshape(-1, 4))
            eef_quat_vel = tnp.rot_to_axis_angle(
                R_this @ np.linalg.inv(R_next)) * fps
        g = np.zeros((int(self.cfg.env.robot.n_grippers), 14), np.float32)
        g[:, :3] = eef_xyz
        g[:, 3:6] = eef_vel
        g[:, 6:10] = eef_quat
        g[:, 10:13] = eef_quat_vel
        g[:, 13:] = eef_gripper
        self.grippers = g

    def update_phystwin_pts(self, phystwin_pts):
        self.state["x"] = torch.as_tensor(phystwin_pts, device=self.device)

    def update_state(self, state):
        """Consume a physics next_state dict."""
        if "qpos" in state and state["qpos"] is not None:
            qpos = to_numpy(state["qpos"]).astype(np.float32)
            eef_xyz, eef_quat = self.compute_fk(qpos)
            eef_gripper = 1.0 - qpos[:, -1:]
            prev_q = self.grippers[:, 6:10].copy()
            prev_xyz = self.grippers[:, :3].copy()
            aa = tnp.rot_to_axis_angle(tnp.quat_to_rot(prev_q) @ np.linalg.inv(
                tnp.quat_to_rot(eef_quat)))
            fps = float(self.cfg.physics.fps)
            self.set_eef(eef_xyz, eef_quat, eef_gripper,
                         eef_vel=(eef_xyz - prev_xyz) * fps,
                         eef_quat_vel=aa * fps)
            if "current_openness" in state:
                self.grippers[:, 13:] = to_numpy(
                    state["current_openness"]).astype(np.float32).reshape(-1, 1)
            self.update_rendervar(state["x"], qpos_now=qpos)
        else:
            g = self.grippers
            g[:, :3] = to_numpy(state["eef_xyz"])
            if state.get("eef_vel") is not None:
                g[:, 3:6] = to_numpy(state["eef_vel"])
            if state.get("eef_quat") is not None:
                g[:, 6:10] = to_numpy(state["eef_quat"])
                if state.get("eef_quat_vel") is not None:
                    g[:, 10:13] = to_numpy(state["eef_quat_vel"])
                g[:, 13:] = to_numpy(state["eef_gripper"])
            if "current_openness" in state:
                g[:, 13:] = to_numpy(state["current_openness"]).reshape(-1, 1)
            self.update_rendervar(state["x"])
        self.state["x"] = torch.as_tensor(state["x"], device=self.device)
        self.state["v"] = torch.as_tensor(state["v"], device=self.device)

    # ------------------------------------------------------------------
    # frame composition
    # ------------------------------------------------------------------

    def _scene_on_device(self) -> dict:
        """The loaded splat arrays on the device, copied once per load."""
        if self._dev_scene is None:
            dev = self.device

            def on(d):
                return {k: torch.as_tensor(np.asarray(d[k]), device=dev)
                        for k in SPLAT_KEYS}
            self._dev_scene = {
                "obj": on(self.rendervar), "table": on(self.table_rendervar),
                "meshes": {n: on(p) for n, p in self.params_meshes.items()},
                "mask": torch.as_tensor(self.total_mask_full, device=dev)}
        return self._dev_scene

    def _solve_ik(self, target: np.ndarray) -> np.ndarray:
        """IK toward a (4, 4) eef target from the current arm pose, at
        E = 1; read back to the host (the reference syncs here too)."""
        dev = self.device
        q = self._ik(torch.as_tensor(self.qpos_curr_xarm, dtype=torch.float32,
                                     device=dev)[None],
                     torch.as_tensor(target, device=dev)[None])
        return q[0, :7].cpu().numpy()

    def update_rendervar(self, x_pred=None, gripper_now=None, qpos_now=None):
        sc = self._scene_on_device()
        obj, table = sc["obj"], sc["table"]
        bones = self.state["x"]
        bones_pred = (bones if x_pred is None
                      else torch.as_tensor(x_pred, device=self.device))
        use_lbs = bool(self.cfg.physics.use_lbs)
        if self.relations is None:
            self.relations = lbs_mod.knn_relations(bones)
            self.weights = (lbs_mod.knn_weights(bones, obj["means3D"])
                            if use_lbs else
                            lbs_mod.simple_weights(bones, obj["means3D"]))
        weights, weights_idx = self.weights

        # the robot splats' qpos: IK from the eef pose unless given
        g = self.grippers if gripper_now is None else np.asarray(gripper_now)
        if qpos_now is None:
            target = np.eye(4, dtype=np.float32)
            target[:3, :3] = tnp.quat_to_rot(g[0, 6:10])
            target[:3, 3] = g[0, :3]
            qpos7 = self._solve_ik(target)
        else:
            qpos7 = np.asarray(qpos_now, np.float32)[0, :7]
        openness_counts = float(g[0, 13]) * 800.0

        if use_lbs:
            xyz = lbs_mod.interpolate_motions(
                bones[None], (bones_pred - bones)[None], self.relations,
                weights, weights_idx, obj["means3D"][None])[0]
        else:
            xyz = lbs_mod.simple_apply(weights, weights_idx, bones_pred)
        art = self.articulation
        q_full = art.full_qpos(
            torch.as_tensor(qpos7, dtype=torch.float32,
                            device=self.device)[None],
            torch.full((1,), openness_counts, device=self.device))
        t_means, t_quats = art.apply(q_full, table["means3D"],
                                     table["rotations"], sc["mask"])

        parts = [dict(obj, means3D=xyz)]
        parts += list(sc["meshes"].values())
        parts.append(dict(table, means3D=t_means[0], rotations=t_quats[0]))
        self.rendervar_full = {
            k: (_pad_cat_sh([p[k] for p in parts]) if k == "shs"
                else torch.cat([p[k] for p in parts], 0))
            for k in SPLAT_KEYS}
        self.qpos_curr_xarm = np.asarray(qpos7, np.float64)
        self.gripper_openness_curr_xarm = openness_counts

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------

    def _render_with(self, w, h, intr, w2c, near, far, bg):
        rd = self.rendervar_full
        if not rd:
            raise RuntimeError("update_rendervar first")
        cam, w2c = setup_camera(w, h, intr, w2c, near, far, z_threshold=0.05)
        sh_deg = (int(np.sqrt(rd["shs"].shape[1]) - 1)
                  if self.cfg.gs.get("use_shs", False) else 0)
        shs = rd["shs"] if sh_deg > 0 else rd["shs"][:, :1]
        im, depth = rasterize(cam, w2c, rd["means3D"], rd["scales"],
                              rd["rotations"], rd["opacities"], shs, sh_deg,
                              bg=tuple(bg), config=self.raster_config,
                              device=self.device)
        return torch.clamp(im, 0.0, 1.0), depth

    def render(self, render_data=None, bg=(0.0, 0.0, 0.0), camera=None):
        if camera is not None:
            w, h, k, w2c = camera
        else:
            m = self.metadata
            w, h, k, w2c = m["w"], m["h"], m["k"], m["w2c"]
        m = self.metadata or {"near": 0.01, "far": 100.0}
        return self._render_with(w, h, k, w2c, m.get("near", 0.01),
                                 m.get("far", 100.0), bg)

    def render_wrist(self, render_data=None, bg=(0.0, 0.0, 0.0),
                     camera=None):
        if camera is not None:
            w, h, k, eef2c = camera
        else:
            m = self.metadata_wrist
            w, h, k, eef2c = m["w"], m["h"], m["k"], m["eef2c"]
        g = self.grippers
        w2c = wrist_w2c_np(eef2c, g[0, :3], tnp.quat_to_rot(g[0, 6:10]))
        mw = self.metadata_wrist or {}
        return self._render_with(w, h, k, w2c, mw.get("near", 0.01),
                                 mw.get("far", 100.0), bg)

    def render_fixed_cameras(self):
        frames = [self.render(camera=c) for c in self.cameras]
        return [f[0] for f in frames], [f[1] for f in frames]

    def render_wrist_cameras(self):
        frames = [self.render_wrist(camera=c) for c in self.wrist_cameras]
        return [f[0] for f in frames], [f[1] for f in frames]

    def render_online(self, render_data=None, bg=(0.0, 0.0, 0.0)):
        """Render the online viewer's camera and hand it the uint8 frame;
        nothing before the viewer has a camera."""
        if self.viser_viewer is None:
            raise RuntimeError("render_online needs online: true")
        meta = self.viser_viewer.get_metadata()
        if not meta:
            return
        im, _ = self.render(camera=[meta["w"], meta["h"], meta["k"],
                                    meta["w2c"]], bg=bg)
        self.viser_viewer.set_output(
            {"image": (to_numpy(im).transpose(1, 2, 0) * 255).astype(
                np.uint8)})
        self.viser_viewer.update()

    # ------------------------------------------------------------------
    # kinematics
    # ------------------------------------------------------------------

    def _eef_name(self) -> str:
        names = self.sample_robot.chain.link_names
        return "link7" if "link7" in names else names[self._eef_idx]

    def compute_fk(self, joint_commands):
        """(n, >= 7) joint positions -> eef xyz (n, 3), wxyz quat (n, 4),
        host float64 FK."""
        q = np.asarray(joint_commands, np.float64)
        robot = self.sample_robot
        xyzs, quats = [], []
        for i in range(q.shape[0]):
            T = robot.link_pose(robot.full_qpos(q[i, :7], openness=1.0),
                                self._eef_name())
            xyzs.append(T[:3, 3])
            quats.append(tnp.rot_to_quat(T[:3, :3]))
        return (np.stack(xyzs).astype(np.float32),
                np.stack(quats).astype(np.float32))

    def mimic_velocity_control(self, action):
        """Position command -> joint-velocity smoothing: IK toward the
        target, a joint step clamped to 0.1 rad, host FK of the new pose,
        and the gripper command clamped to 2/30 per step."""
        action = to_numpy(action).astype(np.float32)
        if action.shape != (1, 13):
            raise ValueError(f"action of shape {action.shape}, not (1, 13)")
        target = np.eye(4, dtype=np.float32)
        target[:3, :3] = action[0, 3:12].reshape(3, 3)
        target[:3, 3] = action[0, 0:3]
        qpos = self._solve_ik(target)

        delta = qpos - self.qpos_curr_xarm[:7]
        norm = np.linalg.norm(delta)
        if norm > 0.10:
            delta = delta / norm * 0.10
        v = delta / 0.02 * 0.15
        new_qpos = self.qpos_curr_xarm[:7] + v * (1.0 / 30.0)

        robot = self.sample_robot
        T = robot.link_pose(robot.full_qpos(new_qpos, openness=1.0),
                            self._eef_name())
        action = action.copy()
        action[0, 0:3] = T[:3, 3]
        action[0, 3:12] = T[:3, :3].reshape(-1)
        current_g = self.gripper_openness_curr_xarm / 800.0
        delta_g = np.clip(float(action[0, 12]) - current_g,
                          -2.0 / 30.0, 2.0 / 30.0)
        action[0, 12] = current_g + delta_g
        return torch.as_tensor(action, device=self.device)


def _pad_cat_sh(parts):
    """Concatenate SH coefficient tensors of differing band counts,
    zero-padding each to the largest."""
    kmax = max(int(p.shape[1]) for p in parts)
    return torch.cat([torch.nn.functional.pad(p, (0, 0, 0, kmax - p.shape[1]))
                      if p.shape[1] < kmax else p for p in parts], 0)
