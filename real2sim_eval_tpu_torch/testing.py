"""Synthetic scenes and checkpoints for the tests and the card run.

Two builders, both numpy alone:

- the fixture writers (``make_rope_points``, ``write_fixture_checkpoint``,
  ``physics_cfg``, ``env_cfg``, ``full_cfg``, ``make_synthetic_scene``,
  ``TEST_CAMERAS``), counterparts of the JAX package's testing.py: they
  write a PhysTwin checkpoint, splat PLYs, a link mask and a clip mesh,
  and return the config that ``BatchedEvaluator(cfg, ...)`` and
  ``envs.make("BaseEnv-v0", cfg=...)`` build from;
- the scene-construction inputs (``make_t_block``, ``make_raw_scan``): a
  T-shaped object mesh for ``create_rigid_phystwin`` and a raw scene scan
  for ``construct_scene``: a table plane and splats sampled on the
  built-in arm's collision surfaces, in the scan's own frame, with each
  splat's true link id;
- ``make_flagship_assets``, which builds the flagship scene's
  ``BatchedAssets`` directly, without the config build: a 1000-particle
  rope (springs from ``connect_springs``, Y = 2e3) fleshed out by
  ``n_obj_dense`` LBS-driven body splats, a table scan of ``n_table``
  splats, a 120-splat box clip that is also a static SDF collider, the
  finger colliders of the built-in ``simple_arm.urdf`` (tables from
  ``RobotModel``), grid-randomized per-env object poses, dt = 5e-5 (667
  substeps at 30 Hz) with self-collision, and bench.py's three 848x480
  cameras. It need not equal the config build bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .config import ConfigNode
from .convert import assets_from_numpy
from .kinematics.chain import KinematicChain
from .kinematics.robot import CANONICAL_ARM_QPOS, RobotModel
from .physics import checkpoints as ckpt_io
from .physics.sdf import build_sdf_grid
from .physics.topology import build_neighbor_tables, connect_springs
from .renderer.scene import (XARM_GRIPPER_LINK_IDS, apply_random_pose,
                             grid_random_values, transform_params_by_pose)
from .utils.colormap import colorize_mask
from .utils.gs_processor import GSProcessor
from .utils.mesh import make_box, merge_meshes
from .utils.sh import C0
from .utils.urdf import BUILTIN_URDF

_INTR = [427.3, 0.0, 430.0, 0.0, 426.8, 242.8, 0.0, 0.0, 1.0]
# bench.py's cameras: two fixed side views and the wrist view
CAMERAS = [
    dict(type="side", h=480, w=848, intr=_INTR,
         c2w=[0.005, 0.613, -0.790, 0.883, 1.0, -0.004, 0.004, 0.054,
              -0.001, -0.790, -0.613, 0.398, 0.0, 0.0, 0.0, 1.0]),
    dict(type="side", h=480, w=848, intr=_INTR,
         c2w=[-0.707, 0.433, -0.559, 0.70, 0.707, 0.433, -0.559, -0.45,
              0.0, -0.790, -0.613, 0.398, 0.0, 0.0, 0.0, 1.0]),
    dict(type="wrist", h=480, w=848, intr=_INTR,
         c2w=[-0.006, -1.0, -0.024, 0.07, 1.0, -0.006, -0.010, -0.006,
              0.010, -0.024, 1.0, 0.031, 0.0, 0.0, 0.0, 1.0]),
]
# the small cameras of the CPU tests: one fixed, one wrist, 64x128
TEST_CAMERAS = [
    dict(type="side", h=64, w=128,
         intr=[60.0, 0.0, 64.0, 0.0, 60.0, 32.0, 0.0, 0.0, 1.0],
         c2w=[0.005, 0.613, -0.790, 0.883, 1.0, -0.004, 0.004, 0.054,
              -0.001, -0.790, -0.613, 0.398, 0.0, 0.0, 0.0, 1.0]),
    dict(type="wrist", h=64, w=128,
         intr=[60.0, 0.0, 64.0, 0.0, 60.0, 32.0, 0.0, 0.0, 1.0],
         c2w=[-0.006, -1.0, -0.024, 0.07, 1.0, -0.006, -0.010, -0.006,
              0.010, -0.024, 1.0, 0.031, 0.0, 0.0, 0.0, 1.0]),
]
GRIPPER_LINK_IDS = XARM_GRIPPER_LINK_IDS
FINGER_LINKS = ("left_finger", "right_finger")
GRID_XY = [[-0.05, -0.05], [0.0, 0.0], [0.05, 0.05]]
GRID_THETA = [-10, 0, 10]
# the synthetic scenes' table: x and y ranges (m) of the z = 0 plane
TABLE_EXTENT = ((-0.2, 0.8), (-0.5, 0.5))
# the built-in arm's links with collision geometry, the arm's first: the
# links a scan of it shows (construct_scene's GRIPPER_LINKS name the
# xArm's, which simple_arm.urdf lacks)
SCAN_LINKS = ["link1", "link2", "link3", "link4", "link5", "link6", "link7",
              "gripper_base_link", "left_finger", "right_finger"]


def make_rope_points(n=200, length=0.5, jitter=0.002, seed=0):
    """A slightly jittered rope: a line of points with small noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, length, n)
    pts = np.stack([t, np.zeros(n), np.zeros(n)], axis=-1)
    pts += rng.normal(scale=jitter, size=pts.shape)
    return pts.astype(np.float64)


# ---------------------------------------------------------------------------
# fixture writers: checkpoint, configs, splat scene
# ---------------------------------------------------------------------------


def write_fixture_checkpoint(root, case_name, points, radius=0.02,
                             max_neighbours=30, spring_Y=3e4, **kwargs):
    """Connect springs as the loader will, then write a checkpoint tree
    whose num_object_springs matches."""
    # connect on the float32 points the loader reads back (regular grids
    # have distance ties whose order is dtype-sensitive)
    points = np.asarray(points, np.float32)
    springs, _ = connect_springs(points, radius, max_neighbours)
    ckpt_io.write_phystwin_checkpoint(
        root, case_name, object_points=points,
        surface_points=np.zeros((0, 3)), interior_points=np.zeros((0, 3)),
        spring_Y=np.full(len(springs), spring_Y, np.float32),
        num_object_springs=len(springs), **kwargs)
    return springs


def physics_cfg(**overrides):
    """A physics config with cfg/physics/default.yaml's defaults."""
    base = dict(
        ckpt_path=None, case_name=None, use_graph=True,
        fps=30, dt=5e-5, num_substeps=667, duration=30,
        dashpot_damping=100, drag_damping=3,
        init_spring_Y=3e4, spring_Y_min=0, spring_Y_max=1e5,
        object_radius=0.02, object_max_neighbours=30,
        controller_radius=0.04, controller_max_neighbours=50,
        collide_elas=0.5, collide_fric=0.3,
        collide_self_elas=0.5, collide_self_fric=0.3,
        collide_eef_elas=0.0, collide_eef_fric=1.0,
        collision_requires_grad=True, self_collision=True,
        collision_dist=0.005, reverse_z=False,
        icp_threshold=0.02, use_lbs=True, precompute_relations=True,
        table_height=0.0, grasp_force_threshold=3e4,
        visualize_mesh_points=False, visualize_phystwin_points=False,
        visualize_eef_points=False,
    )
    base.update(overrides)
    return ConfigNode(base)


def env_cfg(use_pusher=False, urdf=None, **overrides):
    base = dict(
        sim=dict(frame_rate=30, duration=30),
        robot=dict(type="xarm", use_pusher=use_pusher, n_grippers=1, n_qpos=7,
                   init_gripper_openness=800,
                   init_eef_xyz=[0.2568, 0.0, 0.4005],
                   do_velocity_control=True),
        urdf=urdf or dict(
            ik_urdf_path=BUILTIN_URDF,
            collision_urdf_path=BUILTIN_URDF,
            collision_link_names=["left_finger", "right_finger"],
        ),
        cameras=[],
    )
    base.update(overrides)
    return ConfigNode(base)


def full_cfg(ckpt_path, case_name, use_pusher=False, physics_over=None,
             gs=None, cameras=None, urdf=None):
    cfg = ConfigNode(dict(
        seed=0,
        online=False,
        env_name="BaseEnv-v0",
        obs_mode="rgbd",
        exp_root="log/experiments",
        physics=physics_cfg(ckpt_path=str(ckpt_path), case_name=case_name,
                            **(physics_over or {})).to_dict(),
        env=env_cfg(use_pusher=use_pusher, urdf=urdf).to_dict(),
        gs=gs if gs is not None else dict(use_shs=False,
                                          use_grid_randomization=False),
        renderer=dict(gs_center=[0.3, 0.0, 0.0], gs_distance=0.8,
                      gs_azimuth=160, gs_elevation=20),
    ))
    if cameras is not None:
        cfg.env.cameras = cameras
    return cfg


def _splat_params(pts, colors, scale=0.004, opacity=4.0):
    """Raw (pre-activation) splat params of the given points / colours."""
    n = len(pts)
    sh = np.zeros((n, 48), np.float32)
    sh[:, :3] = (np.asarray(colors, np.float32) - 0.5) / C0
    return {
        "means3D": np.asarray(pts, np.float32),
        "sh_colors": sh,
        "log_scales": np.full((n, 3), np.log(scale), np.float32),
        "unnorm_rotations": np.tile(np.array([[1, 0, 0, 0]], np.float32),
                                    (n, 1)),
        "logit_opacities": np.full((n, 1), opacity, np.float32),
    }


def write_rail_pusher_urdf(path) -> Path:
    """Write a second arm for the kinematics tests: the built-in arm on a
    prismatic rail (the first dof, along a rotated x) with a tilted mount,
    and a fixed pusher tip 12 cm past link7 in place of the gripper. Its
    path from the root to ``pusher_tip`` holds a prismatic joint and fixed
    links whose origins are no identities, which the built-in arm's path
    lacks."""
    text = Path(BUILTIN_URDF).read_text()
    head, rest = text.split('  <joint name="world_joint"', 1)
    rest = rest.split("</joint>", 1)[1]
    arm = rest.split('  <link name="link_eef"/>', 1)[0]
    rail = (
        '  <link name="rail"/>\n'
        '  <joint name="rail_joint" type="prismatic">\n'
        '    <parent link="world"/><child link="rail"/>\n'
        '    <origin rpy="0 0 0.2" xyz="0.05 -0.02 0"/>\n'
        '    <axis xyz="1 0 0"/>\n'
        '    <limit effort="50" lower="-0.5" upper="0.5" velocity="1.0"/>\n'
        '  </joint>\n'
        '  <joint name="world_joint" type="fixed">\n'
        '    <parent link="rail"/><child link="link_base"/>\n'
        '    <origin rpy="0.02 0 0.1" xyz="0 0 0.03"/>\n'
        '  </joint>')
    tip = (
        '  <link name="pusher_tip"/>\n'
        '  <joint name="pusher_joint" type="fixed">\n'
        '    <origin rpy="0.1 0 0" xyz="0 0 0.12"/>\n'
        '    <parent link="link7"/><child link="pusher_tip"/>\n'
        '  </joint>\n</robot>\n')
    path = Path(path)
    path.write_text(head + rail + arm + tip)
    return path


def ik_problems(chain, eef: int, width: int, lanes: int, seed: int,
                device="cpu"):
    """``lanes`` IK problems for ``make_ik_fn(chain, eef, n_active=7)``:
    (q_init (lanes, width), target (lanes, 4, 4)) float32 on ``device``.
    q_init is the canonical arm pose (on link1's joint and the six after)
    moved by up to 0.8 rad a joint within the limits; each target is the
    FK of q_init moved by 0.003, 0.02, 0.2 or 1 rad a joint (a quarter of
    the lanes each, interleaved), and every eighth target is moved 0.5 m
    out of reach, so that the solve falls back to q_init."""
    import torch

    rng = np.random.default_rng(seed)
    n = chain.n_dof
    first = int(chain.dof_index[chain.link_index("link1")])
    q0 = np.zeros((lanes, n))
    q0[:, first:first + 7] = CANONICAL_ARM_QPOS
    q0 = np.clip(q0 + rng.uniform(-0.8, 0.8, q0.shape), chain.lower,
                 chain.upper)
    scale = np.array([0.003, 0.02, 0.2, 1.0])[np.arange(lanes) % 4]
    goal = q0 + rng.normal(size=q0.shape) * scale[:, None]
    target = chain.fk_link(torch.as_tensor(goal, dtype=torch.float32,
                                           device=device), eef).clone()
    target[7::8, :3, 3] += 0.5
    return (torch.as_tensor(q0[:, :width], dtype=torch.float32,
                            device=device), target)


def make_synthetic_scene(root, rope_pts=None, ik_urdf=None, seed=0,
                         n_table=400,
                         table_extent=TABLE_EXTENT,
                         n_obj_dense=0):
    """Write object.ply / scene.ply + mask / clip mesh + splats and return
    a gs config dict with cfg/gs/rope.yaml's schema."""
    from .utils.gs_processor import GSProcessor
    from .utils.mesh import save_obj
    from .utils.ply import save_gaussian_ply

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # object: a rope of red splats at the origin (posed by the config);
    # the first len(pts) splats stay the sim particles (the LBS bones), the
    # dense body splats ride the same LBS
    pts = (make_rope_points(n=300, length=0.3, seed=seed) if rope_pts is None
           else rope_pts)
    colors = np.tile([[0.8, 0.1, 0.1]], (len(pts), 1))
    if n_obj_dense:
        seg = rng.integers(0, len(pts) - 1, n_obj_dense)
        t = rng.uniform(0.0, 1.0, (n_obj_dense, 1))
        core = pts[seg] * (1.0 - t) + pts[seg + 1] * t
        dense = core + rng.normal(scale=0.008, size=core.shape)
        dcol = np.clip([[0.8, 0.1, 0.1]]
                       + rng.normal(scale=0.06, size=(n_obj_dense, 3)),
                       0.0, 1.0)
        pts = np.concatenate([pts, dense])
        colors = np.concatenate([colors, dcol])
    save_gaussian_ply(_splat_params(pts, colors), root / "object.ply")

    # scene: a table plane (mask 0) + robot splats on the link origins;
    # splat size tracks density (plane area / count, with a floor)
    nt = n_table
    (x0, x1), (y0, y1) = table_extent
    table_pts = np.stack([rng.uniform(x0, x1, nt), rng.uniform(y0, y1, nt),
                          np.zeros(nt)], -1)
    table_scale = float(np.clip(np.sqrt((x1 - x0) * (y1 - y0) / nt) * 0.2,
                                0.0035, 0.01))
    scene_parts = [_splat_params(table_pts,
                                 np.tile([[0.4, 0.35, 0.3]], (nt, 1)),
                                 scale=table_scale)]
    masks = [np.zeros(nt, np.int32)]
    if ik_urdf is not None:
        robot = RobotModel(ik_urdf)
        q = np.concatenate([CANONICAL_ARM_QPOS,
                            np.full(robot.chain.n_dof - 7,
                                    (800.0 - 750.0) * 0.001)])
        fk = robot.fk_numpy(q)
        link_ids = [i for i in XARM_GRIPPER_LINK_IDS
                    if i < len(robot.chain.link_names)]
        per_link = 20
        pts_r, ids_r = [], []
        for lid in link_ids:
            pts_r.append(fk[lid][:3, 3]
                         + rng.normal(scale=0.01, size=(per_link, 3)))
            ids_r.append(np.full(per_link, lid, np.int32))
        scene_parts.append(_splat_params(
            np.concatenate(pts_r),
            np.tile([[0.8, 0.8, 0.8]], (per_link * len(link_ids), 1))))
        masks.append(np.concatenate(ids_r))
    save_gaussian_ply(GSProcessor().merge(scene_parts), root / "scene.ply")
    np.save(root / "scene_mask.npy", np.concatenate(masks))

    # attached mesh: a box "clip" with its own splats
    clip = make_box((0.03, 0.03, 0.05), center=(0.0, 0.0, 0.025))
    save_obj(clip, root / "clip.obj")
    save_gaussian_ply(_splat_params(clip.sample_surface(120, rng),
                                    np.tile([[0.1, 0.1, 0.9]], (120, 1))),
                      root / "clip_splat.ply")

    return dict(
        use_shs=False,
        use_grid_randomization=False,
        scene=dict(table_splat_path=str(root / "scene.ply"),
                   total_mask_path=str(root / "scene_mask.npy")),
        object=dict(
            path=str(root / "object.ply"),
            pose=[1.0, 0.0, 0.0, 0.15,
                  0.0, 1.0, 0.0, 0.0,
                  0.0, 0.0, 1.0, 0.02,
                  0.0, 0.0, 0.0, 1.0],
            translation_range=[-0.05, 0.05, -0.05, 0.05, 0.0, 0.0],
            azimuth_range=[-10, 10],
            grid_randomization=dict(xy=GRID_XY, theta=GRID_THETA,
                                    one_to_one=False),
        ),
        meshes=[dict(
            name="clip",
            splat_path=str(root / "clip_splat.ply"),
            mesh_path=str(root / "clip.obj"),
            pose=[1.0, 0.0, 0.0, 0.5,
                  0.0, 1.0, 0.0, 0.05,
                  0.0, 0.0, 1.0, 0.0,
                  0.0, 0.0, 0.0, 1.0],
            translation_range=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            azimuth_range=[0, 0],
        )],
    )


# ---------------------------------------------------------------------------
# scene-construction inputs
# ---------------------------------------------------------------------------


def make_t_block():
    """A push-T block of two 3 cm thick boxes: a 20 x 5 cm bar on a
    15 x 5 cm stem, resting on z = 0."""
    bar = make_box((0.20, 0.05, 0.03), center=(0.0, 0.075, 0.015))
    stem = make_box((0.05, 0.15, 0.03), center=(0.0, -0.025, 0.015))
    return merge_meshes([bar, stem])


def make_raw_scan(path, scan_from_robot, n_table=400, pts_per_link=2000,
                  seed=1):
    """Write a raw scene scan to ``path`` and return each splat's true link
    id (-1 for the table), in the SAPIEN document order construct_scene
    labels with.

    In the robot's frame: ``n_table`` splats on the z = 0 plane over
    ``make_synthetic_scene``'s table (its extent, colour and size rule,
    each colour jittered), then ``pts_per_link`` splats on each of
    SCAN_LINKS' collision surfaces at the canonical arm pose with the
    fingers at 750 counts, coloured by link (``colorize_mask``), from
    ``RobotModel.sample_pc`` with ``default_rng(seed)``: another sample of
    the surfaces than construct_scene's ``default_rng(i)`` per link. Then
    every splat (means and orientations) is moved by the 4x4
    ``scan_from_robot``."""
    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1) = TABLE_EXTENT
    table = np.stack([rng.uniform(x0, x1, n_table),
                      rng.uniform(y0, y1, n_table), np.zeros(n_table)], -1)
    table_scale = float(np.clip(np.sqrt((x1 - x0) * (y1 - y0) / n_table)
                                * 0.2, 0.0035, 0.01))
    table_rgb = np.clip([[0.4, 0.35, 0.3]]
                        + rng.normal(scale=0.06, size=(n_table, 3)), 0, 1)

    robot = RobotModel(BUILTIN_URDF, link_names=SCAN_LINKS)
    q = np.concatenate([CANONICAL_ARM_QPOS,
                        np.full(robot.chain.n_dof - 7, (800 - 750) * 0.001)])
    clouds = robot.sample_pc(SCAN_LINKS, [pts_per_link] * len(SCAN_LINKS),
                             rng)
    poses = robot.compute_mesh_poses(q, SCAN_LINKS)
    pts, ids = [], []
    for pose, name in zip(poses, SCAN_LINKS):
        pts.append(clouds[name] @ pose[:3, :3].T + pose[:3, 3])
        ids.append(np.full(len(clouds[name]),
                           robot.chain.link_index(name), np.int32))
    ids = np.concatenate(ids)
    sp = GSProcessor()
    params = sp.merge([_splat_params(table, table_rgb, scale=table_scale),
                       _splat_params(np.concatenate(pts),
                                     colorize_mask(ids))])
    T = np.asarray(scan_from_robot, np.float64)
    params = sp.translate(sp.rotate(params, T[:3, :3]), T[:3, 3])
    sp.save(params, path)
    return np.concatenate([np.full(n_table, -1, np.int32), ids])


# ---------------------------------------------------------------------------
# the flagship's BatchedAssets, built directly
# ---------------------------------------------------------------------------


def _splats(pts, colors, scale, logit_opacity=4.0):
    n = len(pts)
    return {
        "means3D": np.asarray(pts, np.float32),
        "rotations": np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
        "shs": ((np.asarray(colors, np.float32) - 0.5) / C0)[:, None, :],
        "scales": np.full((n, 3), scale, np.float32),
        "opacities": np.full((n, 1), 1.0 / (1.0 + np.exp(-logit_opacity)),
                             np.float32),
    }


def _chain_tree(chain: KinematicChain) -> dict:
    return {"chain/link_names": np.asarray(chain.link_names),
            "chain/parent": chain.parent, "chain/joint_type": chain.joint_type,
            "chain/origins": chain.origins, "chain/axes": chain.axes,
            "chain/dof_index": chain.dof_index,
            "chain/n_dof": np.asarray(chain.n_dof),
            "chain/topo_order": chain.topo_order, "chain/lower": chain.lower,
            "chain/upper": chain.upper}


def _finger_tables():
    """The finger colliders' meshes, openness pose table (F, 101, 4, 4)
    and centroids, from ``RobotModel``, plus the arm's ``RobotModel`` (its
    collision offsets pose the robot splats)."""
    arm = RobotModel(BUILTIN_URDF)
    fingers = RobotModel(BUILTIN_URDF, link_names=list(FINGER_LINKS))
    table = fingers.finger_pose_table(list(FINGER_LINKS))
    centroids = np.stack([fingers.meshes[n].vertices.mean(0)
                          for n in FINGER_LINKS])
    return fingers.meshes, table, centroids, arm


def make_flagship_assets(batch: int = 64, n_table: int = 99000,
                         n_obj_dense: int = 30000, seed: int = 0,
                         device="cuda", n_rope: int = 1000):
    """Numpy-built BatchedAssets of the flagship scene on ``device``.
    Env i takes grid-randomization cell i % 9 of the object pose."""
    from .renderer.scene import RobotArticulation

    rng = np.random.default_rng(seed)
    tree: dict = {}

    # ---- object: rope particles + dense body splats ----------------------
    rope = make_rope_points(n=n_rope, length=0.4, seed=seed).astype(np.float32)
    colors = np.tile([[0.8, 0.1, 0.1]], (n_rope, 1))
    pts = rope.astype(np.float64)
    if n_obj_dense:
        seg = rng.integers(0, n_rope - 1, n_obj_dense)
        tt = rng.uniform(0.0, 1.0, (n_obj_dense, 1))
        core = pts[seg] * (1.0 - tt) + pts[seg + 1] * tt
        pts = np.concatenate([pts, core + rng.normal(scale=0.008,
                                                     size=core.shape)])
        colors = np.concatenate([colors, np.clip(
            [[0.8, 0.1, 0.1]] + rng.normal(scale=0.06, size=(n_obj_dense, 3)),
            0.0, 1.0)])
    obj = _splats(pts, colors, 0.004)
    pose0 = np.eye(4)
    pose0[:3, 3] = [0.15, 0.0, 0.02]
    poses = [apply_random_pose(pose0, grid_random_values(
        i % (len(GRID_XY) * len(GRID_THETA)), GRID_XY, GRID_THETA, False))
        for i in range(batch)]
    obj_env0 = transform_params_by_pose(obj, poses[0])
    for k, v in obj_env0.items():
        tree[f"obj/{k}"] = v
    tree["bones0"] = obj_env0["means3D"][:n_rope]

    # ---- physics: springs, params, options -------------------------------
    springs, _ = connect_springs(rope, 0.02, 30)
    rest_all = np.stack([(rope.astype(np.float64) @ p[:3, :3].T + p[:3, 3])
                         .astype(np.float32) for p in poses])
    rest0 = rest_all[0].astype(np.float64)
    rest_len = np.linalg.norm(rest0[springs[:, 0]] - rest0[springs[:, 1]],
                              axis=-1).astype(np.float32)
    y_log = np.full(len(springs), np.log(2e3), np.float32)
    nbr_idx, nbr_rest, nbr_y = build_neighbor_tables(springs, rest_len, y_log,
                                                     n_rope)
    collision_dist = 0.005
    d0 = np.linalg.norm(rest_all[0][:, None] - rest_all[0][None], axis=-1)
    params = {
        "springs": springs, "rest_lengths": rest_len, "spring_Y_log": y_log,
        "masses": np.ones(n_rope, np.float32), "nbr_idx": nbr_idx,
        "nbr_rest": nbr_rest, "nbr_Y_log": nbr_y,
        "collision_mask": np.arange(n_rope, dtype=np.int32),
        "rest_x": rest_all[0],
        "collide_elas": np.float32(0.5), "collide_fric": np.float32(0.3),
        "collide_eef_elas": np.float32(0.0),
        "collide_eef_fric": np.float32(1.0),
        "collide_self_elas": np.float32(0.5),
        "collide_self_fric": np.float32(0.3),
        "cand_invalid": (d0 < collision_dist * 5.0) | np.eye(n_rope, dtype=bool),
    }
    tree.update({f"params/{k}": v for k, v in params.items()})
    tree.update({"opts/dt": 5e-5, "opts/num_substeps": 667, "opts/fps": 30.0,
                 "opts/self_collision": True, "opts/n_fingers": 2,
                 "opts/collision_dist": collision_dist})

    # ---- colliders: two fingers + the clip box ---------------------------
    meshes, table, centroids, arm = _finger_tables()
    chain = arm.chain
    for f, name in enumerate(FINGER_LINKS):
        g = build_sdf_grid(meshes[name])
        tree.update({f"colliders/fingers/{f}/origin": g.origin.numpy(),
                     f"colliders/fingers/{f}/inv_spacing": g.inv_spacing.numpy(),
                     f"colliders/fingers/{f}/values": g.values.numpy()})
    tree["colliders/finger_pose_table"] = table.astype(np.float32)
    clip = make_box((0.03, 0.03, 0.05), center=(0.0, 0.0, 0.025))
    g = build_sdf_grid(clip)
    tree.update({"colliders/statics/0/origin": g.origin.numpy(),
                 "colliders/statics/0/inv_spacing": g.inv_spacing.numpy(),
                 "colliders/statics/0/values": g.values.numpy()})
    clip_pose = np.eye(4, dtype=np.float32)
    clip_pose[:3, 3] = [0.5, 0.05, 0.0]
    clip_splats = _splats(clip.sample_surface(120, rng) @ clip_pose[:3, :3].T
                          + clip_pose[:3, 3], np.tile([[0.1, 0.1, 0.9]],
                                                      (120, 1)), 0.004)
    tree.update({f"mesh_params/clip/{k}": v for k, v in clip_splats.items()})

    # ---- table scan (mask 0: no robot splats, as in bench.py) ------------
    (x0, x1), (y0, y1) = (-0.2, 0.8), (-0.5, 0.5)
    table_pts = np.stack([rng.uniform(x0, x1, n_table),
                          rng.uniform(y0, y1, n_table), np.zeros(n_table)], -1)
    t_scale = float(np.clip(np.sqrt((x1 - x0) * (y1 - y0) / n_table) * 0.2,
                            0.0035, 0.01))
    tree.update({f"table/{k}": v for k, v in _splats(
        table_pts, np.tile([[0.4, 0.35, 0.3]], (n_table, 1)),
        t_scale).items()})
    tree["mask"] = np.zeros(n_table, np.int32)

    # ---- robot, cameras, misc --------------------------------------------
    tree.update(_chain_tree(chain))
    link_ids = tuple(i for i in GRIPPER_LINK_IDS if i < len(chain.link_names))
    base_q = np.concatenate([CANONICAL_ARM_QPOS, np.zeros(chain.n_dof - 7)])
    art = RobotArticulation.build(arm, link_ids, base_q, device="cpu")
    tree.update({"articulation/link_ids": np.asarray(link_ids),
                 "articulation/base_inv": art.base_inv.numpy(),
                 "articulation/offsets": art.offsets.numpy(),
                 "articulation/active": art.active.numpy(),
                 "articulation/use_pusher": False})
    fixed = [c for c in CAMERAS if c["type"] == "side"]
    wrist = [c for c in CAMERAS if c["type"] == "wrist"]
    for key, cams, ext_key in (("cameras", fixed, "w2c"),
                               ("wrist_cameras", wrist, "eef2c")):
        for i, c in enumerate(cams):
            tree.update({
                f"{key}/{i}/w": c["w"], f"{key}/{i}/h": c["h"],
                f"{key}/{i}/K": np.asarray(c["intr"], np.float32).reshape(3, 3),
                f"{key}/{i}/{ext_key}": np.linalg.inv(
                    np.asarray(c["c2w"], np.float32).reshape(4, 4))})
    tree.update({"finger_centroids": centroids.astype(np.float32),
                 "global_translation": np.zeros(3, np.float32),
                 "force_threshold": 3e4, "fps": 30.0, "use_shs": False,
                 "do_velocity_control": True,
                 "qpos0": CANONICAL_ARM_QPOS.astype(np.float32)})

    # ---- initial state ----------------------------------------------------
    grip = np.zeros(14, np.float32)
    grip[:3] = [0.2568, 0.0, 0.4005]
    grip[6:10] = [0.0, 1.0, 0.0, 0.0]
    grip[13] = 1.0
    inv0 = np.linalg.inv(poses[0])
    tree.update({
        "state/x": rest_all, "state/v": np.zeros_like(rest_all),
        "state/finger_forces": np.zeros((batch, 2, 3), np.float32),
        "state/telemetry": np.zeros((batch, 4), np.int32),
        "state/current_openness": np.ones(batch, np.float32),
        "state/grasped": np.zeros(batch, bool),
        "state/initialized": np.zeros(batch, bool),
        "state/grippers": np.tile(grip, (batch, 1)),
        "state/qpos7": np.tile(CANONICAL_ARM_QPOS.astype(np.float32),
                               (batch, 1)),
        "state/rel_pose": np.stack([(p @ inv0).astype(np.float32)
                                    for p in poses]),
        "state/static_pose": np.tile(clip_pose[None, None], (batch, 1, 1, 1)),
        "state/rest_x": rest_all, "state/step": 0,
    })
    return assets_from_numpy(tree, device)
