"""The flagship benchmark scene, generated in numpy alone.

``make_flagship_assets`` builds the kind of scene the JAX package's
bench.py evaluates, without its host asset build (PLY/checkpoint/config
loaders): a 1000-particle rope (springs from ``connect_springs``,
Y = 2e3) fleshed out by ``n_obj_dense`` LBS-driven body splats, a table
scan of ``n_table`` splats, a 120-splat box clip that is also a static SDF
collider, two finger colliders from the built-in ``simple_arm.urdf``,
grid-randomized per-env object poses, dt = 5e-5 (667 substeps at 30 Hz)
with self-collision, and bench.py's three 848x480 cameras. It feeds the
card run; it need not equal the JAX build bit for bit.
"""

from __future__ import annotations

import numpy as np

from .convert import assets_from_numpy
from .kinematics.chain import KinematicChain
from .physics.sdf import build_sdf_grid
from .physics.topology import build_neighbor_tables, connect_springs
from .utils.mesh import make_box
from .utils.sh import C0
from .utils.urdf import BUILTIN_URDF, load_urdf, resolve_geometry

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
CANONICAL_ARM_QPOS = np.array([0, -45, 0, 30, 0, 75, 0]) * np.pi / 180.0
GRIPPER_LINK_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15, 16)
FINGER_LINKS = ("left_finger", "right_finger")
GRID_XY = [[-0.05, -0.05], [0.0, 0.0], [0.05, 0.05]]
GRID_THETA = [-10, 0, 10]


def make_rope_points(n=200, length=0.5, jitter=0.002, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, length, n)
    pts = np.stack([t, np.zeros(n), np.zeros(n)], axis=-1)
    return pts + rng.normal(scale=jitter, size=pts.shape)


def _rz_pose(pose, rx, ry, ang):
    pose = np.array(pose, np.float64)
    pose[:3, 3] += [rx, ry, 0.0]
    c, s = np.cos(ang), np.sin(ang)
    pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ pose[:3, :3]
    return pose


def _rot_to_quat_np(R):
    w = np.sqrt(np.maximum(1 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def _quat_mul_np(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


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


def _finger_tables(urdf, chain: KinematicChain):
    """SDF source meshes, openness pose table (F, 101, 4, 4) and centroids
    of the two finger colliders, plus every link's collision offset."""
    offsets, meshes, prev = {}, {}, np.eye(4)
    for link in urdf.links:
        if link.collisions:
            spec, prev = link.collisions[0]
            if link.name in FINGER_LINKS:
                meshes[link.name] = resolve_geometry(spec)
        offsets[link.name] = prev.copy()
    eef = chain.link_index("link_eef")
    table = np.zeros((len(FINGER_LINKS), 101, 4, 4))
    for s in range(101):
        ang = 0.8 * (1.0 - s / 100.0)
        q = np.concatenate([CANONICAL_ARM_QPOS,
                            np.full(chain.n_dof - 7, ang)])
        fk = chain.fk_numpy(q)
        T_ew = np.linalg.inv(fk[eef])
        for f, name in enumerate(FINGER_LINKS):
            table[f, s] = T_ew @ fk[chain.link_index(name)] @ offsets[name]
    centroids = np.stack([meshes[n].vertices.mean(0) for n in FINGER_LINKS])
    return meshes, table, centroids, offsets


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
    poses = []
    for i in range(batch):
        cell = i % (len(GRID_XY) * len(GRID_THETA))
        rx, ry = GRID_XY[cell // len(GRID_THETA)]
        ang = GRID_THETA[cell % len(GRID_THETA)] * np.pi / 180.0
        poses.append(_rz_pose(pose0, rx, ry, ang))
    R0 = poses[0][:3, :3].astype(np.float32)
    obj_env0 = dict(obj)
    obj_env0["means3D"] = obj["means3D"] @ R0.T + poses[0][:3, 3].astype(
        np.float32)
    obj_env0["rotations"] = _quat_mul_np(
        _rot_to_quat_np(R0).astype(np.float32),
        obj["rotations"]).astype(np.float32)
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
    urdf = load_urdf(BUILTIN_URDF)
    chain = KinematicChain.from_urdf(urdf)
    meshes, table, centroids, offsets = _finger_tables(urdf, chain)
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
    art = RobotArticulation.build(chain, link_ids, base_q, offsets, "cpu")
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
