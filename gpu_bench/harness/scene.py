"""The benchmark's scene writers: its "weights", made from the seed.

Frozen copies of the program's fixture writers
(``real2sim_eval_tpu_torch/testing.py``: ``make_rope_points``,
``write_fixture_checkpoint``, ``_splat_params``, ``make_synthetic_scene``,
``make_t_block``, ``make_raw_scan``, ``physics_cfg``), taken when the
benchmark was written and built on the frozen reference copy
(``gpu_bench/reference/plain``), so that a later change to the program
cannot change what the benchmark feeds it. Departures from the originals:
sizes, poses and links come from the configuration file, every draw comes
from one ``numpy.random.Generator`` of the run's seed, and the scan is
written in the robot's frame with each splat's true link id as its mask
(``make_raw_scan``'s sampling, without ICP).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..reference.plain.config import ConfigNode
from ..reference.plain.experiments.utils.create_rigid_phystwin import \
    sample_rigid_points
from ..reference.plain.kinematics.robot import CANONICAL_ARM_QPOS, RobotModel
from ..reference.plain.physics import checkpoints as ckpt_io
from ..reference.plain.physics.topology import connect_springs
from ..reference.plain.utils.colormap import colorize_mask
from ..reference.plain.utils.gs_processor import GSProcessor
from ..reference.plain.utils.mesh import make_box, merge_meshes, save_obj
from ..reference.plain.utils.ply import save_gaussian_ply
from ..reference.plain.utils.sh import C0
from ..reference.plain.utils.urdf import BUILTIN_URDF

# testing.py: the synthetic table's x and y ranges (m) on z = 0
TABLE_EXTENT = ((-0.2, 0.8), (-0.5, 0.5))


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def rope_points(n: int, length: float, jitter: float,
                rng: np.random.Generator) -> np.ndarray:
    """``make_rope_points``, centred on the origin: a line of n points
    along x with normal jitter."""
    t = np.linspace(-length / 2, length / 2, n)
    pts = np.stack([t, np.zeros(n), np.zeros(n)], axis=-1)
    return (pts + rng.normal(scale=jitter, size=pts.shape)).astype(np.float32)


def write_checkpoint(root: Path, case: str, points: np.ndarray,
                     radius: float, max_neighbours: int, spring_Y: float,
                     surface: np.ndarray | None = None,
                     interior: np.ndarray | None = None) -> np.ndarray:
    """``write_fixture_checkpoint``: connect springs as the loader will,
    then write a checkpoint tree whose num_object_springs matches;
    returns the springs (S, 2)."""
    points = np.asarray(points, np.float32)
    springs, _ = connect_springs(points, radius, max_neighbours)
    ckpt_io.write_phystwin_checkpoint(
        root, case, object_points=points,
        surface_points=np.zeros((0, 3)) if surface is None else surface,
        interior_points=np.zeros((0, 3)) if interior is None else interior,
        spring_Y=np.full(len(springs), spring_Y, np.float32),
        num_object_springs=len(springs))
    return springs


def splat_params(pts, colors, scale=0.004, opacity=4.0) -> dict:
    """``_splat_params``: raw (pre-activation) splat params."""
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


def write_object(path: Path, bones: np.ndarray, n_body: int, color,
                 spread: float, along_segments: bool,
                 rng: np.random.Generator) -> None:
    """``make_synthetic_scene``'s object: the particles as the first
    splats (the LBS bones), then ``n_body`` body splats jittered by
    ``spread`` around points on the segments between consecutive bones (a
    rope, ``along_segments``) or around the bones themselves (a solid)."""
    pts = np.asarray(bones, np.float64)
    colors = np.tile([color], (len(pts), 1))
    if along_segments:
        seg = rng.integers(0, len(pts) - 1, n_body)
        t = rng.uniform(0.0, 1.0, (n_body, 1))
        core = pts[seg] * (1.0 - t) + pts[seg + 1] * t
    else:
        core = pts[rng.integers(0, len(pts), n_body)]
    dense = core + rng.normal(scale=spread, size=core.shape)
    dcol = np.clip(np.asarray([color])
                   + rng.normal(scale=0.06, size=(n_body, 3)), 0.0, 1.0)
    save_gaussian_ply(splat_params(np.concatenate([pts, dense]),
                                   np.concatenate([colors, dcol])), path)


def write_scan(path: Path, mask_path: Path, n_table: int, links: list,
               per_link: int, rng: np.random.Generator) -> int:
    """``make_raw_scan`` in the robot's frame: ``n_table`` jittered table
    splats over TABLE_EXTENT, then ``per_link`` splats on each of
    ``links``' collision surfaces of the built-in arm at the canonical pose
    (fingers at 750 counts), coloured by link; the mask holds 0 for the
    table and each robot splat's true link id. Returns the robot splats."""
    (x0, x1), (y0, y1) = TABLE_EXTENT
    table = np.stack([rng.uniform(x0, x1, n_table),
                      rng.uniform(y0, y1, n_table), np.zeros(n_table)], -1)
    table_scale = float(np.clip(np.sqrt((x1 - x0) * (y1 - y0) / n_table)
                                * 0.2, 0.0035, 0.01))
    table_rgb = np.clip([[0.4, 0.35, 0.3]]
                        + rng.normal(scale=0.06, size=(n_table, 3)), 0, 1)
    parts = [splat_params(table, table_rgb, scale=table_scale)]
    masks = [np.zeros(n_table, np.int32)]
    if links:
        robot = RobotModel(BUILTIN_URDF, link_names=list(links))
        q = np.concatenate([CANONICAL_ARM_QPOS,
                            np.full(robot.chain.n_dof - 7,
                                    (800 - 750) * 0.001)])
        clouds = robot.sample_pc(list(links), [per_link] * len(links), rng)
        poses = robot.compute_mesh_poses(q, list(links))
        pts, ids = [], []
        for pose, name in zip(poses, links):
            pts.append(clouds[name] @ pose[:3, :3].T + pose[:3, 3])
            ids.append(np.full(len(clouds[name]),
                               robot.chain.link_index(name), np.int32))
        ids = np.concatenate(ids)
        parts.append(splat_params(np.concatenate(pts), colorize_mask(ids)))
        masks.append(ids)
    GSProcessor().save(GSProcessor().merge(parts), path)
    mask = np.concatenate(masks)
    np.save(mask_path, mask)
    return int((mask > 0).sum())


def write_clip(root: Path, size, n_splats: int,
               rng: np.random.Generator) -> tuple[Path, Path]:
    """``make_synthetic_scene``'s clip: a box mesh resting on z = 0 and
    ``n_splats`` splats on its surface."""
    clip = make_box(tuple(size), center=(0.0, 0.0, size[2] / 2))
    save_obj(clip, root / "clip.obj")
    save_gaussian_ply(splat_params(clip.sample_surface(n_splats, rng),
                                   np.tile([[0.1, 0.1, 0.9]], (n_splats, 1))),
                      root / "clip_splat.ply")
    return root / "clip.obj", root / "clip_splat.ply"


def t_block():
    """``make_t_block``: a push-T block of two 3 cm thick boxes, a 20 x 5
    cm bar on a 15 x 5 cm stem, resting on z = 0."""
    bar = make_box((0.20, 0.05, 0.03), center=(0.0, 0.075, 0.015))
    stem = make_box((0.05, 0.15, 0.03), center=(0.0, -0.025, 0.015))
    return merge_meshes([bar, stem])


def rigid_points(mesh, n_surface: int, grid_size: float,
                 seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``create_rigid_phystwin``'s point sampling: surface samples and
    interior grid points, voxel-deduplicated."""
    return sample_rigid_points(mesh, n_surface=n_surface,
                               grid_size=grid_size, seed=seed)


def physics_cfg(**overrides) -> dict:
    """``physics_cfg``: cfg/physics/default.yaml's values."""
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
    return base


def env_cfg(spec: dict) -> dict:
    """The configuration's ``env`` group with the built-in arm as its
    URDF (the xArm's files are not in the repository)."""
    env = dict(spec["env"])
    env["urdf"] = dict(ik_urdf_path=BUILTIN_URDF,
                       collision_urdf_path=BUILTIN_URDF,
                       collision_link_names=list(spec["collision_links"]))
    return env


def full_cfg(spec: dict, ckpt_root: Path, case: str, gs: dict,
             physics_over: dict) -> ConfigNode:
    """``full_cfg``: the whole run config, cfg/eval_policy_batched.yaml's
    top-level keys around the configuration's groups."""
    return ConfigNode(dict(
        seed=0, online=False, env_name="BaseEnv-v0", obs_mode="rgbd",
        exp_root="log/experiments", timestamp=None, raster_backend="auto",
        physics=physics_cfg(ckpt_path=str(ckpt_root), case_name=case,
                            **physics_over),
        env=env_cfg(spec), gs=gs,
        renderer=dict(gs_center=[0.3, 0.0, 0.0], gs_distance=0.8,
                      gs_azimuth=160, gs_elevation=20),
    ))
