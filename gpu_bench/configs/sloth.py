"""Scene writer of the ``sloth`` configuration (``sloth.json`` beside it):
a volumetric plush as a PhysTwin checkpoint with its LBS body splats, the
open container it is packed into, and a scan with robot splats, all
drawn from the run's seed."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gpu_bench.harness import scene as sc
from gpu_bench.reference.plain.utils.mesh import make_box, merge_meshes, save_obj
from gpu_bench.reference.plain.utils.ply import save_gaussian_ply


def _box(x0, x1, y0, y1, z0, z1):
    return make_box((x1 - x0, y1 - y0, z1 - z0),
                    center=((x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2))


def plush(parts_cm):
    """The plush in its natural frame (long axis x, up z, resting on z =
    0): one box a part, (x0, x1, y0, y1, z0, z1) in cm, the parts touching
    but not overlapping, so that the ray-parity inside test of
    ``sample_rigid_points`` holds."""
    return merge_meshes([_box(*(np.asarray(p, np.float64) / 100.0))
                         for p in parts_cm])


def container(size, wall: float):
    """An open box of outer size (x, y, z), resting on z = 0 and centred
    on the z axis: a floor, two long walls on it and two short walls
    between them, none overlapping another."""
    x, y, z, w = size[0] / 2, size[1] / 2, size[2], wall
    return merge_meshes([
        _box(-x, x, -y, y, 0.0, w),
        _box(-x, -x + w, -y, y, w, z), _box(x - w, x, -y, y, w, z),
        _box(-x + w, x - w, -y, -y + w, w, z),
        _box(-x + w, x - w, y - w, y, w, z)])


def to_object_frame(pts: np.ndarray, pose, gap: float) -> np.ndarray:
    """Points of the natural frame in the object's own frame, such that
    ``pose`` (sloth.yaml's, object to world) lays the plush's long axis
    along the world's y, its up along the world's z, and its bottom
    ``gap`` above the table."""
    P = np.asarray(pose, np.float64).reshape(4, 4)
    M = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    rel = (np.asarray(pts, np.float64) @ M.T
           + np.array([0.0, 0.0, gap - P[2, 3]]))     # world minus P's t
    return (rel @ P[:3, :3]).astype(np.float32)


def write(spec: dict, root: Path, seed: int) -> dict:
    """Write the scene under ``root``; returns the run config and the
    object's particles in its own frame and its springs."""
    o, s, b = spec["object"], spec["scan"], spec["box"]
    rng = sc.rng_of(seed, 1)
    surface, interior = sc.rigid_points(plush(o["parts_cm"]), o["n_surface"],
                                        o["grid_size"],
                                        int(rng.integers(1 << 31)))
    pose = spec["gs"]["object"]["pose"]
    bones = to_object_frame(np.concatenate([surface, interior]), pose,
                            o["rest_gap_m"])
    springs = sc.write_checkpoint(root / "ckpt", "sloth", bones, o["radius"],
                                  o["max_neighbours"], o["spring_Y"])
    sc.write_object(root / "object.ply", bones, o["body_splats"], o["color"],
                    o["body_spread"], False, rng)
    sc.write_scan(root / "scene.ply", root / "scene_mask.npy",
                  s["table_splats"], s["links"], s["splats_per_link"], rng)
    box = container(b["size"], b["wall"])
    save_obj(box, root / "box.obj")
    save_gaussian_ply(sc.splat_params(box.sample_surface(b["splats"], rng),
                                      np.tile([b["color"]], (b["splats"], 1))),
                      root / "box_splat.ply")
    gs = dict(spec["gs"])
    gs["scene"] = dict(gs["scene"], table_splat_path=str(root / "scene.ply"),
                       total_mask_path=str(root / "scene_mask.npy"))
    gs["object"] = dict(gs["object"], path=str(root / "object.ply"))
    gs["meshes"] = [dict(m, splat_path=str(root / "box_splat.ply"),
                         mesh_path=str(root / "box.obj"))
                    for m in gs["meshes"]]
    phys = dict(spec["physics"], object_radius=o["radius"],
                object_max_neighbours=o["max_neighbours"])
    cfg = sc.full_cfg(spec, root / "ckpt", "sloth", gs, phys)
    return {"cfg": cfg, "particles": bones, "springs": springs}
