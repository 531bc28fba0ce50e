"""Scene writer of the ``rope`` configuration (``rope.json`` beside it):
a rope checkpoint, its LBS body splats, a scan with robot splats and the
clip, all drawn from the run's seed."""

from __future__ import annotations

from pathlib import Path

from gpu_bench.harness import scene as sc


def write(spec: dict, root: Path, seed: int) -> dict:
    """Write the scene under ``root``; returns the run config (a dict of
    cfg/eval_policy_batched.yaml's schema) and the object's particles in
    its own frame and its springs."""
    o, s, c = spec["object"], spec["scan"], spec["clip"]
    rng = sc.rng_of(seed, 1)
    bones = sc.rope_points(o["particles"], o["length"], o["jitter"], rng)
    springs = sc.write_checkpoint(root / "ckpt", "rope", bones, o["radius"],
                        o["max_neighbours"], o["spring_Y"])
    sc.write_object(root / "object.ply", bones, o["body_splats"], o["color"],
                    o["body_spread"], True, rng)
    sc.write_scan(root / "scene.ply", root / "scene_mask.npy",
                  s["table_splats"], s["links"], s["splats_per_link"], rng)
    clip_mesh, clip_splats = sc.write_clip(root, c["size"], c["splats"], rng)
    gs = dict(spec["gs"])
    gs["scene"] = dict(table_splat_path=str(root / "scene.ply"),
                       total_mask_path=str(root / "scene_mask.npy"))
    gs["object"] = dict(gs["object"], path=str(root / "object.ply"))
    gs["meshes"] = [dict(m, splat_path=str(clip_splats),
                         mesh_path=str(clip_mesh)) for m in gs["meshes"]]
    phys = dict(spec["physics"], object_radius=o["radius"],
                object_max_neighbours=o["max_neighbours"])
    cfg = sc.full_cfg(spec, root / "ckpt", "rope", gs, phys)
    return {"cfg": cfg, "particles": bones, "springs": springs}
