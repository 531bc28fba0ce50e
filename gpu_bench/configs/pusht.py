"""Scene writer of the ``pusht`` configuration (``pusht.json`` beside it):
a rigid PhysTwin of the push-T block, its LBS body splats and a scan with
the pusher arm's robot splats, all drawn from the run's seed."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gpu_bench.harness import scene as sc


def write(spec: dict, root: Path, seed: int) -> dict:
    """Write the scene under ``root``; returns the run config and the
    object's particles in its own frame and its springs."""
    o, s = spec["object"], spec["scan"]
    rng = sc.rng_of(seed, 1)
    surface, interior = sc.rigid_points(sc.t_block(), o["n_surface"],
                                        o["grid_size"], int(rng.integers(1 << 31)))
    bones = np.concatenate([surface, interior]).astype(np.float32)
    springs = sc.write_checkpoint(root / "ckpt", "T", bones, o["spring_radius"],
                        o["max_neighbours"], o["spring_Y"])
    sc.write_object(root / "object.ply", bones, o["body_splats"], o["color"],
                    o["body_spread"], False, rng)
    sc.write_scan(root / "scene.ply", root / "scene_mask.npy",
                  s["table_splats"], s["links"], s["splats_per_link"], rng)
    gs = dict(spec["gs"])
    gs["scene"] = dict(table_splat_path=str(root / "scene.ply"),
                       total_mask_path=str(root / "scene_mask.npy"))
    gs["object"] = dict(gs["object"], path=str(root / "object.ply"))
    cfg = sc.full_cfg(spec, root / "ckpt", "T", gs, dict(spec["physics"]))
    return {"cfg": cfg, "particles": bones, "springs": springs}
