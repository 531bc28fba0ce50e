"""Physics and render component profiler (the JAX package's
experiments/utils/profile_physics.py).

The physics ablation runs one control step of a rope (``--particles``,
``--batch`` envs, 667 substeps) through ``fused_step.make_fused_step_fn``
(the freezes, then K3 on the card) in four variants: with everything,
without self-collision, without the finger and static colliders, and
with springs alone. ``--render`` times the raster stages at 31,000
gaussians and 848x480: preprocess, binning and the full ``rasterize``
(K1 on the card).

Timing rule on the card: the launches are asynchronous, so a host clock
around one call measures its enqueue. Each component gets one warm call
(allocations, the extension's first use), then CUDA events around a loop
of ``iters`` calls with no host synchronise inside it; the mean is the
events' elapsed time over ``iters``. On the CPU the host clock does the
same. Compare variants by toggling components, within one process.

Usage:
    python -m real2sim_eval_tpu_torch.experiments.utils.profile_physics
    python -m real2sim_eval_tpu_torch.experiments.utils.profile_physics --render
    (add --device cpu for the plain PyTorch versions)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# (name, self-collision, colliders) of the physics ablation
VARIANTS = (("full", True, True), ("no-selfcollision", False, True),
            ("no-contact", True, False), ("springs-only", False, False))


def _timeit(name, fn, init, n_inner, iters=5) -> dict:
    """One warm call, then the mean ms of ``iters`` chained calls."""
    on_card = any(t.is_cuda for t in _tensors(init))
    t0 = time.perf_counter()
    s = fn(init)
    if on_card:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    s = init
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            s = fn(s)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            s = fn(s)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    print(f"{name}: {ms:8.1f} ms/call  "
          f"({ms / n_inner * 1e3:7.1f} us/substep, warm-up {warm_s:.1f}s)")
    return {"name": name, "ms": ms, "us_per_substep": ms / n_inner * 1e3,
            "warm_s": warm_s, "iters": iters}


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for f in x.__dataclass_fields__
                for t in _tensors(getattr(x, f))]
    return []


def profile_scene(batch: int = 8, n: int = 1000) -> dict:
    """The ablation's scene as numpy arrays: a 0.4 m rope of ``n``
    particles (springs within 2 cm, 30 a particle, Y = 2e3), two 2x4x8 cm
    finger boxes 8 cm apart under an eef at (0.2, 0, 0.3) pointing down,
    closing from 1.0 to 0.8, and a 3x3x5 cm static box at x = 0.5."""
    from ...physics.sdf import build_sdf_grid
    from ...physics.topology import build_neighbor_tables, connect_springs
    from ...testing import make_rope_points
    from ...utils.mesh import make_box

    rope = make_rope_points(n=n, length=0.4).astype(np.float32)
    springs, rest = connect_springs(rope, radius=0.02, max_neighbours=30)
    ylog = np.log(np.full(len(springs), 2e3, np.float32))
    nbr_idx, nbr_rest, nbr_y = build_neighbor_tables(springs, rest, ylog, n)

    def grid(box):
        g = build_sdf_grid(box)
        return {k: getattr(g, k).numpy()
                for k in ("origin", "inv_spacing", "values", "corners")}

    ftab = np.tile(np.eye(4, dtype=np.float32), (2, 101, 1, 1))
    ftab[:, :, 2, 3] = 0.10
    ftab[0, :, 1, 3] = -0.04
    ftab[1, :, 1, 3] = 0.04
    ctrl = {"eef_xyz": np.array([0.2, 0.0, 0.3], np.float32),
            "eef_vel": np.zeros(3, np.float32),
            "eef_rot": np.diag([1.0, -1.0, -1.0]).astype(np.float32),
            "eef_rot_vel": np.zeros(3, np.float32),
            "openness_start": np.float32(1.0),
            "openness_end": np.float32(0.8),
            "dyn_lin_vel": np.zeros((2, 3), np.float32),
            "dyn_omega": np.zeros(3, np.float32)}
    return {
        "rope": rope, "springs": springs, "rest_lengths": rest,
        "spring_Y_log": ylog, "nbr_idx": nbr_idx, "nbr_rest": nbr_rest,
        "nbr_Y_log": nbr_y,
        "finger": grid(make_box((0.02, 0.04, 0.08), center=(0, 0, 0.04))),
        "static": grid(make_box((0.03, 0.03, 0.05),
                                center=(0.5, 0, 0.025))),
        "finger_pose_table": ftab,
        "static_pose": np.eye(4, dtype=np.float32)[None],
        "ctrl": {k: np.broadcast_to(v, (batch,) + np.shape(v)).copy()
                 for k, v in ctrl.items()},
        "x": np.broadcast_to(rope, (batch, n, 3)).copy()}


def physics_inputs(scene: dict, device) -> dict:
    """The scene's params, colliders, state, controls and rest positions
    as the port's tensors on ``device``."""
    from ...physics.sdf import SdfGrid
    from ...physics.spring_mass import (MeshColliderSet, SpringMassParams,
                                        SpringMassState, SubstepControls)

    def T(a):
        return torch.as_tensor(np.array(a), device=device)

    n = scene["rope"].shape[0]
    batch = scene["x"].shape[0]
    f32 = {k: T(np.float32(v)) for k, v in (
        ("collide_elas", 0.5), ("collide_fric", 0.3),
        ("collide_eef_elas", 0.0), ("collide_eef_fric", 1.0),
        ("collide_self_elas", 0.5), ("collide_self_fric", 0.3))}
    params = SpringMassParams(
        springs=T(scene["springs"]), rest_lengths=T(scene["rest_lengths"]),
        spring_Y_log=T(scene["spring_Y_log"]),
        masses=T(np.ones(n, np.float32)), nbr_idx=T(scene["nbr_idx"]),
        nbr_rest=T(scene["nbr_rest"]), nbr_Y_log=T(scene["nbr_Y_log"]),
        collision_mask=T(np.arange(n, dtype=np.int32)),
        rest_x=T(scene["rope"]), **f32)
    finger = SdfGrid(**{k: T(v) for k, v in scene["finger"].items()})
    static = SdfGrid(**{k: T(v) for k, v in scene["static"].items()})
    colliders = MeshColliderSet(
        fingers=(finger, finger),
        finger_pose_table=T(scene["finger_pose_table"]), statics=(static,),
        static_pose=T(np.broadcast_to(scene["static_pose"],
                                      (batch, 1, 4, 4))))
    state = SpringMassState(x=T(scene["x"]),
                            v=torch.zeros((batch, n, 3), device=device),
                            finger_forces=torch.zeros((batch, 2, 3),
                                                      device=device))
    ctrl = SubstepControls(**{k: T(v) for k, v in scene["ctrl"].items()})
    return {"params": params, "colliders": colliders, "state": state,
            "ctrl": ctrl, "rest_x": T(scene["x"])}


def variant_step(substeps: int, device, self_collision: bool,
                 has_colliders: bool):
    """The fused control step of one ablation variant."""
    from ...physics.fused_step import make_fused_step_fn
    from ...physics.spring_mass import PhysicsOptions

    opts = PhysicsOptions(dt=5e-5, num_substeps=substeps, fps=30,
                          self_collision=self_collision, n_fingers=2)
    return make_fused_step_fn(opts, has_colliders=has_colliders,
                              device=device)


def profile_physics(batch=8, n=1000, substeps=667, device="cuda",
                    iters=5) -> list:
    from ...utils.device import resolve_device

    device = resolve_device(device)
    print("device:", device, torch.cuda.get_device_name(device)
          if device.type == "cuda" else "")
    inp = physics_inputs(profile_scene(batch, n), device)
    rows = []
    for name, self_c, has_c in VARIANTS:
        step = variant_step(substeps, device, self_c, has_c)
        coll = inp["colliders"] if has_c else None
        rows.append(_timeit(
            name, lambda s, step=step, coll=coll: step(
                inp["params"], coll, s, inp["ctrl"], inp["rest_x"]),
            inp["state"], substeps, iters))
    return rows


def render_scene(n=31000, h=480, w=848, seed=0) -> dict:
    """The render ablation's camera and ``n`` random gaussians (numpy):
    4 mm isotropic splats over a 1 x 1 x 0.3 m box in front of the
    flagship's first fixed camera."""
    from ...utils.sh import C0

    rng = np.random.default_rng(seed)
    k = np.array([[427.3, 0, 430.0], [0, 426.8, 242.8], [0, 0, 1]],
                 np.float32)
    c2w = np.array([[0.005, 0.613, -0.790, 0.883],
                    [1.0, -0.004, 0.004, 0.054],
                    [-0.001, -0.790, -0.613, 0.398],
                    [0, 0, 0, 1]], np.float32)
    return {"w": w, "h": h, "k": k, "w2c": np.linalg.inv(c2w),
            "means": rng.uniform([-0.2, -0.5, 0.0], [0.8, 0.5, 0.3],
                                 (n, 3)).astype(np.float32),
            "scales": np.full((n, 3), 0.004, np.float32),
            "quats": np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
            "opacities": np.full((n, 1), 0.8, np.float32),
            "shs": ((rng.random((n, 1, 3)) - 0.5) / C0).astype(np.float32)}


def profile_render(n=31000, h=480, w=848, device="cuda", iters=10) -> list:
    from ...renderer.binning import bin_gaussians
    from ...renderer.camera import setup_camera
    from ...renderer.preprocess import preprocess_gaussians
    from ...renderer.raster import TILE_H, TILE_W, RasterConfig, rasterize
    from ...utils.device import resolve_device

    device = resolve_device(device)
    sc = render_scene(n, h, w)
    cam, w2c = setup_camera(w, h, sc["k"], sc["w2c"])
    w2c = torch.as_tensor(w2c, device=device)
    g = {k: torch.as_tensor(sc[k], device=device)
         for k in ("means", "scales", "quats", "opacities", "shs")}
    tx, ty = -(-w // TILE_W), -(-h // TILE_H)

    def pre_fn(m):
        # one instance: the binning takes (instances, gaussians) tables
        return preprocess_gaussians(cam, w2c[None], m[None],
                                    g["scales"][None], g["quats"][None],
                                    g["opacities"][None], g["shs"][None], 0)

    pre = pre_fn(g["means"])
    rows = [_timeit("preprocess", lambda m: (pre_fn(m), m)[1], g["means"],
                    1, iters),
            _timeit("binning", lambda p: (bin_gaussians(
                p, tx, ty, TILE_W, TILE_H), p)[1], pre, 1, iters),
            _timeit("full rasterize", lambda m: (rasterize(
                cam, w2c, m, g["scales"], g["quats"], g["opacities"],
                g["shs"], 0, config=RasterConfig(), device=device), m)[1],
                g["means"], 1, iters)]
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--particles", type=int, default=1000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.render:
        return profile_render(device=args.device)
    return profile_physics(batch=args.batch, n=args.particles,
                           device=args.device)


if __name__ == "__main__":
    main()
