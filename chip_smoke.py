"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py        (everything)
    python3 chip_smoke.py ik     (the IK kernel's gate alone)

Builds the port's CUDA kernels from ``real2sim_eval_tpu_torch/csrc`` (into
``real2sim_eval_tpu_torch/_build``), holds each kernel against its plain
PyTorch version on the card, then drives the flagship batched evaluation
(64 lockstep envs, 130,120 gaussians per env, two fixed and one wrist
848x480 camera, 667 spring-mass substeps per control step) through
``BatchedEvaluator`` on its default render, the incremental one (dirty
tiles of the fixed cameras by the sort merge and K2, the wrist camera
through the pre-cull rules and K1), and again with the stream merge (K6).
It checks that the render paths agree, and reports timings, a stage
breakdown of one step and render, and each kernel's time beside its bound
at the flagship's shapes. The same flagship then runs on the fine kernel
family (``RasterConfig(kernel="fine")``: the dirty 8x16 fine tiles of the
fixed cameras through the sort merge and K5, the wrist camera through the
fine binning and K4), held bitwise to the fine full pipeline and within
the JAX suite's bound to the wide frames, with its own breakdown and K4's
and K5's times. Then it drives the differentiable render (K7
forward, K8 backward) through the refinement tool ``refine`` on one scan
of the flagship scene (130,120 gaussians, degree-3 SH, 8 views at
848x480), after holding K7 and K8 against their plain versions and the
gradients against autograd of the plain compositor, with broken backwards
that must fail the gate. Each kernel's check on a small scene comes first
(K1, K7, K8, K2, K6, K4, K5, K3): K1, K7, K2 and K6 bitwise their plain
versions, with K1's evaluations before and after its per-warp block cull.
Before the flagship's timed steps, ``ik_kernel`` holds the IK solve's
kernel (one launch a solve) bitwise to the eager solve on two arms, at 64
lanes and lane by lane (``python3 chip_smoke.py ik`` builds the
extension and runs that gate alone). After the refinement, the
evaluator is built from a config as bench.py builds it (``cfg_build``:
bench.py's files written by the port's fixture writers, a save/load
round trip,
``BatchedEvaluator(cfg, range(64))``, gated on its gaussian and particle
counts and its grid poses), timed on the default branch
(``cfg_flagship``), and the single env (``envs.make("BaseEnv-v0")``:
``GSRenderer`` through K1, ``PhysTwinDynamics`` through K3 at B = 1) is
held against a one-episode evaluator of the same config
(``single_env``: particles at every step, frames through the first,
every step's frame against a reference with the single env's blend,
its K1 bitwise on captured inputs, its synchronising calls counted).
The CLIs then run on that scene (``cli_batched``:
``eval_policy_batched.cli`` at 64 lanes with its per-step split, the
reference's file layout, and its particles and lane 0's first frames
bitwise its own evaluator restored to a snapshot and driven directly;
``success``; ``cli_single``, bitwise a single env driven with the
run's recorded actions; ``cli_replay`` in two formats; ``cli_teleop``).
Then the scene- and asset-building tools run at the flagship's width
(``rigid_object``: ``create_rigid_phystwin`` on a push-T block;
``raw_scan``: a 119,000-splat scan of the table and the built-in arm in
a known frame; ``construct_scene``: its alignment, segmentation and
articulated preview through K1; ``scan_views``: ``visualize_scan``'s
orbit views and ``.splat``; ``color_alignment``), and a 64-lane
evaluator is built from what they wrote and timed
(``constructed_flagship``: the rigid object, the constructed scan with
its robot splats articulated every render, the fitted colours). The rest
of the tools follow on the config-built scene: ``ply_native`` (the C++
and the numpy PLY reader on its table scan and body PLY, bitwise, their
host ms), ``online_render`` (``GSRenderer`` with ``online: true``:
``render_online`` twice at 848x480, the viewer's camera orbited between,
each image bitwise ``render(camera=...)``; the debug dump's two PNGs,
``test.png`` bitwise the frame), ``profile_physics`` (the tool's physics
ablation, four variants through K3, each variant's step against K3's
plain version, and its raster ablation, the full rasterize's K1 frame
bitwise its plain version), and
``fan_out`` (``eval_policy_parallel.main`` on the CLI scene at 2 batches
of 8 lanes: two spawned workers on the one card, then one worker, the
run directories equal file for file). After the device profiles,
``trace_step`` traces one step + render of the wide and the fine
flagship with every stage named, each kernel under the stage that
launched it (under 5 % of device time outside every stage, one kernel a
IK solve), beside ``device_profile``'s device time.
Every
compositor's least time counts only the (pixel, pair) evaluations that
reach a pixel (``pixel_pair_walks``).
Every line of standard output is one JSON object (the first holds the
card's ``nvidia-smi`` name and power limit); the last line is ``{"ok": true, "device": {...}}``. Any failed
phase raises and exits non-zero without that line; so does a machine
without a CUDA device. Every host-timed phase runs before the first
``torch.profiler`` session; the device profiles come last, followed by
the default path timed once more as a control.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from real2sim_eval_tpu_torch.utils import profiling  # noqa: E402
from real2sim_eval_tpu_torch.utils.profiling import (  # noqa: E402
    device_profile, patch, stage_timer, time_host)

B_FLAGSHIP = 64
# the IK gate (ik_kernel): lanes solved one by one (E = 1) per arm; the
# dependent FP32 operations on a lane's critical path a Gauss-Newton step
# (counted from csrc/ik_solve.cu: ~80 down the path's 4 x 4 products, ~110
# in the rotation log and its tangent, 7 in J J^T, ~200 in the 6 x 6
# elimination and substitutions, 5 in the update), the basis of its bound
IK_SINGLE_LANES = 8
IK_CHAIN_OPS = 400
N_TABLE = 99000
N_OBJ_DENSE = 30000
TIMED_STEPS = 20
TIMED_STEPS_STREAM = 5
TIMED_STEPS_FINE = 5
# the config-built flagship (cfg_flagship) and the single env (single_env)
TIMED_STEPS_CFG = 5
SINGLE_ENV_STEPS = 3
# the default path timed once more after the device profiles (main)
TIMED_STEPS_AFTER = 3
# the CLI phases' cuts from a user's run: 1 s of control (30 steps after
# the 30 stabilization steps) instead of the rope config's 30 s, and a
# checkpoint and a saturation check every 10 steps
CLI_DURATION = 1
CLI_CHECKPOINT_EVERY = 10
CLI_TELEMETRY_EVERY = 10
# the replayed trajectory: 10 recorded steps, each 5 mm lower
CLI_REPLAY_STEPS = 10
CLI_REPLAY_DESCENT = 0.005
CLI_TELEOP_KEYS = "wwwq"
CLI_TELEOP_STEPS = 3
# the scene-building phases (scene_tools): the rigid object's case name;
# the raw scan's frame against the robot's (a yaw about z, then a shift)
# and its seed (construct_scene samples the robot with default_rng(i) per
# link), and the alignment crop's padding around the robot's box
RIGID_CASE = "rigid_T"
SCAN_YAW_DEG = 30.0
SCAN_SHIFT = (0.1, -0.2, 0.05)
SCAN_SEED = 1
SCAN_CROP_PAD = 0.05
# construct_scene's gates, about ten times the alignment error of this
# scan (0.0103 deg, 0.0897 mm at the flagship's width, numpy and scipy on
# the host, on a CPU and on the H100's host alike); the share of robot
# splats labelled with their own link, 0.959 there: the nearest sampled
# point of a splat where two links meet may lie on the other link, and the
# base disc of link1 sits at the robot box's z cut
ALIGN_ROT_DEG = 0.1
ALIGN_TRANS_MM = 1.0
TRUE_ID_SHARE = 0.95
# color_alignment: the share of the real image's pixels replaced by noise,
# and the fitted map's bound on the clean ones (tests/test_tools.py)
COLOR_OUTLIERS = 0.1
COLOR_TOL = 0.02
TIMED_STEPS_CONSTRUCTED = 5
# step + render samples each stage breakdown averages: one sample of a
# stage can land on a host stall several times its usual length
BREAKDOWN_REPS = 3
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores, for the kernels' least times
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# the tools phases: reads of each PLY reader (the first reported apart);
# the fan-out's batches and lanes (the CLI scene of cli_batched, its 30
# control steps); traced step + render pairs a path, and the share of
# device time the trace may leave outside every stage
PLY_READS = 4
FAN_BATCHES = 2
FAN_LANES = 8
TRACE_ITERS = 1
TRACE_UNATTRIBUTED = 0.05
# warp boxes (rows, columns) whose culled evaluations pixel_pair_walks
# counts: K1's 8x16 blocks of the wide tile, and the fine tile whole and
# split four ways (quadrants, strips)
WIDE_BOX = ((8, 16),)
FINE_BOXES = ((8, 16), (4, 8), (2, 16))
# f32 operations per (pixel, pair) evaluation of the compositor's blend
# (offsets, the conic quadratic, exp, the alpha/T tests, one update)
K1_OPS_PER_EVAL = 20
# f32 operations the backward K8 adds per contributing (pixel, pair) for
# its ten gradient terms (the prefix colour, the suffix identity with its
# division, the clamp gate and the x/y/conic/opacity/colour/depth terms),
# on top of K1_OPS_PER_EVAL for the forward walk it repeats
K8_OPS_PER_CONTRIB = 60
# gradients against autograd through the plain compositor: the JAX suite's
# tolerances (tests/test_diff.py:104-107), atol relative to the largest
GRAD_RTOL = 2e-3
GRAD_ATOL_REL = 1e-4
# K8's per-pair table against its plain version: the same per-pixel
# operations, the sums over a tile's 1024 pixels in another order
K8_PLAIN_TOL = 1e-4                    # of each lane's largest |gradient|
# K7's transmittance against the plain version's: the same operations
T_TOL = 1e-5
# the refinement phase: one scan of the flagship scene, 8 views
REFINE_ITERS = 20
REFINE_GEOM_ITERS = 3
# shifts (m) along each fixed camera's x axis of the six extra views
REFINE_SHIFTS = ((0.03, -0.03, 0.06), (0.03, -0.03, -0.06))
# f32 operations of the spring-mass step's inner work items
K3_OPS = {"spring_slot": 30, "particle": 30, "self_slot": 45,
          "contact_base": 80, "contact_query": 60}
RGB_TOL = 2e-3
# the full-pipeline branch composes the scene in another gaussian order
# ([object, meshes, table] vs [dynamic; static]), so only equal-depth ties
# may differ from the incremental branch (tests/test_incremental.py:306)
BRANCH_RGB_TOL = 1e-5
# the fine family cuts each splat at its 3-sigma rect of 8x16 tiles, the
# wide one at its rect of 8x128 tiles: the JAX suite's bound between the
# two families (tests/test_incremental_fine.py:172-174), rgb max and depth
# (pixels over it counted against flips_limit, as every depth gate here)
FAMILY_RGB_TOL = 2e-2
FAMILY_DEPTH_TOL = 1e-2
# the cull-too-much mutant of K4 and K5: the kernels built with this
# absolute cull margin in place of tile_blend.cuh's kCullAbs = 1e-4
CULL_MUTANT_MARGIN = -0.05
# K3 against its plain version, per case: max |x| (m), max |v| (m/s) and
# the largest gap between the ropes' centres of mass (m). Each gate is a
# small multiple of the gap measured on an H100 (PERF.md, Findings);
# the gaps are deterministic (same inputs, no atomics in either version).
# Each case also reports the plain version's own f32-vs-f64 gap: what
# rounding alone does to that step (k3_rounding_gap)
K3_GATES = {
    # a resting rope: the ground flips a few particles' velocities between
    # its bounce and rest branches
    "flagship": {"x": 1e-5, "v": 1e-2, "com": 1e-6},
    # fingers pressing into the rope: chaotic contact, whose v gap equals
    # the plain version's own f32-vs-f64 gap
    "grasp": {"x": 2e-4, "v": 5e-1, "com": 1e-5},
    # stretched loop in the air, its ends colliding: springs + phase B
    "loop": {"x": 1e-6, "v": 5e-4, "com": 1e-8},
    # a box tool pushing down onto the rope with the pusher's 1 mm margin
    # (measured on an H100: x 4.8e-7, v 6.9e-4 as the plain version's own
    # f32-vs-f64 gap, CoM 3.1e-8)
    "pusher": {"x": 5e-6, "v": 1e-2, "com": 5e-7},
    # the constructed flagship's rigid push-T lattice (817 particles, up
    # to 50 springs each, self-collision on) settling on the table, one
    # step after the timed ones (measured on an H100: x 1.7e-6, v 1.7e-4,
    # CoM 4.0e-8; the plain version's own f32-vs-f64 gap x 4.3e-6). The
    # object moves 1.2e-5 m in that step, so x's gate lies between the
    # gap and the no-op kernel's; no self-collision slot is live (its
    # close pairs are springs), so that mutant is not a must-catch
    "constructed": {"x": 5e-6, "v": 1e-3, "com": 2e-7},
    # profile_physics' four variants (profile_physics_phase): a rope
    # settling on the ground, the fingers closing above it, with and
    # without the self-collision table (no slot live: the close pairs are
    # springs) and the contact table (8 candidates in reach, on the static
    # box). Measured on an H100: x 7.4e-7, v 4.0e-4, CoM 6.6e-8 with the
    # colliders, x 1.1e-6, v 8.1e-4, CoM 3.6e-8 without; the no-op and
    # no-springs kernels >= 2.6e-2
    "profile_full": {"x": 5e-6, "v": 5e-3, "com": 5e-7},
    "profile_no-selfcollision": {"x": 5e-6, "v": 5e-3, "com": 5e-7},
    "profile_no-contact": {"x": 5e-6, "v": 5e-3, "com": 5e-7},
    "profile_springs-only": {"x": 5e-6, "v": 5e-3, "com": 5e-7},
    # the sloth cell's tables (k3_sloth_case): a 3,400-particle plush with
    # volumetric springs falling onto its container's floor against a wall,
    # self-collision and contact at the full caps
    "sloth": {"x": 2e-4, "v": 5e-1, "com": 1e-5},
}
# the loop's control step is cut to its first substeps: its ends' collision
# is chaotic, and by 40 substeps rounding alone flips a hit in the plain
# version (PERF.md, Findings)
K3_LOOP_SUBSTEPS = 20
# the broken kernels each case's gates must reject (k3_mutants)
K3_MUST_CATCH = {"flagship": ("no_op", "no_springs"),
                 "grasp": ("no_op", "no_springs"),
                 "loop": ("no_op", "no_springs", "no_self_collision"),
                 "pusher": ("no_op", "no_springs", "no_pusher"),
                 "constructed": ("no_op", "no_springs"),
                 "profile_full": ("no_op", "no_springs"),
                 "profile_no-selfcollision": ("no_op", "no_springs"),
                 "profile_no-contact": ("no_op", "no_springs"),
                 "profile_springs-only": ("no_op", "no_springs"),
                 "sloth": ("no_op", "no_springs")}
# profile_physics' physics ablation at the tool's defaults
PROFILE_BATCH, PROFILE_PARTICLES, PROFILE_SUBSTEPS = 8, 1000, 667
# the drift test of K3's two-CTA cluster (check_k3_drift): control steps
# cut to this many substeps, run with these delays (ns, one CTA of each
# env against the other at every phase boundary)
K3_DRIFT_SUBSTEPS = 8
K3_DRIFT_NS = (0, 250, 2000, 16000)
DEVICE = "cuda"


def render_off():
    """The full-pipeline render: for the checks that build an evaluator
    only for its scene or its controls (no static frames to build)."""
    from real2sim_eval_tpu_torch.renderer import RasterConfig

    return RasterConfig(incremental="off")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def flips_limit(n_pixels: int) -> int:
    """Median depth is discontinuous in alpha (the T = 0.5 crossing): a
    few pixels may flip between a depth and the 15.0 default."""
    return max(5, int(2e-4 * n_pixels))


def depth_flips(a, b) -> int:
    return int(((a - b).abs() > 1e-2).sum())


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def capture(module, name: str):
    """Wrap ``module.name`` so the next call records its arguments."""
    seen = {}

    def make(orig):
        def wrapper(*args, **kwargs):
            seen.setdefault("args", args)
            return orig(*args, **kwargs)
        return wrapper

    return seen, patch(module, name, make)


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def composite_both(pairs, starts, ends, n_tx, n_ty, chunk_inst=16,
                   fine: bool = False):
    """K1 (K4 if ``fine``; the grid in 8x128 tiles either way) and its
    plain version on the same inputs; the plain version runs over instance
    chunks to bound its (tiles, 8, tile width) working set."""
    import torch

    from real2sim_eval_tpu_torch.renderer import fine_kernel as fk
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    kernel, plain = ((fk.rasterize_fine_batch, fk.composite_fine_plain)
                     if fine else (tk.rasterize_tiles_batch,
                                   tk.composite_tiles_plain))
    rgb_k, dep_k = kernel(pairs, starts, ends, n_tx, n_ty)
    parts = []
    t_plain = 0.0
    for i in range(0, starts.shape[0], chunk_inst):
        ms, out = time_host(lambda i=i: plain(
            pairs, starts[i:i + chunk_inst], ends[i:i + chunk_inst], n_tx,
            n_ty))
        t_plain += ms
        parts.append(out)
    rgb_p = torch.cat([p[0] for p in parts])
    dep_p = torch.cat([p[1] for p in parts])
    return rgb_k, dep_k, rgb_p, dep_p, t_plain


def pixel_pair_walks(pairs, starts, ends, tiles, n_tx: int,
                     tile_w: int = 128, boxes=()) -> dict:
    """What a compositor's walk over this input holds, whatever order a
    kernel does it in. Tile ``tiles[g]`` of a grid n_tx tiles of 8 x tile_w
    pixels wide (8x128, or the 8x16 fine tiles) walks
    pairs[starts[g]:ends[g]] (flat lists); same tests as
    ``tile_kernel._blend_tiles_plain``. Returns a dict of sums over pixels:

    - ``walks``: the pairs each pixel blends before it is done, the pair
      that finishes it included;
    - ``reaching``: of those, the pairs that pass power <= 0 and the alpha
      floor, the evaluations an exact cull cannot skip (the bound's count);
    - ``contributions``: the pairs that contribute (the backward's terms);

    and with ``boxes`` ((rows, columns) of warp boxes that tile the tile)
    a compositor's evaluations without and with a per-box cull, each until
    done at pair granularity (the kernels stop at batch boundaries):
    ``tile_evals``, 8 * tile_w per pair until the tile's last pixel is
    done (a walk without the cull: the fine kernels' first form), and
    ``box_evals`` {"RxC": rows * columns per pair that
    ``tile_kernel.block_cull_keep`` keeps for a box until the box's last
    pixel is done, summed over the boxes (each warp's walk)}; K1's 8x16
    blocks are "8x16" of an 8x128 tile."""
    import torch

    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    dev = pairs.device
    chunk = 16 * 420 * 128 // tile_w          # tiles of 860,160 pixels
    out = {k: torch.zeros((), dtype=torch.int64, device=dev)
           for k in ("walks", "reaching", "contributions", "tile_evals")}
    box_evals = {f"{bh}x{bw}": torch.zeros((), dtype=torch.int64, device=dev)
                 for bh, bw in boxes}
    for i in range(0, starts.shape[0], chunk):
        s = starts[i:i + chunk].long()
        e = ends[i:i + chunk].long()
        t = tiles[i:i + chunk].long()
        px, py = tk._tile_pixels(t, n_tx, tile_w)
        T = torch.ones((s.shape[0], tk.TILE_H, tile_w), device=dev)
        done = torch.zeros_like(T, dtype=torch.bool)
        # per box shape: its origins (g, boxes down, boxes across)
        origins = {}
        for bh, bw in boxes:
            bx0 = ((t % n_tx) * tile_w)[:, None, None].float() + torch.arange(
                0, tile_w, bw, device=dev).float()[None, None, :]
            by0 = ((t // n_tx) * tk.TILE_H)[:, None, None].float() + \
                torch.arange(0, tk.TILE_H, bh, device=dev).float()[None, :,
                                                                    None]
            origins[(bh, bw)] = torch.broadcast_tensors(bx0, by0)
        for j in range(int((e - s).max()) if s.numel() else 0):
            in_range = (s + j < e)[:, None, None]
            live = in_range & ~done
            out["walks"] += live.sum()
            if j % 32 == 31 and not bool(live.any()):
                break
            a = pairs[:, torch.where(s + j < e, s + j, 0)][:, :, None, None]
            if boxes:
                out["tile_evals"] += (live.flatten(1).any(1).sum()
                                      * tk.TILE_H * tile_w)
            for (bh, bw), (bx0, by0) in origins.items():
                blive = live.reshape(-1, tk.TILE_H // bh, bh, tile_w // bw,
                                     bw).any(dim=4).any(dim=2)
                keep = tk.block_cull_keep(a, bx0, by0, bw, bh)
                box_evals[f"{bh}x{bw}"] += (blive & keep).sum() * bh * bw
            dx, dy = a[0] - px, a[1] - py
            power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
            alpha = torch.clamp(a[5] * torch.exp(power), max=tk.ALPHA_MAX)
            ok = in_range & (power <= 0.0) & (alpha >= tk.ALPHA_MIN)
            out["reaching"] += (ok & ~done).sum()
            test_T = T * (1.0 - alpha)
            finish = ok & (test_T < tk.T_EPS)
            contrib = ok & ~finish & ~done
            out["contributions"] += contrib.sum()
            T = torch.where(contrib, test_T, T)
            done = done | finish
    res = {k: int(v) for k, v in out.items()}
    if boxes:
        res["box_evals"] = {k: int(v) for k, v in box_evals.items()}
    else:
        del res["tile_evals"]
    return res


def bound_ms(n_bytes: float, reaching: int) -> tuple[float, str]:
    """Least time of a compositor: bytes over the HBM rate or the f32
    operations of its reaching (pixel, pair) blends over the f32 rate,
    whichever is larger. An exact cull computes the same function without
    evaluating the pairs that do not reach a pixel, so only the reaching
    evaluations are the compositor's necessary work."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = float(reaching) * K1_OPS_PER_EVAL / PEAK_F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound_ms(pairs, starts, rgb, reaching: int) -> tuple[float, str]:
    return bound_ms(pairs.numel() * 4 + 2 * starts.numel() * 4
                    + rgb.numel() * 4 * 4 // 3, reaching)


def sparse_bound_ms(rows_read: int, n_tables: int, n_dirty: int,
                    reaching: int, tile_w: int = 128) -> tuple[float, str]:
    """K2/K6/K5: the pair rows read (10 f32 each), the dirty-list tables
    (i32) and the dirty tiles written (rgb + depth, 8 x tile_w f32
    each)."""
    return bound_ms(rows_read * 40 + n_tables * n_dirty * 4
                    + n_dirty * 8 * tile_w * 4 * 4, reaching)


def k3_bound_ms(opts, tab, state) -> tuple[float, str]:
    B, N, _ = state.x.shape
    S = opts.num_substeps
    active_slots = int((tab.nbr_k != 0).sum())           # shared table
    per_step = B * (active_slots * K3_OPS["spring_slot"]
                    + N * K3_OPS["particle"])
    if tab.sc_ok is not None:
        per_step += int(tab.sc_ok.sum()) * K3_OPS["self_slot"]
    n_bytes = state.x.numel() * 4 * 4 + tab.nbr_k.numel() * 16
    if tab.cand_ok is not None:
        C = tab.pose.shape[2]
        per_step += int(tab.cand_ok.sum()) * (K3_OPS["contact_base"]
                                              + C * K3_OPS["contact_query"])
        n_bytes += tab.pose.numel() * 4 + tab.combo["corners"].numel() * 4
    t_ops = per_step * S / PEAK_F32_OPS_S
    t_bytes = n_bytes / PEAK_BYTES_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def small_flagship_bins(fine: bool = False):
    """One 848x480 instance of a 20k-gaussian scene (flagship layout, cut
    to 20,000 gaussians) through preprocess and binning, wide or ``fine``:
    (bins, n_tx, n_ty, gaussians), the grid in 8x128 tiles."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer.binning import (bin_gaussians,
                                                          bin_gaussians_fine)
    from real2sim_eval_tpu_torch.renderer.preprocess import \
        preprocess_gaussians
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    a = make_flagship_assets(batch=1, n_table=15000, n_obj_dense=3880,
                             device=DEVICE)
    ev = BatchedEvaluator(a, [0], device=DEVICE, raster_config=render_off())
    scenes, _ = ev.compose(ev.state, dc_only=True)
    cam, w2c = ev._fixed_cams[0]
    pre = preprocess_gaussians(cam, torch.as_tensor(w2c, device=DEVICE)[None],
                               scenes["means3D"], scenes["scales"],
                               scenes["rotations"], scenes["opacities"],
                               scenes["shs"], 0)
    n_tx, n_ty = -(-cam.width // 128), -(-cam.height // 8)
    bins = (bin_gaussians_fine(pre, n_tx, n_ty) if fine
            else bin_gaussians(pre, n_tx, n_ty, 128, 8))
    return bins, n_tx, n_ty, int(scenes["means3D"].shape[1])


def check_k1_small():
    """K1 vs its plain version on small_flagship_bins' scene: bitwise (its
    block cull may skip only what changes no pixel), with its evaluations
    before and after the cull."""
    import torch

    bins, n_tx, n_ty, n = small_flagship_bins()
    pairs, starts, ends = (bins["pair_attrs"], bins["tile_starts"],
                           bins["tile_ends"])
    rgb_k, dep_k, rgb_p, dep_p, _ = composite_both(pairs, starts, ends, n_tx,
                                                   n_ty)
    w = pixel_pair_walks(pairs, starts.reshape(-1), ends.reshape(-1),
                         torch.arange(starts.numel(), device=DEVICE)
                         % starts.shape[1], n_tx, boxes=WIDE_BOX)
    out = {"phase": "k1_check", "gaussians": n,
           "pairs": int(pairs.shape[1]),
           "max_abs_rgb": float((rgb_k - rgb_p).abs().max()),
           "differing_depth_pixels": int((dep_k != dep_p).sum()),
           "evaluations": {"tile_level": w["tile_evals"],
                           "block_level": w["box_evals"]["8x16"]},
           "pixel_pair_blends": w["walks"], "reaching_blends": w["reaching"]}
    emit(out)
    if out["max_abs_rgb"] or out["differing_depth_pixels"]:
        fail(f"K1 is not bitwise its plain version: {out}")


def check_k7_small():
    """K7 on small_flagship_bins' scene: its rgb and depth bitwise K1's
    (one kernel body), its transmittance within T_TOL of the plain
    version's, and T = d(rgb)/d(bg): the red plane at bg 1 minus the one
    at bg 0."""
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    bins, n_tx, n_ty, n = small_flagship_bins()
    args = (bins["pair_attrs"], bins["tile_starts"], bins["tile_ends"],
            n_tx, n_ty)
    bg = (0.1, 0.2, 0.3)
    rgb7, dep7, t7 = tk.rasterize_tiles_batch_t(*args, bg)
    rgb1, dep1 = tk.rasterize_tiles_batch(*args, bg)
    rgb_p, _, t_p = tk.composite_tiles_plain(*args, bg, with_t=True)
    rgb_w, _, _ = tk.rasterize_tiles_batch_t(*args, (1.0, 0.2, 0.3))
    out = {"phase": "k7_check", "gaussians": n,
           "pairs": int(bins["pair_attrs"].shape[1]),
           "differing_pixels_vs_k1": int(((rgb7 != rgb1).any(dim=1)
                                          | (dep7 != dep1)).sum()),
           "max_abs_t_vs_plain": float((t7 - t_p).abs().max()),
           "max_abs_rgb_vs_plain": float((rgb7 - rgb_p).abs().max()),
           "max_abs_t_vs_bg_difference": float(
               (rgb_w[:, 0] - rgb7[:, 0] - 0.9 * t7).abs().max()),
           "t_min": float(t7.min()), "t_tol": T_TOL}
    emit(out)
    if (out["differing_pixels_vs_k1"] or out["max_abs_t_vs_plain"] > T_TOL
            or out["max_abs_rgb_vs_plain"] > RGB_TOL
            or out["max_abs_t_vs_bg_difference"] > 1e-5):
        fail(f"K7 disagrees with K1 or its plain version: {out}")


def grad_ratio(a, b) -> float:
    """Largest |a - b| / (atol + GRAD_RTOL |b|), atol = GRAD_ATOL_REL *
    max(|b|, 1): at most 1 where the JAX suite's gradient test passes."""
    atol = GRAD_ATOL_REL * max(float(b.abs().max()), 1.0)
    return float(((a - b).abs() / (atol + GRAD_RTOL * b.abs())).max())


def lane_gap(table, ref) -> float:
    """Largest |table - ref| of a (10, P) per-pair table, relative to the
    largest |ref| of its lane; the worst lane."""
    lane_max = ref.abs().amax(dim=1).clamp(min=1e-30)
    return float(((table - ref).abs().amax(dim=1) / lane_max).max())


def table_ratio(table, ref) -> float:
    """grad_ratio lane by lane of a (10, P) per-pair table, the worst."""
    return max(grad_ratio(table[i], ref[i]) for i in range(table.shape[0]))


def k8_scene(n: int = 300, n_big: int = 40):
    """check_reference's random scene plus ``n_big`` large splats of
    opacity exactly 1, so the 0.99 clamp is active near their centres and
    some pixels saturate; degree-3 SH. Tensors on the card."""
    import torch

    rng = np.random.default_rng(1)
    m = n + n_big
    q = rng.normal(size=(m, 4))
    arrays = (
        np.stack([rng.uniform(-1, 1, m), rng.uniform(-0.4, 0.4, m),
                  rng.uniform(0.5, 3.0, m)], -1),
        np.concatenate([rng.uniform(0.01, 0.08, (n, 3)),
                        rng.uniform(0.08, 0.15, (n_big, 3))]),
        q / np.linalg.norm(q, axis=-1, keepdims=True),
        np.concatenate([rng.uniform(0.1, 1.0, n), np.ones(n_big)]),
        rng.normal(size=(m, 16, 3)) * 0.3)
    return [torch.as_tensor(v, dtype=torch.float32, device=DEVICE)
            for v in arrays]


def check_k8_small():
    """The differentiable render on the card, on k8_scene from two views
    at 256x64 with bg (0.3, 0.5, 0.2):

    - K8's per-pair table against its plain version (K8_PLAIN_TOL of each
      lane's largest gradient) and both against autograd's gradient of
      the plain compositor with respect to the pair table (the gradient
      gate: GRAD_RTOL, atol GRAD_ATOL_REL of the largest);
    - four broken backwards, each the plain version with one edit, must
      fail that gate: zero gradients, the bg * T_fin term dropped, the
      clamp gate removed, the depth-crossing term dropped;
    - ``rasterize_diff_views`` gradients in means, scales, quats,
      opacities and SH against autograd through the same pipeline with
      the plain compositor in place of K7/K8 (the gradient gate);
    - a central finite difference of three opacities (rtol 5e-2) on
      tests/test_diff.py's sparse scene."""
    import torch

    from real2sim_eval_tpu_torch.renderer import (Camera, diff,
                                                  rasterize_diff,
                                                  rasterize_diff_views)
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
    from real2sim_eval_tpu_torch.renderer.binning import bin_gaussians
    from real2sim_eval_tpu_torch.renderer.preprocess import \
        preprocess_gaussians

    scene = k8_scene()
    cam = Camera(width=256, height=64, fx=80.0, fy=80.0, cx=128.0, cy=32.0)
    w2cs = torch.eye(4, device=DEVICE).repeat(2, 1, 1)
    w2cs[1, 0, 3] = 0.1
    bg = (0.3, 0.5, 0.2)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    wr = torch.randn((2, 3, 64, 256), generator=gen, device=DEVICE)
    wd = torch.randn((2, 64, 256), generator=gen, device=DEVICE)

    with torch.no_grad():
        pre = preprocess_gaussians(cam, w2cs, *[
            s[None].expand((2,) + s.shape) for s in scene], 3)
        bins = bin_gaussians(pre, 2, 8, 128, 8)
    pairs, starts, ends = (bins["pair_attrs"], bins["tile_starts"],
                           bins["tile_ends"])
    rgb, _, t_fin = tk.rasterize_tiles_batch_t(pairs, starts, ends, 2, 8, bg)
    c_fin = rgb - t_fin[:, None] * torch.tensor(
        bg, device=DEVICE)[None, :, None, None]
    args = (pairs, starts, ends, wr, wd, c_fin, t_fin)
    table_k = tk.composite_backward(*args, bg)
    table_p = tk.composite_backward_plain(*args, bg)
    leaf = pairs.clone().requires_grad_(True)
    rgb_p, dep_p = tk.composite_tiles_plain(leaf, starts, ends, 2, 8, bg)
    table_ref, = torch.autograd.grad(
        (rgb_p * wr).sum() + (dep_p * wd).sum(), leaf)
    undo = patch(tk, "_alpha_grad_gate",
                 lambda orig: lambda araw: torch.ones_like(araw,
                                                           dtype=torch.bool))
    try:
        no_gate = tk.composite_backward_plain(*args, bg)
    finally:
        undo()
    mutants = {
        "zero_gradients": torch.zeros_like(table_p),
        "no_bg_t_fin": tk.composite_backward_plain(*args, (0.0, 0.0, 0.0)),
        "no_clamp_gate": no_gate,
        "no_depth_crossing": tk.composite_backward_plain(
            pairs, starts, ends, wr, torch.zeros_like(wd), c_fin, t_fin, bg)}
    plain_gap = lane_gap(table_k, table_p)

    class PlainComposite:
        """The plain compositor in K7/K8's place: autograd differentiates
        it."""

        @staticmethod
        def apply(p, s, e, n_tx, n_ty, bg_):
            return tk.composite_tiles_plain(p, s, e, n_tx, n_ty, bg_)

    def scene_grads(plain: bool):
        ts = [s.clone().requires_grad_(True) for s in scene]
        undo = patch(diff, "_CompositeDiff",
                     lambda orig: PlainComposite) if plain else None
        try:
            rgb_d, dep_d = rasterize_diff_views(cam, w2cs, *ts, 3, bg=bg,
                                                device=DEVICE)
        finally:
            if undo:
                undo()
        ((rgb_d * wr).sum() + 0.1 * (dep_d * wd).sum()).backward()
        return [t.grad for t in ts]

    names = ("means3d", "scales", "quats", "opacities", "shs")
    g_k, g_p = scene_grads(False), scene_grads(True)
    scene_ratio = {nm: grad_ratio(a, b) for nm, a, b in zip(names, g_k, g_p)}

    # central differences of opacity on tests/test_diff.py's sparse scene
    # (20 splats, 256x16): a dense one crosses the alpha >= 1/255 and
    # freeze thresholds within the step, which a derivative does not see
    rng = np.random.default_rng(2)
    fd_scene = [torch.as_tensor(v, dtype=torch.float32, device=DEVICE) for v
                in (np.stack([rng.uniform(-1.2, 1.2, 20),
                              rng.uniform(-1.2, 1.2, 20),
                              rng.uniform(1.0, 3.0, 20)], -1),
                    rng.uniform(0.02, 0.10, (20, 3)), np.tile([1.0, 0, 0, 0],
                                                              (20, 1)),
                    rng.uniform(0.2, 0.9, 20), rng.normal(size=(20, 1, 3)))]
    fd_cam = Camera(width=256, height=16, fx=40.0, fy=40.0, cx=128.0, cy=8.0)
    fd_w = torch.as_tensor(rng.normal(size=(3, 16, 256)), dtype=torch.float64,
                           device=DEVICE)

    def loss(o):
        rgb_v, _ = rasterize_diff(fd_cam, torch.eye(4, device=DEVICE),
                                  fd_scene[0], fd_scene[1], fd_scene[2], o,
                                  fd_scene[4], 0, device=DEVICE)
        return (rgb_v.double() * fd_w).sum()

    opac = fd_scene[3]
    o = opac.clone().requires_grad_(True)
    loss(o).backward()
    picks = (0, 7, 13)
    fd = []
    eps = 1e-3
    with torch.no_grad():
        for i in picks:
            d = torch.zeros_like(opac)
            d[i] = eps
            fd.append([float(o.grad[i]),
                       float((loss(opac + d) - loss(opac - d)) / (2 * eps))])
    fd_ok = all(abs(g - f) <= 1e-3 + 5e-2 * abs(f) for g, f in fd)

    out = {"phase": "k8_check", "gaussians": len(scene[0]), "views": 2,
           "pairs": int(pairs.shape[1]),
           "pairs_with_gradient": int((table_k.abs().sum(0) > 0).sum()),
           "k8_vs_plain_max_rel": plain_gap, "k8_plain_tol": K8_PLAIN_TOL,
           "k8_vs_autograd_ratio": table_ratio(table_k, table_ref),
           "plain_vs_autograd_ratio": table_ratio(table_p, table_ref),
           "mutant_ratios": {k: table_ratio(v, table_ref)
                             for k, v in mutants.items()},
           "scene_grad_ratios": scene_ratio,
           "grad_rtol": GRAD_RTOL, "grad_atol_rel": GRAD_ATOL_REL,
           "fd_opacity": {"index": picks, "grad_vs_fd": fd, "ok": fd_ok},
           "t_min": float(t_fin.min())}
    emit(out)
    bad = [k for k in ("k8_vs_autograd_ratio", "plain_vs_autograd_ratio")
           if out[k] > 1.0]
    bad += [k for k, v in scene_ratio.items() if v > 1.0]
    if plain_gap > K8_PLAIN_TOL or bad or not fd_ok:
        fail(f"K8 gradients disagree: {bad} {out}")
    passing = [k for k, v in out["mutant_ratios"].items() if v <= 1.0]
    if passing:
        fail(f"broken backwards pass the gradient gate: {passing}")


def k3_mutants(opts, tab, state, plain) -> dict:
    """Max |x| from the plain version of the broken kernels: one that
    returns its input, one without springs and dashpots, one without the
    self-collision phase, and under ``use_pusher`` one that ignores it
    (the fingers' 5 mm margin on the tool), each computed as the plain
    version would be."""
    import torch

    from real2sim_eval_tpu_torch.physics import spring_mass as sm

    def gap(s):
        return float((s.x - plain.x).abs().max())

    zero = torch.zeros_like(tab.nbr_k)
    out = {"no_op": gap(state),
           "no_springs": gap(sm.run_substeps_plain(opts, dataclasses.replace(
               tab, nbr_k=zero, nbr_c=zero), state))}
    if tab.sc_sel is not None:
        out["no_self_collision"] = gap(sm.run_substeps_plain(
            opts, dataclasses.replace(tab, sc_sel=None, sc_idx=None,
                                      sc_ok=None, sc_invm=None,
                                      sc_msel=None), state))
    if opts.use_pusher:
        out["no_pusher"] = gap(sm.run_substeps_plain(
            dataclasses.replace(opts, use_pusher=False), tab, state))
    return out


def k3_rounding_gap(opts, tab, state, plain) -> dict:
    """Max |x| and |v| between the plain version in f32 and in f64 on the
    same inputs: how far rounding alone moves this case (a contact-heavy
    step is chaotic, and a kernel may be as far from the plain version)."""
    p64 = plain_f64(opts, tab, state)
    return {"x": float((plain.x - p64.x).abs().max()),
            "v": float((plain.v - p64.v).abs().max())}


def plain_f64(opts, tab, state):
    """K3's plain version in float64 on the same inputs."""
    import torch

    from real2sim_eval_tpu_torch.physics import spring_mass as sm

    def f64(t):
        if isinstance(t, dict):
            return {k: f64(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
            return t.double()
        return t

    tab64 = dataclasses.replace(tab, **{
        f.name: f64(getattr(tab, f.name)) for f in dataclasses.fields(tab)})
    st64 = dataclasses.replace(state, x=f64(state.x), v=f64(state.v),
                               finger_forces=f64(state.finger_forces))
    return sm.run_substeps_plain(opts, tab64, st64)


def same_step(a, b) -> bool:
    """Two K3 results bitwise equal (x, v and finger forces)."""
    return all(torch_equal(getattr(a, k), getattr(b, k))
               for k in ("x", "v", "finger_forces"))


def check_k3(case: str, opts, tab, state, **extra) -> dict:
    """K3 against its plain version on one control step: the gaps, the
    work the case exercises, and the gaps of the broken kernels the gates
    must reject. Fails on a gap over its gate or a mutant under it. Both
    launches of the kernel run (one CTA per env, the two-CTA cluster):
    the main path's (``fused_step.K3_RANKS``) is gated, and whether the
    other gives bitwise the same step is reported; the cluster may be the
    main path only while it does (else this fails)."""
    import torch

    from real2sim_eval_tpu_torch.physics import fused_step
    from real2sim_eval_tpu_torch.physics import spring_mass as sm

    stages = {r: fused_step.spring_mass_step(opts, tab, state, ranks=r)
              for r in (1, 2)}
    kern = stages[fused_step.K3_RANKS]
    cluster_same = same_step(stages[1], stages[2])
    plain = sm.run_substeps_plain(opts, tab, state)
    gates = K3_GATES[case]
    gaps = {"x": float((kern.x - plain.x).abs().max()),
            "v": float((kern.v - plain.v).abs().max()),
            "com": float((kern.x.mean(1) - plain.x.mean(1)).norm(dim=-1)
                         .max())}
    mutants = k3_mutants(opts, tab, state, plain)
    ff_k = kern.finger_forces.norm(dim=-1)
    ff_p = plain.finger_forces.norm(dim=-1)
    out = {"phase": "k3_check", "case": case, "envs": int(state.x.shape[0]),
           "particles": int(state.x.shape[1]),
           "substeps": opts.num_substeps,
           "active_spring_slots": int((tab.nbr_k != 0).sum()),
           "self_slots_valid": (int(tab.sc_ok.sum())
                                if tab.sc_ok is not None else 0),
           "contact_candidates_in_reach": (int(tab.cand_ok.sum())
                                           if tab.cand_ok is not None else 0),
           "max_abs": gaps, "gates": gates,
           "plain_f32_vs_f64": k3_rounding_gap(opts, tab, state, plain),
           "mutant_max_abs_x": mutants,
           "finger_force_envs": [int((ff_k > 0).any(-1).sum()),
                                 int((ff_p > 0).any(-1).sum())],
           "telemetry": tab.telemetry.sum(0).tolist(),
           "finite": bool(torch.isfinite(kern.x).all()
                          and torch.isfinite(kern.v).all()),
           "min_z": float(kern.x[..., 2].min()),
           "main_path_ranks": fused_step.K3_RANKS,
           "cluster_bitwise_one_cta": cluster_same,
           "cluster_max_abs_x": float(
               (stages[2].x - stages[1].x).abs().max()), **extra}
    emit(out)
    over = [k for k in gates if gaps[k] > gates[k]]
    missed = [m for m in K3_MUST_CATCH[case] if mutants[m] <= gates["x"]]
    if over or missed or not out["finite"] or out["min_z"] < -0.01:
        fail(f"K3 {case}: gaps over their gates {over}, broken kernels "
             f"passing {missed}: {out}")
    if fused_step.K3_RANKS == 2 and not cluster_same:
        fail(f"K3 {case}: the cluster launch is not bitwise one CTA per env")
    return out


def k3_sloth_case(B: int = 8, seed: int = 2**31 + 22):
    """The sloth cell's K3 problem at its full size: the benchmark's
    ``sloth`` scene written from ``seed`` (a blocky plush of ~3,400
    particles, springs within 0.02 m, at most 30; an open 18 x 24 x 9 cm
    container on its per-episode pose), built for B lanes; each lane's
    plush moved into its own container, 1 mm above the floor and 2 mm
    clear of a long wall, falling at 0.2 m/s, the gripper held open above
    it. Self-collision (256 rows) and contact (512 slots) run at the full
    caps. Returns (opts, tables, state, extra)."""
    import torch

    from gpu_bench.harness import cell as cell_mod
    from gpu_bench.harness import main as bench_main
    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics import fused_step
    from real2sim_eval_tpu_torch.physics import spring_mass as sm

    cell = cell_mod.find("sloth.pack64")
    with tempfile.TemporaryDirectory() as root:
        bench_main.write_scene(cell, seed, Path(root))
        cfg = load_config(Path(root) / "cfg", "run")
        ev = BatchedEvaluator(cfg, list(range(0, 5 * B, 5)), device=DEVICE,
                              raster_config=render_off())
    st = ev.state
    box = cell.spec["box"]
    x = st.sm.x
    lo, hi = x.amin(1), x.amax(1)
    pose = st.static_pose[:, 0]                   # (B, 4, 4) model frame
    # each lane's plush against its container's +x wall, on its floor
    inner_x = box["size"][0] / 2 - box["wall"]
    target = pose[:, :3, 3] + (pose[:, :3, :3] @ torch.tensor(
        [inner_x - 0.002, 0.0, box["wall"] + 0.001], device=DEVICE)[:, None]
        )[..., 0]
    shift = target - torch.stack([hi[:, 0], (lo[:, 1] + hi[:, 1]) / 2,
                                  lo[:, 2]], -1)
    moved = x + shift[:, None]
    vel = torch.zeros_like(moved)
    vel[..., 2] = -0.2
    st = st.replace(sm=dataclasses.replace(st.sm, x=moved, v=vel))
    rot = torch.tensor(np.diag([1.0, -1.0, -1.0]).reshape(-1),
                       dtype=torch.float32, device=DEVICE)
    act = torch.cat([st.grippers[:, :3], rot.expand(B, 9),
                     torch.zeros((B, 1), device=DEVICE)], dim=1)
    ctrl, _, _, colliders = ev._env_pre(st, act)
    a = ev.assets
    tab = sm.freeze(a.params, a.opts, colliders, st.sm, ctrl, st.rest_x)
    N = int(moved.shape[1])
    M, PM = int(tab.sc_sel.shape[1]), int(tab.cand.shape[1])
    shared = 4 * (15 * N + 3 * M + 4 * PM)
    return a.opts, tab, st.sm, {
        "springs": int(a.params.springs.shape[0]),
        "spring_records": int((tab.nbr_k != 0).sum()),
        "self_rows": M, "contact_slots": PM,
        "shared_bytes": shared,
        "shared_share_of_ceiling": shared / fused_step.MAX_SHARED_BYTES,
        "mesh_groups": ev.n_mesh_groups}


def check_k3_sloth():
    """K3 at the sloth cell's tables against its plain version."""
    opts, tab, state, extra = k3_sloth_case()
    out = check_k3("sloth", opts, tab, state, **extra)
    if out["contact_candidates_in_reach"] == 0:
        fail(f"K3 sloth: no particle within reach of the container: {out}")


def sloth_witness(steps: int = 120, total: int = 300,
                  seed: int = 2**31 + 23):
    """Whether the sloth cell's positions can be held, and how far its
    traffic packs the plush: the benchmark's sloth scene and ``pack``
    policy over 64 lanes, 30 hold steps and ``total`` policy steps (one
    cycle). After ``steps`` of them the next control step's K3 inputs are
    captured and run by K3, by its plain version in f32 and in f64: per
    lane, the mean particle distance (m) between each pair. Where K3 and
    plain f32 lie alike far from f64, a gap between them is the problem's
    rounding (rope's case, PERF.md §2), not K3. Every step each lane's
    particles inside its box's OBB scaled by 1.05 are counted (upstream's
    success rule, ``success.is_sloth_success``): the lanes that reach
    3,050, and the largest count of each lane."""
    import torch

    from gpu_bench.harness import cell as cell_mod
    from gpu_bench.harness import main as bench_main
    from gpu_bench.harness import policy as bench_policy
    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.experiments.eval_policy_batched import (
        actions_from_policy, hold_actions)
    from real2sim_eval_tpu_torch.experiments.utils import success
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics import fused_step
    from real2sim_eval_tpu_torch.physics import spring_mass as sm

    cell = cell_mod.find("sloth.pack64")
    ids = list(range(int(cell.traffic["lanes"])))
    with tempfile.TemporaryDirectory() as root:
        scene = bench_main.write_scene(cell, seed, Path(root))
        ev = BatchedEvaluator(load_config(Path(root) / "cfg", "run"), ids,
                              device=DEVICE)
    pol = bench_policy.make(cell.traffic, scene["cfg"], cell.spec,
                            scene["particles"], ids, seed)
    hold = torch.as_tensor(hold_actions(ev.state.grippers.cpu().numpy()),
                           dtype=torch.float32, device=DEVICE)
    for _ in range(30):
        ev.step(hold, do_velocity_control=False)
    obbs = [success.minimal_obb(np.asarray(d["physics"]["static_meshes"][0]
                                           ["vertices"]))
            for d in ev.get_state_dumps()]
    best = np.zeros(len(ids), np.int64)

    def act():
        return torch.as_tensor(actions_from_policy(pol.inference(None),
                                                   False),
                               dtype=torch.float32, device=DEVICE)

    def tally():
        for i, x in enumerate(ev.particle_states()):
            best[i] = max(best[i], success.points_in_obb(
                x, *obbs[i], scale=success.SLOTH_OBB_SCALE))

    out = None
    for k in range(total):
        if k != steps:
            ev.step(act())
            tally()
            continue
        seen, undo = capture(fused_step, "spring_mass_step")
        try:
            ev.step(act())
        finally:
            undo()
        tally()
        opts, tab, state = seen["args"][:3]
        kern = fused_step.spring_mass_step(opts, tab, state)
        plain = sm.run_substeps_plain(opts, tab, state)
        p64 = plain_f64(opts, tab, state)

        def lane_mean(a, b):
            return (a.double() - b.double()).norm(dim=-1).mean(1)

        k_64, p_64, k_p = (lane_mean(kern.x, p64.x),
                           lane_mean(plain.x, p64.x),
                           lane_mean(kern.x, plain.x))
        worst = torch.argsort(k_p, descending=True)[:6].tolist()
        out = {"phase": "sloth_witness", "steps": steps, "seed": seed,
               "x_mean_gap_k3_plain_max": float(k_p.max()),
               "x_mean_gap_k3_f64_max": float(k_64.max()),
               "x_mean_gap_plain_f64_max": float(p_64.max()),
               "x_gap_k3_plain_max": float((kern.x - plain.x).abs().max()),
               "worst_lanes": [{"lane": i, "k3_plain": float(k_p[i]),
                                "k3_f64": float(k_64[i]),
                                "plain_f64": float(p_64[i]),
                                "telemetry": tab.telemetry[i].tolist(),
                                "grasped": bool(ev.state.grasp.grasped[i])}
                               for i in worst]}
        del kern, plain, p64
    out.update({"policy_steps": total,
                "particles": int(ev.state.sm.x.shape[1]),
                "lanes_in_box": int((best >= success.SLOTH_POINTS_REQUIRED
                                     ).sum()),
                "in_box_max_per_lane": best.tolist()})
    emit(out)
    return out


def check_k3_grasp():
    """8 flagship ropes, each gripped mid-rope: the fingers straddle the
    rope, half closed (openness 0.4) and pressing into it, while the eef
    moves down 2 mm (k3_grasp_case). The finger-contact branch (relative
    surface velocity, the second finger query, finger forces) runs on
    every substep; both versions must see finger contact on the last
    substep in every env."""
    opts, tab, state = k3_grasp_case()
    out = check_k3("grasp", opts, tab, state)
    B = int(state.x.shape[0])
    if out["finger_force_envs"] != [B, B]:
        fail(f"K3 grasp: finger contact missing in some env: {out}")


def k3_loop_case(substeps: int, B: int = 8):
    """8 flagship ropes wound into a loop in the air, 2 % over their rest
    length, whose two ends overlap 3 cm apart by 3 mm and close on each
    other at 0.3 m/s: every spring is stretched and the self-collision
    slots of the overlap are live, with no ground or collider contact.
    Returns (opts, tables, state, spring strain stats) for a control step
    of ``substeps`` substeps."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics import spring_mass as sm
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    a = make_flagship_assets(batch=B, n_table=1000, n_obj_dense=0,
                             device=DEVICE)
    opts = dataclasses.replace(a.opts, num_substeps=substeps)
    ev = BatchedEvaluator(dataclasses.replace(a, opts=opts), list(range(B)),
                          device=DEVICE, raster_config=render_off())
    # the rest rope in its own frame: arclength u along it, offsets y, z
    rest = a.params.rest_x.double()
    ax = rest[-1] - rest[0]
    ax = ax / ax.norm()
    up = torch.tensor([0.0, 0.0, 1.0], dtype=rest.dtype, device=DEVICE)
    side = torch.linalg.cross(up, ax)
    side = side / side.norm()
    d = rest - rest[0]
    u, y, z = d @ ax, d @ side, d @ up
    length = float(u.max() - u.min())
    stretch, overlap, pitch = 1.02, 0.03, 0.003
    radius = (stretch * length - overlap) / (2 * np.pi)
    theta = stretch * (u - u.min()) / radius
    loop = torch.stack([0.25 + (radius + y) * torch.cos(theta),
                        (radius + y) * torch.sin(theta),
                        0.08 + pitch * theta / (2 * np.pi) + z], -1)
    vz = 0.3 * (0.5 - (u - u.min()) / length)
    vel = torch.stack([torch.zeros_like(vz), torch.zeros_like(vz), vz], -1)
    st = ev.state.replace(sm=dataclasses.replace(
        ev.state.sm, x=loop.float().expand(B, -1, -1).contiguous(),
        v=vel.float().expand(B, -1, -1).contiguous()))
    rot = torch.tensor(np.diag([1.0, -1.0, -1.0]).reshape(-1),
                       dtype=torch.float32, device=DEVICE)
    act = torch.cat([st.grippers[:, :3], rot.expand(B, 9),
                     torch.ones((B, 1), device=DEVICE)], dim=1)
    ctrl, _, _, colliders = ev._env_pre(st, act)
    tab = sm.freeze(a.params, opts, colliders, st.sm, ctrl, st.rest_x)
    cur = (st.sm.x[0][a.params.nbr_idx.long()] - st.sm.x[0][:, None]).norm(
        dim=-1)
    strain = (cur / a.params.nbr_rest - 1.0)[tab.nbr_k != 0]
    return opts, tab, st.sm, {
        "spring_strain_mean": float(strain.mean()),
        "spring_strain_max_abs": float(strain.abs().max())}


def check_k3_loop():
    opts, tab, state, extra = k3_loop_case(K3_LOOP_SUBSTEPS)
    check_k3("loop", opts, tab, state, **extra)


def k3_grasp_case(B: int = 8, openness: float = 0.4):
    """The grasp check's control step: (opts, tables, state)."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics import spring_mass as sm
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    a = make_flagship_assets(batch=B, n_table=1000, n_obj_dense=0,
                             device=DEVICE)
    ev = BatchedEvaluator(a, list(range(B)), device=DEVICE,
                          raster_config=render_off())
    g = ev.state.grippers.clone()
    # the finger pads reach 0.14 m below the eef: put their lower end 1 cm
    # under a particle 3/8 along the rope
    x = ev.state.sm.x
    g[:, :3] = x[:, x.shape[1] * 3 // 8] + torch.tensor([0.0, 0.0, 0.13],
                                                        device=DEVICE)
    g[:, 13] = openness
    grasp = ev.state.grasp
    st = ev.state.replace(grippers=g, grasp=dataclasses.replace(
        grasp,
        current_openness=torch.full_like(grasp.current_openness, openness),
        initialized=torch.ones_like(grasp.initialized)))
    rot = torch.tensor(np.diag([1.0, -1.0, -1.0]).reshape(-1),
                       dtype=torch.float32, device=DEVICE)
    act = torch.cat([g[:, :3] - torch.tensor([0.0, 0.0, 0.002], device=DEVICE),
                     rot.expand(B, 9), torch.full((B, 1), openness,
                                                  device=DEVICE)], dim=1)
    ctrl, _, _, colliders = ev._env_pre(st, act)
    return a.opts, sm.freeze(a.params, a.opts, colliders, st.sm, ctrl,
                             st.rest_x), st.sm


def k3_pusher_case(B: int = 8):
    """8 flagship ropes under a pusher (tests/test_pallas_step.py:234 at
    the flagship's widths): a 0.06 m box tool at 4 mm voxels as the one
    finger collider with ``use_pusher`` (1 mm contact margin), its bottom
    face 1.5 mm above a particle 3/8 along the rope, which starts at rest
    in the air, and descending at 0.2 m/s, so it catches up with the
    falling rope and presses into it during the step. Returns (opts,
    tables, state)."""
    import torch

    from real2sim_eval_tpu_torch.physics import spring_mass as sm
    from real2sim_eval_tpu_torch.physics.sdf import build_sdf_grid
    from real2sim_eval_tpu_torch.testing import make_flagship_assets
    from real2sim_eval_tpu_torch.utils.mesh import make_box

    a = make_flagship_assets(batch=B, n_table=1000, n_obj_dense=0,
                             device=DEVICE)
    opts = dataclasses.replace(a.opts, use_pusher=True, n_fingers=1)
    tool = build_sdf_grid(make_box((0.06, 0.06, 0.06)), voxel_size=0.004,
                          device=DEVICE)
    colliders = sm.MeshColliderSet(
        fingers=(tool,),
        finger_pose_table=torch.eye(4, device=DEVICE).expand(1, 101, 4, 4),
        statics=(), static_pose=torch.zeros((B, 0, 4, 4), device=DEVICE))
    x = a.state.sm.x
    eef = x[:, x.shape[1] * 3 // 8] + torch.tensor([0.0, 0.0, 0.0315],
                                                   device=DEVICE)
    vel = torch.tensor([0.0, 0.0, -0.2], device=DEVICE).expand(B, 3)
    ctrl = sm.SubstepControls(
        eef_xyz=eef, eef_vel=vel,
        eef_rot=torch.eye(3, device=DEVICE).expand(B, 3, 3),
        eef_rot_vel=torch.zeros((B, 3), device=DEVICE),
        openness_start=torch.ones(B, device=DEVICE),
        openness_end=torch.ones(B, device=DEVICE),
        dyn_lin_vel=vel[:, None].contiguous(),
        dyn_omega=torch.zeros((B, 3), device=DEVICE))
    state = dataclasses.replace(a.state.sm, v=torch.zeros_like(x),
                                finger_forces=torch.zeros((B, 1, 3),
                                                          device=DEVICE))
    return opts, sm.freeze(a.params, opts, colliders, state, ctrl,
                           a.state.rest_x), state


def check_k3_pusher():
    """K3 on k3_pusher_case; a kernel that ignored ``use_pusher`` lands
    over the gates (the tool's margin changes the step)."""
    check_k3("pusher", *k3_pusher_case())


def check_k3_drift():
    """The drift test of K3's two-CTA cluster: on the grasp, loop and
    pusher cases (their control steps cut to K3_DRIFT_SUBSTEPS substeps),
    the cluster launch with one CTA of each env delayed against the other
    by varying multiples of each K3_DRIFT_NS at every phase boundary
    (csrc/spring_mass_step.cu ``drift``) against the one-CTA launch,
    bitwise. Each buffer one CTA reads from the other crosses: the x and
    v mirrors (phase A), the v1 mirror (phase B, whose rows touch both
    halves in the loop case), and the contact slots (grasp and pusher);
    the kernel's ms shows that the delays ran. Fails only where the
    cluster is the main path."""
    from real2sim_eval_tpu_torch.physics import fused_step

    S = K3_DRIFT_SUBSTEPS
    cases = {"grasp": k3_grasp_case(), "pusher": k3_pusher_case(),
             "loop": k3_loop_case(K3_LOOP_SUBSTEPS)[:3]}
    res = {}
    for case, (opts, tab, state) in cases.items():
        opts = dataclasses.replace(opts, num_substeps=S)
        if tab.pose is not None:
            tab = dataclasses.replace(tab, pose=tab.pose[:, :S].contiguous())
        one = fused_step.spring_mass_step(opts, tab, state, ranks=1)
        res[case] = {}
        for ns in K3_DRIFT_NS:
            ms = time_cuda(lambda ns=ns: fused_step.spring_mass_step(
                opts, tab, state, ranks=2, drift_ns=ns), 1)
            two = fused_step.spring_mass_step(opts, tab, state, ranks=2,
                                              drift_ns=ns)
            res[case][str(ns)] = {
                "bitwise": same_step(one, two), "ms": ms,
                "max_abs_x": float((two.x - one.x).abs().max()),
                "max_abs_v": float((two.v - one.v).abs().max())}
    ok = all(r["bitwise"] for c in res.values() for r in c.values())
    emit({"phase": "k3_drift", "substeps": S, "drift_ns": list(K3_DRIFT_NS),
          "main_path_ranks": fused_step.K3_RANKS, "all_bitwise": ok,
          "cases": res})
    if fused_step.K3_RANKS == 2 and not ok:
        fail("K3's cluster exchange fails the drift test")


def check_reference():
    """The tile pipeline (K1, and K4 with ``kernel="fine"``) against the
    dense reference compositor gated at the same tiles, on a small random
    scene, on the card."""
    import torch

    from real2sim_eval_tpu_torch.renderer import Camera, RasterConfig, rasterize

    rng = np.random.default_rng(0)
    n = 300
    q = rng.normal(size=(n, 4))
    args = [torch.as_tensor(v, dtype=torch.float32, device=DEVICE) for v in (
        np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.4, 0.4, n),
                  rng.uniform(0.5, 3.0, n)], -1),
        rng.uniform(0.01, 0.08, (n, 3)), q / np.linalg.norm(q, axis=-1,
                                                            keepdims=True),
        rng.uniform(0.1, 1.0, n), rng.uniform(-0.5, 0.5, (n, 1, 3)))]
    cam = Camera(width=256, height=64, fx=80.0, fy=80.0, cx=128.0, cy=32.0)
    eye = torch.eye(4, device=DEVICE)
    for kernel in ("wide", "fine"):
        rgb_k, dep_k = rasterize(cam, eye, *args, 0, device=DEVICE,
                                 config=RasterConfig(kernel=kernel))
        rgb_r, dep_r = rasterize(cam, eye, *args, 0, device=DEVICE,
                                 config=RasterConfig(backend="reference",
                                                     kernel=kernel))
        err = float((rgb_k - rgb_r).abs().max())
        flips = depth_flips(dep_k, dep_r)
        emit({"phase": "reference_check", "kernel": kernel, "gaussians": n,
              "max_abs_rgb": err, "depth_flips": flips})
        if err > RGB_TOL or flips > flips_limit(dep_k.numel()):
            fail(f"the {kernel} tile pipeline disagrees with the dense "
                 "reference")


def gate_vs_plain(phase: str, out: dict, kern, plain, mutant,
                  bitwise: bool = False, mutant_cull=None) -> None:
    """Adds the max |rgb| and depth flips of a kernel's frames (rgb,
    depth) against its plain version's, and of a broken kernel's, to
    ``out``; emits it; fails unless the kernel passes the gates (with
    ``bitwise``: equals its plain version exactly) and the broken one does
    not. ``mutant_cull``, where given, is the kernel built with a cull that
    drops too much (a negative margin): it must not be bitwise the plain
    version."""
    limit = flips_limit(kern[1].numel())
    out.update({"max_abs_rgb": float((kern[0] - plain[0]).abs().max()),
                "depth_flips": depth_flips(kern[1], plain[1]),
                "depth_pixels_differing": int((kern[1] != plain[1]).sum()),
                "rgb_tol": 0.0 if bitwise else RGB_TOL,
                "flips_limit": 0 if bitwise else limit,
                "mutant_no_op": {
                    "max_abs_rgb": float((mutant[0] - plain[0]).abs().max()),
                    "depth_flips": depth_flips(mutant[1], plain[1])}})
    if mutant_cull is not None:
        out["mutant_cull_too_much"] = {
            "margin": CULL_MUTANT_MARGIN,
            "max_abs_rgb": float((mutant_cull[0] - plain[0]).abs().max()),
            "pixels_differing": int(((mutant_cull[0] != plain[0]).any(dim=1)
                                     | (mutant_cull[1] != plain[1])).sum())}
    emit(out)
    if out["max_abs_rgb"] > RGB_TOL or out["depth_flips"] > limit:
        fail(f"{phase}: the kernel disagrees with its plain version")
    if bitwise and not (torch_equal(kern[0], plain[0])
                        and torch_equal(kern[1], plain[1])):
        fail(f"{phase}: the kernel is not bitwise its plain version")
    mut = out["mutant_no_op"]
    if mut["max_abs_rgb"] <= RGB_TOL and mut["depth_flips"] <= limit:
        fail(f"{phase}: a no-op kernel would pass the gates")
    if mutant_cull is not None and not out["mutant_cull_too_much"][
            "pixels_differing"]:
        fail(f"{phase}: a kernel that culls too much would pass the bitwise "
             "gate")


def check_k2_k6_small():
    """K2 and K6 against their plain versions on check_k1_small's 848x480
    scene split into static and dynamic splats (4 envs, both fixed
    cameras): the kernels' inputs are those of one incremental render.
    Both (K1's warp blocks and exact block cull; K6 on the merge of the
    static and dynamic segments) must be bitwise their plain versions. A
    no-op mutant (the cached frames returned unchanged) must land over the
    gates."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import RasterConfig, incremental
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    B = 4
    a = make_flagship_assets(batch=B, n_table=15000, n_obj_dense=3880,
                             device=DEVICE)
    # (phase, merge, wrapper, plain version, position of inst_ids)
    for phase, merge, name, plain, at_inst in (
            ("k2_check", "sort", "rasterize_tiles_sparse",
             tk.composite_sparse_plain, 1),
            ("k6_check", "stream", "rasterize_tiles_sparse_merge",
             tk.composite_sparse_merge_plain, 2)):
        ev = BatchedEvaluator(a, list(range(B)), device=DEVICE,
                              raster_config=RasterConfig(
                                  incremental="on", merge_kernel=merge))
        seen, undo = capture(incremental, name)
        try:
            ev.render()
        finally:
            undo()
        args = seen["args"]
        gate_vs_plain(phase, {"phase": phase, "envs": B, "cameras": 2,
                              "dirty_tiles": int(args[at_inst].numel())},
                      getattr(tk, name)(*args), plain(*args),
                      tk.copy_frames(args[-5], args[-4]), bitwise=True)


def check_k4_small(mutant_lib):
    """K4 against its plain version on small_flagship_bins' scene, fine
    binned: bitwise (its per-quadrant cull may skip only what changes no
    pixel), with its evaluations before and after the cull. The no-op
    mutant composites nothing (every fine tile's range empty: the
    background everywhere); the cull-too-much mutant is K4 built with a
    negative cull margin (``mutant_lib``)."""
    import torch

    from real2sim_eval_tpu_torch.renderer import fine_kernel as fk

    bins, n_tx, n_ty, n = small_flagship_bins(fine=True)
    args = (bins["pair_attrs"], bins["tile_starts"], bins["tile_ends"], n_tx,
            n_ty)
    starts = args[1]
    w = pixel_pair_walks(args[0], starts.reshape(-1), args[2].reshape(-1),
                         torch.arange(starts.numel(), device=DEVICE)
                         % starts.shape[1], n_tx * 8, tile_w=16,
                         boxes=FINE_BOXES)
    mutant = fk.rasterize_fine_batch(args[0], args[1], args[1], n_tx, n_ty)
    gate_vs_plain("k4_check", {
        "phase": "k4_check", "gaussians": n,
        "fine_tiles": int(starts.numel()),
        "pairs": int(bins["pair_attrs"].shape[1]),
        **fine_evaluations(w)},
        fk.rasterize_fine_batch(*args), fk.composite_fine_plain(*args),
        mutant, bitwise=True,
        mutant_cull=mutant_fine_composite(mutant_lib, *args))


def check_k5_small(mutant_lib):
    """K5 against its plain version on check_k2_k6_small's split scene (4
    envs, both fixed cameras): the kernel's inputs are those of one fine
    incremental render. Bitwise, with its evaluations before and after the
    cull; a no-op mutant (the cached frames returned unchanged) must land
    over the gates, the cull-too-much mutant (``mutant_lib``) off the
    plain version's bits."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import (RasterConfig,
                                                  incremental_fine)
    from real2sim_eval_tpu_torch.renderer import fine_kernel as fk
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    B = 4
    a = make_flagship_assets(batch=B, n_table=15000, n_obj_dense=3880,
                             device=DEVICE)
    ev = BatchedEvaluator(a, list(range(B)), device=DEVICE,
                          raster_config=RasterConfig(incremental="on",
                                                     kernel="fine"))
    seen, undo = capture(incremental_fine, "rasterize_fine_sparse")
    try:
        ev.render()
    finally:
        undo()
    args = seen["args"]
    w = pixel_pair_walks(args[0], args[3], args[4], args[2], args[7] * 8,
                         tile_w=16, boxes=FINE_BOXES)
    gate_vs_plain("k5_check", {
        "phase": "k5_check", "envs": B, "cameras": 2,
        "dirty_fine_tiles": int(args[1].numel()),
        "dirty_supertiles": int(ev.render_telemetry[0][..., 0].sum()),
        **fine_evaluations(w)},
        fk.rasterize_fine_sparse(*args), fk.composite_fine_sparse_plain(*args),
        tk.copy_frames(args[5], args[6]), bitwise=True,
        mutant_cull=mutant_fine_sparse(mutant_lib, *args))


def fine_evaluations(w: dict) -> dict:
    """pixel_pair_walks' counts of a fine kernel's walk (boxes=FINE_BOXES):
    its (pixel, pair) evaluations without the cull (``tile_evals``, the
    first form's), with the cull on each box shape (``sub_block_evals``;
    the kernels' warps walk "4x8" quadrants), and the pixels' own walks
    and reaching blends."""
    return {"tile_evals": w["tile_evals"], "sub_block_evals": w["box_evals"],
            "pixel_pair_blends": w["walks"], "reaching_blends": w["reaching"]}


def start_fine_lib(csrc: Path, out: Path, defines=()):
    """nvcc of csrc's K4 and K5 (fine_composite.cu, fine_sparse.cu) into a
    shared library with their plain C interface, in the background
    (seconds: the sources do not include PyTorch's headers). Returns
    (process, out, whether the launches take a tile order: the
    declarations in csrc's tile_composite.h say)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from real2sim_eval_tpu_torch import ext

    header = (csrc / "tile_composite.h").read_text()
    decl = header[header.index("fine_composite_launch("):]
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [str(Path(CUDA_HOME) / "bin" / "nvcc"), *ext.CUDA_FLAGS, *defines,
         "-shared", "-Xcompiler", "-fPIC", "-I", str(csrc),
         str(csrc / "fine_composite.cu"), str(csrc / "fine_sparse.cu"), "-o",
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out, "order" in decl[:decl.index(";")]


def load_fine_lib(build) -> tuple:
    """The library of start_fine_lib's ``build``, through ctypes: (library,
    whether its launches take a tile order)."""
    import ctypes

    proc, path, with_order = build
    text, _ = proc.communicate()
    if proc.returncode:
        fail(f"nvcc failed on {path.name}: {text[-2000:]}")
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    o = [p] if with_order else []
    lib.fine_composite_launch.argtypes = ([p, ctypes.c_longlong, p, p] + o
                                          + [i, i, i, f, f, f, p, p, p])
    lib.fine_sparse_launch.argtypes = ([p, ctypes.c_longlong, p, p, p, p]
                                       + o + [i, i, i, i, f, f, f, p, p, p])
    for fn in (lib.fine_composite_launch, lib.fine_sparse_launch):
        fn.restype = ctypes.c_int
    return lib, with_order


def start_cull_mutant():
    """start_fine_lib of this checkout's K4 and K5 with a cull margin of
    CULL_MUTANT_MARGIN, started beside the build."""
    from real2sim_eval_tpu_torch import ext

    return start_fine_lib(ext.CSRC, ext.BUILD_DIR / "fine_cull_mutant.so",
                          [f"-DR2S_CULL_ABS={CULL_MUTANT_MARGIN}f"])


def fine_lib_composite(lib, with_order: bool, pairs, starts, ends, order,
                       nsx: int, nsy: int, bg, rgb, depth) -> None:
    """K4 of a load_fine_lib library into rgb and depth
    (rasterize_fine_batch's arguments, contiguous, and the tile order)."""
    import torch

    o = [order.data_ptr()] if with_order else []
    err = lib.fine_composite_launch(
        pairs.data_ptr(), pairs.shape[1], starts.data_ptr(), ends.data_ptr(),
        *o, starts.shape[0], nsx * 8, nsy, *bg, rgb.data_ptr(),
        depth.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"K4 of {lib._name} did not launch: error {err}")


def fine_lib_sparse(lib, with_order: bool, pairs, inst, tile, starts, ends,
                    order, nsx: int, nsy: int, bg, rgb, depth) -> None:
    """K5 of a load_fine_lib library into rgb and depth, which hold the
    cached frames (rasterize_fine_sparse's arguments, contiguous, and the
    entries' order)."""
    import torch

    o = [order.data_ptr()] if with_order else []
    err = lib.fine_sparse_launch(
        pairs.data_ptr(), pairs.shape[1], inst.data_ptr(), tile.data_ptr(),
        starts.data_ptr(), ends.data_ptr(), *o, inst.numel(), rgb.shape[0],
        nsx * 8, nsy, *bg, rgb.data_ptr(), depth.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"K5 of {lib._name} did not launch: error {err}")


def mutant_fine_composite(lib, pairs, starts, ends, nsx, nsy,
                          bg=(0.0, 0.0, 0.0)):
    """K4's frames from the cull-too-much library (rasterize_fine_batch's
    arguments)."""
    import torch

    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    n_inst = starts.shape[0]
    rgb = torch.empty((n_inst, 3, nsy * 8, nsx * 128), device=DEVICE)
    depth = torch.empty((n_inst, nsy * 8, nsx * 128), device=DEVICE)
    fine_lib_composite(lib, True, pairs.contiguous(), starts.contiguous(),
                       ends.contiguous(), tk.longest_first(starts, ends), nsx,
                       nsy, bg, rgb, depth)
    return rgb, depth


def mutant_fine_sparse(lib, pairs, inst, tile, starts, ends, rgb_cache,
                       depth_cache, nsx, nsy, bg=(0.0, 0.0, 0.0)):
    """K5's frames from the cull-too-much library (rasterize_fine_sparse's
    arguments)."""
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    rgb, depth = tk.copy_frames(rgb_cache, depth_cache)
    fine_lib_sparse(lib, True, *(t.contiguous() for t in (
        pairs, inst, tile, starts, ends)), tk.longest_first(starts, ends),
        nsx, nsy, bg, rgb, depth)
    return rgb, depth


# ---------------------------------------------------------------------------
# the flagship paths
# ---------------------------------------------------------------------------


def flagship_actions():
    from real2sim_eval_tpu_torch.experiments.utils import trace_step

    return trace_step.flagship_actions(B_FLAGSHIP, DEVICE)


def run_path(phase: str, ev, actions, steps: int, kernels, setup_s: float):
    """One flagship path: a warm-up step and render, then ``steps`` timed
    steps and renders with the launch counts set to 0 just before and read
    just after. Fails on a drop, on bad frames, or unless each kernel in
    ``kernels`` launched at least once per timed step."""
    import torch

    from real2sim_eval_tpu_torch import ext

    ev.step(actions)                      # warm-up: allocator, first calls
    ev.render()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ext.reset_launch_counts()
    phys, rend, dirty, merged, kept, fine = [], [], [], [], [], []
    for _ in range(steps):
        ms, _ = time_host(lambda: ev.step(actions))
        phys.append(ms)
        ms, frames = time_host(ev.render)
        rend.append(ms)
        dirty.append(ev.render_telemetry[0][..., 0])
        merged.append(ev.render_stats.get("merged_pairs", 0))
        kept.append(ev.render_stats.get("wrist_static_blocks"))
        fine.append(ev.render_stats.get("dirty_fine_tiles"))
    launches = dict(ext.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    ims, depths, wims, wdepths = frames
    drops = ev.render_drops()
    tele = {k: int(np.sum(v)) for k, v in ev.telemetry().items()}
    finite = bool(torch.isfinite(ims).all() and torch.isfinite(wims).all()
                  and torch.isfinite(depths).all()
                  and torch.isfinite(ev.state.sm.x).all())
    shapes_ok = (tuple(ims.shape) == (B_FLAGSHIP, 2, 3, 480, 848)
                 and tuple(wims.shape) == (B_FLAGSHIP, 1, 3, 480, 848))
    total = float(np.mean(phys) + np.mean(rend))
    dirty = torch.stack(dirty).float()               # (steps, n_cams, B)
    kept = [k for k in kept if k is not None]
    kept = torch.stack(kept).float() if kept else None
    fine = [f for f in fine if f is not None]
    fine = torch.stack(fine).float() if fine else None
    out = {"phase": phase, "envs": B_FLAGSHIP,
           "gaussians_per_env": int(ev.compose_scenes()["means3D"].shape[1]),
           "cameras": "2 fixed + 1 wrist, 848x480",
           "raster_config": dataclasses.asdict(ev.raster_config),
           "incremental": ev.incremental,
           "substeps": ev.assets.opts.num_substeps, "timed_steps": steps,
           "setup_s": setup_s,
           "physics_ms": float(np.mean(phys)), "render_ms": float(np.mean(rend)),
           "total_ms": total, "env_steps_per_s": B_FLAGSHIP / (total / 1e3),
           "physics_ms_each": phys, "render_ms_each": rend,
           "max_memory_allocated_bytes": int(peak),
           # 8x128 tiles; on the fine family the dirty supertiles
           "dirty_tiles_per_camera": {
               "mean": dirty.mean(dim=(0, 2)).tolist(),
               "max": dirty.amax(dim=(0, 2)).tolist(),
               "tiles": 60 * 7},
           "dirty_fine_tiles_per_camera": (
               None if fine is None
               else {"mean": fine.mean(dim=(0, 2)).tolist(),
                     "max": fine.amax(dim=(0, 2)).tolist(),
                     "fine_tiles": 60 * 7 * 8}),
           "merged_pairs_per_render": {"mean": float(np.mean(merged)),
                                       "max": int(np.max(merged))},
           "wrist_cull": ev.wrist_cull,
           "wrist_static_blocks_kept": (
               None if kept is None
               else {"mean": float(kept.mean()), "max": int(kept.max())}),
           "render_drops": drops, "physics_telemetry": tele,
           "frames_finite": finite, "frame_shapes_ok": shapes_ok,
           "frame_mean": float(ims.mean()), "launches": launches}
    emit(out)
    if sum(drops.values()) or any(tele[k] for k in (
            "self_candidates_dropped", "self_particles_dropped",
            "contact_particles_dropped")):
        fail(f"budget saturation: {drops} {tele}")
    if not (finite and shapes_ok):
        fail(f"{phase} frames are not finite or misshapen")
    if kept is not None and not (ev.wrist_cull or {}).get("static"):
        fail(f"{phase}: the wrist is rendered unculled, yet the evaluator "
             "reports kept static blocks")
    for name in kernels:
        if launches[name] < steps:
            fail(f"{phase}: {name} launched {launches[name]} times in "
                 f"{steps} steps")
    # the mimic's and compose_dyn's solves, one kernel launch each
    if launches["ik_solve"] != 2 * steps:
        fail(f"{phase}: the IK kernel launched {launches['ik_solve']} times "
             f"in {steps} steps")
    return launches, out


def run_flagship():
    """The default path: incremental render, sort merge, pre-cull auto;
    ik_kernel first, with the evaluator's targets before its timed
    steps."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    t0 = time.perf_counter()
    a = make_flagship_assets(batch=B_FLAGSHIP, n_table=N_TABLE,
                             n_obj_dense=N_OBJ_DENSE, device=DEVICE)
    ev = BatchedEvaluator(a, list(range(B_FLAGSHIP)), device=DEVICE)
    setup_s = time.perf_counter() - t0
    if not ev.incremental:
        fail("the flagship does not take the incremental branch")
    actions = flagship_actions()
    ik = ik_kernel(ev, actions)
    launches, out = run_path(
        "flagship", ev, actions, TIMED_STEPS,
        ("spring_mass_step", "tile_sparse", "tile_composite"), setup_s)
    return ev, actions, launches, out, ik


def ik_targets(ev, actions) -> dict:
    """The flagship's two IK targets: the mimic's (the action pose) and
    compose_dyn's (the current eef)."""
    from real2sim_eval_tpu_torch.utils import transforms as tf

    st = ev.state
    B = actions.shape[0]
    return {"mimic": tf.make_se3(actions[:, 3:12].reshape(B, 3, 3),
                                 actions[:, :3]),
            "compose_dyn": tf.make_se3(tf.quat_to_rot(
                st.grippers[:, 6:10]), st.grippers[:, :3])}


def ik_arms() -> dict:
    """The arms the IK gate holds: the built-in arm as the evaluator uses
    it (link7, a 7-wide q) and the rail arm with its pusher tip
    (``testing.write_rail_pusher_urdf``: a prismatic joint and fixed links
    that are no identities on its path; an 8-wide q): name -> (chain, eef,
    q width)."""
    from real2sim_eval_tpu_torch.kinematics import KinematicChain
    from real2sim_eval_tpu_torch.testing import write_rail_pusher_urdf
    from real2sim_eval_tpu_torch.utils.urdf import BUILTIN_URDF

    builtin = KinematicChain.from_urdf_file(BUILTIN_URDF)
    with tempfile.TemporaryDirectory() as d:
        rail = KinematicChain.from_urdf_file(
            write_rail_pusher_urdf(Path(d) / "rail.urdf"))
    return {"builtin": (builtin, builtin.link_index("link7"), 7),
            "rail": (rail, rail.link_index("pusher_tip"), 8)}


def ik_latency_bound_ms(iters: int = 32) -> float:
    """The least time of one solve: IK_CHAIN_OPS dependent operations a
    Gauss-Newton step at the FMA's 4-cycle latency and the card's top SM
    clock (``nvidia-smi clocks.max.sm``); the lanes run side by side."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return iters * IK_CHAIN_OPS * 4 / (mhz * 1e3)


def ik_bands(chain, eef: int, q, t, reps: int = 20) -> dict:
    """The IK kernel launched through the binding ``reps`` times on one
    problem, its output each time inside a band of 4,096 NaN floats on
    either side: the bands stay NaN (it writes its output alone), its
    inputs equal their copies (it only reads them), and every launch gives
    the same bits (a race between the warp's threads would vary them).
    They stand in for compute-sanitizer's memcheck and racecheck where
    that tool cannot run."""
    import torch

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.kinematics.ik import pack_chain

    table = torch.as_tensor(pack_chain(chain, eef), device=DEVICE)
    ins = (table, q.contiguous(), t.contiguous())
    copies = [x.clone() for x in ins]
    E, n = q.shape
    pad = 4096
    outs, bands = [], True
    for _ in range(reps):
        buf = torch.full((2 * pad + E * n,), float("nan"), device=DEVICE)
        out = buf[pad:pad + E * n].view(E, n)
        ext.load().ik_solve(*ins, 7, 32, 1e-4, 1.0, 0.01, 0.01, out)
        sync()
        bands &= bool(buf[:pad].isnan().all() and buf[pad + E * n:].isnan()
                      .all())
        outs.append(out.clone())
    return {"bands_untouched": bands,
            "inputs_unchanged": all(torch_equal(a, b)
                                    for a, b in zip(ins, copies)),
            "launches_equal": all(torch_equal(o, outs[0]) for o in outs)}


def ik_kernel(ev=None, actions=None) -> dict:
    """The IK solve as one kernel launch (``make_ik_fn`` on the card)
    against the eager solve, bitwise: on both arms (ik_arms), at
    B_FLAGSHIP lanes on three sets of problems (``testing.ik_problems``:
    targets 0.003-1 rad of joint motion away, every eighth out of reach)
    and lane by lane (E = 1) on IK_SINGLE_LANES of them; with the
    flagship's evaluator, on its two targets too (the mimic's and
    compose_dyn's) from its arm's pose moved by up to 0.05 rad a joint,
    three times. A solve is one launch (``ext.LAUNCHES``). Each arm's
    first set also runs through ik_bands. Then the card ms of one launch
    at B_FLAGSHIP lanes (CUDA events, mean of 100) beside its latency
    bound and the eager solve's ms (mean of 3)."""
    import torch

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.kinematics import make_ik_fn
    from real2sim_eval_tpu_torch.testing import ik_problems

    cases, bands = [], {}
    for arm, (chain, eef, width) in ik_arms().items():
        solver = make_ik_fn(chain, eef, n_active=7)
        for k in range(3):
            q, t = ik_problems(chain, eef, width, B_FLAGSHIP, 100 + k,
                               DEVICE)
            cases.append((f"{arm}/B{B_FLAGSHIP}/{k}", solver, q, t))
        bands[arm] = ik_bands(chain, eef, *cases[-3][2:])
        q, t = ik_problems(chain, eef, width, IK_SINGLE_LANES, 200, DEVICE)
        cases += [(f"{arm}/E1/{i}", solver, q[i:i + 1], t[i:i + 1])
                  for i in range(IK_SINGLE_LANES)]
    if ev is not None:
        solver = make_ik_fn(ev.assets.chain, ev._eef_idx, n_active=7)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        for k in range(3):
            q = ev.state.qpos7 + 0.05 * (2.0 * torch.rand(
                ev.state.qpos7.shape, generator=gen, device=DEVICE) - 1.0)
            for name, t in ik_targets(ev, actions).items():
                t = t.clone()
                t[:, 0, 3] += 0.01 * k
                cases.append((f"flagship/{name}/{k}", solver, q, t))
    before = ext.LAUNCHES["ik_solve"]
    bitwise = {name: torch_equal(solver(q, t), solver.eager(q, t))
               for name, solver, q, t in cases}
    launches = ext.LAUNCHES["ik_solve"] - before
    fell = sum(int((solver.eager(q, t) == q).all(1).sum())
               for name, solver, q, t in cases if "/B" in name)
    _, solver, q, t = cases[0]
    kernel_ms = time_cuda(lambda: solver(q, t), 100)
    eager_ms = time_cuda(lambda: solver.eager(q, t), 3)
    out = {"phase": "ik_kernel", "lanes": B_FLAGSHIP, "iters": 32,
           "cases": len(cases), "bitwise_vs_eager": bitwise,
           "bands": bands,
           "launches": launches, "fallback_lanes": fell,
           "kernel_ms": kernel_ms,
           "latency_bound_ms": ik_latency_bound_ms(),
           "eager_ms": eager_ms}
    emit(out)
    if not all(bitwise.values()):
        fail("the IK kernel is not the eager solve: "
             f"{[k for k, v in bitwise.items() if not v]}")
    if launches != len(cases):
        fail(f"{len(cases)} IK solves took {launches} kernel launches")
    if not all(all(b.values()) for b in bands.values()):
        fail(f"the IK kernel's writes, reads or repeats are off: {bands}")
    return out


def ik_sync_free(ev, actions):
    """The flagship's two IK solves (the mimic's, toward the action pose,
    and compose_dyn's, toward the current eef), the kernel and eager, under
    ``torch.cuda.set_sync_debug_mode("error")``: fails if either
    synchronises the host with the card. Then one ``step`` and ``render``
    with their synchronising calls counted (step_render_syncs)."""
    import torch

    st = ev.state
    targets = ik_targets(ev, actions)
    for t in targets.values():                    # warm: allocations
        ev._ik(st.qpos7, t)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        # the kernel's solve (one launch) and the eager one
        for name, t in targets.items():
            for solve in (ev._ik, ev._ik.eager):
                try:
                    solve(st.qpos7, t)
                except RuntimeError as e:
                    fail(f"ik_sync_free: the {name} IK solve synchronises: "
                         f"{e}")
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ik_ms, _ = time_host(lambda: [ev._ik(st.qpos7, t)
                                  for t in targets.values()])
    sites = step_render_syncs(ev, actions)
    emit({"phase": "ik_sync_free", "ik_solves": list(targets),
          "error_mode_ok": True, "kernel_and_eager_enqueue_ms": enqueue_ms,
          "ik_ms": ik_ms, "step_render_syncs": sum(sites.values()),
          "step_render_sync_sites": sites})


def step_render_syncs(ev, actions) -> dict:
    """One ``step`` and ``render`` of evaluator ev with their synchronising
    calls counted (count_syncs). The evaluator's state is put back after
    that step, so later phases see the state sequence of the timed paths
    alone."""
    st = ev.state
    try:
        return count_syncs(lambda: (ev.step(actions), ev.render()))
    finally:
        ev.state = st


def count_syncs(fn) -> dict:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``, each
    synchronising call counted by the innermost line of the port (or of
    this script) that made it: {site: count}, most first."""
    import traceback
    import warnings

    import torch

    sites: dict = {}
    root = str(Path(__file__).resolve().parent)

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(root)]
        site = (f"{Path(frames[-1].filename).relative_to(root)}:"
                f"{frames[-1].lineno} {frames[-1].name}" if frames
                else f"{filename}:{lineno}")
        sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def fine_step_render_syncs(ev_f, actions) -> None:
    """step_render_syncs of the fine family's step and render; fails if
    the fine compositors' wrappers (their tile order included)
    synchronise."""
    sites = step_render_syncs(ev_f, actions)
    emit({"phase": "fine_sync_count", "step_render_syncs":
          sum(sites.values()), "step_render_sync_sites": sites})
    if any("fine_kernel.py" in k or "longest_first" in k for k in sites):
        fail(f"the fine compositors' wrappers synchronise: {sites}")


def run_flagship_stream(ev, actions):
    """The same flagship with the stream merge (K6), from the state the
    default path ended in."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import RasterConfig

    t0 = time.perf_counter()
    ev_s = BatchedEvaluator(ev.assets, list(range(B_FLAGSHIP)), device=DEVICE,
                            raster_config=RasterConfig(merge_kernel="stream"))
    ev_s.state = ev.state
    launches, _ = run_path(
        "flagship_stream", ev_s, actions, TIMED_STEPS_STREAM,
        ("spring_mass_step", "tile_sparse_merge", "tile_composite"),
        time.perf_counter() - t0)
    return ev_s, launches


def run_flagship_fine(ev, actions):
    """The same flagship on the fine family (``RasterConfig(kernel=
    "fine")``: the fixed cameras' dirty fine tiles through the sort merge
    and K5, the wrist camera through the fine full pipeline and K4), from
    the state the default path ended in."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import RasterConfig

    t0 = time.perf_counter()
    ev_f = BatchedEvaluator(ev.assets, list(range(B_FLAGSHIP)), device=DEVICE,
                            raster_config=RasterConfig(kernel="fine"))
    ev_f.state = ev.state
    launches, out = run_path(
        "flagship_fine", ev_f, actions, TIMED_STEPS_FINE,
        ("spring_mass_step", "fine_sparse", "fine_composite"),
        time.perf_counter() - t0)
    return ev_f, launches, out


def fine_render_parity(ev, ev_f):
    """On one flagship state: the fine family's fixed frames bitwise the
    fine full pipeline's on the [dynamic; static] scene (one camera at a
    time, to bound the pair table), and the fine frames against the wide
    ones within FAMILY_RGB_TOL and FAMILY_DEPTH_TOL (pixels over it
    counted against the flip limit), fixed and wrist cameras."""
    import torch

    from real2sim_eval_tpu_torch.renderer import RasterConfig, rasterize_batch

    st = ev_f.state
    outs = {}
    for name, e in (("wide", ev), ("fine", ev_f)):
        e.state = st
        outs[name] = e.render()
    B = B_FLAGSHIP
    dyn, _ = ev_f.compose_dyn(st, dc_only=ev_f.sh_deg == 0)
    scene = {k: torch.cat([dyn[k], ev_f._static[k][None].expand(
        (B,) + ev_f._static[k].shape)], dim=1) for k in dyn}
    fixed_diff = []
    for c, (cam, w2c) in enumerate(ev_f._fixed_cams):
        rgb, depth = rasterize_batch(
            [(cam, torch.as_tensor(w2c, device=DEVICE)[None].expand(B, 4, 4))],
            scene, ev_f.sh_deg, config=RasterConfig(kernel="fine"),
            device=DEVICE)
        fixed_diff.append(int(((outs["fine"][0][:, c] != rgb[0]).any(dim=1)
                               | (outs["fine"][1][:, c] != depth[0])).sum()))
    del scene

    def family_gap(i_rgb: int, i_dep: int) -> dict:
        a, b = outs["fine"], outs["wide"]
        return {"max_abs_rgb": float((a[i_rgb] - b[i_rgb]).abs().max()),
                "max_abs_depth": float((a[i_dep] - b[i_dep]).abs().max()),
                "depth_pixels_over_tol": int(
                    ((a[i_dep] - b[i_dep]).abs() > FAMILY_DEPTH_TOL).sum()),
                "flips_limit": flips_limit(a[i_dep].numel()),
                "differing_pixels": int(((a[i_rgb] != b[i_rgb]).any(dim=2)
                                         | (a[i_dep] != b[i_dep])).sum())}

    out = {"phase": "fine_render_parity",
           "fine_incremental_vs_fine_full_differing_pixels": fixed_diff,
           "fine_vs_wide": {"fixed": family_gap(0, 1),
                            "wrist": family_gap(2, 3)},
           "rgb_tol": FAMILY_RGB_TOL, "depth_tol": FAMILY_DEPTH_TOL}
    emit(out)
    if any(fixed_diff):
        fail(f"the fine incremental frames differ from the fine full "
             f"pipeline: {fixed_diff}")
    for part in out["fine_vs_wide"].values():
        if (part["max_abs_rgb"] > FAMILY_RGB_TOL
                or part["depth_pixels_over_tol"] > part["flips_limit"]):
            fail(f"the fine frames leave the bound to the wide ones: {out}")
        if not part["differing_pixels"]:
            fail("the fine and wide frames are identical: the fine family "
                 "did not render")


def render_parity(ev, ev_s):
    """On one flagship state: the fixed frames of the sort path, the stream
    path and the full pipeline on the [dynamic; static] scene bitwise; the
    full-pipeline branch (``incremental="off"``) within BRANCH_RGB_TOL and
    the flip limit; the culled wrist frames (static and dynamic cull
    forced on) bitwise the unculled ones in the same scene order. The
    cull walks the static splats in KD order and the unculled wrist path
    in scene order, as the JAX package does; those two differ only where
    splats of the flat table tie in depth, so they are held to the
    compositor tolerances."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import (RasterConfig, precull,
                                                  rasterize_batch)
    from real2sim_eval_tpu_torch.renderer.camera import wrist_w2c
    from real2sim_eval_tpu_torch.utils import transforms as tf

    st = ev.state
    ev_off = BatchedEvaluator(ev.assets, list(range(B_FLAGSHIP)),
                              device=DEVICE,
                              raster_config=RasterConfig(incremental="off"))
    outs = {}
    for name, e in (("sort", ev), ("stream", ev_s), ("off", ev_off)):
        e.state = st
        outs[name] = e.render()
    B = B_FLAGSHIP
    dyn, _ = ev.compose_dyn(st, dc_only=ev.sh_deg == 0)

    def with_static(static):
        return {k: torch.cat([dyn[k], static[k][None].expand(
            (B,) + static[k].shape)], dim=1) for k in dyn}

    fixed = [(cam, torch.as_tensor(w2c, device=DEVICE)[None].expand(B, 4, 4))
             for cam, w2c in ev._fixed_cams]
    rgb, depth = rasterize_batch(fixed, with_static(ev._static), ev.sh_deg,
                                 device=DEVICE)
    outs["full"] = (rgb.transpose(0, 1), depth.transpose(0, 1))

    def differing(a, b) -> int:
        return int(((a[0] != b[0]).any(dim=2) | (a[1] != b[1])).sum())

    def close(a, b) -> dict:
        return {"max_abs_rgb": float((a[0] - b[0]).abs().max()),
                "depth_flips": depth_flips(a[1], b[1]),
                "flips_limit": flips_limit(a[1].numel())}

    fixed_diff = {"sort_vs_full": differing(outs["sort"], outs["full"]),
                  "stream_vs_full": differing(outs["stream"], outs["full"]),
                  "sort_vs_stream": differing(outs["sort"], outs["stream"])}
    branch = {"fixed": close(outs["off"][:2], outs["sort"][:2]),
              "wrist": close(outs["off"][2:], outs["sort"][2:])}

    # the wrist: both culls forced on, against the same scene order unculled
    dyn_cull = dyn["means3D"].shape[1] >= 16 * precull.BLOCK
    culled = ev.render_wrist(st, dyn, True, dyn_cull)[:2]
    st_w = ev._cull_static[0]
    eef_rot = tf.quat_to_rot(st.grippers[:, 6:10])
    wrist = [(cam, wrist_w2c(eef2c, st.grippers[:, :3], eef_rot))
             for cam, eef2c in ev._wrist_cams]
    rgb, depth = rasterize_batch(wrist, with_static(st_w), ev.sh_deg,
                                 device=DEVICE)
    same_order = (rgb.transpose(0, 1), depth.transpose(0, 1))
    kept = ev.render_stats["wrist_static_blocks"]
    out = {"phase": "render_parity", "differing_pixels_fixed": fixed_diff,
           "incremental_vs_full_branch": branch,
           "branch_rgb_tol": BRANCH_RGB_TOL,
           "wrist_culled_vs_unculled_differing_pixels":
               differing(culled, same_order),
           "wrist_culled_vs_unculled_scene_order": close(
               culled, ev.render_wrist(st, dyn, False, False)[:2]),
           "wrist_cull_forced": {
               "static_blocks_kept_max": int(kept.max()),
               "static_blocks_total": int(st_w["means3D"].shape[0]
                                          // precull.BLOCK),
               "dynamic": dyn_cull}}
    emit(out)
    if any(fixed_diff.values()):
        fail(f"the incremental fixed frames differ: {fixed_diff}")
    for part in branch.values():
        if (part["max_abs_rgb"] > BRANCH_RGB_TOL
                or part["depth_flips"] > part["flips_limit"]):
            fail(f"the full-pipeline branch disagrees: {branch}")
    if out["wrist_culled_vs_unculled_differing_pixels"]:
        fail("the culled wrist frames differ from the unculled ones")
    part = out["wrist_culled_vs_unculled_scene_order"]
    if (part["max_abs_rgb"] > RGB_TOL
            or part["depth_flips"] > part["flips_limit"]):
        fail(f"the culled wrist frames disagree with the unculled path: "
             f"{part}")


def stamped_stages(fns: list) -> tuple[list, dict]:
    """``fns`` in turn, BREAKDOWN_REPS times, with the program's recorder
    stamping its spans and a synchronise after each call: (each call's
    mean synchronised host ms, the mean ms a rep of each stage's spans: the
    card's time between their events, the host's where they have none).
    Nested stages count inside their parents: the IK runs in the mimic and
    in compose_dyn, the LBS in compose_dyn, the cache copy in K2/K6, the
    pre-cull, preprocess, binning and K1 in the wrist pipeline."""
    ms = [0.0] * len(fns)
    with profiling.recording("stamps") as rec:
        for _ in range(BREAKDOWN_REPS):
            for i, fn in enumerate(fns):
                t0 = time.perf_counter()
                fn()
                profiling.anchor()
                ms[i] += (time.perf_counter() - t0) * 1e3
        record = rec.read()
    stages: dict = {}
    for s in record["spans"]:
        t0, t1 = s["device"] or s["host"]
        stages[s["label"]] = (stages.get(s["label"], 0.0)
                              + (t1 - t0) / BREAKDOWN_REPS)
    return [m / BREAKDOWN_REPS for m in ms], stages


def stage_breakdown(ev, ev_s, actions):
    """Where a flagship control step and render spend their time: the
    mean of BREAKDOWN_REPS more steps and renders of the default path, and
    renders of the stream path, each stage timed by its spans
    (stamped_stages)."""
    (step_ms, render_ms), stages = stamped_stages(
        [lambda: ev.step(actions), ev.render])
    (stream_render_ms,), stream_stages = stamped_stages([ev_s.render])
    emit({"phase": "breakdown", "reps": BREAKDOWN_REPS, "step_ms": step_ms,
          "render_ms": render_ms, "stages_ms": stages,
          "stream_render_ms": stream_render_ms,
          "stream_render_stages_ms": stream_stages})


def fine_breakdown(ev_f, actions):
    """stage_breakdown for the fine family: the mean of BREAKDOWN_REPS
    more steps and renders with each stage timed."""
    (step_ms, render_ms), stages = stamped_stages(
        [lambda: ev_f.step(actions), ev_f.render])
    emit({"phase": "breakdown_fine", "reps": BREAKDOWN_REPS,
          "step_ms": step_ms, "render_ms": render_ms, "stages_ms": stages})


# ---------------------------------------------------------------------------
# the evaluator and the single env built from a config
# ---------------------------------------------------------------------------


def write_flagship_config(root: Path):
    """bench.py's flagship files and config (bench.py:72-101), written by
    the port's own fixture writers: a 1000-particle rope checkpoint (Y =
    2e3), a 99,000-splat table scan, the rope fleshed out by 30,000 body
    splats, the clip; grid randomization, bench.py's three 848x480
    cameras, dt = 5e-5 with self-collision. Returns (cfg, seconds)."""
    from real2sim_eval_tpu_torch import testing as tt

    t0 = time.perf_counter()
    rope = tt.make_rope_points(n=1000, length=0.4)
    tt.write_fixture_checkpoint(root, "bench_rope", rope, spring_Y=2e3)
    gs = tt.make_synthetic_scene(root / "scans", rope_pts=rope, ik_urdf=None,
                                 n_table=N_TABLE, n_obj_dense=N_OBJ_DENSE)
    gs["use_grid_randomization"] = True
    cfg = tt.full_cfg(root, "bench_rope", gs=gs, cameras=tt.CAMERAS,
                      physics_over=dict(dt=5e-5, self_collision=True))
    return cfg, time.perf_counter() - t0


def grid_rel_poses(cfg, n: int) -> np.ndarray:
    """Env i's object pose relative to env 0's, worked out in numpy from
    the config alone: grid cell i % (xy x theta), the cell's offset added
    to the pose's translation and its yaw applied before its rotation."""
    g = cfg.gs.object.grid_randomization
    pose = np.array(cfg.gs.object.pose, np.float64).reshape(4, 4)
    poses = []
    for i in range(n):
        cell = i % (len(g.xy) * len(g.theta))
        rx, ry = g.xy[cell // len(g.theta)]
        a = np.deg2rad(g.theta[cell % len(g.theta)])
        p = pose.copy()
        p[:3, 3] += [rx, ry, 0.0]
        p[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0.0],
                              [np.sin(a), np.cos(a), 0.0],
                              [0.0, 0.0, 1.0]]) @ p[:3, :3]
        poses.append(p)
    inv0 = np.linalg.inv(poses[0])
    return np.stack([p @ inv0 for p in poses])


def cfg_build(root: Path):
    """``BatchedEvaluator(cfg, range(64))`` on the card from bench.py's
    flagship config, after a save_config / load_config round trip. Gates:
    the loaded config equals the written one; 130,120 gaussians per env
    (31,000 object, 99,000 table, 120 clip) and 1,000 particles; env i's
    object pose is grid cell i % 9 (grid_rel_poses, within 1e-6)."""
    import torch

    from real2sim_eval_tpu_torch.config import load_config, save_config
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator

    cfg, write_s = write_flagship_config(root)
    t0 = time.perf_counter()
    save_config(cfg, root / "cfg" / "flagship.yaml")
    loaded = load_config(root / "cfg", "flagship")
    load_s = time.perf_counter() - t0
    if loaded != cfg:
        fail("cfg_build: the loaded config differs from the written one")
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev = BatchedEvaluator(loaded, list(range(B_FLAGSHIP)), device=DEVICE)
    sync()
    build_s = time.perf_counter() - t0
    a = ev.assets
    parts = {"object": int(a.obj["means3D"].shape[0]),
             "table": int(a.table["means3D"].shape[0]),
             **{k: int(v["means3D"].shape[-2])
                for k, v in a.mesh_params.items()}}
    rel = ev.state.rel_pose.cpu().numpy().astype(np.float64)
    rel_err = float(np.abs(rel - grid_rel_poses(loaded, B_FLAGSHIP)).max())
    out = {"phase": "cfg_build", "envs": B_FLAGSHIP,
           "write_s": write_s, "save_load_s": load_s, "build_s": build_s,
           "build_s_per_env": build_s / B_FLAGSHIP,
           "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
           "gaussians_per_env": sum(parts.values()), "gaussians": parts,
           "particles": int(ev.state.sm.x.shape[1]),
           "springs": int(a.params.springs.shape[0]),
           "substeps": a.opts.num_substeps, "incremental": ev.incremental,
           "rel_pose_max_err": rel_err,
           "random_variables_first": ev.random_variables[:2]}
    emit(out)
    if parts != {"object": 1000 + N_OBJ_DENSE, "table": N_TABLE,
                 "clip": 120}:
        fail(f"cfg_build: the scene has {parts} gaussians")
    if out["particles"] != 1000 or a.opts.num_substeps != 667:
        fail(f"cfg_build: {out['particles']} particles, "
             f"{a.opts.num_substeps} substeps")
    if rel_err > 1e-6:
        fail(f"cfg_build: env poses are not the grid cells ({rel_err})")
    if not ev.incremental:
        fail("cfg_build: the evaluator does not take the incremental branch")
    return ev, loaded, build_s


def run_cfg_flagship(ev, actions, build_s: float, flagship: dict):
    """The config-built flagship on the default branch, through run_path
    and its gates, beside the make_flagship_assets path's numbers."""
    _, out = run_path("cfg_flagship", ev, actions, TIMED_STEPS_CFG,
                      ("spring_mass_step", "tile_sparse", "tile_composite"),
                      build_s)
    emit({"phase": "cfg_flagship_vs_flagship",
          "cfg_flagship": {k: out[k] for k in (
              "env_steps_per_s", "physics_ms", "render_ms",
              "max_memory_allocated_bytes")},
          "flagship": {k: flagship[k] for k in (
              "env_steps_per_s", "physics_ms", "render_ms",
              "max_memory_allocated_bytes")}})
    return out["env_steps_per_s"]


def single_env(cfg, seed: int = 3):
    """``envs.make("BaseEnv-v0", cfg=cfg, randomize=True)`` on the card:
    reset(seed), then SINGLE_ENV_STEPS steps of the hold action without
    velocity control, a get_obs after each; the same episode on
    ``BatchedEvaluator(cfg, [seed], RasterConfig(incremental="off"))``.
    Gates: particles within 1e-4 at every step (the JAX suite's
    single-versus-batch tolerance, tests/test_batched.py:121); the fixed
    frames within RGB_TOL, depth over 1e-3 counted against flips_limit,
    after the reset and the first step; K3 and K1 launched by each; the
    single env's K1 bitwise its plain version on captured inputs. From
    the second step on both packages' single env blend the last step's
    particle motion onto the rest splats, the evaluator the motion from
    the rest bones, so those frames part from the evaluator's (the gap is
    reported). Every step's fixed frame is therefore also held, at the
    same tolerances, to a reference with the single env's blend: the
    evaluator's own composition (``_posed_object``, the IK arm pose, the
    articulation) rendered from its pre-render state of that step, with
    its rest bones swapped for the single env's particles of the step
    before and its particles for the single env's of the step."""
    import torch

    import real2sim_eval_tpu_torch.envs as envs
    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import raster
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    rot = np.diag([1.0, -1.0, -1.0]).reshape(-1)
    act = np.concatenate([[0.26, 0.02, 0.38], rot, [0.6]])[None].astype(
        np.float32)
    hold = {"action": act, "do_velocity_control": False}

    ext.reset_launch_counts()
    t0 = time.perf_counter()
    env = envs.make("BaseEnv-v0", cfg=cfg, randomize=True, device=DEVICE)
    obs, _ = env.reset(seed=seed)
    sync()
    reset_s = time.perf_counter() - t0
    u = env.unwrapped
    env_x, env_obs, step_ms, obs_ms = [], [obs], [], []
    env_x.append(u.physics.current_points.clone())
    env_bones = [u.renderer.state["x"].clone()]
    for _ in range(SINGLE_ENV_STEPS):
        ms, _ = time_host(lambda: env.step(hold))
        step_ms.append(ms)
        ms, obs = time_host(u.get_obs)
        obs_ms.append(ms)
        env_obs.append(obs)
        env_x.append(u.physics.current_points.clone())
        env_bones.append(u.renderer.state["x"].clone())
    env_launches = dict(ext.LAUNCHES)

    seen, undo = capture(raster, "rasterize_tiles_batch")
    try:
        u.get_obs()
    finally:
        undo()
    args = seen["args"]
    gate_vs_plain("single_env_k1", {"phase": "single_env_k1",
                                    "pairs": int(args[0].shape[1])},
                  tk.rasterize_tiles_batch(*args),
                  tk.composite_tiles_plain(*args),
                  tk.rasterize_tiles_batch(args[0], args[1], args[1],
                                           *args[3:]), bitwise=True)
    sites = count_syncs(lambda: (env.step(hold), u.get_obs()))

    ext.reset_launch_counts()
    ev = BatchedEvaluator(cfg, [seed], render_off(), device=DEVICE)
    ev_x, ev_frames = [ev.state.sm.x[0].clone()], [ev.render()]
    ev_pre = []   # each step's pre-render (grippers, qpos7)
    for _ in range(SINGLE_ENV_STEPS):
        ev.step(act, do_velocity_control=False)
        ev_x.append(ev.state.sm.x[0].clone())
        ev_pre.append((ev.state.grippers.clone(), ev.state.qpos7.clone()))
        ev_frames.append(ev.render())
    ev_launches = dict(ext.LAUNCHES)

    # the reference with the single env's blend: the evaluator's own
    # composition on the single env's bones of steps k - 1 and k
    base_assets, base = ev.assets, ev.state
    blend_frames = [None]
    for k, (grippers, qpos7) in enumerate(ev_pre, start=1):
        ev.assets = dataclasses.replace(base_assets, bones0=env_bones[k - 1])
        ev.state = base.replace(
            sm=dataclasses.replace(base.sm, x=env_bones[k][None]),
            grippers=grippers, qpos7=qpos7)
        blend_frames.append(ev.render())
    ev.assets, ev.state = base_assets, base

    x_err = [float((e - b).abs().max()) for e, b in zip(env_x, ev_x)]
    def frame_gap(o, f):
        return (float((o["image_list"][0] - f[0][0, 0]).abs().max()),
                int(((o["depth_list"][0] - f[1][0, 0]).abs() > 1e-3).sum()))

    rgb_err, depth_over = map(list, zip(*(
        frame_gap(o, f) for o, f in zip(env_obs, ev_frames))))
    blend_rgb_err, blend_depth_over = map(list, zip(*(
        frame_gap(o, f) for o, f in zip(env_obs[1:], blend_frames[1:]))))
    limit = flips_limit(env_obs[0]["depth_list"][0].numel())
    out = {"phase": "single_env", "seed": seed, "steps": SINGLE_ENV_STEPS,
           "reset_s": reset_s, "step_ms": step_ms, "get_obs_ms": obs_ms,
           "env_step_ms": float(np.mean(step_ms)),
           "get_obs_ms_mean": float(np.mean(obs_ms)),
           "syncs_per_step_and_get_obs": sum(sites.values()),
           "sync_sites": sites,
           "particles_max_err": x_err, "fixed_rgb_max_err": rgb_err,
           "fixed_depth_pixels_over_1e-3": depth_over,
           "frames_gated_through_step": 1, "depth_flips_limit": limit,
           "blend_ref_rgb_max_err": blend_rgb_err,
           "blend_ref_depth_pixels_over_1e-3": blend_depth_over,
           "launches_single_env": env_launches,
           "launches_evaluator": ev_launches,
           "frames_finite": bool(all(
               torch.isfinite(o["image_list"][0]).all()
               and torch.isfinite(o["image_wrist_list"][0]).all()
               for o in env_obs))}
    emit(out)
    if max(x_err) > 1e-4:
        fail(f"single_env: the particles part from the evaluator's: {x_err}")
    if max(rgb_err[:2]) > RGB_TOL or max(depth_over[:2]) > limit:
        fail(f"single_env: the fixed frames part from the evaluator's: "
             f"{rgb_err} {depth_over}")
    if max(blend_rgb_err) > RGB_TOL or max(blend_depth_over) > limit:
        fail(f"single_env: the fixed frames part from the reference with "
             f"the single env's blend: {blend_rgb_err} {blend_depth_over}")
    if not out["frames_finite"]:
        fail("single_env: frames are not finite")
    for name in ("spring_mass_step", "tile_composite"):
        if env_launches[name] < 1 or ev_launches[name] < 1:
            fail(f"single_env: {name} was not launched")


# ---------------------------------------------------------------------------
# the CLIs on the flagship scene
# ---------------------------------------------------------------------------


def probe_encoders() -> dict:
    """What this machine has to encode frames and videos: OpenCV, PIL and
    the ffmpeg binary (a version, a path or None)."""
    import importlib
    import shutil

    out = {}
    for mod in ("cv2", "PIL"):
        try:
            out[mod] = importlib.import_module(mod).__version__
        except ImportError:
            out[mod] = None
    out["ffmpeg"] = shutil.which("ffmpeg")
    return out


def write_cli_configs(cfg, root: Path) -> Path:
    """cfg_build's flagship config as each CLI's config file, with the
    phases' cuts. The grid randomization would cap the batched CLI at its
    9 cells (``n_grid_episodes``), so the episodes draw uniform poses."""
    from real2sim_eval_tpu_torch.config import ConfigNode, save_config

    c = ConfigNode(copy.deepcopy(cfg.to_dict()))
    c.gs.use_grid_randomization = False
    c.exp_root = str(root / "log")
    c.timestamp = "cli"
    c.env.sim.duration = CLI_DURATION
    c.raster_backend = "auto"
    c.batch_size = B_FLAGSHIP
    c.episode_start = 0
    c.checkpoint_every = CLI_CHECKPOINT_EVERY
    c.telemetry_every = CLI_TELEMETRY_EVERY
    c.policy = dict(builtin="hold", n_episodes=B_FLAGSHIP,
                    inference_cfg_path=None, checkpoint_path=None)
    d = root / "cli_cfg"
    save_config(c, d / "eval_policy_batched.yaml")
    c.policy.n_episodes = 1
    save_config(c, d / "eval_policy.yaml")
    c.gt_dir = str(root / "gt")
    c.use_qpos = False
    c.randomize = False
    save_config(c, d / "replay.yaml")
    save_config(c, d / "keyboard_teleop.yaml")
    return d


def episode_paths(n_episodes: int, n_cams: int, n_steps: int) -> set:
    """Relative paths a CLI run writes for its episodes (the reference's
    layout): per camera n_steps + 1 frames and the start and final
    frames, per step a robot JSON and a state pickle, the calibration and
    the random variables, a video per camera; and ``hydra.yaml``."""
    out = {"hydra.yaml"}
    for ep in range(n_episodes):
        e = f"episode_{ep:04d}"
        for cam in range(n_cams):
            out |= {f"{e}/camera_{cam}/rgb/{k:06d}.jpg"
                    for k in range(n_steps + 1)}
            out |= {f"{sf}_images/{e}_camera_{cam}.jpg"
                    for sf in ("start", "final")}
            out.add(f"{e}/vis_camera_{cam}.mp4")
        out |= {f"{e}/robot/{k:06d}.json" for k in range(n_steps)}
        out |= {f"{e}/state/{k:06d}.pkl" for k in range(n_steps)}
        out |= {f"{e}/calibration/{n}.npy"
                for n in ("rvecs", "tvecs", "intrinsics")}
        out.add(f"{e}/random_variables.json")
    return out


def written(run: Path) -> tuple:
    """(relative paths, bytes) of the files under ``run``."""
    files = [p for p in Path(run).rglob("*") if p.is_file()]
    return ({str(p.relative_to(run)) for p in files},
            sum(p.stat().st_size for p in files))


def check_layout(phase: str, run: Path, expected: set) -> dict:
    paths, n_bytes = written(run)
    if paths != expected:
        fail(f"{phase}: the run wrote other files than the reference's "
             f"layout: missing {sorted(expected - paths)[:5]}, extra "
             f"{sorted(paths - expected)[:5]}")
    return {"files_written": len(paths), "bytes_written": n_bytes}


def check_state_dumps(phase: str, run: Path) -> None:
    """Every state pickle of the run: step 0's holds ``physics`` and later
    ones do not; every ``renderer.x`` is finite."""
    import pickle

    for p in sorted(Path(run).glob("episode_*/state/*.pkl")):
        with open(p, "rb") as f:
            s = pickle.load(f)
        if ("physics" in s) != (p.stem == "000000"):
            fail(f"{phase}: {p.relative_to(run)} has keys {sorted(s)}")
        if not np.isfinite(s["renderer"]["x"].numpy()).all():
            fail(f"{phase}: {p.relative_to(run)} holds non-finite particles")


def syncs_by_phase(fn, stats: dict):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``, each
    synchronising call counted by the CLI phase that ran it
    (``stats["current"]``, set by the CLI's ``PhaseTimer``; calls outside
    a phase count as "outside"). Returns (fn's result, counts)."""
    import warnings

    import torch

    counts: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            k = stats.get("current") or "outside"
            counts[k] = counts.get(k, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, counts


def run_cli(fn, stats: dict):
    """A CLI call with its printed progress sent to standard error (every
    line of this script's standard output is one JSON object), its
    synchronising calls counted (syncs_by_phase) and its peak memory."""
    import torch

    sync()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):
        out, syncs = syncs_by_phase(fn, stats)
    sync()
    return out, syncs, int(torch.cuda.max_memory_allocated())


def loop_split(stats: dict, n_steps: int, syncs: dict) -> dict:
    """Per loop step: each phase's ms (its total over the loop / steps)
    and synchronising calls, and the walls between the CLI's marks."""
    m = stats["marks"]
    walls = {"build_s": m["built"] - m["start"],
             "stabilization_s": m["stabilized"] - m["built"],
             "loop_s": m["looped"] - m["stabilized"],
             "final_frames_and_videos_s": m["done"] - m["looped"]}
    ms = {k: float(np.sum(v)) / n_steps for k, v in stats["ms"].items()}
    loop_syncs = {k: v for k, v in syncs.items() if k in stats["ms"]}
    return {**walls, "loop_ms_per_step": walls["loop_s"] * 1e3 / n_steps,
            "ms_per_step": ms, "phase_calls": {
                k: len(v) for k, v in stats["ms"].items()},
            "syncs_per_step": sum(loop_syncs.values()) / n_steps,
            "syncs_per_step_by_phase": {k: v / n_steps
                                        for k, v in loop_syncs.items()},
            "syncs_outside_loop_phases": syncs.get("outside", 0)}


def cli_batched(cfg_dir: Path, root: Path, bare_rate: float):
    """``eval_policy_batched.cli`` at the flagship: 64 lanes, the hold
    policy, the phases' cuts. Gates: the written files are the reference's
    layout (no checkpoint left, the batch's done marker); step 0's pickle
    alone holds ``physics``; every ``renderer.x`` is finite; K3, K1 and K2
    launched every loop step; the CLI's evaluator, restored to its
    snapshot from before the stabilization and driven directly with the
    same hold actions, gives bitwise the CLI's particles after the last
    step and lane 0's step-0 uint8 frames (as the CLI hands them to
    ``cv2.imwrite``)."""
    import cv2
    import torch

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.experiments import eval_policy_batched as epb
    from real2sim_eval_tpu_torch.experiments.episode_io import camera_frames
    from real2sim_eval_tpu_torch.experiments.policy_api import HoldPolicy

    snapshot = root / "cli_initial.pkl"
    launches: dict = {}
    seen: dict = {}

    def on_mark(name, ev):
        if name == "built":
            ev.save_state(snapshot)
            seen["evaluator"] = ev
        elif name == "stabilized":
            ext.reset_launch_counts()
        elif name == "looped":
            launches.update(ext.LAUNCHES)
            seen["particles"] = ev.particle_states()

    frames0: dict = {}      # camera -> lane 0's step-0 frame
    imwrite = cv2.imwrite

    def record(path, img):
        p = Path(path)
        if p.name == "000000.jpg" and p.parts[-4] == "episode_0000":
            frames0[int(p.parts[-3].removeprefix("camera_"))] = np.array(img)
        return imwrite(path, img)

    stats = {"on_mark": on_mark}
    t0 = time.perf_counter()
    cv2.imwrite = record
    try:
        run, syncs, peak = run_cli(lambda: epb.cli(
            ["--config-path", str(cfg_dir), "--device", DEVICE],
            stats=stats), stats)
    finally:
        cv2.imwrite = imwrite
    wall_s = time.perf_counter() - t0
    ev = seen.pop("evaluator")
    cfg = ev.cfg
    n_steps = int(cfg.physics.fps) * CLI_DURATION
    n_cams = len(cfg.env.cameras)
    split = loop_split(stats, n_steps, syncs)
    layout = check_layout("cli_batched", run, episode_paths(
        B_FLAGSHIP, n_cams, n_steps) | {"batch_00000.done"})
    check_state_dumps("cli_batched", run)

    # the same episodes driven directly
    ev.load_state(snapshot)
    hold = torch.as_tensor(epb.hold_actions(ev.state.grippers.cpu().numpy()),
                           dtype=torch.float32, device=DEVICE)
    for _ in range(30):
        ev.step(hold, do_velocity_control=False)
    obs = ev.observations()
    lane0 = [(f * 255).to(torch.uint8).permute(1, 2, 0).flip(-1).cpu().numpy()
             for f in camera_frames(cfg.env.cameras, obs["images"][0],
                                    obs["wrist_images"][0])]
    frames_bitwise = len(frames0) == n_cams and all(
        np.array_equal(a, frames0[k]) for k, a in enumerate(lane0))
    policy = HoldPolicy()
    for _ in range(n_steps):
        cartesian = policy.inference(
            {"observation.state": obs["observation.state"].cpu().numpy()})
        ev.step(torch.as_tensor(epb.actions_from_policy(cartesian, False),
                                device=DEVICE))
        obs = ev.observations()
    x_direct = ev.particle_states()
    x_gap = float(np.abs(x_direct - seen["particles"]).max())
    particles_bitwise = bool(np.array_equal(x_direct, seen["particles"]))
    del ev, obs
    torch.cuda.empty_cache()

    counts = stats["counts"]
    out = {"phase": "cli_batched", "envs": B_FLAGSHIP,
           "cuts": {"env.sim.duration": CLI_DURATION,
                    "control_steps": n_steps, "stabilization_steps": 30,
                    "checkpoint_every": CLI_CHECKPOINT_EVERY,
                    "telemetry_every": CLI_TELEMETRY_EVERY,
                    "gs.use_grid_randomization": False},
           "wall_s": wall_s, **split,
           "loop_env_steps_per_s": B_FLAGSHIP * n_steps / split["loop_s"],
           "cfg_flagship_env_steps_per_s": bare_rate,
           "copy_bytes_per_step": {k: v / n_steps for k, v in counts.items()},
           **layout, "max_memory_allocated_bytes": peak,
           "launches_loop": launches,
           "frames_lane0_step0_bitwise": frames_bitwise,
           "particles_bitwise_direct": particles_bitwise,
           "particles_max_gap_direct": x_gap}
    emit(out)
    for name in ("spring_mass_step", "tile_composite", "tile_sparse"):
        if launches.get(name, 0) < n_steps:
            fail(f"cli_batched: {name} launched {launches.get(name, 0)} "
                 f"times in {n_steps} loop steps")
    if not frames_bitwise:
        fail("cli_batched: lane 0's step-0 frames differ from the directly "
             "driven evaluator's")
    if not particles_bitwise:
        fail(f"cli_batched: the particles part from the directly driven "
             f"evaluator's ({x_gap})")
    return run


def cli_success(run: Path) -> None:
    """``calculate_success_rope`` over cli_batched's dumps, every frame
    from step 0: 64 results, all False under the hold policy."""
    from real2sim_eval_tpu_torch.experiments.utils import (
        calculate_success_rope as rope)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        results = rope.main(["--data_dir", str(run), "--start_step", "0"])
    seconds = time.perf_counter() - t0
    table = np.loadtxt(Path(run) / "success.txt")
    emit({"phase": "success", "criterion": "rope", "start_step": 0,
          "episodes": len(results), "successes": int(sum(results)),
          "seconds": seconds, "success_txt_tail": table[-2:].tolist()})
    if len(results) != B_FLAGSHIP or any(results) or table[-2] != 0:
        fail(f"success: {len(results)} results, {sum(results)} successes")


def cli_single(cfg_dir: Path) -> None:
    """``eval_policy.cli`` for one episode on the flagship scene. Gates:
    the reference's layout; the particles before every step and after the
    last equal, bitwise, a single env driven directly with the actions
    the run's robot JSONs record."""
    import json
    import pickle

    import torch

    import real2sim_eval_tpu_torch.envs as envs
    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.experiments import eval_policy as ep
    from real2sim_eval_tpu_torch.utils import transforms_np as tnp

    seen: dict = {}

    def on_mark(name, env):
        if name == "looped":
            seen["particles"] = env.unwrapped.get_state()["renderer"]["x"]

    stats = {"on_mark": on_mark}
    run, syncs, peak = run_cli(lambda: ep.cli(
        ["--config-path", str(cfg_dir), "--device", DEVICE], stats=stats),
        stats)
    cfg = load_config(cfg_dir, "eval_policy")
    n_steps = int(cfg.physics.fps) * CLI_DURATION
    layout = check_layout("cli_single", run, episode_paths(
        1, len(cfg.env.cameras), n_steps))
    check_state_dumps("cli_single", run)

    env = envs.make(cfg.env_name, cfg=cfg, randomize=True,
                    raster_config=ep.raster_config_from(cfg), device=DEVICE)
    obs, _ = env.reset(seed=0)
    xyz, quat, grip = ep.robot_obs(obs)
    hold = np.concatenate([xyz, tnp.quat_to_rot(quat).reshape(1, -1), grip],
                          axis=1)
    for _ in range(30):
        env.step({"action": ep.env_action(hold, DEVICE),
                  "do_velocity_control": False})
    env.unwrapped.get_obs()
    ep_dir = Path(run) / "episode_0000"
    gaps = []
    for cnt in range(n_steps):
        with open(ep_dir / "state" / f"{cnt:06d}.pkl", "rb") as f:
            x_cli = pickle.load(f)["renderer"]["x"].numpy()
        x = env.unwrapped.get_state()["renderer"]["x"]
        gaps.append(None if np.array_equal(x, x_cli)
                    else float(np.abs(x - x_cli).max()))
        with open(ep_dir / "robot" / f"{cnt:06d}.json") as f:
            rec = json.load(f)
        a_xyz = np.array(rec["action.ee_pos"], np.float32)[None]
        a_quat = np.array(rec["action.ee_quat"], np.float32)[None]
        a_grip = np.array(rec["action.gripper_qpos"], np.float32)[None]
        action = np.concatenate([a_xyz, tnp.quat_to_rot(a_quat).reshape(1, -1),
                                 1.0 - a_grip], axis=1)
        env.step({"action": ep.env_action(action, DEVICE),
                  "do_velocity_control":
                      bool(cfg.env.robot.do_velocity_control)})
        env.unwrapped.get_obs()
    x = env.unwrapped.get_state()["renderer"]["x"]
    gaps.append(None if np.array_equal(x, seen["particles"])
                else float(np.abs(x - seen["particles"]).max()))
    del env
    torch.cuda.empty_cache()
    split = loop_split(stats, n_steps, syncs)
    emit({"phase": "cli_single",
          "cuts": {"env.sim.duration": CLI_DURATION,
                   "control_steps": n_steps, "stabilization_steps": 30,
                   "gs.use_grid_randomization": False},
          **split, **layout, "max_memory_allocated_bytes": peak,
          "particles_steps_not_bitwise": [i for i, g in enumerate(gaps)
                                          if g is not None],
          "particles_max_gap": max((g for g in gaps if g is not None),
                                   default=0.0)})
    if any(g is not None for g in gaps):
        fail(f"cli_single: the particles part from the directly driven "
             f"single env's at steps {[i for i, g in enumerate(gaps) if g]}")


def write_replay_trajectory(cfg, gt: Path) -> dict:
    """CLI_REPLAY_STEPS recorded frames from the configured initial eef,
    each CLI_REPLAY_DESCENT lower, pointing down, the gripper open; each
    with the ``action.qpos`` of the port's ``KinHelper`` IK (chained from
    the canonical arm pose) beside the ``ee_pos`` format. Returns the IK's
    largest FK distance from the recorded positions."""
    import json

    from real2sim_eval_tpu_torch.kinematics import KinHelper
    from real2sim_eval_tpu_torch.kinematics.robot import CANONICAL_ARM_QPOS

    kh = KinHelper(cfg.env.urdf.ik_urdf_path, device=DEVICE)
    x0 = np.array(cfg.env.robot.init_eef_xyz, np.float64)
    q = CANONICAL_ARM_QPOS.astype(np.float32)
    (gt / "robot").mkdir(parents=True)
    fk_err = 0.0
    for i in range(CLI_REPLAY_STEPS):
        xyz = x0 - [0.0, 0.0, CLI_REPLAY_DESCENT * i]
        q = kh.compute_ik_sapien(q, np.concatenate([xyz, [np.pi, 0.0, 0.0]]))
        T = kh.compute_fk_sapien_links(q, [kh.sapien_eef_idx])[0]
        fk_err = max(fk_err, float(np.abs(T[:3, 3] - xyz).max()))
        rec = {"action.ee_pos": xyz.tolist(),
               "action.ee_quat": [0.0, 1.0, 0.0, 0.0],
               "action.gripper_qpos": [0.0], "action.qpos": q.tolist()}
        with open(gt / "robot" / f"{i:06d}.json", "w") as f:
            json.dump(rec, f)
    return {"kinhelper_fk_max_err": fk_err}


def cli_replay(cfg_dir: Path) -> None:
    """``replay.cli`` over the recorded descent, in the ``ee_pos`` format
    and in the ``qpos`` format (through ``KinHelper``'s FK). Gates: the
    reference's layout, finite state, and the eef below its start by at
    least half the recorded descent."""
    import json

    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.experiments import replay

    cfg = load_config(cfg_dir, "replay")
    ik = write_replay_trajectory(cfg, Path(cfg.gt_dir))
    descent = CLI_REPLAY_DESCENT * (CLI_REPLAY_STEPS - 1)
    out = {"phase": "cli_replay", "steps": CLI_REPLAY_STEPS,
           "recorded_descent_m": descent, **ik}
    for fmt, use_qpos in (("ee_pos", False), ("qpos", True)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            run = replay.cli(["--config-path", str(cfg_dir), "--device",
                              DEVICE, f"timestamp=replay_{fmt}",
                              f"use_qpos={use_qpos}"])
        wall = time.perf_counter() - t0
        layout = check_layout(f"cli_replay_{fmt}", run, episode_paths(
            1, len(cfg.env.cameras), CLI_REPLAY_STEPS))
        check_state_dumps(f"cli_replay_{fmt}", run)
        robot = sorted((Path(run) / "episode_0000" / "robot").glob("*.json"))
        z = [json.load(open(p))["obs.ee_pos"][2] for p in (robot[0],
                                                           robot[-1])]
        out[fmt] = {"wall_s": wall, **layout, "eef_z_first": z[0],
                    "eef_z_last": z[1], "eef_descent_m": z[0] - z[1]}
    emit(out)
    for fmt in ("ee_pos", "qpos"):
        if out[fmt]["eef_descent_m"] < 0.5 * descent:
            fail(f"cli_replay: the {fmt} replay moved the eef down "
                 f"{out[fmt]['eef_descent_m']} m of {descent}")


def cli_teleop(cfg_dir: Path) -> None:
    """``InteractivePlayground`` with a programmatic ``KeySource``
    ("wwwq": +x three times, +z once), CLI_TELEOP_STEPS steps, no window.
    Gate: the eef's x increased."""
    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.experiments.keyboard_teleop import (
        InteractivePlayground, KeySource)
    from real2sim_eval_tpu_torch.utils.device import to_numpy

    cfg = load_config(cfg_dir, "keyboard_teleop")
    keys = KeySource()
    for k in CLI_TELEOP_KEYS:
        keys.push(k)
    t0 = time.perf_counter()
    obs = InteractivePlayground(cfg, key_source=keys,
                                max_steps=CLI_TELEOP_STEPS, show=False,
                                device=DEVICE).run()
    wall = time.perf_counter() - t0
    eef = to_numpy(obs["robot"]["eef_xyz"])[0]
    x0 = float(cfg.env.robot.init_eef_xyz[0])
    emit({"phase": "cli_teleop", "keys": CLI_TELEOP_KEYS,
          "steps": CLI_TELEOP_STEPS, "wall_s": wall,
          "eef_xyz": eef.tolist(), "init_eef_x": x0})
    if not eef[0] > x0:
        fail(f"cli_teleop: the eef did not move +x ({eef} from x {x0})")


def run_clis(cfg, root: Path, bare_rate: float) -> None:
    """The CLI phases on cfg_build's flagship scene. They write JPEGs and
    videos as the package does, through cv2 (probed on the device line)."""
    cfg_dir = write_cli_configs(cfg, root)
    run = cli_batched(cfg_dir, root, bare_rate)
    cli_success(run)
    cli_single(cfg_dir)
    cli_replay(cfg_dir)
    cli_teleop(cfg_dir)


# ---------------------------------------------------------------------------
# scene and asset building, and the flagship built from what it wrote
# ---------------------------------------------------------------------------


def quiet(fn):
    """``fn()`` with its standard output captured (every line of this
    script's own is one JSON object); returns (seconds, result, text)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return time.perf_counter() - t0, out, buf.getvalue()


def rigid_object(root: Path) -> dict:
    """``create_rigid_phystwin.main`` on a push-T block (two boxes,
    ``testing.make_t_block``) with ``--spring_Y 2e3``, the flagship rope's
    stiffness, and the other flags at their defaults. Gate: the checkpoint
    read back through physics/checkpoints.py has the counts the tool
    printed."""
    import re

    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.experiments.utils import create_rigid_phystwin
    from real2sim_eval_tpu_torch.physics import checkpoints as ckpt_io
    from real2sim_eval_tpu_torch.utils.mesh import save_obj

    out_dir = root / "rigid"
    out_dir.mkdir(parents=True)
    save_obj(tt.make_t_block(), out_dir / "T.obj")
    seconds, _, text = quiet(lambda: create_rigid_phystwin.main(
        ["--mesh", str(out_dir / "T.obj"), "--out", str(out_dir),
         "--case", RIGID_CASE, "--spring_Y", "2e3"]))
    m = re.search(r"(\d+) points \((\d+) surface, (\d+) interior\), "
                  r"(\d+) springs", text)
    if m is None:
        fail(f"rigid_object: unexpected output {text!r}")
    n_pts, n_surf, n_int, n_springs = map(int, m.groups())
    data = ckpt_io.load_final_data(out_dir / "data", RIGID_CASE)
    first = ckpt_io.load_first_order(out_dir / "experiments", RIGID_CASE)
    points = np.asarray(data["object_points"])[0]
    out = {"phase": "rigid_object", "mesh": "push-T, two boxes",
           "spring_Y": 2e3, "spring_radius": 0.5, "max_neighbours": 50,
           "points": n_pts, "surface": n_surf, "interior": n_int,
           "springs": n_springs, "seconds": seconds,
           "read_back": {"points": int(points.shape[0]),
                         "springs": int(first["num_object_springs"]),
                         "spring_Y": float(np.max(first["spring_Y"]))}}
    emit(out)
    if (out["read_back"]["points"], out["read_back"]["springs"]) != (
            n_pts, n_springs) or n_pts != n_surf + n_int:
        fail(f"rigid_object: the checkpoint does not hold what the tool "
             f"wrote: {out}")
    return {"root": out_dir, "points": points}


def scan_pose() -> np.ndarray:
    """The raw scan's frame against the robot's: SCAN_YAW_DEG about z,
    then SCAN_SHIFT (m)."""
    a = np.deg2rad(SCAN_YAW_DEG)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                 [0.0, 0.0, 1.0]]
    T[:3, 3] = SCAN_SHIFT
    return T


def raw_scan(root: Path) -> dict:
    """A raw scan at the flagship's width (``testing.make_raw_scan``):
    N_TABLE table splats over make_synthetic_scene's extent, 2,000 splats
    on each of the built-in arm's ten collision surfaces at the canonical
    pose (another sample than construct_scene's), all moved by
    ``scan_pose()``, with each splat's true link id. The alignment crop is
    the robot splats' box in the scan's frame, padded by SCAN_CROP_PAD."""
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.utils.gs_processor import GSProcessor

    path = root / "raw_scan.ply"
    t0 = time.perf_counter()
    ids = tt.make_raw_scan(path, scan_pose(), n_table=N_TABLE,
                           seed=SCAN_SEED)
    write_s = time.perf_counter() - t0
    means = GSProcessor().load(path)["means3D"]
    robot = means[ids > 0]
    lo, hi = robot.min(0) - SCAN_CROP_PAD, robot.max(0) + SCAN_CROP_PAD
    crop = [float(v) for pair in zip(lo, hi) for v in pair]
    in_crop = np.all((means > lo) & (means < hi), axis=1)
    links, counts = np.unique(ids[ids > 0], return_counts=True)
    emit({"phase": "raw_scan", "splats": int(len(ids)),
          "table": int((ids < 0).sum()), "robot": int((ids > 0).sum()),
          "per_link": dict(zip(map(str, links.tolist()), counts.tolist())),
          "scan_yaw_deg": SCAN_YAW_DEG, "scan_shift_m": list(SCAN_SHIFT),
          "crop": crop, "splats_in_crop": int(in_crop.sum()),
          "table_in_crop": int((in_crop & (ids < 0)).sum()),
          "write_s": write_s, "bytes": path.stat().st_size})
    return {"path": path, "ids": ids, "crop": crop}


def transform_error(src: np.ndarray, dst: np.ndarray,
                    T_true: np.ndarray) -> tuple[float, float]:
    """The rigid transform taking ``src`` to ``dst`` (Kabsch) against
    ``T_true``: rotation error in degrees, translation error in mm."""
    from real2sim_eval_tpu_torch.utils.icp import _kabsch

    T = _kabsch(src.astype(np.float64), dst.astype(np.float64))
    dR = T[:3, :3].T @ T_true[:3, :3]
    cos = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.degrees(np.arccos(cos))),
            float(1e3 * np.linalg.norm(T[:3, 3] - T_true[:3, 3])))


def construct_scene(root: Path, scan: dict) -> dict:
    """``construct_scene.main`` on the raw scan with ``--crop``,
    ``--visualize`` and ``--device``, GRIPPER_LINKS patched to the
    built-in arm's ten collision links (``testing.SCAN_LINKS``: the
    constants name the xArm's, which simple_arm.urdf lacks). Gates: the
    scan->robot transform against the known one (ALIGN_ROT_DEG,
    ALIGN_TRANS_MM); the share of robot splats labelled with their true
    link (TRUE_ID_SHARE); no table splat labelled robot; one K1 launch
    for an 848x480 finite preview that differs from the preview at the
    canonical pose; K1's preview frame bitwise its plain version."""
    import cv2
    import torch

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.experiments.utils import construct_scene as cs
    from real2sim_eval_tpu_torch.kinematics.robot import CANONICAL_ARM_QPOS
    from real2sim_eval_tpu_torch.renderer import raster
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
    from real2sim_eval_tpu_torch.utils.gs_processor import GSProcessor

    out_ply, mask_path = root / "scene.ply", root / "scene_mask.npy"
    preview = root / "preview.png"
    acc = {}
    seen, undo_k1 = capture(raster, "rasterize_tiles_batch")
    undo = [undo_k1,
            patch(cs, "GRIPPER_LINKS", lambda _: list(tt.SCAN_LINKS)),
            patch(cs, "articulate_preview", stage_timer(acc, "preview"))]
    ext.reset_launch_counts()
    try:
        seconds, _, text = quiet(lambda: cs.main(
            ["--scan", str(scan["path"]), "--out", str(out_ply),
             "--mask", str(mask_path), "--urdf", tt.BUILTIN_URDF,
             "--crop", *map(str, scan["crop"]),
             "--visualize", str(preview), "--device", DEVICE]))
    finally:
        for u in reversed(undo):
            u()
    launches = dict(ext.LAUNCHES)

    sp = GSProcessor()
    raw = sp.load(scan["path"])["means3D"]
    scene = sp.load(out_ply)
    mask = np.load(mask_path)
    ids = scan["ids"]
    rot_deg, trans_mm = transform_error(raw, scene["means3D"],
                                        np.linalg.inv(scan_pose()))
    robot = ids > 0
    # the preview at the canonical pose the scan was taken in
    canon = root / "preview_canonical.png"
    quiet(lambda: cs.articulate_preview(
        scene, mask, tt.BUILTIN_URDF, np.degrees(CANONICAL_ARM_QPOS),
        cs.BASE_GRIPPER_COUNTS, canon, device=DEVICE))
    img, img_canon = cv2.imread(str(preview)), cv2.imread(str(canon))
    # K1 again on the preview's inputs: the gate below holds it bitwise
    # the frame the preview was made from
    args = seen["args"]
    rgb, depth = tk.rasterize_tiles_batch(*args)
    out = {"phase": "construct_scene",
           "gripper_links_patched_to": list(tt.SCAN_LINKS),
           "flags": ["--crop", "--visualize", "--device", DEVICE],
           "rotation_err_deg": rot_deg, "translation_err_mm": trans_mm,
           "robot_splats_found": int((mask >= 0).sum()),
           "robot_splats_true": int(robot.sum()),
           "true_id_share": float((mask[robot] == ids[robot]).mean()),
           "robot_unlabelled": int((mask[robot] < 0).sum()),
           "table_labelled_robot": int((mask[~robot] >= 0).sum()),
           "ids": sorted(set(np.unique(mask).tolist())),
           "preview_ms": acc["preview"], "preview_shape": list(img.shape),
           "preview_k1_launches": launches["tile_composite"],
           "preview_pixels_moved_from_canonical": int(
               (img != img_canon).any(axis=2).sum()),
           "seconds": seconds, "log": text.strip().splitlines()}
    emit(out)
    if rot_deg > ALIGN_ROT_DEG or trans_mm > ALIGN_TRANS_MM:
        fail(f"construct_scene: the alignment is off by {rot_deg} deg, "
             f"{trans_mm} mm")
    if out["true_id_share"] < TRUE_ID_SHARE or out["table_labelled_robot"]:
        fail(f"construct_scene: the segmentation is wrong: {out}")
    if (tuple(img.shape) != (480, 848, 3)
            or out["preview_k1_launches"] != 1
            or not (bool(torch.isfinite(rgb).all())
                    and bool(torch.isfinite(depth).all()))
            or not out["preview_pixels_moved_from_canonical"]):
        fail(f"construct_scene: bad preview: {out}")
    gate_vs_plain("construct_scene_k1", {"phase": "construct_scene_k1",
                                         "pairs": int(args[0].shape[1])},
                  (rgb, depth), tk.composite_tiles_plain(*args),
                  tk.rasterize_tiles_batch(args[0], args[1], args[1],
                                           *args[3:]), bitwise=True)
    return {"ply": out_ply, "mask": mask_path, "preview": preview,
            "robot_rows": int((mask > 0).sum()),
            "splats": int(len(mask))}


def scan_views(root: Path, scene: dict) -> None:
    """``visualize_scan.main`` over the constructed scene with ``--out``,
    ``--splat`` and ``--device``. Gates: four 640x480 PNGs from four K1
    launches, a .splat of 32 bytes a splat, and K1's frame of the first
    view bitwise its plain version."""
    import cv2

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.experiments.utils import visualize_scan
    from real2sim_eval_tpu_torch.renderer import raster
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    views, splat = root / "scan_views", root / "scene.splat"
    seen, undo = capture(raster, "rasterize_tiles_batch")
    ext.reset_launch_counts()
    try:
        seconds, _, _ = quiet(lambda: visualize_scan.main(
            [str(scene["ply"]), "--out", str(views), "--splat", str(splat),
             "--device", DEVICE]))
    finally:
        undo()
    launches = dict(ext.LAUNCHES)
    shapes = [list(cv2.imread(str(p)).shape)
              for p in sorted(views.glob("*.png"))]
    out = {"phase": "scan_views", "views": shapes,
           "k1_launches": launches["tile_composite"],
           "splat_bytes": splat.stat().st_size,
           "splat_bytes_expected": 32 * scene["splats"], "seconds": seconds}
    emit(out)
    if (shapes != [[480, 640, 3]] * 4 or out["k1_launches"] != 4
            or out["splat_bytes"] != out["splat_bytes_expected"]):
        fail(f"scan_views: {out}")
    args = seen["args"]
    gate_vs_plain("scan_views_k1", {"phase": "scan_views_k1", "view": 0,
                                    "pairs": int(args[0].shape[1])},
                  tk.rasterize_tiles_batch(*args),
                  tk.composite_tiles_plain(*args),
                  tk.rasterize_tiles_batch(args[0], args[1], args[1],
                                           *args[3:]), bitwise=True)


def color_alignment(root: Path, scene: dict) -> dict:
    """``color_alignment.main`` with the preview as the sim image and, as
    the real one, the preview under a known quadratic colour map (A2, A1, b
    of tests/test_tools.py), stored as 8-bit, with COLOR_OUTLIERS of its
    pixels replaced by seeded noise. The map takes the brightest reds past
    1, which an 8-bit image clips: ``--mask`` leaves those pixels out, as a
    user masks saturated ones. Gate: the printed map reproduces the clean
    pixels (inside the mask, not replaced) within COLOR_TOL
    (tests/test_tools.py's outlier case)."""
    import re

    import cv2

    from real2sim_eval_tpu_torch.experiments.utils import (
        color_alignment as ca)

    sim = cv2.imread(str(scene["preview"]))[:, :, ::-1] / 255.0
    A2, A1 = np.diag([0.2, -0.1, 0.15]), np.diag([0.8, 0.9, 0.7])
    b = np.array([0.05, 0.0, 0.03])
    flat = sim.reshape(-1, 3)
    real = flat ** 2 @ A2.T + flat @ A1.T + b
    unsaturated = (real <= 1.0).all(axis=1)
    rng = np.random.default_rng(0)
    n_bad = int(COLOR_OUTLIERS * len(flat))
    bad = rng.choice(len(flat), n_bad, replace=False)
    real[bad] = rng.random((n_bad, 3))
    real_u8 = np.round(np.clip(real, 0, 1) * 255).astype(np.uint8)
    real_png, mask_png = root / "real.png", root / "real_mask.png"
    cv2.imwrite(str(real_png), real_u8.reshape(sim.shape)[:, :, ::-1])
    cv2.imwrite(str(mask_png), (unsaturated.reshape(sim.shape[:2])
                                * 255).astype(np.uint8))
    seconds, _, text = quiet(lambda: ca.main(
        ["--sim", str(scene["preview"]), "--real", str(real_png),
         "--mask", str(mask_png)]))
    nums = [float(v) for v in re.findall(r"-?\d+\.\d+", text.split(
        "color_A:")[1])]
    A_fit, b_fit = np.array(nums[:18]).reshape(3, 6), np.array(nums[18:21])
    clean = np.setdiff1d(np.where(unsaturated)[0], bad)
    fitted = ca.apply_color_transform(flat[clean], A_fit, b_fit)
    err = float(np.abs(fitted - real_u8[clean] / 255.0).max())
    out = {"phase": "color_alignment", "pixels": int(len(flat)),
           "outliers": n_bad, "saturated": int((~unsaturated).sum()),
           "clean": int(len(clean)), "max_abs_err_clean": err,
           "tol": COLOR_TOL, "yaml": text.strip().splitlines(),
           "seconds": seconds}
    emit(out)
    if err > COLOR_TOL:
        fail(f"color_alignment: the fitted map misses the clean pixels by "
             f"{err}")
    return {"color_A": A_fit.reshape(-1).tolist(),
            "color_b": b_fit.tolist()}


def write_constructed_config(root: Path, rigid: dict, scene: dict,
                             color: dict):
    """write_flagship_config's flagship with what the tools wrote: the
    constructed scan and mask with the fitted colour map as ``gs.scene``;
    the rigid object's splats as ``gs.object`` (the fixture writer with
    the checkpoint's points as bones and N_OBJ_DENSE body splats); the
    rigid checkpoint as the physics case, with the tool's spring radius
    and neighbour count as the loader's (``object_radius``,
    ``object_max_neighbours``), so that it rebuilds the same springs."""
    from real2sim_eval_tpu_torch import testing as tt

    gs = tt.make_synthetic_scene(root / "object", rope_pts=rigid["points"],
                                 n_obj_dense=N_OBJ_DENSE)
    gs["use_grid_randomization"] = True
    gs["scene"] = dict(table_splat_path=str(scene["ply"]),
                       total_mask_path=str(scene["mask"]), **color)
    return tt.full_cfg(rigid["root"], RIGID_CASE, gs=gs, cameras=tt.CAMERAS,
                       physics_over=dict(dt=5e-5, self_collision=True,
                                         object_radius=0.5,
                                         object_max_neighbours=50))


def constructed_flagship(root: Path, rigid: dict, scene: dict, color: dict,
                         bare_rate: float) -> None:
    """``BatchedEvaluator(cfg, range(64))`` from write_constructed_config,
    then TIMED_STEPS_CONSTRUCTED timed steps and renders through run_path
    and its gates, beside cfg_flagship's rate in this call. K3's and K2's
    inputs are captured from one more step and render and each kernel is
    held against its plain version there: K3 on the rigid lattice
    (check_k3 "constructed"), K2 bitwise on dirty tiles that hold the
    articulated robot splats. Then the stage breakdown with the robot
    rows' articulation as its own stage. Gates besides run_path's and the
    kernels': robot rows = the mask's ids > 0; one K3 and one K2 launch a
    step; the object's springs finite in every step sampled (the last
    timed one, the captured one and the breakdown's, each read after its
    step returned)."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics import fused_step
    from real2sim_eval_tpu_torch.renderer import incremental
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    cfg = write_constructed_config(root, rigid, scene, color)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev = BatchedEvaluator(cfg, list(range(B_FLAGSHIP)), device=DEVICE)
    sync()
    build_s = time.perf_counter() - t0
    p = ev.assets.params
    i, j = p.springs[:, 0].long(), p.springs[:, 1].long()

    def strain() -> float:
        x = ev.state.sm.x
        return float(((x[:, i] - x[:, j]).norm(dim=-1) / p.rest_lengths
                      - 1.0).abs().max())

    actions = flagship_actions()
    launches, out = run_path(
        "constructed_flagship", ev, actions, TIMED_STEPS_CONSTRUCTED,
        ("spring_mass_step", "tile_sparse", "tile_composite"), build_s)
    strains = [strain()]

    k3_seen, undo3 = capture(fused_step, "spring_mass_step")
    k2_seen, undo2 = capture(incremental, "rasterize_tiles_sparse")
    try:
        ev.step(actions)
        ev.render()
    finally:
        undo2()
        undo3()
    strains.append(strain())
    opts, tab, state = k3_seen["args"]
    check_k3("constructed", opts, tab, state,
             spring_records=(int(tab.records.records.shape[0])
                             if tab.records is not None else None))
    args2 = k2_seen["args"]
    gate_vs_plain("constructed_k2", {"phase": "constructed_k2",
                                     "envs": B_FLAGSHIP, "cameras": 2,
                                     "dirty_tiles": int(args2[1].numel())},
                  tk.rasterize_tiles_sparse(*args2),
                  tk.composite_sparse_plain(*args2),
                  tk.copy_frames(args2[-5], args2[-4]), bitwise=True)
    del k3_seen, k2_seen, opts, tab, state, args2

    (step_ms, _, render_ms), stages = stamped_stages(
        [lambda: ev.step(actions), lambda: strains.append(strain()),
         ev.render])
    n = BREAKDOWN_REPS
    robot_rows = int(ev._robot_rows.shape[0])
    res = {"phase": "constructed_flagship_summary", "build_s": build_s,
           "env_steps_per_s": out["env_steps_per_s"],
           "cfg_flagship_env_steps_per_s": bare_rate,
           "physics_ms": out["physics_ms"], "render_ms": out["render_ms"],
           "gaussians_per_env": out["gaussians_per_env"],
           "particles": int(ev.state.sm.x.shape[1]),
           "springs": int(p.springs.shape[0]),
           "robot_rows": robot_rows, "mask_ids_over_0": scene["robot_rows"],
           "robot_row_share_of_gaussians": robot_rows
           / out["gaussians_per_env"],
           "dirty_tiles_per_camera": out["dirty_tiles_per_camera"],
           "max_memory_allocated_bytes": out["max_memory_allocated_bytes"],
           "launches": launches,
           "max_spring_strain_sampled_steps": strains,
           "breakdown_reps": n, "breakdown_step_ms": step_ms,
           "breakdown_render_ms": render_ms, "breakdown_stages_ms": stages}
    emit(res)
    if robot_rows != scene["robot_rows"] or not robot_rows:
        fail(f"constructed_flagship: {robot_rows} robot rows, the mask has "
             f"{scene['robot_rows']}")
    steps = TIMED_STEPS_CONSTRUCTED
    if launches["spring_mass_step"] != steps or launches["tile_sparse"] != steps:
        fail(f"constructed_flagship: not one K3 and one K2 launch a step: "
             f"{launches}")
    if not np.isfinite(strains).all():
        fail("constructed_flagship: the object's springs are not finite")


def scene_tools(root: Path, bare_rate: float) -> None:
    """The scene- and asset-building tools on the card at the flagship's
    width, then a 64-lane evaluator built from what they wrote."""
    rigid = rigid_object(root)
    scan = raw_scan(root)
    scene = construct_scene(root, scan)
    scan_views(root, scene)
    color = color_alignment(root, scene)
    constructed_flagship(root, rigid, scene, color, bare_rate)


# ---------------------------------------------------------------------------
# the rest of the tools: the native PLY reader, the online viewer and the
# debug image dump, the component profiler, the multi-device fan-out and
# the stage trace
# ---------------------------------------------------------------------------


def ply_native(cfg) -> None:
    """Both PLY readers, the C++ one (ctypes) and the numpy one, on the
    config-built flagship's table scan and body PLY. Gate: the tables are
    bitwise equal. Host ms: each reader's first read and the mean of the
    next PLY_READS - 1."""
    from real2sim_eval_tpu_torch.utils import ply

    out = {"phase": "ply_native", "reads": PLY_READS}
    for name, path in (("table", cfg.gs.scene.table_splat_path),
                       ("body", cfg.gs.object.path)):
        tables, ms = {}, {}
        for reader, fn in (("native", ply.read_ply_vertex_table_native),
                           ("numpy", ply.read_ply_vertex_table)):
            ms[reader] = []
            for _ in range(PLY_READS):
                t0 = time.perf_counter()
                tables[reader] = fn(path)
                ms[reader].append((time.perf_counter() - t0) * 1e3)
        a, b = tables["native"], tables["numpy"]
        bitwise = list(a) == list(b) and all(
            a[k].dtype == b[k].dtype == np.float32
            and np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32))
            for k in a)
        out[name] = {"splats": int(len(b["x"])), "properties": len(b),
                     "bytes": Path(path).stat().st_size, "bitwise": bitwise,
                     **{f"{r}_first_ms": v[0] for r, v in ms.items()},
                     **{f"{r}_ms": float(np.mean(v[1:]))
                        for r, v in ms.items()}}
        if not bitwise:
            fail(f"ply_native: the readers' {name} tables differ")
    emit(out)


def u8_frame(im) -> np.ndarray:
    """A (3, H, W) frame as the viewer's uint8 (H, W, 3) image."""
    return (im.cpu().numpy().transpose(1, 2, 0) * 255).astype(np.uint8)


def online_render(cfg, root: Path) -> None:
    """``GSRenderer`` with ``online: true`` (the viewer on a free port) on
    the flagship's config, one env after a reset: ``render_online`` twice
    at the renderer's 848x480 camera, ``set_orbit`` moving the viewer's
    camera between; then the debug dump ``reset_state(visualize_image=
    True)`` in a directory of its own. Gates: each viewer image equals
    ``render(camera=...)`` on the same camera bitwise, the second differs
    from the first, K1 launched by each; both PNGs written, ``test.png``
    bitwise the frame."""
    import os

    import cv2

    from real2sim_eval_tpu_torch import envs, ext
    from real2sim_eval_tpu_torch.config import ConfigNode

    c = ConfigNode(copy.deepcopy(cfg.to_dict()))
    c.online = True
    c.viser_port = 0
    env = envs.make("BaseEnv-v0", cfg=c, randomize=True, device=DEVICE)
    env.reset(seed=3)
    r = env.unwrapped.renderer
    v = r.viser_viewer
    try:
        m = r.metadata
        v.set_metadata(m["w"], m["h"], m["k"], m["w2c"])
        frames, same, ms, k1 = [], [], [], []
        for orbit in (None, (0.8, 0.5, 1.0)):
            if orbit:
                v.set_orbit(*orbit)
            ext.reset_launch_counts()
            t, _ = time_host(r.render_online)
            k1.append(ext.LAUNCHES["tile_composite"])
            ms.append(t)
            frames.append(v._frame.copy())
            meta = v.get_metadata()
            ref = u8_frame(r.render(camera=[meta["w"], meta["h"], meta["k"],
                                            meta["w2c"]])[0])
            same.append(bool(np.array_equal(frames[-1], ref)))
        moved = not np.array_equal(frames[0], frames[1])
        dump = root / "debug_dump"
        dump.mkdir()
        cwd = os.getcwd()
        os.chdir(dump)
        try:
            dump_ms, _ = time_host(lambda: r.reset_state(visualize_image=True))
        finally:
            os.chdir(cwd)
        written = sorted(p.name for p in dump.iterdir())
        png = cv2.imread(str(dump / "test.png"))
        dump_bitwise = png is not None and np.array_equal(
            png, u8_frame(r.render()[0])[:, :, ::-1])
    finally:
        v.close()
    emit({"phase": "online_render", "size": [int(m["w"]), int(m["h"])],
          "gaussians": int(r.rendervar_full["means3D"].shape[0]),
          "render_online_ms": ms, "viewer_bitwise_render": same,
          "orbit_moved_frame": moved,
          "k1_launches_each": k1, "debug_dump_ms": dump_ms,
          "debug_dump_files": written,
          "debug_dump_bitwise_frame": dump_bitwise})
    if not all(same):
        fail(f"online_render: the viewer's image differs from render(): "
             f"{same}")
    if not moved:
        fail("online_render: the orbit did not change the viewer's image")
    if min(k1) < 1:
        fail(f"online_render: K1 launched {k1} times by the two calls")
    if written != ["test.png", "test_depth.png"] or not dump_bitwise:
        fail(f"online_render: the debug dump wrote {written}, test.png "
             f"bitwise the frame: {dump_bitwise}")


def profile_physics_phase() -> None:
    """``profile_physics``' physics ablation (8 envs, a 1000-particle
    rope, 667 substeps, four variants) and its render ablation (31,000
    gaussians, 848x480), called as functions. Gates: K3 launched by every
    call of every variant, K1 by every full rasterize; each variant's
    control step, captured from one more call, against K3's plain version
    (``check_k3``, cases ``profile_*``: without self-collision K3 runs
    with no self-collision table, without colliders with no contact
    table); the full rasterize's K1 frame bitwise its plain version."""
    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.experiments.utils import profile_physics as pp
    from real2sim_eval_tpu_torch.physics import fused_step
    from real2sim_eval_tpu_torch.renderer import raster
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    ext.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        phys = pp.profile_physics(batch=PROFILE_BATCH, n=PROFILE_PARTICLES,
                                  substeps=PROFILE_SUBSTEPS, device=DEVICE)
    k3 = ext.LAUNCHES["spring_mass_step"]
    ext.reset_launch_counts()
    k1_seen, undo = capture(raster, "rasterize_tiles_batch")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rend = pp.profile_render(device=DEVICE)
    finally:
        undo()
    k1 = ext.LAUNCHES["tile_composite"]
    emit({"phase": "profile_physics", "batch": PROFILE_BATCH,
          "particles": PROFILE_PARTICLES, "substeps": PROFILE_SUBSTEPS,
          "physics": phys, "render": rend, "k3_launches": k3,
          "k1_launches": k1})
    want_k3 = sum(1 + row["iters"] for row in phys)
    if k3 != want_k3:
        fail(f"profile_physics: K3 launched {k3} times, not {want_k3}")
    if k1 != 1 + rend[-1]["iters"]:
        fail(f"profile_physics: K1 launched {k1} times in the full "
             "rasterize")
    inp = pp.physics_inputs(pp.profile_scene(PROFILE_BATCH,
                                             PROFILE_PARTICLES), DEVICE)
    for name, self_c, has_c in pp.VARIANTS:
        step = pp.variant_step(PROFILE_SUBSTEPS, DEVICE, self_c, has_c)
        seen, undo = capture(fused_step, "spring_mass_step")
        try:
            step(inp["params"], inp["colliders"] if has_c else None,
                 inp["state"], inp["ctrl"], inp["rest_x"])
        finally:
            undo()
        check_k3(f"profile_{name}", *seen["args"][:3], variant=name)
    args = k1_seen["args"]
    gate_vs_plain("profile_render_k1", {"phase": "profile_render_k1",
                                        "pairs": int(args[0].shape[1])},
                  tk.rasterize_tiles_batch(*args),
                  tk.composite_tiles_plain(*args),
                  tk.rasterize_tiles_batch(args[0], args[1], args[1],
                                           *args[3:]), bitwise=True)


@contextlib.contextmanager
def stdout_to_stderr():
    """This process's standard output, and that of the processes it
    starts, sent to standard error (every line of this script's own
    standard output is one JSON object)."""
    import os

    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def tree_gap(a, b) -> tuple:
    """(leaves, leaves not bitwise equal) of two unpickled state trees."""
    import torch

    if isinstance(a, dict):
        parts = [tree_gap(a[k], b[k]) for k in a] if a.keys() == b.keys() \
            else [(1, 1)]
    elif isinstance(a, (list, tuple)):
        parts = [tree_gap(u, w) for u, w in zip(a, b)]
    elif torch.is_tensor(a):
        return 1, int(not (a.dtype == b.dtype and torch.equal(a, b)))
    elif isinstance(a, np.ndarray):
        return 1, int(not np.array_equal(a, b))
    else:
        return 1, int(a != b)
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


def fan_out(cfg, root: Path) -> None:
    """``eval_policy_parallel.main`` on the CLI scene of cli_batched at
    FAN_BATCHES batches of FAN_LANES lanes (30 control steps): two spawned
    workers on the one card, then one worker (this process). Gates: the
    same files; JSONs, calibrations and markers byte for byte;
    ``hydra.yaml`` apart from the run name; the pickled particles
    (``renderer.x``) bitwise; the JPEG frames within 1 level. A failed
    worker raises here."""
    import pickle

    import cv2

    from real2sim_eval_tpu_torch.config import ConfigNode
    from real2sim_eval_tpu_torch.experiments import eval_policy_parallel as epp

    c = ConfigNode(copy.deepcopy(cfg.to_dict()))
    c.gs.use_grid_randomization = False
    c.exp_root = str(root / "fan_log")
    c.env.sim.duration = CLI_DURATION
    c.raster_backend = "auto"
    c.batch_size = FAN_LANES
    c.episode_start = 0
    c.checkpoint_every = CLI_CHECKPOINT_EVERY
    c.telemetry_every = CLI_TELEMETRY_EVERY
    c.policy = dict(builtin="hold", n_episodes=FAN_LANES * FAN_BATCHES,
                    inference_cfg_path=None, checkpoint_path=None)
    card = f"{DEVICE}:0"
    runs, walls = {}, {}
    for name, devices in (("two_workers", [card, card]),
                          ("one_worker", [card])):
        run_cfg = ConfigNode(copy.deepcopy(c.to_dict()))
        run_cfg.timestamp = f"fan_{name}"
        t0 = time.perf_counter()
        with stdout_to_stderr():
            runs[name] = Path(epp.main(run_cfg, devices=devices))
        walls[name] = time.perf_counter() - t0
    one, two = runs["one_worker"], runs["two_workers"]
    names, _ = written(one)
    same_files = names == written(two)[0]
    gaps = {"bytes_differ": [], "jpg_max_gap": 0, "jpg_bytes_differ": 0,
            "particles_differ": [], "pickle_leaves": 0,
            "pickle_leaves_differ": 0, "videos_bytes_differ": 0}
    for f in sorted(names & written(two)[0]):
        a, b = one / f, two / f
        if f.endswith(".jpg"):
            if a.read_bytes() != b.read_bytes():
                gaps["jpg_bytes_differ"] += 1
                gap = np.abs(cv2.imread(str(a)).astype(int)
                             - cv2.imread(str(b)).astype(int)).max()
                gaps["jpg_max_gap"] = max(gaps["jpg_max_gap"], int(gap))
        elif f.endswith(".mp4"):
            gaps["videos_bytes_differ"] += a.read_bytes() != b.read_bytes()
        elif f.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                sa, sb = pickle.load(fa), pickle.load(fb)
            n, d = tree_gap(sa, sb)
            gaps["pickle_leaves"] += n
            gaps["pickle_leaves_differ"] += d
            if not (sa["renderer"]["x"].dtype == sb["renderer"]["x"].dtype
                    and np.array_equal(sa["renderer"]["x"].numpy(),
                                       sb["renderer"]["x"].numpy())):
                gaps["particles_differ"].append(f)
        elif f == "hydra.yaml":
            keep = [[ln for ln in p.read_text().splitlines()
                     if not ln.startswith("timestamp:")] for p in (a, b)]
            if keep[0] != keep[1]:
                gaps["bytes_differ"].append(f)
        elif a.read_bytes() != b.read_bytes():
            gaps["bytes_differ"].append(f)
    n_steps = int(c.physics.fps) * CLI_DURATION
    episodes = FAN_LANES * FAN_BATCHES
    expected = episode_paths(episodes, len(c.env.cameras), n_steps) | {
        f"batch_{i * FAN_LANES:05d}.done" for i in range(FAN_BATCHES)}
    emit({"phase": "fan_out", "batches": FAN_BATCHES, "lanes": FAN_LANES,
          "control_steps": n_steps, "devices_two_workers": [card, card],
          "wall_s": walls, "files": len(names), "same_files": same_files,
          "layout_ok": names == expected,
          "episode_steps_per_s": {k: episodes * n_steps / v
                                  for k, v in walls.items()},
          **{k: (v[:5] if isinstance(v, list) else v)
             for k, v in gaps.items()}})
    if not same_files or names != expected:
        fail("fan_out: the two runs wrote other files than each other or "
             "than the reference's layout")
    if gaps["bytes_differ"] or gaps["particles_differ"]:
        fail(f"fan_out: files differ: {gaps['bytes_differ'][:5]}, "
             f"particles {gaps['particles_differ'][:5]}")
    if gaps["jpg_max_gap"] > 1:
        fail(f"fan_out: frames differ by {gaps['jpg_max_gap']} levels")


def trace_stages(ev, ev_f, actions, profiles: dict) -> None:
    """``trace_step``'s trace and parse on the flagship evaluators, wide
    and fine: TRACE_ITERS step + render pairs under ``torch.profiler``
    with every stage named, each kernel attributed to the stage around
    its launch. Gates: the card's events are read; under 5 % of device
    time unattributed; each IK solve is one kernel (two a step)."""
    from real2sim_eval_tpu_torch.experiments.utils import trace_step

    for path, e in (("flagship", ev), ("flagship_fine", ev_f)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            table, wall, _ = trace_step.trace(e, actions, "both",
                                              TRACE_ITERS, d)
        n = TRACE_ITERS
        unattributed = (table.by_stage.get(trace_step.UNATTRIBUTED, 0.0)
                        / max(table.total_us, 1e-9))
        top = max(table.counts, key=table.counts.get)
        per_stage: dict = {}
        for (stage, name), us in table.by_op.most_common():
            if len(per_stage.setdefault(stage, [])) < 3:
                per_stage[stage].append([name[:60], us / 1e3 / n])
        emit({"phase": "trace_step", "path": path, "iters": n,
              "source": table.source, "events": table.n_events,
              "seconds": time.perf_counter() - t0, "traced_wall_ms": wall,
              "device_ms": table.total_us / 1e3 / n,
              "device_profile_device_ms": profiles[path]["device_ms"],
              "unattributed_share": unattributed,
              "most_kernels": top,
              "stages_ms": {k: v / 1e3 / n
                            for k, v in table.by_stage.most_common()},
              "kernels_per_stage": {k: v / n for k, v in
                                    table.counts.most_common()},
              "top_ops_ms": per_stage})
        if table.source != "device":
            fail(f"trace_step {path}: the trace holds no device events")
        if unattributed >= TRACE_UNATTRIBUTED:
            fail(f"trace_step {path}: {unattributed:.1%} of the device time "
                 "is outside every stage")
        if table.counts.get("IK", 0) != 2 * n:
            fail(f"trace_step {path}: the IK launched "
                 f"{table.counts.get('IK', 0)} kernels in {n} steps, not "
                 "one a solve")


def device_profiles(runs) -> dict:
    """The device's busy share and heaviest operations of each path: for
    each (path, fn, timed units in fn, the unit's unprofiled ms) one
    ``device_profile`` of fn. They run after every host-timed phase: host
    work timed after a ``torch.profiler`` session in the same process can
    run slower (PERF.md, Findings), so only the control path that measures
    that follows them."""
    out = {}
    for path, fn, n_units, unit_ms in runs:
        prof = out[path] = device_profile(fn)
        emit({"phase": "device_profile", "path": path, **prof,
              # over the unprofiled unit (the profiler slows the host, not
              # the device)
              "device_busy_share": prof["device_ms"] / n_units / unit_ms})
    return out


def measure_kernels(ev, ev_s, actions, launches, launches_s):
    """Each kernel at the shapes the main paths give it: its inputs are
    captured from one more flagship step and render (K3, K1, K2) and one
    more stream render (K6), then the kernel, its plain version and the
    least time the card could take are measured. K2's and K6's times are
    of the kernel alone, into preallocated frames (no cache copy)."""
    import torch

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.physics import fused_step
    from real2sim_eval_tpu_torch.physics import spring_mass as sm
    from real2sim_eval_tpu_torch.renderer import incremental, raster
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    k3_seen, undo3 = capture(fused_step, "spring_mass_step")
    k1_seen, undo1 = capture(raster, "rasterize_tiles_batch")
    k2_seen, undo2 = capture(incremental, "rasterize_tiles_sparse")
    k6_seen, undo6 = capture(incremental, "rasterize_tiles_sparse_merge")
    try:
        ev.step(actions)
        ev.render()
        ev_s.render()
    finally:
        for u in (undo6, undo2, undo1, undo3):
            u()
    sync()
    lib = ext.load()

    opts, tab, state = k3_seen["args"]
    # both launches, one CTA per env and the two-CTA cluster; the main
    # path's is K3's time
    k3_ranks_ms = {r: time_cuda(lambda r=r: fused_step.spring_mass_step(
        opts, tab, state, ranks=r), 3) for r in (1, 2)}
    k3_ms = k3_ranks_ms[fused_step.K3_RANKS]
    plain_ms, _ = time_host(lambda: sm.run_substeps_plain(opts, tab, state))
    k3_out = check_k3("flagship", opts, tab, state)
    k3_bound, k3_by = k3_bound_ms(opts, tab, state)
    k3 = {"name": "spring_mass_step", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/spring_mass_step.cu",
          "replaces": "real2sim_eval_tpu/physics/pallas_step.py:214",
          "launches": launches["spring_mass_step"],
          "max_abs_err": k3_out["max_abs"]["x"],
          "ms": k3_ms, "plain_ms": plain_ms, "bound_ms": k3_bound,
          "bound_by": k3_by, "library_ms": None}

    pairs, starts, ends, n_tx, n_ty = k1_seen["args"][:5]
    k1_ms = time_cuda(lambda: tk.rasterize_tiles_batch(pairs, starts, ends,
                                                       n_tx, n_ty), 10)
    rgb_k, dep_k, rgb_p, dep_p, k1_plain_ms = composite_both(
        pairs, starts, ends, n_tx, n_ty)
    tiles = torch.arange(starts.numel(), device=DEVICE) % starts.shape[1]
    w1 = pixel_pair_walks(pairs, starts.reshape(-1), ends.reshape(-1),
                          tiles, n_tx, boxes=WIDE_BOX)
    k1_bound, k1_by = k1_bound_ms(pairs, starts, rgb_k, w1["reaching"])
    k1 = {"name": "tile_composite", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/tile_composite.cu",
          "replaces": "real2sim_eval_tpu/renderer/tile_kernel.py:157",
          "launches": launches["tile_composite"],
          "max_abs_err": float((rgb_k - rgb_p).abs().max()),
          "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
          "bound_by": k1_by, "library_ms": None}
    flips = {"tile_composite": depth_flips(dep_k, dep_p)}
    limits = {"tile_composite": flips_limit(dep_k.numel())}
    k1_depth_diff = int((dep_k != dep_p).sum())
    inputs = {"tile_composite": {"instances": int(starts.shape[0]),
                                 "tiles": int(starts.numel()),
                                 "pairs": int(pairs.shape[1]),
                                 "pixel_pair_blends": w1["walks"],
                                 "reaching_blends": w1["reaching"],
                                 "evaluations": {
                                     "tile_level": w1["tile_evals"],
                                     "block_level": w1["box_evals"]["8x16"]}}}

    args2 = k2_seen["args"]
    m_pairs, inst, tile, m_st, m_en, rgb_c, dep_c, ntx, nty, bg = args2
    rgb_o, dep_o = tk.copy_frames(rgb_c, dep_c)
    k2_ms = time_cuda(lambda: lib.tile_sparse(
        m_pairs, inst, tile, m_st, m_en, ntx, nty, *bg, rgb_o, dep_o), 10)
    rgb_k, dep_k = tk.rasterize_tiles_sparse(*args2)
    k2_plain_ms, (rgb_p, dep_p) = time_host(
        lambda: tk.composite_sparse_plain(*args2))
    w2 = pixel_pair_walks(m_pairs, m_st, m_en, tile, ntx, boxes=WIDE_BOX)
    k2_depth_diff = int((dep_k != dep_p).sum())
    rows = int((m_en - m_st).sum())
    k2_bound, k2_by = sparse_bound_ms(rows, 4, int(inst.numel()),
                                      w2["reaching"])
    k2 = {"name": "tile_sparse", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/tile_sparse.cu",
          "replaces": "real2sim_eval_tpu/renderer/tile_kernel.py:176",
          "launches": launches["tile_sparse"],
          "max_abs_err": float((rgb_k - rgb_p).abs().max()),
          "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
          "bound_by": k2_by, "library_ms": None}
    flips["tile_sparse"] = depth_flips(dep_k, dep_p)
    limits["tile_sparse"] = flips_limit(dep_k.numel())
    inputs["tile_sparse"] = {"instances": int(rgb_k.shape[0]),
                             "dirty_tiles": int(inst.numel()),
                             "merged_pairs": rows,
                             "pixel_pair_blends": w2["walks"],
                             "reaching_blends": w2["reaching"],
                             "evaluations": {
                                 "tile_level": w2["tile_evals"],
                                 "block_level": w2["box_evals"]["8x16"]},
                             "depth_pixels_differing": k2_depth_diff}

    args6 = k6_seen["args"]
    data_s, data_d, inst, tile, ss, se, ds, de, rgb_c, dep_c = args6[:10]
    rgb_o, dep_o = tk.copy_frames(rgb_c, dep_c)
    k6_ms = time_cuda(lambda: lib.tile_sparse_merge(
        data_s, data_d, inst, tile, ss, se, ds, de, ntx, nty, *bg, rgb_o,
        dep_o), 10)
    rgb_k, dep_k = tk.rasterize_tiles_sparse_merge(*args6)
    k6_plain_ms, (rgb_p, dep_p) = time_host(
        lambda: tk.composite_sparse_merge_plain(*args6))
    merged, m_st, m_en = tk.merge_segments(data_s, ss, se, data_d, ds, de)
    # the merged order of K6 is K2's: K2 over the same merge, bitwise
    rgb_2, dep_2 = tk.rasterize_tiles_sparse(merged, inst, tile, m_st, m_en,
                                             rgb_c, dep_c, ntx, nty, bg)
    w6 = pixel_pair_walks(merged, m_st, m_en, tile, ntx, boxes=WIDE_BOX)
    k6_depth_diff = int((dep_k != dep_p).sum())
    rows = int((se - ss).sum() + (de - ds).sum())
    k6_bound, k6_by = sparse_bound_ms(rows, 6, int(inst.numel()),
                                      w6["reaching"])
    k6 = {"name": "tile_sparse_merge", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/tile_sparse_merge.cu",
          "replaces": "real2sim_eval_tpu/renderer/tile_kernel.py:533",
          "launches": launches_s["tile_sparse_merge"],
          "max_abs_err": float((rgb_k - rgb_p).abs().max()),
          "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound,
          "bound_by": k6_by, "library_ms": None}
    flips["tile_sparse_merge"] = depth_flips(dep_k, dep_p)
    limits["tile_sparse_merge"] = flips_limit(dep_k.numel())
    k6_vs_k2 = int(((rgb_k != rgb_2).any(dim=1) | (dep_k != dep_2)).sum())
    inputs["tile_sparse_merge"] = {"instances": int(rgb_k.shape[0]),
                                   "dirty_tiles": int(inst.numel()),
                                   "merged_pairs": rows,
                                   "pixel_pair_blends": w6["walks"],
                                   "reaching_blends": w6["reaching"],
                                   "evaluations": {
                                       "tile_level": w6["tile_evals"],
                                       "block_level": w6["box_evals"]["8x16"]},
                                   "depth_pixels_differing": k6_depth_diff,
                                   "differing_pixels_vs_k2": k6_vs_k2}
    inputs["spring_mass_step"] = {
        "envs": int(state.x.shape[0]), "particles": int(state.x.shape[1]),
        "neighbour_slots": int(tab.nbr_k.shape[1]),
        "spring_records": (int(tab.records.records.shape[0])
                           if tab.records is not None else None),
        "ms_by_ranks": {str(r): v for r, v in k3_ranks_ms.items()},
        "main_path_ranks": fused_step.K3_RANKS}
    emit({"phase": "kernel_inputs", "depth_flips": flips,
          "flips_limits": limits, **inputs})
    kernels = [k3, k1, k2, k6]
    if k1["max_abs_err"] or k1_depth_diff:
        fail(f"K1 is not bitwise its plain version at the wrist's shapes: "
             f"{k1}, {k1_depth_diff} depth pixels differ")
    if k2["max_abs_err"] or k2_depth_diff:
        fail(f"K2 is not bitwise its plain version at the flagship's "
             f"shapes: {k2}, {k2_depth_diff} depth pixels differ")
    if k6["max_abs_err"] or k6_depth_diff:
        fail(f"K6 is not bitwise its plain version at the flagship's "
             f"shapes: {k6}, {k6_depth_diff} depth pixels differ")
    for k in kernels[1:]:
        if (k["max_abs_err"] > RGB_TOL
                or flips[k["name"]] > limits[k["name"]]):
            fail(f"{k['name']} disagrees at the main path's shapes: {k}")
    if k6_vs_k2:
        fail("K6 and K2 disagree on the same merge")
    return kernels


def measure_fine_kernels(ev_f, actions, launches_f):
    """K4 and K5 at the fine flagship's shapes: their inputs captured from
    one more step and render (K4: the wrist's fine full pipeline; K5: the
    fixed cameras' dirty fine tiles), then each kernel, its plain version
    (both bitwise), the least time the card could take, the evaluations
    of the walk without and with the per-quadrant cull, and the split of
    each kernel's time between its 1 % heaviest tiles and the rest. K5's
    time is of the kernel and its tile order alone, into preallocated
    frames (no cache copy)."""
    import torch

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.renderer import fine_kernel as fk
    from real2sim_eval_tpu_torch.renderer import incremental_fine, raster
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    k4_seen, undo4 = capture(raster, "rasterize_fine_batch")
    k5_seen, undo5 = capture(incremental_fine, "rasterize_fine_sparse")
    try:
        ev_f.step(actions)
        ev_f.render()
    finally:
        undo5()
        undo4()
    sync()
    lib = ext.load()

    pairs, starts, ends, nsx, nsy = k4_seen["args"][:5]
    k4_ms = time_cuda(lambda: fk.rasterize_fine_batch(pairs, starts, ends,
                                                      nsx, nsy), 10)
    rgb_k, dep_k, rgb_p, dep_p, k4_plain_ms = composite_both(
        pairs, starts, ends, nsx, nsy, fine=True)
    tiles = torch.arange(starts.numel(), device=DEVICE) % starts.shape[1]
    w4 = pixel_pair_walks(pairs, starts.reshape(-1), ends.reshape(-1),
                          tiles, nsx * 8, tile_w=16, boxes=FINE_BOXES)
    k4_bound, k4_by = k1_bound_ms(pairs, starts, rgb_k, w4["reaching"])
    k4 = {"name": "fine_composite", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/fine_composite.cu",
          "replaces": "real2sim_eval_tpu/renderer/fine_kernel.py:78",
          "launches": launches_f["fine_composite"],
          "max_abs_err": float((rgb_k - rgb_p).abs().max()),
          "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
          "bound_by": k4_by, "library_ms": None}
    differing = {"fine_composite": int((dep_k != dep_p).sum())}
    per_inst = (ends - starts).sum(dim=1).float()
    inputs = {"fine_composite": {
        "instances": int(starts.shape[0]), "fine_tiles": int(starts.numel()),
        "pairs": int(pairs.shape[1]),
        "pairs_per_wrist_instance": {"mean": float(per_inst.mean()),
                                     "max": int(per_inst.max())},
        "longest_fine_tile": int((ends - starts).max()),
        **fine_evaluations(w4),
        "heaviest_tiles": heaviest_split(starts, ends, {
            "k4": lambda e: fk.rasterize_fine_batch(pairs, starts, e, nsx,
                                                    nsy)})}}

    args5 = k5_seen["args"]
    m_pairs, inst, tile, m_st, m_en, rgb_c, dep_c, nsx5, nsy5, bg = args5
    rgb_o, dep_o = tk.copy_frames(rgb_c, dep_c)

    def k5_alone(e):
        lib.fine_sparse(m_pairs, inst, tile, m_st, e,
                        tk.longest_first(m_st, e), nsx5 * 8, nsy5, *bg,
                        rgb_o, dep_o)

    k5_ms = time_cuda(lambda: k5_alone(m_en), 10)
    rgb_k, dep_k = fk.rasterize_fine_sparse(*args5)
    k5_plain_ms, (rgb_p, dep_p) = time_host(
        lambda: fk.composite_fine_sparse_plain(*args5))
    w5 = pixel_pair_walks(m_pairs, m_st, m_en, tile, nsx5 * 8, tile_w=16,
                          boxes=FINE_BOXES)
    rows = int((m_en - m_st).sum())
    k5_bound, k5_by = sparse_bound_ms(rows, 4, int(inst.numel()),
                                      w5["reaching"], tile_w=16)
    k5 = {"name": "fine_sparse", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/fine_sparse.cu",
          "replaces": "real2sim_eval_tpu/renderer/incremental_fine.py:218",
          "launches": launches_f["fine_sparse"],
          "max_abs_err": float((rgb_k - rgb_p).abs().max()),
          "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
          "bound_by": k5_by, "library_ms": None}
    differing["fine_sparse"] = int((dep_k != dep_p).sum())
    inputs["fine_sparse"] = {"instances": int(rgb_k.shape[0]),
                             "dirty_fine_tiles": int(inst.numel()),
                             "merged_pairs": rows, **fine_evaluations(w5),
                             "heaviest_tiles": heaviest_split(
                                 m_st, m_en, {"k5": k5_alone})}
    emit({"phase": "fine_kernel_inputs",
          "depth_pixels_differing": differing, **inputs})
    for k in (k4, k5):
        if k["max_abs_err"] or differing[k["name"]]:
            fail(f"{k['name']} is not bitwise its plain version at the main "
                 f"path's shapes: {k}, {differing[k['name']]} depth pixels "
                 "differ")
    return [k4, k5]


# ---------------------------------------------------------------------------
# the refinement path
# ---------------------------------------------------------------------------


def refinement_scene() -> dict:
    """Env 0 of the flagship scene (object 31,000, table 99,000, clip 120:
    130,120 gaussians) as raw 3DGS parameters (numpy): log scales, logit
    opacities and degree-3 SH, the DC from the scene and the 45 higher
    coefficients N(0, 0.05^2) from a seeded generator, as a real PLY."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.testing import make_flagship_assets
    from real2sim_eval_tpu_torch.utils.ply import coeffs_to_sh_colors

    a = make_flagship_assets(batch=1, n_table=N_TABLE,
                             n_obj_dense=N_OBJ_DENSE, device=DEVICE)
    ev = BatchedEvaluator(a, [0], device=DEVICE, raster_config=render_off())
    s = {k: v[0] for k, v in ev.compose(ev.state, dc_only=True)[0].items()}
    n = s["means3D"].shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    coeffs = torch.cat([s["shs"][:, :1], 0.05 * torch.randn(
        (n, 15, 3), generator=gen, device=DEVICE)], dim=1)
    o = s["opacities"].reshape(-1, 1)
    return {"means3D": s["means3D"].cpu().numpy(),
            "sh_colors": coeffs_to_sh_colors(coeffs.cpu().numpy()),
            "log_scales": torch.log(s["scales"]).cpu().numpy(),
            "unnorm_rotations": s["rotations"].cpu().numpy(),
            "logit_opacities": torch.log(o / (1.0 - o)).cpu().numpy()}


def refinement_views():
    """bench.py's two fixed cameras and six poses shifted along their
    camera x axes by REFINE_SHIFTS: (ks (8, 3, 3), w2cs (8, 4, 4))."""
    from real2sim_eval_tpu_torch.testing import CAMERAS

    ks, w2cs = [], []
    fixed = [c for c in CAMERAS if c["type"] == "side"]
    for c, shifts in zip(fixed, REFINE_SHIFTS):
        w2c = np.linalg.inv(np.asarray(c["c2w"], np.float32).reshape(4, 4))
        for d in (0.0,) + shifts:
            v = w2c.copy()
            v[0, 3] -= d              # the centre moves d along camera x
            w2cs.append(v)
            ks.append(np.asarray(c["intr"], np.float32).reshape(3, 3))
    return np.stack(ks), np.stack(w2cs).astype(np.float32)


def run_refinement():
    """The refinement tool at the size its users run: ``refine`` on one
    scan of the flagship scene (130,120 gaussians, degree-3 SH) against 8
    views at 848x480, all in one K7 and one K8 launch per iteration. The
    targets are the port's forward render (``rasterize``, K1) of the true
    scene; the start perturbs the SH by N(0, 0.3^2) and the logit
    opacities by -1. REFINE_ITERS iterations of the CLI's defaults (colours
    and opacities, lr 5e-3) with the launch counts set to 0 just before and
    read just after; the loss must fall and K7 and K8 launch every
    iteration. Then REFINE_GEOM_ITERS iterations of means, scales and
    rotations, whose losses must be finite. Returns (launches, K7's and
    K8's arguments of the first iteration, a function that runs 5 more
    iterations for the device profile, the ms of one iteration)."""
    import torch

    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.experiments.utils.refine_gs import refine
    from real2sim_eval_tpu_torch.renderer import Camera, diff, rasterize
    from real2sim_eval_tpu_torch.utils.ply import sh_colors_to_coeffs

    t0 = time.perf_counter()
    true = refinement_scene()
    ks, w2cs = refinement_views()
    k = ks[0]
    cam = Camera(width=848, height=480, fx=float(k[0, 0]), fy=float(k[1, 1]),
                 cx=float(k[0, 2]), cy=float(k[1, 2]))
    dev = {key: torch.as_tensor(v, device=DEVICE) for key, v in true.items()}
    shs = torch.as_tensor(sh_colors_to_coeffs(true["sh_colors"]),
                          device=DEVICE)
    images = np.stack([torch.clamp(rasterize(
        cam, w2c, dev["means3D"], torch.exp(dev["log_scales"]),
        dev["unnorm_rotations"],
        torch.sigmoid(dev["logit_opacities"]).reshape(-1), shs, 3,
        device=DEVICE)[0], 0.0, 1.0).permute(1, 2, 0).cpu().numpy()
        for w2c in w2cs])
    gen = torch.Generator().manual_seed(1)
    start = dict(true)
    start["sh_colors"] = true["sh_colors"] + 0.3 * torch.randn(
        true["sh_colors"].shape, generator=gen).numpy()
    start["logit_opacities"] = true["logit_opacities"] - 1.0
    setup_s = time.perf_counter() - t0

    k7_seen, undo7 = capture(diff, "rasterize_tiles_batch_t")
    k8_seen, undo8 = capture(diff, "composite_backward")
    stats = {}
    sync()
    torch.cuda.reset_peak_memory_stats()
    ext.reset_launch_counts()
    try:
        wall_ms, (_, hist) = time_host(lambda: refine(
            start, ks, w2cs, images, attrs=("colors", "opacities"),
            iters=REFINE_ITERS, lr=5e-3, log_every=1, device=DEVICE,
            stats=stats))
    finally:
        undo8()
        undo7()
    launches = dict(ext.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _, hist_g = refine(start, ks, w2cs, images,
                       attrs=("means", "scales", "rotations"),
                       iters=REFINE_GEOM_ITERS, lr=5e-3, log_every=1,
                       device=DEVICE)
    gradient_determinism(start, ks, w2cs, images)
    iter_ms = float(sum(np.mean(v) for v in stats.values()))
    _, starts, ends = k7_seen["args"][:3]
    out = {"phase": "refinement", "gaussians": int(true["means3D"].shape[0]),
           "sh_degree": 3, "views": len(w2cs), "size": "848x480",
           "setup_s": setup_s, "iters": REFINE_ITERS, "wall_ms": wall_ms,
           **{key: float(np.mean(v)) for key, v in stats.items()},
           "iter_ms": iter_ms, "each_ms": stats,
           "pairs_per_view": (ends - starts).sum(dim=1).tolist(),
           "max_memory_allocated_bytes": int(peak),
           "loss_first": hist[0], "loss_last": hist[-1], "losses": hist,
           "geometry_losses": hist_g, "launches": launches}
    emit(out)
    finite = bool(np.isfinite(hist).all() and np.isfinite(hist_g).all())
    if not (finite and hist[-1] < hist[0]):
        fail(f"the refinement's loss did not fall or is not finite: {out}")
    for name in ("tile_composite_t", "tile_backward"):
        if launches[name] < REFINE_ITERS:
            fail(f"refinement: {name} launched {launches[name]} times in "
                 f"{REFINE_ITERS} iterations")

    def five():
        """5 more iterations for the device profile (their set-up, the
        parameters' and targets' upload, count with them)."""
        return refine(start, ks, w2cs, images, iters=5, lr=5e-3,
                      log_every=5, device=DEVICE)

    return launches, k7_seen["args"], k8_seen["args"], five, iter_ms


def gradient_determinism(params: dict, ks, w2cs, images) -> None:
    """The refinement's loss (refine's: the 8 views through one K7 launch,
    clipped, mean squared error) and its backward on the same raw
    parameters twice, every attribute trained: the per-gaussian gradients
    (K8's per-pair gradients gathered back to the gaussians, then the
    preprocess's autograd) must be bitwise equal."""
    import torch

    from real2sim_eval_tpu_torch.experiments.utils.refine_gs import (
        clip01, sh_colors_to_coeffs)
    from real2sim_eval_tpu_torch.renderer import Camera, diff

    k = ks[0]
    cam = Camera(width=int(images.shape[2]), height=int(images.shape[1]),
                 fx=float(k[0, 0]), fy=float(k[1, 1]), cx=float(k[0, 2]),
                 cy=float(k[1, 2]), z_threshold=0.05)
    targets = torch.as_tensor(np.moveaxis(images, -1, 1), device=DEVICE)
    w2c = torch.as_tensor(w2cs, device=DEVICE)
    deg = int(round(np.sqrt(params["sh_colors"].shape[1] // 3))) - 1

    def grads():
        p = {key: torch.tensor(np.asarray(v, np.float32), device=DEVICE,
                               requires_grad=True)
             for key, v in params.items()}
        rgb, _ = diff.rasterize_diff_views(
            cam, w2c, p["means3D"], torch.exp(p["log_scales"]),
            p["unnorm_rotations"],
            torch.sigmoid(p["logit_opacities"]).reshape(-1),
            sh_colors_to_coeffs(p["sh_colors"]), deg, device=DEVICE)
        loss = torch.mean((clip01(rgb) - targets) ** 2)
        ms, _ = time_host(loss.backward)
        return {key: v.grad for key, v in p.items()}, ms

    (a, ms_a), (b, ms_b) = grads(), grads()
    res = {key: {"bitwise": torch_equal(a[key], b[key]),
                 "max_abs_diff": float((a[key] - b[key]).abs().max()),
                 "max_abs": float(a[key].abs().max())} for key in a}
    out = {"phase": "gradient_determinism", "backward_ms": [ms_a, ms_b],
           "all_bitwise": all(r["bitwise"] for r in res.values()),
           "grads": res}
    emit(out)
    if not out["all_bitwise"]:
        fail(f"per-gaussian gradients differ between two backwards: {res}")


def measure_refine_kernels(launches, k7_args, k8_args):
    """K7 and K8 at the refinement's shapes (its first iteration's
    inputs): each kernel, its plain version and the least time the card
    could take."""
    import torch

    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    # the captured pair table is the autograd graph's: measure it detached
    k7_args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                    for a in k7_args)
    k8_args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                    for a in k8_args)
    pairs, starts, ends, n_tx, n_ty, bg = k7_args
    k7_ms = time_cuda(lambda: tk.rasterize_tiles_batch_t(*k7_args), 10)
    rgb_k, dep_k, t_k = tk.rasterize_tiles_batch_t(*k7_args)
    rgb_1, dep_1 = tk.rasterize_tiles_batch(*k7_args)
    k7_vs_k1 = int(((rgb_k != rgb_1).any(dim=1) | (dep_k != dep_1)).sum())
    k7_plain_ms, (rgb_p, _, t_p) = time_host(
        lambda: tk.composite_tiles_plain(*k7_args, with_t=True))
    tiles = torch.arange(starts.numel(), device=DEVICE) % starts.shape[1]
    w7 = pixel_pair_walks(pairs, starts.reshape(-1), ends.reshape(-1), tiles,
                          n_tx, boxes=WIDE_BOX)
    # rgb, depth and T written: 5 planes
    k7_bound, k7_by = bound_ms(pairs.numel() * 4 + 2 * starts.numel() * 4
                               + rgb_k.numel() * 4 * 5 // 3, w7["reaching"])
    k7 = {"name": "tile_composite_t", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/tile_composite.cu",
          "replaces": "real2sim_eval_tpu/renderer/tile_kernel.py:264",
          "launches": launches["tile_composite_t"],
          "max_abs_err": max(float((rgb_k - rgb_p).abs().max()),
                             float((t_k - t_p).abs().max())),
          "ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound,
          "bound_by": k7_by, "library_ms": None}

    k8_ms = time_cuda(lambda: tk.composite_backward(*k8_args), 10)
    table_k = tk.composite_backward(*k8_args)
    k8_plain_ms, table_p = time_host(
        lambda: tk.composite_backward_plain(*k8_args))
    # pairs read and their gradients written (10 f32 each), the tile
    # ranges, and 8 planes read: dL/drgb, C_fin, dL/ddepth, T_fin
    n_bytes = (pairs.numel() * 4 * 2 + 2 * starts.numel() * 4
               + rgb_k.numel() * 4 * 8 // 3)
    t_bytes = n_bytes / PEAK_BYTES_S
    # the forward walk K8 repeats, at its reaching evaluations
    t_ops = (w7["reaching"] * K1_OPS_PER_EVAL
             + w7["contributions"] * K8_OPS_PER_CONTRIB) / PEAK_F32_OPS_S
    k8_rel = lane_gap(table_k, table_p)
    k8 = {"name": "tile_backward", "route": "cuda",
          "source": "real2sim_eval_tpu_torch/csrc/tile_backward.cu",
          "replaces": "real2sim_eval_tpu/renderer/diff.py:128",
          "launches": launches["tile_backward"],
          "max_abs_err": float((table_k - table_p).abs().max()),
          "ms": k8_ms, "plain_ms": k8_plain_ms,
          "bound_ms": max(t_bytes, t_ops) * 1e3,
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": None}
    emit({"phase": "refine_kernel_inputs", "instances": int(starts.shape[0]),
          "tiles": int(starts.numel()), "pairs": int(pairs.shape[1]),
          "pixel_pair_blends": w7["walks"],
          "reaching_blends": w7["reaching"],
          "contributing_blends": w7["contributions"],
          "k7_evaluations": {"tile_level": w7["tile_evals"],
                             "block_level": w7["box_evals"]["8x16"]},
          "k8_vs_plain_max_rel": k8_rel, "k8_plain_tol": K8_PLAIN_TOL,
          "k7_max_abs_t": float((t_k - t_p).abs().max()),
          "k7_vs_k1_differing_pixels": k7_vs_k1,
          "heaviest_tiles": heaviest_tiles(k7_args, k8_args)})
    if (k7["max_abs_err"] > RGB_TOL or float((t_k - t_p).abs().max()) > T_TOL
            or k7_vs_k1):
        fail(f"K7 disagrees at the refinement's shapes: {k7}")
    if k8_rel > K8_PLAIN_TOL:
        fail(f"K8 disagrees at the refinement's shapes: {k8_rel}")
    return [k7, k8]


def heaviest_split(starts, ends, timed: dict) -> dict:
    """Whether the longest tiles bound a kernel: each ``timed[label](e)``
    (a launch over the ranges [starts, e)) timed (CUDA events, mean of 10)
    on the 1 % of tiles (or dirty-list entries) with the most pairs alone
    and on all the others alone (a tile left out gets an empty range).
    Where the heaviest tiles alone take most of the whole launch's time,
    one CTA's walk, not the total work, sets it."""
    import torch

    counts = (ends - starts).reshape(-1)
    top = torch.topk(counts, max(1, counts.numel() // 100)).indices
    heavy = torch.zeros_like(counts, dtype=torch.bool)
    heavy[top] = True
    out = {"tiles": int(top.numel()), "pairs_max": int(counts.max()),
           "pairs_mean": float(counts.float().mean()),
           "pairs_heaviest_share": float(counts[top].sum() / counts.sum())}
    for name, keep in (("heaviest", heavy), ("rest", ~heavy)):
        e = torch.where(keep.reshape(starts.shape), ends, starts)
        for label, fn in timed.items():
            out[f"{label}_ms_{name}"] = time_cuda(lambda: fn(e), 10)
    return out


def heaviest_tiles(k7_args, k8_args) -> dict:
    """heaviest_split of K7 and K8 at the refinement's shapes."""
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk

    pairs, starts, ends, n_tx, n_ty, bg = k7_args
    return heaviest_split(starts, ends, {
        "k7": lambda e: tk.rasterize_tiles_batch_t(pairs, starts, e, n_tx,
                                                   n_ty, bg),
        "k8": lambda e: tk.composite_backward(k8_args[0], starts, e,
                                              *k8_args[3:])})


def start_ptxas() -> dict:
    """``nvcc -Xptxas -v`` on each kernel source the build compiles, one
    process each, started together (seconds: the sources do not include
    PyTorch's headers); objects go to the git-ignored build directory."""
    from torch.utils.cpp_extension import CUDA_HOME

    from real2sim_eval_tpu_torch import ext

    ext.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    return {src: subprocess.Popen(
        [nvcc, *ext.CUDA_FLAGS, "-Xptxas", "-v", "-I", str(ext.CSRC), "-c",
         str(ext.CSRC / src), "-o", str(ext.BUILD_DIR / f"ptxas_{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ext.SOURCES if src.endswith(".cu")}


def report_ptxas(procs: dict) -> None:
    """Each kernel's registers, shared memory and spills, from
    start_ptxas."""
    from real2sim_eval_tpu_torch import ext

    out = {}
    for src, proc in procs.items():
        text, _ = proc.communicate()
        out[src] = [ln.split(":", 1)[-1].strip() for ln in text.splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]
        if proc.returncode:
            fail(f"nvcc failed on {src}: {text[-2000:]}")
    emit({"phase": "ptxas", "flags": list(ext.CUDA_FLAGS), "sources": out})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from real2sim_eval_tpu_torch import ext

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    encoders = probe_encoders()
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count(), "encoders": encoders})

    if sys.argv[1:] == ["sloth"]:      # the K3 gate at the sloth's tables
        t0 = time.perf_counter()
        ptxas = start_ptxas()
        ext.load()
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        report_ptxas(ptxas)
        check_k3_sloth()
        sloth_witness()
        emit({"ok": True, "device": {"platform": "gpu", "kind": name}})
        return 0
    if sys.argv[1:] == ["ik"]:         # the IK gate alone
        t0 = time.perf_counter()
        ext.load()
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        ik_kernel()
        emit({"ok": True, "device": {"platform": "gpu", "kind": name}})
        return 0
    t0 = time.perf_counter()
    ptxas = start_ptxas()
    mutant = start_cull_mutant()
    ext.load()
    mutant_lib = load_fine_lib(mutant)[0]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "flags": list(ext.CUDA_FLAGS), "sources": list(ext.SOURCES)})
    report_ptxas(ptxas)

    check_k1_small()
    check_k7_small()
    check_k8_small()
    check_k2_k6_small()
    check_k4_small(mutant_lib)
    check_k5_small(mutant_lib)
    check_k3_drift()
    check_k3_grasp()
    check_k3_loop()
    check_k3_pusher()
    check_k3_sloth()
    check_reference()
    # every host-timed phase first, the device profiles last
    ev, actions, launches, flagship, ik = run_flagship()
    ik_sync_free(ev, actions)
    ev_s, launches_s = run_flagship_stream(ev, actions)
    ev_f, launches_f, flagship_f = run_flagship_fine(ev, actions)
    fine_step_render_syncs(ev_f, actions)
    render_parity(ev, ev_s)
    fine_render_parity(ev, ev_f)
    stage_breakdown(ev, ev_s, actions)
    fine_breakdown(ev_f, actions)
    kernels = measure_kernels(ev, ev_s, actions, launches, launches_s)
    kernels += measure_fine_kernels(ev_f, actions, launches_f)
    del ev_s
    launches_r, k7_args, k8_args, refine_five, iter_ms = run_refinement()
    kernels += measure_refine_kernels(launches_r, k7_args, k8_args)
    with tempfile.TemporaryDirectory() as root:
        ev_c, cfg, build_s = cfg_build(Path(root))
        bare_rate = run_cfg_flagship(ev_c, actions, build_s, flagship)
        del ev_c
        torch.cuda.empty_cache()
        single_env(cfg)
        run_clis(cfg, Path(root), bare_rate)
        scene_tools(Path(root), bare_rate)
        ply_native(cfg)
        online_render(cfg, Path(root))
        profile_physics_phase()
        fan_out(cfg, Path(root))
    ik_target = ik_targets(ev, actions)["mimic"]
    profiles = device_profiles([
        # one IK solve: one kernel launch
        ("ik_kernel", lambda: ev._ik(ev.state.qpos7, ik_target), 1,
         ik["kernel_ms"]),
        ("flagship", lambda: (ev.step(actions), ev.render()), 1,
         flagship["total_ms"]),
        ("flagship_fine", lambda: (ev_f.step(actions), ev_f.render()), 1,
         flagship_f["total_ms"]),
        ("refinement", refine_five, 5, iter_ms)])
    trace_stages(ev, ev_f, actions, profiles)
    # the control: the default path timed again, after the profiles
    run_path("flagship_after_profiler", ev, actions, TIMED_STEPS_AFTER,
             ("spring_mass_step", "tile_sparse", "tile_composite"), 0.0)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
