"""The output check: what the timed path produced against the plain
reference (``gpu_bench/reference/plain``), once the window has closed and
the program's state is freed.

The reference builds its own evaluator from the config files the
benchmark wrote, for the checked lanes' episodes, on the full-pipeline
render branch (``incremental="off"``) with every kernel's plain version
and the eager IK: it works out again from the inputs everything the
program derived from them (springs, neighbour tables, SDF grids, LBS
weights, articulation tables, static frames). A simulation step depends
on the state before it, and the program's state after hundreds of steps
is its own, so the reference follows the program step by step, a stage at a time:
from the program's state before each checked control step it runs the
same control step (the velocity-control mimic's IK and FK, the grasp
machine and controls, the freezes, all 667 substeps), and from the
program's state after that step the same render (LBS and articulation
with the render's IK, both cameras). Rendering the program's own state
keeps the physics' rounding, which contact can grow to millimetres within
one control step, out of the frames' comparison. The start, which this skips, is held
by itself: the program's state after its build against the reference's.

Numbers read (each the widest over the checked lanes and steps); a
cell's ``limits/<cell>.json`` names those it compares, the rest are
recorded beside them:

- ``start_gap``: every leaf of the state after the build;
- ``qpos_gap`` (rad): the mimic's joint targets and the render's IK pose;
- ``x_gap`` (m), ``v_gap`` (m/s): the particles after the step, the
  widest gap of any particle's coordinate;
- ``x_mean_gap`` (m), ``v_mean_gap`` (m/s): each lane's mean over its
  particles of their distance, the widest lane's;
- ``eef_gap``: the gripper rows (eef pose, velocities, openness) and the
  grasp machine's openness; a grasp flag that differs counts 1;
- ``rgb_gap``: the fixed and wrist frames' colours;
- ``depth_share``: the share of the fixed and wrist frames' pixels whose
  depth is off by more than DEPTH_OFF_M.

With ``control`` the reference runs a second time, each stage in the
nearest precision below the configuration's float32 with TF32 off:
matrix products in TF32 and the spring-mass step's positions and
velocities kept in bfloat16 between substeps (it has no matrix product
for TF32 to reach). Its outputs are compared, in the program's place,
with the reference's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

NUMBERS = ("start_gap", "qpos_gap", "x_gap", "x_mean_gap", "v_gap",
           "v_mean_gap", "eef_gap", "rgb_gap", "depth_share")
# a depth is the median depth of a pixel's blend: where the transmittance
# crosses one half, which can jump to a splat far behind on rounding, so
# depths are held by the share of pixels off by more than this (m)
DEPTH_OFF_M = 0.01


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    d = np.abs(a - b)
    d[~(np.isfinite(a) & np.isfinite(b))] = np.inf
    d[np.isnan(a) & np.isnan(b)] = np.inf
    return float(d.max())


def _mean_gap(a, b) -> float:
    """Each lane's mean distance over its particles, the widest lane's;
    (B, N, 3) arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    d = np.linalg.norm(a - b, axis=-1).mean(-1)
    d[~np.isfinite(d)] = np.inf
    return float(d.max())


def _state_np(state) -> dict:
    from .outputs import state_numpy

    return state_numpy(state, list(range(state.sm.x.shape[0])))


def _frames_np(frames) -> list:
    return [f.detach().cpu().numpy() for f in frames]


def state_gaps(ref: dict, got: dict) -> dict:
    """Gaps between two host states of the same lanes."""
    grasp = max(_gap(ref["grasp/current_openness"],
                     got["grasp/current_openness"]),
                float(np.any(ref["grasp/grasped"] != got["grasp/grasped"])))
    return {"x_gap": _gap(ref["sm/x"], got["sm/x"]),
            "x_mean_gap": _mean_gap(ref["sm/x"], got["sm/x"]),
            "v_gap": _gap(ref["sm/v"], got["sm/v"]),
            "v_mean_gap": _mean_gap(ref["sm/v"], got["sm/v"]),
            "eef_gap": max(_gap(ref["grippers"], got["grippers"]), grasp),
            "qpos_gap": _gap(ref["qpos7"], got["qpos7"])}


def _depth_share(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    off = ~(np.abs(a - b) <= DEPTH_OFF_M)     # NaN counts as off
    return float(off.mean()) if off.size else 0.0


def frame_gaps(ref: list, got: list) -> dict:
    """rgb gap and depth share of (images, depths, wrist images, wrist
    depths); a camera kind the configuration lacks is an empty part."""
    return {"rgb_gap": max(_gap(ref[0], got[0]), _gap(ref[2], got[2])),
            "depth_share": _depth_share(
                np.concatenate([ref[1].ravel(), ref[3].ravel()]),
                np.concatenate([got[1].ravel(), got[3].ravel()]))}


def start_gaps(ref: dict, got: dict) -> dict:
    """Each leaf's gap between two host states."""
    return {k: (_gap(ref[k], got[k]) if k in ref and k in got
                else float("inf"))
            for k in sorted(set(ref) | set(got)) if k != "step"}


def reference_evaluator(cfg_dir: Path, episode_ids: list, device: str):
    from ..reference.plain.config import load_config
    from ..reference.plain.parallel import BatchedEvaluator
    from ..reference.plain.renderer import RasterConfig

    cfg = load_config(cfg_dir, "run")
    return BatchedEvaluator(cfg, episode_ids,
                            raster_config=RasterConfig(incremental="off"),
                            device=device)


def _pad(tree: dict) -> dict:
    """A host state of the checked lanes with the first lane repeated in
    front, for the reference's leading episode-0 slot."""
    return {k: v if k == "step" else np.concatenate([v[:1], v])
            for k, v in tree.items()}


def _unpad(tree):
    if isinstance(tree, dict):
        return {k: v if k == "step" else v[1:] for k, v in tree.items()}
    return [f[1:] for f in tree]


def follow(ref_ev, sample: dict, lower: bool = False):
    """The reference's control step from the program's state before a
    checked step, and its render from the program's state after that
    step: (state after the step, after the render, frames). ``lower``:
    each stage in the precision below the configuration's (the
    control)."""
    import functools

    import torch

    from ..reference.plain.parallel.batched import _state_from_numpy
    from ..reference.plain.physics import fused_step, spring_mass

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    if lower:
        fused_step.run_substeps_plain = functools.partial(
            spring_mass.run_substeps_plain, store=torch.bfloat16)
    try:
        ref_ev.state = _state_from_numpy(_pad(sample["pre"]), ref_ev.device)
        acts = np.concatenate([sample["actions"][:1], sample["actions"]])
        ref_ev.step(torch.as_tensor(acts, device=ref_ev.device))
        post = _unpad(_state_np(ref_ev.state))
        ref_ev.state = _state_from_numpy(_pad(sample["render_in"]),
                                         ref_ev.device)
        frames = _unpad(_frames_np(ref_ev.render()))
        rendered = _unpad(_state_np(ref_ev.state))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        fused_step.run_substeps_plain = spring_mass.run_substeps_plain
    return post, rendered, frames


def gaps_of(outs: list, samples: list) -> dict:
    """The widest gaps of the programs' (or the control's) outputs
    ``samples`` against the reference's ``outs``."""
    g = {k: 0.0 for k in NUMBERS if k != "start_gap"}
    for (post, rendered, frames), s in zip(outs, samples):
        for k, v in state_gaps(post, s["post"]).items():
            g[k] = max(g[k], v)
        g["qpos_gap"] = max(g["qpos_gap"],
                            _gap(rendered["qpos7"], s["rendered"]["qpos7"]))
        for k, v in frame_gaps(frames, s["frames"]).items():
            g[k] = max(g[k], v)
    return g


def compare(run, cfg_dir: Path, device: str = "cuda",
            control: bool = False) -> dict:
    """The numbers compared for ``run`` (and, with ``control``, the
    control's, under "control")."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # episode 0 first: a build takes its shared scene arrays (the
    # canonical frame the object poses are relative to) from its first
    # episode, as the program's does
    ids = [0] + [run.episode_ids[i] for i in run.check_lanes]
    ref_ev = reference_evaluator(cfg_dir, ids, device)
    leaves = start_gaps(_unpad(_state_np(ref_ev.state)), run.init_state)
    numbers = {"start_gap": max(leaves.values())}
    outs = [follow(ref_ev, s) for s in run.samples]
    numbers.update(gaps_of(outs, run.samples))
    if control:
        ctl = [follow(ref_ev, s, lower=True) for s in run.samples]
        as_program = [{"post": c[0], "rendered": c[1], "frames": c[2]}
                      for c in ctl]
        numbers["control"] = gaps_of(outs, as_program)
    del ref_ev
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, number, limit], ...]) over the numbers the
    cell's limits name: correct when each is at most its limit; a limit
    that is not set, or a number missing or not finite, is not correct."""
    rows, ok = [], True
    for k in (k for k in NUMBERS if k in limits):
        v, lim = numbers.get(k), limits.get(k)
        good = (v is not None and lim is not None and np.isfinite(v)
                and v <= lim)
        ok &= bool(good)
        rows.append([k, v, lim])
    return ok, rows
