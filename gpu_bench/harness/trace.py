"""Traced runs: the stage spans around the program's layers, and the
reading of the profiler's trace.

Frozen copies, taken when the benchmark was written: ``STAGES`` is the
stage list of the program's ``utils/profiling.stages``, wrapped here with
``torch.profiler.record_function`` from the benchmark's own code
(``spans``); ``load_events``, ``_innermost``, ``_self_times`` and
``parse_trace`` are ``experiments/utils/trace_step.py``'s (each card
event under the innermost stage range open on the host thread that
launched it, matched by its ``correlation`` id, which a CUDA-graph
replay's kernels share with its ``cudaGraphLaunch``; self time on each
lane). ``busy_and_gaps`` is the benchmark's own: the card's busy time in
a window and its idle gaps, each named by the host span open when it
began.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
from pathlib import Path
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"


class TraceTable(NamedTuple):
    by_stage: collections.Counter     # stage -> self us
    by_op: collections.Counter        # (stage, op or kernel name) -> self us
    counts: collections.Counter       # stage -> events
    total_us: float
    n_events: int
    source: str                       # "device" (card events) or "cpu"


def load_events(path) -> list:
    """The events of a Chrome trace: ``path`` itself, or the newest
    ``*.pt.trace.json[.gz]`` under it."""
    path = Path(path)
    if path.is_dir():
        files = (glob.glob(str(path / "**" / "*.pt.trace.json"),
                           recursive=True)
                 + glob.glob(str(path / "**" / "*.pt.trace.json.gz"),
                             recursive=True))
        if not files:
            raise FileNotFoundError(f"no *.pt.trace.json under {path}")
        path = Path(max(files, key=os.path.getmtime))
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _lane(e) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _innermost(spans: dict, queries: list) -> list:
    """For each (lane, ts) query, the label of the innermost span of that
    lane whose [ts, ts + dur) holds ts, else None. Spans on one lane nest
    (record_function ranges on one thread)."""
    out = [None] * len(queries)
    by_lane = collections.defaultdict(list)
    for i, (lane, t) in enumerate(queries):
        if lane is not None:
            by_lane[lane].append((t, i))
    for lane, qs in by_lane.items():
        sp = sorted(spans.get(lane, ()), key=lambda s: (s[0], -s[1]))
        qs.sort()
        stack, j = [], 0
        for t, i in qs:
            while j < len(sp) and sp[j][0] <= t:
                while stack and stack[-1][1] <= sp[j][0]:
                    stack.pop()
                stack.append(sp[j])
                j += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out[i] = stack[-1][2] if stack else None
    return out


def _self_times(items: list) -> list:
    """Each event's duration less its children's on the same lane."""
    own = [float(e.get("dur", 0.0)) for e in items]
    lanes = collections.defaultdict(list)
    for i, e in enumerate(items):
        lanes[_lane(e)].append(i)
    for idx in lanes.values():
        idx.sort(key=lambda i: (float(items[i].get("ts", 0.0)),
                                -float(items[i].get("dur", 0.0))))
        stack = []                    # (end, index)
        for i in idx:
            ts = float(items[i].get("ts", 0.0))
            while stack and stack[-1][0] <= ts + 1e-9:
                stack.pop()
            if stack:
                own[stack[-1][1]] -= float(items[i].get("dur", 0.0))
            stack.append((ts + float(items[i].get("dur", 0.0)), i))
    return own


def parse_trace(path) -> TraceTable:
    """Self time by stage of a ``device_trace``: the card's events when
    the trace holds any, each under the stage range around its launch;
    else the CPU operators, each under the stage range around it."""
    events = [e for e in load_events(path) if e.get("ph") == "X"]
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            ts = float(e.get("ts", 0.0))
            spans[_lane(e)].append((ts, ts + float(e.get("dur", 0.0)),
                                    e.get("name", "")))
    items = [e for e in events if e.get("cat") in DEVICE_CATS]
    if items:
        source = "device"
        launches = {}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launches[corr] = e
        queries = []
        for e in items:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            queries.append((None, 0.0) if launch is None else
                           (_lane(launch), float(launch.get("ts", 0.0))))
    else:
        source = "cpu"
        items = [e for e in events if e.get("cat") == "cpu_op"]
        queries = [(_lane(e), float(e.get("ts", 0.0))) for e in items]
    stage_of = _innermost(spans, queries)
    by_stage, by_op, counts = (collections.Counter() for _ in range(3))
    total = 0.0
    for e, stage, us in zip(items, stage_of, _self_times(items)):
        stage = stage or UNATTRIBUTED
        by_stage[stage] += us
        by_op[(stage, e.get("name", "")[:160])] += us
        counts[stage] += 1
        total += us
    return TraceTable(by_stage, by_op, counts, total, len(items), source)


# (owner: "ev", a module of the program or "module:Class"; attribute;
# label): the stages of the program's step and render
STAGES = (
    ("ev", "step", "step: other"), ("ev", "render", "render: other"),
    ("ev", "_mimic", "mimic (IK + FK)"), ("ev", "_ik", "IK"),
    ("ev", "_env_pre", "grasp + controls"),
    ("physics.fused_step", "freeze", "freezes"),
    ("physics.fused_step", "spring_mass_step", "K3 spring_mass_step"),
    ("ev", "compose_dyn", "compose_dyn"),
    ("renderer.lbs", "interpolate_motions", "LBS"),
    ("renderer.scene:RobotArticulation", "apply", "articulation"),
    ("renderer.incremental", "bin_dynamic", "dynamic preprocess + binning"),
    ("renderer.incremental", "merge_segments", "merge (sort)"),
    ("renderer.incremental_fine", "merge_segments", "merge (sort)"),
    ("renderer.tile_kernel", "copy_frames", "cache copy"),
    ("renderer.fine_kernel", "copy_frames", "cache copy"),
    ("renderer.incremental", "rasterize_tiles_sparse",
     "K2 tile_sparse (incl. cache copy)"),
    ("renderer.incremental", "rasterize_tiles_sparse_merge",
     "K6 tile_sparse_merge (incl. cache copy)"),
    ("renderer.incremental_fine", "rasterize_fine_sparse",
     "K5 fine_sparse (incl. cache copy)"),
    ("ev", "render_wrist", "wrist pipeline"),
    ("renderer.precull", "cull_static_blocks", "precull static"),
    ("renderer.precull", "cull_dynamic_blocks", "precull dynamic"),
    ("renderer.raster", "preprocess_gaussians", "wrist preprocess"),
    ("renderer.raster", "bin_gaussians", "wrist binning"),
    ("renderer.raster", "bin_gaussians_fine", "wrist binning (fine)"),
    ("renderer.raster", "rasterize_tiles_batch", "K1 tile_composite"),
    ("renderer.raster", "rasterize_fine_batch", "K4 fine_composite"),
)


def _owner(path: str, ev):
    """The object a stage's attribute lives on: the evaluator, a module
    of the program, or a class in one (``module:Class``)."""
    import importlib

    if path == "ev":
        return ev
    mod, _, cls = path.partition(":")
    obj = importlib.import_module("real2sim_eval_tpu_torch." + mod)
    return getattr(obj, cls) if cls else obj


def _span(label: str, orig):
    import torch

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return orig(*args, **kwargs)
    return wrapper


def missing_stages(ev) -> list:
    """The stage attributes this program does not have."""
    out = []
    for path, attr, label in STAGES:
        try:
            getattr(_owner(path, ev), attr)
        except (ImportError, AttributeError):
            out.append(label)
    return out


@contextlib.contextmanager
def spans(ev):
    """Within the block, each stage of STAGES that the program has runs
    inside a ``record_function`` range of its label."""
    undo = []
    for path, attr, label in STAGES:
        try:
            owner = _owner(path, ev)
            orig = getattr(owner, attr)
        except (ImportError, AttributeError):
            continue
        setattr(owner, attr, _span(label, orig))
        undo.append((owner, attr, orig))
    try:
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


def busy_and_gaps(path, window: tuple, top: int = 10) -> dict:
    """The card's busy seconds in ``window`` (trace microseconds, from
    the span named "window"), the device operations that took most
    time, and the idle gaps summed by the innermost host span open when
    each began."""
    events = [e for e in load_events(path) if e.get("ph") == "X"]
    t0, t1 = window
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                  e.get("name", "")) for e in events
                 if e.get("cat") in DEVICE_CATS
                 and t0 <= float(e["ts"]) < t1)
    busy, gaps, end = 0.0, [], t0
    for s, f, _ in dev:
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    if t1 > end:
        gaps.append((end, t1))
    spans_by_lane = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            ts = float(e.get("ts", 0.0))
            spans_by_lane[_lane(e)].append((ts, ts + float(e.get("dur", 0.0)),
                                            e.get("name", "")))
    main = max(spans_by_lane, key=lambda k: len(spans_by_lane[k]),
               default=None)
    names = _innermost(spans_by_lane, [(main, s) for s, _ in gaps])
    idle = collections.Counter()
    for (s, f), name in zip(gaps, names):
        idle[name or "outside every span"] += (f - s) / 1e6
    ops = collections.Counter()
    for s, f, name in dev:
        ops[name[:120]] += (f - s) / 1e6
    return {"busy_s": busy / 1e6, "window_s": (t1 - t0) / 1e6,
            "device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}


def window_of(path, name: str = "window") -> tuple:
    """(start, end) trace microseconds of the host span ``name``."""
    for e in load_events(path):
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            ts = float(e["ts"])
            return ts, ts + float(e.get("dur", 0.0))
    raise ValueError(f"no span {name!r} in the trace")


def stage_ms(run, labels) -> float | None:
    """Device ms a traced step under the stages ``labels`` (self time),
    or None where the program lacks one of them or nothing was traced."""
    t = run.traced
    if t is None or t["table"].source != "device" or any(
            label in t["missing"] for label in labels):
        return None
    return sum(t["table"].by_stage.get(label, 0.0)
               for label in labels) / 1e3 / t["steps"]
