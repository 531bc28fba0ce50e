"""Per-stage trace of the flagship step and render (the JAX package's
experiments/utils/trace_step.py).

Builds the flagship evaluator (``testing.make_flagship_assets`` and
``BatchedEvaluator``), warms it up, then runs ``--iters`` step + render
pairs under ``utils.profiling.device_trace`` with the program's recorder
in ``profile`` mode, so that every stage's span is a ``record_function``
range of its name, and reads the Chrome trace back:

- on the card, each kernel, copy and memset is attributed to the
  innermost stage range open on the CPU thread when it was launched. The
  launch is found through the event's ``correlation`` id, which a kernel
  replayed from a CUDA graph shares with its ``cudaGraphLaunch``;
- on the CPU (``--device cpu``), each operator's self time is attributed
  to the innermost stage range around it.

A parent span never counts its children's time (self time on each
lane). The step and the render are ranges of their own, so work outside
every named stage lands in "step: other" or "render: other";
"unattributed" is what ran outside both.

With ``--stamps N`` it then runs N more step + render pairs unprofiled,
with the recorder stamping and a synchronise after each, and prints the
record's ``utils.profiling.report`` (the slow steps span by span on the
host's and the card's clock, the counters, the clock's error).

Usage:
    python -m real2sim_eval_tpu_torch.experiments.utils.trace_step --batch 64
    python -m real2sim_eval_tpu_torch.experiments.utils.trace_step \\
        --what render --kernel fine [--device cpu]
    python -m real2sim_eval_tpu_torch.experiments.utils.trace_step \\
        --stamps 240
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

# the flagship's sizes when --gaussians / --obj-dense are 0 (bench.py's
# N_TABLE_SMALL; no LBS'd body splats), as in the JAX tool
N_TABLE_DEFAULT = 30000
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


def report(table: TraceTable, n_iters: int, wall_ms: float, top: int = 6):
    what = "device" if table.source == "device" else "CPU operator"
    print(f"\n== {what} time over {n_iters} iters "
          f"(wall {wall_ms:.0f} ms/iter) ==")
    print(f"{'stage':<42}{'ms/iter':>9}  {'%':>5}  {'events/iter':>11}")
    for stage, us in table.by_stage.most_common():
        print(f"{stage:<42}{us / 1e3 / n_iters:>9.1f}  "
              f"{100.0 * us / max(table.total_us, 1):>5.1f}  "
              f"{table.counts[stage] / n_iters:>11.0f}")
    print(f"{'TOTAL (' + table.source + ')':<42}"
          f"{table.total_us / 1e3 / n_iters:>9.1f}")
    print("\n== top ops per stage ==")
    per_stage = collections.defaultdict(list)
    for (stage, name), us in table.by_op.items():
        per_stage[stage].append((us, name))
    for stage, _ in table.by_stage.most_common():
        print(f"-- {stage}")
        for us, name in sorted(per_stage[stage], reverse=True)[:top]:
            print(f"   {us / 1e3 / n_iters:>8.2f} ms  {name}")


def step_render(ev, actions, what: str = "both"):
    """One step and/or render of ``ev``, each inside a range of its own."""
    import torch

    def one():
        out = None
        if what in ("both", "physics"):
            # flagship semantics: velocity-control mimic on (the default)
            with torch.profiler.record_function("step: other"):
                ev.step(actions)
            out = ev.state.sm.x
        if what in ("both", "render"):
            with torch.profiler.record_function("render: other"):
                out = ev.render()[0]
        return out

    return one


def trace(ev, actions, what: str = "both", iters: int = 3,
          out_dir=None) -> tuple[TraceTable, float, str]:
    """Warm up, then trace ``iters`` step + render pairs of ``ev`` with
    its stages named; (the parsed table, wall ms an iteration, the trace
    directory)."""
    from ...utils.profiling import device_trace, recording, sync_devices

    one = step_render(ev, actions, what)
    one()
    sync_devices()
    trace_dir = str(out_dir or tempfile.mkdtemp(prefix="trace_step_"))
    t0 = time.perf_counter()
    with device_trace(trace_dir), recording("profile"):
        for _ in range(iters):
            one()
        sync_devices()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return parse_trace(trace_dir), wall, trace_dir


def stamp(ev, actions, steps: int, what: str = "both") -> dict:
    """``steps`` step + render pairs of ``ev`` with the recorder stamping,
    each followed by a synchronise and an anchor; the record."""
    from ...utils import profiling

    one = step_render(ev, actions, what)
    with profiling.recording("stamps") as rec:
        for _ in range(steps):
            one()
            profiling.anchor()
        return rec.read()


def flagship_actions(batch: int, device):
    """The flagship's action: the eef held at (0.2, 0, 0.3) pointing down,
    the gripper open."""
    import numpy as np
    import torch

    rot = np.diag([1.0, -1.0, -1.0]).reshape(-1)
    return torch.tensor(
        np.tile(np.concatenate([[0.2, 0.0, 0.3], rot, [1.0]]), (batch, 1)),
        dtype=torch.float32, device=device)


def build_evaluator(args, device):
    from ...parallel import BatchedEvaluator
    from ...renderer import RasterConfig
    from ...testing import make_flagship_assets

    rc = RasterConfig(kernel=args.kernel, wrist_precull=args.precull,
                      merge_kernel=args.merge_kernel)
    assets = make_flagship_assets(batch=args.batch,
                                  n_table=args.gaussians or N_TABLE_DEFAULT,
                                  n_obj_dense=args.obj_dense, device=device)
    return BatchedEvaluator(assets, list(range(args.batch)),
                            raster_config=rc, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--what", default="both",
                    choices=("both", "render", "physics"))
    ap.add_argument("--gaussians", type=int, default=0,
                    help="table gaussian count (0 = 30,000)")
    ap.add_argument("--out", default="")
    ap.add_argument("--kernel", default="wide", choices=("wide", "fine"),
                    help="compositor family (RasterConfig.kernel)")
    ap.add_argument("--obj-dense", type=int, default=0,
                    help="LBS'd object body splats (the flagship: 30000)")
    ap.add_argument("--precull", default="auto",
                    choices=("auto", "on", "off"),
                    help="wrist static pre-cull (RasterConfig.wrist_precull)")
    ap.add_argument("--merge-kernel", default="sort",
                    choices=("sort", "stream"),
                    help="incremental merge (RasterConfig.merge_kernel)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stamps", type=int, default=0,
                    help="stamped step + render pairs after the trace")
    args = ap.parse_args(argv)

    from ...utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.time()
    ev = build_evaluator(args, device)
    print(f"evaluator built in {time.time() - t0:.0f}s", flush=True)
    table, wall, trace_dir = trace(
        ev, flagship_actions(args.batch, device), args.what, args.iters,
        args.out or None)
    print(f"traced {args.iters} iters to {trace_dir}", flush=True)
    print(f"({table.n_events} {table.source} events)")
    report(table, args.iters, wall)
    if args.stamps:
        from ...utils import profiling

        record = stamp(ev, flagship_actions(args.batch, device),
                       args.stamps, args.what)
        print(f"\n== {args.stamps} stamped iters ==")
        print("\n".join(profiling.report(record)))
    return table


if __name__ == "__main__":
    main()
