"""One run of one cell: ``run.py --workload W --seed N --seconds S
--trace 0|1``.

Looks the cell up in BENCHMARK.json, refuses to run without the cards it
asks for, writes the configuration's scene from the seed into a
directory under TMPDIR, runs the traffic's entry (the module of
``gpu_bench/harness`` that its traffic file names; ``bare``: the lockstep
evaluator), checks the outputs against
the plain reference, and prints the result as the last line of standard
output: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics. The numbers compared, each beside its limit,
are the last lines of standard error and the last key of the result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import check, device
from .cell import ROOT, find


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="gpu_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control (the reference a "
                         "precision lower)")
    return ap.parse_args(argv)


def entry_of(name: str):
    """The ``run`` of the entry module ``gpu_bench/harness/<name>.py``."""
    return importlib.import_module(f".{name}", __package__).run


def end_to_end(cell, run) -> dict:
    rate = run.lanes * run.steps / run.window_s
    vals = {
        "env_steps_per_s": rate,
        "control_step_ms_p95": (float(np.percentile(run.step_ms, 95))
                                if run.step_ms else None),
        "setup_s": run.setup_s,
    }
    return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if vals.get(m["name"]) is not None}


def per_layer(cell, run) -> dict:
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"]).read(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def write_scene(cell, seed: int, root: Path) -> dict:
    from ..reference.plain.config import save_config

    scene = cell.writer().write(cell.spec, root, seed)
    (root / "cfg").mkdir(parents=True, exist_ok=True)
    save_config(scene["cfg"], root / "cfg" / "run.yaml")
    scene["cfg"] = scene["cfg"].to_dict()
    return scene


def execute(args, cell, dev: str = "cuda") -> dict:
    """Run the cell and return the result line's object (without
    printing it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="gpu_bench_"))
    try:
        scene = write_scene(cell, args.seed, work / "scene")
        run = entry_of(cell.traffic["entry"])(
            cell, scene, work / "scene" / "cfg", args.seed, args.seconds,
            work / "trace" if args.trace else None, dev)
        metrics = per_layer(cell, run) if args.trace else end_to_end(cell,
                                                                    run)
        record = (device.record(cell.chips) if dev == "cuda" else
                  {"platform": "cpu", "kind": "cpu", "count": 1})
        record["memory_peak_bytes"] = run.memory_peak
        if run.traced is not None:
            record["busy_s"] = run.traced["busy_s"]
            record["window_s"] = run.traced["window_s"]
        numbers = check.compare(run, work / "scene" / "cfg", dev,
                                control=bool(args.control))
        correct, rows = check.verdict(numbers, cell.limits)
        out = {"correct": correct, "attempted": run.attempted,
               "failed": run.failed, "metrics": metrics, "device": record}
        if run.traced is not None:
            out["breakdown"] = {"device_ops": run.traced["device_ops"],
                                "idle_gaps": run.traced["idle_gaps"]}
        if run.step_ms:
            q = np.percentile(run.step_ms, [50, 90, 95, 97, 99, 100])
            print("step ms p50 p90 p95 p97 p99 max "
                  + " ".join(f"{v:.2f}" for v in q)
                  + f" of {len(run.step_ms)}", file=sys.stderr)
        if run.extra.get("setup_parts"):
            print("setup parts (s) " + " ".join(
                f"{k} {v:.2f}" for k, v in run.extra["setup_parts"].items()),
                file=sys.stderr)
        if run.extra.get("by_reason"):
            print(f"env-steps by reason {json.dumps(run.extra['by_reason'])}",
                  file=sys.stderr)
        if run.extra.get("motion"):
            print(f"motion {json.dumps(run.extra['motion'])}",
                  file=sys.stderr)
        if "control" in numbers:
            out["control"] = numbers["control"]
        out["recorded"] = {k: v for k, v in numbers.items()
                           if k in check.NUMBERS and k not in cell.limits}
        out["compared"] = {name: {"value": v, "limit": lim}
                           for name, v, lim in rows}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = find(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"gpu_bench: {e}", file=sys.stderr)
        return 2
    try:
        device.require_cards(cell.chips)
    except device.NoCard as e:
        print(f"gpu_bench: no card to run on: {e}", file=sys.stderr)
        return 3
    device.fix_caches(ROOT)
    out = execute(args, cell)
    bad = device.forbidden_modules()
    if bad:
        print(f"gpu_bench: the run loaded {bad}", file=sys.stderr)
        return 4
    for name, v in out["recorded"].items():
        print(f"recorded {name} {v!r}", file=sys.stderr)
    for name, row in out["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
