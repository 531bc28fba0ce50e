"""A cell as the harness runs it: its entries in BENCHMARK.json, and the
files found by their names under ``gpu_bench/``: the configuration
(``configs/<config>.json`` and its writer ``configs/<config>.py``), the
traffic (``traffic/<traffic>.json``), each per-layer metric's reader
(``metrics/<metric>.py``) and the limits of the output check
(``limits/<cell>.json``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]     # gpu_bench/
ROOT = BENCH.parent                             # the checkout


def load_module(path: Path, name: str):
    """A Python file of the benchmark as a module (its name may hold
    dots, as a metric's does)."""
    spec = importlib.util.spec_from_file_location(
        "gpu_bench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: str
    spec: dict                 # configs/<config>.json
    traffic: dict              # traffic/<traffic>.json
    end_to_end: list           # the cell's end-to-end metric entries
    per_layer: list            # the cell's per-layer metric entries
    limits: dict               # limits/<cell>.json
    files: Path = BENCH        # where the files above are found

    def writer(self):
        return load_module(self.files / "configs" / f"{self.config}.py",
                           "config_" + self.config)

    def reader(self, metric: str):
        return load_module(self.files / "metrics" / f"{metric}.py",
                           "metric_" + metric)


def _applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def find(workload: str, root: Path = ROOT, files: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json, its files under
    ``files``; raises KeyError if there is none."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, reported)]
    spec = json.loads((files / "configs" / f"{entry['config']}.json")
                      .read_text())
    traffic = json.loads((files / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    limits = json.loads((files / "limits" / f"{workload}.json").read_text())
    return Cell(workload, int(entry["chips"]), entry["config"], spec,
                traffic, e2e, per_layer, limits, files)
