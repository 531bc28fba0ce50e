"""Tracing and profiling helpers (the JAX package's utils/profiling.py).

``ScopedTimer`` (the reference's ``wp.ScopedTimer``, off by default),
``sync_devices`` and ``StepTimer`` (the entry points' per-step FPS with
an explicit synchronise) keep the JAX package's surface; ``device_trace``
is a ``torch.profiler`` session that writes a Chrome trace.

The stage machinery names every stage of a ``BatchedEvaluator``'s step
and render (``stages``) and instruments them by patching the callables in
place: ``timed_stages`` adds each stage's synchronised host milliseconds
to a dict, ``stage_spans`` wraps each in ``torch.profiler.record_function``
so a trace carries the stage names (``experiments/utils/trace_step.py``
attributes device time by them), and ``device_profile`` sums the kernels
of one call under the profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path

import torch


class ScopedTimer:
    """Drop-in for wp.ScopedTimer: ``with ScopedTimer('eval_springs'):``.
    Globally disabled by default (as the reference runs); accumulates
    per-label totals when enabled. ``synchronize`` waits for the cards."""

    enabled: bool = False
    totals: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)

    def __init__(self, label: str, synchronize: bool = False,
                 print_each: bool = False):
        self.label = label
        self.synchronize = synchronize
        self.print_each = print_each

    def __enter__(self):
        if ScopedTimer.enabled:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not ScopedTimer.enabled:
            return False
        if self.synchronize:
            sync_devices()
        dt = time.perf_counter() - self._t0
        ScopedTimer.totals[self.label] += dt
        ScopedTimer.counts[self.label] += 1
        if self.print_each:
            print(f"[timer] {self.label}: {dt * 1000:.2f} ms")
        return False

    @classmethod
    def report(cls) -> str:
        lines = [f"{k}: {v * 1000:.1f} ms total / {cls.counts[k]} calls"
                 for k, v in sorted(cls.totals.items())]
        return "\n".join(lines)

    @classmethod
    def reset(cls):
        cls.totals.clear()
        cls.counts.clear()


def sync_devices(device=None) -> None:
    """Wait for the card's queued work: ``device`` (a device, a list of
    them or an ``EnvMesh``), or every visible card when None. Nothing to
    wait for on the CPU."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        return
    devices = getattr(device, "devices", device)
    if not isinstance(devices, (list, tuple)):
        devices = [devices]
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def time_host(fn) -> tuple[float, object]:
    """(host ms of ``fn()`` between two synchronises, its result)."""
    sync_devices()
    t0 = time.perf_counter()
    out = fn()
    sync_devices()
    return (time.perf_counter() - t0) * 1e3, out


@contextlib.contextmanager
def device_trace(log_dir: str | Path = "log/trace"):
    """Capture a profile around a block:

        with device_trace('log/trace'):
            step(...)

    CPU operators, and the card's kernels and copies when there is a card,
    written as a Chrome trace ``*.pt.trace.json`` under ``log_dir`` (open
    it in chrome://tracing or Perfetto; ``trace_step.parse_trace`` reads
    it). Yields the ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        str(log_dir / f"trace_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


class StepTimer:
    """Per-step FPS meter matching the entry points' prints
    (eval_policy.py:257-259)."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self._t0 = None

    def start(self):
        if self.sync:
            sync_devices()
        self._t0 = time.perf_counter()

    def stop(self) -> tuple[float, float]:
        if self.sync:
            sync_devices()
        dt = time.perf_counter() - self._t0
        return dt, 1.0 / max(dt, 1e-9)


# ---------------------------------------------------------------------------
# the evaluator's stages
# ---------------------------------------------------------------------------


def patch(obj, name: str, make):
    """Replace ``obj.name`` by ``make(original)``; returns the undo."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    return lambda: setattr(obj, name, orig)


def stage_timer(acc: dict, label: str):
    """A ``patch`` maker: the wrapped call adds its synchronised host ms to
    acc[label]."""
    def make(orig):
        def wrapper(*args, **kwargs):
            ms, out = time_host(lambda: orig(*args, **kwargs))
            acc[label] = acc.get(label, 0.0) + ms
            return out
        return wrapper
    return make


def stage_span(label: str):
    """A ``patch`` maker: the wrapped call runs inside
    ``torch.profiler.record_function(label)``."""
    def make(orig):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return orig(*args, **kwargs)
        return wrapper
    return make


def stages(e) -> list:
    """(object, attribute, label) of every stage of evaluator e's step and
    render, both kernel families; a stage a path does not run stays out of
    its breakdown."""
    from ..physics import fused_step
    from ..renderer import (fine_kernel, incremental, incremental_fine, lbs,
                            precull, raster, tile_kernel)

    return [(e, "_mimic", "mimic (IK + FK)"), (e, "_ik", "IK"),
            (e, "_env_pre", "grasp + controls"),
            (fused_step, "freeze", "freezes"),
            (fused_step, "spring_mass_step", "K3 spring_mass_step"),
            (e, "compose_dyn", "compose_dyn"),
            (lbs, "interpolate_motions", "LBS"),
            (incremental, "bin_dynamic", "dynamic preprocess + binning"),
            (incremental, "merge_segments", "merge (sort)"),
            (incremental_fine, "merge_segments", "merge (sort)"),
            (tile_kernel, "copy_frames", "cache copy"),
            (fine_kernel, "copy_frames", "cache copy"),
            (incremental, "rasterize_tiles_sparse",
             "K2 tile_sparse (incl. cache copy)"),
            (incremental, "rasterize_tiles_sparse_merge",
             "K6 tile_sparse_merge (incl. cache copy)"),
            (incremental_fine, "rasterize_fine_sparse",
             "K5 fine_sparse (incl. cache copy)"),
            (e, "render_wrist", "wrist pipeline"),
            (precull, "cull_static_blocks", "precull static"),
            (precull, "cull_dynamic_blocks", "precull dynamic"),
            (raster, "preprocess_gaussians", "wrist preprocess"),
            (raster, "bin_gaussians", "wrist binning"),
            (raster, "bin_gaussians_fine", "wrist binning (fine)"),
            (raster, "rasterize_tiles_batch", "K1 tile_composite"),
            (raster, "rasterize_fine_batch", "K4 fine_composite")]


@contextlib.contextmanager
def _patched(e, make_for_label):
    undo = [patch(obj, name, make_for_label(label))
            for obj, name, label in stages(e)]
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def timed_stages(e, acc: dict, fn) -> float:
    """``fn`` with every stage of ``stages(e)`` timed into acc; its own
    synchronised host ms."""
    with _patched(e, lambda label: stage_timer(acc, label)):
        return time_host(fn)[0]


@contextlib.contextmanager
def stage_spans(e):
    """Within the block, every stage of ``stages(e)`` runs inside a
    ``record_function`` range of its label, so a profiler trace names the
    stage of each operator and of each kernel it launched."""
    with _patched(e, stage_span):
        yield


def device_profile(fn) -> dict:
    """``fn`` once under ``torch.profiler``: its wall ms (profiled), the
    device's kernel ms, and the heaviest kernels and operators."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms, _ = time_host(fn)
    events = prof.key_averages()
    # device rows are the kernels themselves; a CPU operator's self device
    # time is that of the kernels it launched (the same time again)
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)

    def top(rows, n):
        return [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in rows[:n]]

    return {"profiled_wall_ms": wall_ms,
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernels_launched": sum(e.count for e in kernels),
            "top_kernels_ms": top(kernels, 8), "top_ops_ms": top(ops, 10)}
