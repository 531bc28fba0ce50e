"""Tracing and profiling helpers (the JAX package's utils/profiling.py).

``ScopedTimer`` (the reference's ``wp.ScopedTimer``, off by default),
``sync_devices`` and ``StepTimer`` (the entry points' per-step FPS with
an explicit synchronise) keep the JAX package's surface; ``device_trace``
is a ``torch.profiler`` session that writes a Chrome trace, and
``device_profile`` sums the kernels of one call under the profiler.

The program's stages open spans where they run: ``span(label)`` at each
layer boundary of a ``BatchedEvaluator``'s step and render, ``host_span``
in the build, ``count(name, value)`` beside them. One module-level
``Recorder`` (``RECORDER``) decides what they do: nothing (``off``, the
default), a ``record_function`` range (``profile``, which
``experiments/utils/trace_step.py`` reads from a trace), or host stamps
and CUDA events with counters (``stamps``): ``read`` gives the raw record
after the window, and ``report`` the lines an operator reads of it.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os
import time
import warnings
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
# patching one call to time it (chip_smoke.py)
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


# ---------------------------------------------------------------------------
# spans and counters at the program's stage boundaries
# ---------------------------------------------------------------------------

MODES = ("off", "profile", "stamps")
# an anchor is the best of this many event round trips: its error is half
# the shortest one
ANCHOR_TRIES = 3
# the slow steps that ``report`` takes apart: those above this percentile
# of the window's step walls
SLOW_PERCENTILE = 90.0
_NULL = contextlib.nullcontext()


class _Stamped:
    """A span of a ``stamps`` recording: the ``record_function`` range,
    with a host stamp and (on a card) an event at its enter and exit."""

    __slots__ = ("rec", "label", "device", "new_step", "rf", "row")

    def __init__(self, rec, label: str, device: bool, new_step: bool):
        self.rec, self.label = rec, label
        self.device, self.new_step = device, new_step

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.label)
        self.rf.__enter__()
        self.row = self.rec._enter(self.label, self.device, self.new_step)
        return self

    def __exit__(self, *exc):
        self.rec._exit(self.row)
        self.rf.__exit__(*exc)
        return False


class Recorder:
    """The spans and counters of the program's stages, in one of MODES.

    ``off`` (the default): ``span`` is a flag test and a no-op context.
    ``profile``: a span is a ``torch.profiler.record_function`` range of
    its label, so a trace names the stage of each operator and of each
    kernel it launched (``trace_step.parse_trace``). ``stamps``: the range
    too, and at the span's enter and exit a host ``perf_counter_ns`` and,
    on a card, a pooled CUDA event; each span keeps its parent and its
    control step (``span(..., new_step=True)`` opens the next). Counters
    are summed per control step, a card's values on the card; Python's
    garbage collections and the card's synchronising calls (under
    ``torch.cuda.set_sync_debug_mode("warn")``) are counted too. Nothing
    synchronises inside a step. ``read`` puts each event on the host clock
    through the last anchor before its span: an event recorded just after
    a synchronise and waited for, placed at the middle of its host round
    trip, whose half is the clock's error (``anchor``)."""

    def __init__(self):
        self.mode = "off"
        self._cuda = False
        self._pool: list = []
        self._reset()

    def _reset(self):
        # [label, parent, step, host enter ns, host exit ns, enter event,
        # exit event]
        self.spans: list = []
        self._open: list = []
        self.step = -1
        self.counts: dict = {}          # step -> {name: number or tensor}
        # (first span index, host ns at the round trip's middle, event,
        # round trip us)
        self.anchors: list = []
        self._t0 = time.perf_counter_ns()
        self._gc_t0 = None

    # -- mode ------------------------------------------------------------

    def start(self, mode: str) -> None:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if self.mode != "off":
            raise RuntimeError(f"already recording ({self.mode})")
        self._release()
        self._reset()
        self._cuda = torch.cuda.is_available()
        self.mode = mode
        if mode == "stamps":
            gc.callbacks.append(self._on_gc)
            if self._cuda:
                self._warnings = warnings.catch_warnings()
                self._warnings.__enter__()
                warnings.filterwarnings("always", message=".*synchroniz")
                self._showwarning = warnings.showwarning
                warnings.showwarning = self._on_warning
                torch.cuda.set_sync_debug_mode("warn")
                self.anchor()

    def stop(self) -> None:
        if self.mode == "stamps":
            gc.callbacks.remove(self._on_gc)
            if self._cuda:
                torch.cuda.set_sync_debug_mode("default")
                self._warnings.__exit__(None, None, None)
        self.mode = "off"

    # -- spans -------------------------------------------------------------

    def span(self, label: str, new_step: bool = False, device: bool = True):
        if self.mode == "profile":
            if new_step:
                self.step += 1
            return torch.profiler.record_function(label)
        return _Stamped(self, label, device and self._cuda, new_step)

    def _event(self):
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    def _enter(self, label: str, device: bool, new_step: bool) -> list:
        if new_step:
            self.step += 1
        ev = self._event() if device else None
        t = time.perf_counter_ns()
        if ev is not None:
            ev.record()
        row = [label, self._open[-1] if self._open else -1, self.step, t,
               None, ev, None]
        self._open.append(len(self.spans))
        self.spans.append(row)
        return row

    def _exit(self, row: list) -> None:
        row[4] = time.perf_counter_ns()
        if row[5] is not None:
            ev = self._event()
            ev.record()
            row[6] = ev
        self._open.pop()

    def anchor(self) -> None:
        """Synchronise and record the anchor of the spans that follow: an
        event on the idle card, waited for. The card ran it somewhere
        between the host's stamps before the record and after the wait, so
        it is placed at their middle, half the round trip either way; of
        ANCHOR_TRIES such events the one with the shortest round trip is
        kept. A caller that synchronises every step re-anchors each step,
        so that no drift builds up between the clocks."""
        if self.mode != "stamps" or not self._cuda:
            return
        torch.cuda.synchronize()
        best = None
        for _ in range(ANCHOR_TRIES):
            ev = self._event()
            t0 = time.perf_counter_ns()
            ev.record()
            # an event recorded on an idle stream may wait in the CUDA
            # driver's queue until the next launch flushes it: wait for it
            ev.synchronize()
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[1] - best[0]:
                if best is not None:
                    self._pool.append(best[2])
                best = (t0, t1, ev)
            else:
                self._pool.append(ev)
        t0, t1, ev = best
        self.anchors.append((len(self.spans), (t0 + t1) // 2, ev,
                             (t1 - t0) / 1e3))

    # -- counters ----------------------------------------------------------

    def add(self, name: str, value) -> None:
        d = self.counts.setdefault(self.step, {})
        d[name] = d[name] + value if name in d else value

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        elif self._gc_t0 is not None:
            self.add("gc_collections", 1)
            self.add("gc_ms", (time.perf_counter_ns() - self._gc_t0) / 1e6)
            self._gc_t0 = None

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if "synchroniz" not in str(message):
            self._showwarning(message, category, filename, lineno, file, line)
            return
        where = self.spans[self._open[-1]][0] if self._open else "outside"
        self.add("syncs", 1)
        self.add(f"syncs in {where}", 1)

    # -- reading -----------------------------------------------------------

    def read(self) -> dict:
        """The record: {"spans": [{label, parent, step, host: [enter,
        exit], device: [enter, exit] or None, anchor: the index of the
        anchor that placed device, or -1}], "counts": [[step, name,
        value]], "anchors": [host ms], "anchor_rtt_us": [each anchor's
        round trip: twice its error]}, every time in ms on the host clock
        from the recording's start. Synchronises; call after the
        window."""
        if self._cuda:
            torch.cuda.synchronize()
        base = self._t0
        spans, a = [], -1
        for i, (label, parent, step, h0, h1, e0, e1) in enumerate(self.spans):
            while a + 1 < len(self.anchors) and self.anchors[a + 1][0] <= i:
                a += 1
            dev = None
            if e1 is not None and a >= 0:
                _, t_a, ev_a, _ = self.anchors[a]
                off = (t_a - base) / 1e6
                dev = [off + ev_a.elapsed_time(e0),
                       off + ev_a.elapsed_time(e1)]
            spans.append({"label": label, "parent": parent, "step": step,
                          "host": [(h0 - base) / 1e6,
                                   None if h1 is None else (h1 - base) / 1e6],
                          "device": dev, "anchor": a if dev else -1})
        counts = [[step, name, float(v)]
                  for step, d in sorted(self.counts.items())
                  for name, v in d.items()]
        return {"spans": spans, "counts": counts,
                "anchors": [(a[1] - base) / 1e6 for a in self.anchors],
                "anchor_rtt_us": [a[3] for a in self.anchors]}

    def _release(self) -> None:
        """Return the record's events to the pool."""
        for row in self.spans:
            self._pool.extend(e for e in row[5:] if e is not None)
        self._pool.extend(a[2] for a in self.anchors)


RECORDER = Recorder()


def span(label: str, new_step: bool = False, traced: bool = False):
    """The context of a stage: a no-op unless the recorder is on (see
    ``Recorder``); ``new_step`` opens the next control step. ``traced``:
    with the recorder off, a ``record_function`` range all the same while
    a ``torch.profiler`` session runs, so that a caller's own trace names
    a stage that no caller wraps from outside (``mesh groups``)."""
    if RECORDER.mode == "off":
        if traced and torch._C._autograd._profiler_enabled():
            return torch.profiler.record_function(label)
        return _NULL
    return RECORDER.span(label, new_step)


def spanned(label: str, new_step: bool = False):
    """A decorator: each call of the function runs inside ``span(label,
    new_step)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if RECORDER.mode == "off":
                return fn(*args, **kwargs)
            with RECORDER.span(label, new_step):
                return fn(*args, **kwargs)
        return inner
    return wrap


def host_span(label: str):
    """``span`` without a card event: a stage of the build, timed on the
    host clock alone."""
    if RECORDER.mode == "off":
        return _NULL
    return RECORDER.span(label, device=False)


def counting() -> bool:
    """Whether ``count`` counts: guard a counter that costs work."""
    return RECORDER.mode == "stamps"


def count(name: str, value=1) -> None:
    """Add ``value`` (a number or a card tensor) to the counter ``name``
    of the current control step; counts only in ``stamps`` mode."""
    if RECORDER.mode == "stamps":
        RECORDER.add(name, value)


def anchor() -> None:
    """``RECORDER.anchor()``: a no-op unless stamping on a card."""
    RECORDER.anchor()


@contextlib.contextmanager
def recording(mode: str = "stamps"):
    """The recorder in ``mode`` within the block, with a fresh record;
    yields the recorder (``read`` it before the block ends or after)."""
    RECORDER.start(mode)
    try:
        yield RECORDER
    finally:
        RECORDER.stop()


# ---------------------------------------------------------------------------
# reading a stamps record
# ---------------------------------------------------------------------------


def _ms(pair) -> float:
    return pair[1] - pair[0]


def step_counts(record: dict) -> dict:
    """{step: {counter: value}} of a record."""
    out: dict = {}
    for step, name, v in record["counts"]:
        out.setdefault(step, {})[name] = v
    return out


def step_walls(record: dict) -> dict:
    """{step: host ms from its first span's enter to the first anchor
    after it (the caller's synchronise), else to its last span's exit}."""
    first, last = {}, {}
    for s in record["spans"]:
        if s["step"] < 0 or s["host"][1] is None:
            continue
        first.setdefault(s["step"], s["host"][0])
        last[s["step"]] = max(last.get(s["step"], s["host"][1]),
                              s["host"][1])
    anchors = sorted(record["anchors"])
    out = {}
    for step, t0 in first.items():
        after = [t for t in anchors if t >= last[step]]
        out[step] = (after[0] if after else last[step]) - t0
    return out


def _slow_steps(record: dict, walls: dict, counts: dict) -> list:
    import numpy as np

    per: dict = {}                      # step -> label -> [host, device]
    for s in record["spans"]:
        if s["step"] < 0 or s["host"][1] is None:
            continue
        row = per.setdefault(s["step"], {}).setdefault(s["label"],
                                                       [0.0, None])
        row[0] += _ms(s["host"])
        if s["device"] is not None:
            row[1] = (row[1] or 0.0) + _ms(s["device"])
    labels = sorted({k for d in per.values() for k in d})

    def med(label, i):
        xs = [d[label][i] for d in per.values()
              if label in d and d[label][i] is not None]
        return float(np.median(xs)) if xs else float("nan")

    cut = float(np.percentile(list(walls.values()), SLOW_PERCENTILE))
    lines = [f"stamped steps {len(walls)}: wall ms p50 "
             f"{np.median(list(walls.values())):.2f} p{SLOW_PERCENTILE:g} "
             f"{cut:.2f}"]
    for st in sorted(s for s, w in walls.items() if w > cut):
        c = counts.get(st, {})
        lines.append(
            f"slow step {st}: wall {walls[st]:.2f} ms, gc "
            f"{c.get('gc_collections', 0):.0f} ({c.get('gc_ms', 0.0):.2f} "
            f"ms), syncs {c.get('syncs', 0):.0f}, IK launches "
            f"{c.get('ik_launches', 0):.0f}")
        for label in labels:
            h, d = per[st].get(label, (0.0, None))
            lines.append(
                f"  {label}: host {h:.2f} (median {med(label, 0):.2f}) "
                f"device {'-' if d is None else f'{d:.2f}'} "
                f"(median {med(label, 1):.2f})")
    return lines


def report(record: dict) -> list:
    """Lines that explain the slow steps of a stamps record: for each step
    whose wall ms (``step_walls``) lies above SLOW_PERCENTILE of the
    window's,
    each span's host and device ms beside that span's median over all
    steps, with the step's garbage collections, synchronising calls and
    IK kernel launches; then the live contact slots and self-collision rows
    a lane-step, the anchors' round trips, and the build's spans."""
    import numpy as np

    walls = step_walls(record)
    counts = step_counts(record)
    lines = []
    if walls:
        lines += _slow_steps(record, walls, counts)
    totals: dict = {}
    for st, d in counts.items():
        if st >= 0:
            for k, v in d.items():
                totals[k] = totals.get(k, 0.0) + v
    lanes = totals.get("env_steps")
    if lanes:
        lines.append(
            f"a lane-step: live contact slots "
            f"{totals.get('contact_slots', 0.0) / lanes:.2f}, live "
            f"self-collision rows {totals.get('self_rows', 0.0) / lanes:.2f}"
            f", capped {totals.get('capped_env_steps', 0.0):.0f} of "
            f"{lanes:.0f} env-steps")
    lines.append("window counts " + " ".join(
        f"{k}={v:g}" for k, v in sorted(totals.items())))
    rtt = record["anchor_rtt_us"]
    if rtt:
        q = np.percentile(rtt, [50, 90, 100])
        lines.append(f"anchors {len(rtt)}: round trip us p50 {q[0]:.1f} "
                     f"p90 {q[1]:.1f} max {q[2]:.1f} (the clock's error is "
                     f"half)")
    build: dict = {}
    for s in record["spans"]:
        if s["step"] < 0 and s["host"][1] is not None:
            n, ms = build.get(s["label"], (0, 0.0))
            build[s["label"]] = (n + 1, ms + _ms(s["host"]))
    if build:
        lines.append("build spans " + ", ".join(
            f"{k} {n}x {ms / 1e3:.2f} s" for k, (n, ms) in build.items()))
    return lines
