"""The readers of the program's stamped window (``harness/stamps.py`` and
its seven metrics) on a hand-written record with known answers, and the
program's spans against the benchmark's stage list: in ``profile`` mode
every operator of a tiny flagship's step and render lies under the same
stage, in the same order, as under the patched spans of
``harness/trace.py``."""

import dataclasses
from types import SimpleNamespace

import pytest

from gpu_bench.harness import cell as cell_mod

READERS = ("kinematics.ik_event_ms", "renderer.event_ms",
           "device.host_paced_pct", "parallel.host_ms_p95",
           "device.step_ms_p95", "physics.capped_pct",
           "parallel.build_resets_s")


def read(name, run):
    return cell_mod.load_module(cell_mod.BENCH / "metrics" / f"{name}.py",
                                name).read(run)


def row(label, parent, step, host, device=None, anchor=-1):
    return {"label": label, "parent": parent, "step": step, "host": host,
            "device": device, "anchor": -1 if device is None else anchor}


def window(k3_lags=(0.049, 0.051), rtts=(20.0, 20.0)):
    """Two control steps on the host clock (ms), step k placed by anchor
    k. In each, the step's IK exits its events 1.2 ms after the host left
    it (card-paced); K3's exit event lies k3_lags[k] ms after its host
    exit; the render's IK lies inside compose_dyn."""
    rows = []
    for step, (base, lag) in enumerate(zip((0.0, 10.0), k3_lags)):
        i = len(rows)
        rows += [
            row("step: other", -1, step, [base, base + 2.96],
                [base + 0.01, base + 3.0], step),
            row("mimic (IK + FK)", i, step, [base + 0.1, base + 0.5],
                [base + 0.11, base + 1.8], step),
            row("IK", i + 1, step, [base + 0.2, base + 0.4],
                [base + 0.21, base + 1.6], step),
            row("K3 spring_mass_step", i, step, [base + 0.6, base + 2.95],
                [base + 1.8, base + 2.95 + lag], step),
            row("render: other", -1, step, [base + 3.1, base + 4.0],
                [base + 3.2, base + 6.0], step),
            row("compose_dyn", i + 4, step, [base + 3.2, base + 3.5],
                [base + 3.25, base + 4.5], step),
            row("IK", i + 5, step, [base + 3.3, base + 3.4],
                [base + 3.3, base + 4.3], step),
            row("LBS", i + 5, step, [base + 3.41, base + 3.45])]
    return {"spans": rows, "anchors": [-0.5, 6.5], "anchor_rtt_us":
            list(rtts),
            "counts": [[-1, "env_steps", 99.0],
                       [0, "env_steps", 64.0], [0, "capped_env_steps", 3.0],
                       [1, "env_steps", 64.0],
                       [1, "capped_env_steps", 1.0]]}


def build():
    return {"spans": [row("PLY read", -1, -1, [-1000.0, -990.0]),
                      row("reset", -1, -1, [-900.0, -400.0]),
                      row("reset", -1, -1, [-390.0, -140.0])],
            "anchors": [], "anchor_rtt_us": [], "counts": []}


def run_of(win, bld=None):
    return SimpleNamespace(extra={"stamps": {"window": win,
                                             "build": bld or build()}})


def test_readers_on_a_written_record():
    run = run_of(window())
    # IK: 1.39 (the step's) + 1.0 (the render's) device ms a step
    assert read("kinematics.ik_event_ms", run) == pytest.approx(2.39)
    # the render: 2.8 less its IK's 1.0
    assert read("renderer.event_ms", run) == pytest.approx(1.8)
    # leaf spans with events: the IKs (1.39 and 1.0, exits 1.2 and 0.9 ms
    # after the host's) and K3: 1.199 ms exiting 49 us after the host's
    # (paced) in step 0, 1.201 exiting 51 us after in step 1 (not)
    leaf = 2 * (1.39 + 1.0) + 1.199 + 1.201
    assert read("device.host_paced_pct", run) == pytest.approx(
        100.0 * 1.199 / leaf)
    # the launch path: "step: other" entered to "render: other" left
    assert read("parallel.host_ms_p95", run) == pytest.approx(4.0)
    # the step's first enter event to the render's exit event
    assert read("device.step_ms_p95", run) == pytest.approx(5.99)
    # the build's env_steps (step -1) are not the window's
    assert read("physics.capped_pct", run) == pytest.approx(
        100.0 * 4 / 128)
    assert read("parallel.build_resets_s", run) == pytest.approx(0.75)


def test_the_50_us_rule_moves_with_the_exit_stamps():
    leaf = 2 * (1.39 + 1.0)
    # both K3 exits under 50 us after the host's: both paced
    run = run_of(window(k3_lags=(0.0, 0.0495)))
    assert read("device.host_paced_pct", run) == pytest.approx(
        100.0 * (1.15 + 1.1995) / (leaf + 1.15 + 1.1995))
    # neither
    run = run_of(window(k3_lags=(0.0505, 0.2)))
    assert read("device.host_paced_pct", run) == 0.0
    # step 1's anchor took 60 us to come back, over the rule: its spans
    # are left out, step 0's paced K3 stays
    run = run_of(window(rtts=(20.0, 60.0)))
    assert read("device.host_paced_pct", run) == pytest.approx(
        100.0 * 1.199 / (1.39 + 1.0 + 1.199))
    run = run_of(window(rtts=(51.0, 60.0)))
    assert read("device.host_paced_pct", run) is None


def test_readers_read_nothing_without_stamps():
    from gpu_bench.harness.outputs import Run

    run = Run(lanes=2, steps=2, window_s=1.0, step_ms=[1.0], setup_s=1.0,
              attempted=4, failed=0, memory_peak=0, traced=None,
              check_lanes=[0], episode_ids=[0], init_state={}, samples=[],
              extra={})
    for name in READERS:
        assert read(name, run) is None
    # a record with spans but no device stamps (a CPU run)
    win = window()
    for s in win["spans"]:
        s["device"], s["anchor"] = None, -1
    win["anchors"], win["anchor_rtt_us"] = [], []
    run = run_of(win, {"spans": [], "anchors": [], "anchor_rtt_us": [],
                       "counts": []})
    for name in ("kinematics.ik_event_ms", "renderer.event_ms",
                 "device.host_paced_pct", "device.step_ms_p95",
                 "parallel.build_resets_s"):
        assert read(name, run) is None
    assert read("parallel.host_ms_p95", run) == pytest.approx(4.0)


class Ranges:
    """Stands in for ``torch.profiler.record_function``: the labels of
    the ranges opened and, under ``ops()``, the innermost open range of
    each operator dispatched."""

    def __init__(self):
        self.stack, self.opened, self.seen = [], [], []

    def __call__(self, label):
        ranges = self

        class Range:
            def __enter__(self):
                ranges.stack.append(label)
                ranges.opened.append(label)

            def __exit__(self, *exc):
                ranges.stack.pop()

        return Range()

    def ops(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ranges = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ranges.seen.append((ranges.stack[-1] if ranges.stack
                                    else None, str(func)))
                return func(*args, **(kwargs or {}))

        return Mode()


@pytest.mark.parametrize("incremental", ["off", "on"])
def test_program_spans_match_the_patched_stages(monkeypatch, incremental):
    """A 2-lane flagship (60 particles, 4 substeps, the test cameras cut
    to 16 rows, a one-iteration IK): one step and render under the
    program's spans in ``profile`` mode and under the benchmark's patches
    (the recorder off) put each operator under the same stage."""
    import torch

    from gpu_bench.harness import trace as tr
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.experiments.utils.trace_step import (
        flagship_actions)
    from real2sim_eval_tpu_torch.kinematics import make_ik_fn
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import RasterConfig
    from real2sim_eval_tpu_torch.utils.profiling import recording

    cams = [dict(c, h=16, intr=[60.0, 0.0, 64.0, 0.0, 60.0, 8.0, 0.0, 0.0,
                                1.0]) for c in tt.TEST_CAMERAS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "CAMERAS", cams)
        a = tt.make_flagship_assets(batch=2, n_table=200, n_obj_dense=0,
                                    n_rope=60, device="cpu")
    a = dataclasses.replace(a, opts=dataclasses.replace(a.opts,
                                                        num_substeps=4))
    acts = flagship_actions(2, "cpu")
    ev = BatchedEvaluator(a, [0, 1], device="cpu",
                          raster_config=RasterConfig(incremental=incremental))
    ev._ik = make_ik_fn(a.chain, ev._eef_idx, n_active=7, iters=1)
    ev.step(acts)
    ev.render()
    state = ev.state

    def run(ctx):
        ev.state = state
        ranges = Ranges()
        monkeypatch.setattr(torch.profiler, "record_function", ranges)
        with ctx, ranges.ops():
            ev.step(acts)
            ev.render()
        return ranges

    patched = run(tr.spans(ev))
    spanned = run(recording("profile"))
    assert spanned.seen == patched.seen
    assert spanned.opened == patched.opened
    assert set(spanned.opened) <= {label for _, _, label in tr.STAGES}
