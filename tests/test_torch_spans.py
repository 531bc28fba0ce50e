"""The program's spans and counters (``utils/profiling.py``'s recorder) on
the CPU.

Held: in ``off`` mode a step and render of a tiny flagship (2 lanes, 60
particles, 4 substeps, the test cameras cut to 16x128) open no
``record_function`` range and record nothing; in ``profile`` mode each
stage's range opens where the benchmark's stage list puts it (``WHERE``,
the nesting of its labels, on the full-pipeline and the incremental
branch) and covers nearly every operator; in ``stamps`` mode the spans
carry host stamps and no device stamps, their parents and control steps,
and the counters sum per step; on a fake card the anchor places each
event on the host clock within half its round trip, the shortest of its
tries; the build's spans cover each episode's reset; ``trace_step.stamp``
records a stamped window; ``report`` takes apart the steps above the
window's 90th percentile of a hand-written record."""

import dataclasses
import gc
import time

import pytest
import torch

from real2sim_eval_tpu_torch.renderer import RasterConfig
from real2sim_eval_tpu_torch.utils import profiling
from real2sim_eval_tpu_torch.utils.profiling import count, recording

B = 2
BRANCHES = {"off": RasterConfig(incremental="off"),
            "sort": RasterConfig(incremental="on")}
# the labels of the benchmark's stage list (gpu_bench/harness/trace.py)
STAGE_LABELS = {
    "step: other", "render: other", "mimic (IK + FK)", "IK",
    "grasp + controls", "freezes", "K3 spring_mass_step", "compose_dyn",
    "LBS", "articulation", "dynamic preprocess + binning", "merge (sort)",
    "cache copy", "K2 tile_sparse (incl. cache copy)",
    "K6 tile_sparse_merge (incl. cache copy)",
    "K5 fine_sparse (incl. cache copy)", "wrist pipeline", "precull static",
    "precull dynamic", "wrist preprocess", "wrist binning",
    "wrist binning (fine)", "K1 tile_composite", "K4 fine_composite"}
# (label, the label of the range it opens in) of one step and render, as
# the stage list's functions nest on each branch
STEP = {("step: other", None), ("mimic (IK + FK)", "step: other"),
        ("IK", "mimic (IK + FK)"), ("grasp + controls", "step: other"),
        ("freezes", "step: other"), ("K3 spring_mass_step", "step: other"),
        ("render: other", None)}
WHERE = {
    "off": STEP | {("LBS", "render: other"), ("IK", "render: other"),
                   ("articulation", "render: other"),
                   ("wrist preprocess", "render: other"),
                   ("wrist binning", "render: other"),
                   ("K1 tile_composite", "render: other")},
    "sort": STEP | {("compose_dyn", "render: other"), ("LBS", "compose_dyn"),
                    ("IK", "compose_dyn"),
                    ("dynamic preprocess + binning", "render: other"),
                    ("merge (sort)", "render: other"),
                    ("K2 tile_sparse (incl. cache copy)", "render: other"),
                    ("cache copy", "K2 tile_sparse (incl. cache copy)"),
                    ("wrist pipeline", "render: other"),
                    ("wrist preprocess", "wrist pipeline"),
                    ("wrist binning", "wrist pipeline"),
                    ("K1 tile_composite", "wrist pipeline")},
}


@pytest.fixture(scope="module")
def flagship():
    """A tiny flagship evaluator per branch, each stepped and rendered once
    (first-call caches built), and its action. Its IK is the program's
    solver at one Gauss-Newton iteration, to keep the tests short."""
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.experiments.utils.trace_step import (
        flagship_actions)
    from real2sim_eval_tpu_torch.kinematics import make_ik_fn
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator

    # the test cameras cut to 16 rows: two 8-row tile rows a frame
    cams = [dict(c, h=16, intr=[60.0, 0.0, 64.0, 0.0, 60.0, 8.0, 0.0, 0.0,
                                1.0]) for c in tt.TEST_CAMERAS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "CAMERAS", cams)
        a = tt.make_flagship_assets(batch=B, n_table=200, n_obj_dense=0,
                                    n_rope=60, device="cpu")
    a = dataclasses.replace(a, opts=dataclasses.replace(a.opts,
                                                        num_substeps=4))
    acts = flagship_actions(B, "cpu")
    out = {}
    for name, rc in BRANCHES.items():
        ev = BatchedEvaluator(a, list(range(B)), raster_config=rc,
                              device="cpu")
        ev._ik = make_ik_fn(a.chain, ev._eef_idx, n_active=7, iters=1)
        ev.step(acts)
        ev.render()
        out[name] = ev
    return out, acts


class Ranges:
    """Stands in for ``torch.profiler.record_function``: keeps the stack
    of open ranges, each range's (label, enclosing label) and, under
    ``ops()``, the innermost range of each operator dispatched."""

    def __init__(self):
        self.stack, self.opened, self.seen = [], [], []

    def __call__(self, label):
        ranges = self

        class Range:
            def __enter__(self):
                ranges.opened.append(
                    (label, ranges.stack[-1] if ranges.stack else None))
                ranges.stack.append(label)

            def __exit__(self, *exc):
                ranges.stack.pop()

        return Range()

    def ops(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ranges = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ranges.seen.append(ranges.stack[-1] if ranges.stack
                                   else None)
                return func(*args, **(kwargs or {}))

        return Mode()


def test_off_mode_records_nothing(flagship, monkeypatch):
    evs, acts = flagship
    ev = evs["sort"]
    assert profiling.RECORDER.mode == "off"
    assert profiling.span("IK") is profiling.span("LBS")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ev.step(acts)
    names = {e.name for e in prof.events()}
    assert any(n.startswith("aten::") for n in names)
    assert not names & STAGE_LABELS
    ranges = Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    ev.step(acts)
    ev.render()
    count("env_steps", B)
    assert ranges.opened == []
    assert profiling.RECORDER.spans == []
    assert profiling.RECORDER.counts == {}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_profile_mode_matches_the_patched_stages(flagship, monkeypatch,
                                                 branch):
    """One step and render in ``profile`` mode: each stage's range opens
    inside the range of the stage whose function calls it, and nearly
    every operator runs under some stage."""
    evs, acts = flagship
    ev = evs[branch]
    ranges = Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    with recording("profile"), ranges.ops():
        ev.step(acts)
        ev.render()
    assert profiling.RECORDER.mode == "off"
    assert set(ranges.opened) == WHERE[branch]
    assert {label for label, _ in ranges.opened} <= STAGE_LABELS
    # the step's IK once, the render's once
    assert [p for label, p in ranges.opened if label == "IK"] == [
        "mimic (IK + FK)", "render: other" if branch == "off"
        else "compose_dyn"]
    unnamed = sum(label is None for label in ranges.seen)
    assert unnamed < 0.01 * len(ranges.seen)


def test_stamps_mode_on_the_cpu(flagship):
    evs, acts = flagship
    ev = evs["sort"]
    with recording("stamps") as rec:
        for _ in range(2):
            ev.step(acts)
            count("probe", 1)
            count("probe", torch.tensor(2))
            gc.collect()
            ev.render()
        record = rec.read()
    assert profiling.RECORDER.mode == "off"
    assert gc.callbacks.count(profiling.RECORDER._on_gc) == 0
    spans = record["spans"]
    assert spans and all(s["device"] is None and s["anchor"] == -1
                         for s in spans)
    assert record["anchors"] == [] and record["anchor_rtt_us"] == []
    assert {s["step"] for s in spans} == {0, 1}
    for i, s in enumerate(spans):
        t0, t1 = s["host"]
        assert t0 <= t1
        if s["parent"] < 0:
            assert s["label"] in ("step: other", "render: other")
            continue
        p = spans[s["parent"]]
        assert p["host"][0] <= t0 and t1 <= p["host"][1] and p["step"] == \
            s["step"] and s["parent"] < i

    def chain(s):
        out = []
        while s["parent"] >= 0:
            s = spans[s["parent"]]
            out.append(s["label"])
        return out

    by = {}
    for s in spans:
        by.setdefault(s["label"], []).append(s)
    assert [s["step"] for s in by["step: other"]] == [0, 1]
    assert [chain(s) for s in by["IK"]] == [
        ["mimic (IK + FK)", "step: other"],
        ["compose_dyn", "render: other"]] * 2
    assert all(chain(s) == ["step: other"] for s in by["freezes"])
    assert all(chain(s)[-1] == "render: other" for s in by["LBS"])
    counts = profiling.step_counts(record)
    for step in (0, 1):
        c = counts[step]
        assert c["probe"] == 3 and c["env_steps"] == B
        assert c["gc_collections"] >= 1 and c["gc_ms"] >= 0
        assert 0 <= c["capped_env_steps"] <= B
        assert 0 < c["contact_slots"] <= B * 512 and c["self_rows"] >= 0
    walls = profiling.step_walls(record)
    assert sorted(walls) == [0, 1] and all(w > 0 for w in walls.values())


class FakeEvent:
    """A CUDA event of a fake card whose clock runs OFFSET_NS ahead of the
    host's and which runs an event when it is recorded. The host learns
    of it 1 ms later, and 10 ms later on the first of every three waits
    (the first try of each anchor)."""

    OFFSET_NS = 5_000_000_000
    waits = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns() + self.OFFSET_NS

    def synchronize(self):
        FakeEvent.waits += 1
        time.sleep(0.011 if FakeEvent.waits % 3 == 1 else 0.001)

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_stamps_on_a_fake_card(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a: None)
    with recording("stamps") as rec:
        for _ in range(3):
            with profiling.span("step: other", new_step=True):
                with profiling.span("IK"):
                    pass
            with profiling.host_span("reset"):
                pass
            profiling.anchor()
        record = rec.read()
    rtt = record["anchor_rtt_us"]
    # the first anchor at start, one after each step; each kept the
    # shortest of its tries, not the one that waited 10 ms more
    assert len(rtt) == len(record["anchors"]) == 4
    assert all(1000 <= r < 10_000 for r in rtt)
    spans = record["spans"]
    assert [s["anchor"] for s in spans] == [0, 0, -1, 1, 1, -1, 2, 2, -1]
    for s in spans:
        if s["label"] == "reset":
            assert s["device"] is None
            continue
        # the card ran each event just after its host stamp, and the
        # anchor's at the start of its round trip: the anchor, at the
        # round trip's middle, puts each event within half of it (an
        # anchor at the round trip's end would put them a whole one late)
        err = rtt[s["anchor"]] / 2e3
        for k in (0, 1):
            gap = s["device"][k] - s["host"][k]
            assert -err <= gap <= err + 0.2
    lines = profiling.report(record)
    assert any(line.startswith("anchors 4: round trip us p50")
               for line in lines)


def test_trace_step_stamps(flagship):
    from real2sim_eval_tpu_torch.experiments.utils.trace_step import stamp

    evs, acts = flagship
    record = stamp(evs["off"], acts, 2)
    assert profiling.RECORDER.mode == "off"
    assert sorted(profiling.step_walls(record)) == [0, 1]
    assert record["anchors"] == [] and record["anchor_rtt_us"] == []
    lines = profiling.report(record)
    assert lines[0].startswith("stamped steps 2")
    assert any(line.startswith("a lane-step:") for line in lines)


def test_build_spans_cover_each_reset(tmp_path):
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.parallel.assets import assets_tree

    rope = tt.make_rope_points(n=60, length=0.3)
    tt.write_fixture_checkpoint(tmp_path, "rope_spans", rope, spring_Y=2e3)
    gs = tt.make_synthetic_scene(tmp_path / "scans", rope_pts=rope,
                                 ik_urdf=tt.BUILTIN_URDF, n_table=200)
    cfg = tt.full_cfg(tmp_path, "rope_spans", gs=gs, cameras=tt.TEST_CAMERAS,
                      physics_over=dict(dt=2e-4))
    episodes = [0, 3, 5]
    with recording("stamps") as rec:
        assets_tree(cfg, episodes, device="cpu")
        record = rec.read()
    spans = record["spans"]
    resets = [s for s in spans if s["label"] == "reset"]
    assert len(resets) == len(episodes)
    assert all(s["step"] == -1 and s["parent"] == -1 for s in resets)
    ends = [s["host"][1] for s in resets]
    assert all(a < b for a, b in zip(ends, [s["host"][0]
                                            for s in resets][1:]))
    assert any(s["label"] == "PLY read" for s in spans)
    total = sum(s["host"][1] - s["host"][0] for s in resets) / 1e3
    assert f"reset 3x {total:.2f} s" in "\n".join(profiling.report(record))


def span_row(label, parent, step, host, device=None, anchor=-1):
    return {"label": label, "parent": parent, "step": step, "host": host,
            "device": device, "anchor": -1 if device is None else anchor}


def test_report_on_a_written_record():
    """20 control steps on the host clock (ms), each step's wall 5 ms but
    step 4's 6 and steps 7 and 13's 9: the window's 90th percentile lies
    at 6.3, so only steps 7 and 13 are taken apart."""
    walls = {st: 5.0 for st in range(20)}
    walls.update({4: 6.0, 7: 9.0, 13: 9.0})
    rows, anchors, counts = [], [], []
    for st, w in walls.items():
        b, i = 10.0 * st, len(rows)
        rows += [
            span_row("step: other", -1, st, [b, b + 2.0], [b + 0.1, b + 3.0],
                     st),
            span_row("IK", i, st, [b + 0.2, b + 0.4], [b + 0.3, b + 1.3],
                     st),
            span_row("render: other", -1, st, [b + 2.1, b + 2.5],
                     [b + 3.0, b + w - 0.5], st)]
        anchors.append(b + w)
        counts += [[st, "env_steps", 64.0], [st, "contact_slots", 640.0],
                   [st, "ik_launches", 2.0]]
    counts += [[13, "gc_collections", 1.0], [13, "gc_ms", 4.5],
               [7, "capped_env_steps", 3.0]]
    rows.append(span_row("reset", -1, -1, [-900.0, -400.0]))
    record = {"spans": rows, "anchors": anchors, "counts": counts,
              "anchor_rtt_us": [20.0] * 19 + [60.0]}
    assert profiling.step_walls(record) == pytest.approx(walls)
    lines = profiling.report(record)
    text = "\n".join(lines)
    assert lines[0] == "stamped steps 20: wall ms p50 5.00 p90 6.30"
    assert [line.split(":")[0] for line in lines
            if line.startswith("slow")] == ["slow step 7", "slow step 13"]
    assert ("slow step 13: wall 9.00 ms, gc 1 (4.50 ms), syncs 0, IK "
            "launches 2") in text
    assert "  IK: host 0.20 (median 0.20) device 1.00 (median 1.00)" in text
    assert ("  render: other: host 0.40 (median 0.40) device 5.50 "
            "(median 1.50)") in text
    assert ("a lane-step: live contact slots 10.00, live self-collision "
            "rows 0.00, capped 3 of 1280 env-steps") in text
    assert ("anchors 20: round trip us p50 20.0 p90 20.0 max 60.0 (the "
            "clock's error is half)") in text
    assert "build spans reset 1x 0.50 s" in text


# ---------------------------------------------------------------------------
# mesh groups: attached meshes posed per episode
# ---------------------------------------------------------------------------


@pytest.fixture
def single_thread():
    """One torch thread: the suite runs files side by side in workers."""
    from torch_cli_scene import one_thread

    with one_thread():
        yield


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    """The tiny sloth-shaped scene of ``test_torch_mesh_groups`` (its
    container on two cells over 4 lanes) built on the incremental branch
    with the wrist pre-cull on, inside a ``stamps`` recording, and the
    recording's record of the build."""
    from test_torch_mesh_groups import BRANCHES as GB
    from test_torch_mesh_groups import EPISODES, write_scene

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from torch_cli_scene import one_thread

    cfg = write_scene(tmp_path_factory.mktemp("spans_groups"))
    with one_thread(), recording("stamps") as rec:
        ev = BatchedEvaluator(cfg, EPISODES, raster_config=GB["on"],
                              device="cpu")
        record = rec.read()
    return ev, record


def test_mesh_groups_counter_and_build_span(grouped, flagship,
                                           single_thread):
    """The build counts its mesh groups (2 here) under ``mesh_groups`` and
    builds the per-group static rasters and pre-cull blocks inside host
    spans ``static rasters (mesh groups)``; a flagship build with one mesh
    pose counts 1."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator

    ev, record = grouped
    assert ev.n_mesh_groups == 2
    assert profiling.step_counts(record)[-1]["mesh_groups"] == 2
    builds = [s for s in record["spans"]
              if s["label"] == "static rasters (mesh groups)"]
    assert len(builds) == 2                  # fixed cameras, wrist blocks
    assert all(s["step"] == -1 and s["device"] is None for s in builds)
    evs, _ = flagship
    with recording("stamps") as rec:
        one = BatchedEvaluator(evs["sort"].assets, list(range(B)),
                               raster_config=BRANCHES["sort"], device="cpu")
        counts = profiling.step_counts(rec.read())
    assert one.n_mesh_groups == 1 and counts[-1]["mesh_groups"] == 1


def test_mesh_groups_span_only_with_groups(grouped, flagship, monkeypatch,
                                           single_thread):
    """``mesh groups`` opens in ``profile`` mode where the lanes hold two
    mesh poses: inside the render (the fixed cameras' static segments),
    and in the wrist pipeline where the wrist is not culled (each lane's
    static scene); the culled wrist reads block bounds gathered per lane
    at build, so it opens nothing there. With one pose it opens nowhere."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import RasterConfig

    ev, _ = grouped
    ranges = Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    with recording("profile"):
        ev.render()
    assert {p for label, p in ranges.opened if label == "mesh groups"} == {
        "render: other"}
    unculled = BatchedEvaluator(ev.assets, ev.episode_ids, device="cpu",
                                raster_config=RasterConfig(
                                    incremental="on", wrist_precull="off"))
    ranges.opened.clear()
    with recording("profile"):
        unculled.render()
    assert {p for label, p in ranges.opened if label == "mesh groups"} == {
        "render: other", "wrist pipeline"}
    evs, acts = flagship
    for one in evs.values():
        ranges.opened.clear()
        with recording("profile"):
            one.step(acts)
            one.render()
        assert ranges.opened and all(label != "mesh groups"
                                     for label, _ in ranges.opened)


def test_mesh_groups_span_under_a_profiler(grouped, flagship,
                                           single_thread):
    """With the recorder off, ``mesh groups`` still names its operators in
    a ``torch.profiler`` session's trace (a benchmark's traced run), where
    there are groups; with one group, and with no profiler, nothing opens."""
    ev, _ = grouped
    assert profiling.RECORDER.mode == "off"
    assert profiling.span("mesh groups", traced=True) is profiling.span("IK")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        ev.render()
    assert "mesh groups" in {e.name for e in prof.events()}
    evs, _ = flagship
    with torch.profiler.profile(activities=acts) as prof:
        evs["sort"].render()
    assert "mesh groups" not in {e.name for e in prof.events()}
