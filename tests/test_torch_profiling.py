"""The port's profiling tools on the CPU: ``utils/profiling.py``,
``experiments/utils/trace_step.py`` and ``profile_physics.py``.

Held: ``ScopedTimer`` and ``StepTimer`` as tests/test_aux.py holds the
JAX ones, run against both packages; ``device_trace`` writes a Chrome
trace that ``parse_trace`` reads; ``parse_trace``'s self times, exactly,
on a hand-written trace (nested stages, a graph launch with two kernels,
a copy, an unannotated kernel; nested CPU operators); ``trace_step.main``
at ``--device cpu`` on a 2-lane flagship cut to 60 particles, 4 substeps
and the 64x128 test cameras, its CPU time under the named stages; the
physics ablation's four variants on ``profile_scene`` (60 particles, 2
envs, 4 substeps) against the JAX ``make_step_fn`` with the same options
on the same numpy arrays, within 3e-5 m (tests/test_pallas_step.py:77)."""

import dataclasses
import importlib
import json
import time

import numpy as np
import pytest
import torch

PACKAGES = ("real2sim_eval_tpu", "real2sim_eval_tpu_torch")


@pytest.mark.parametrize("package", PACKAGES)
def test_scoped_timer_accumulates(package):
    ScopedTimer = importlib.import_module(
        f"{package}.utils.profiling").ScopedTimer

    ScopedTimer.reset()
    ScopedTimer.enabled = False
    with ScopedTimer("off"):
        pass
    assert "off" not in ScopedTimer.totals  # disabled by default (parity)

    ScopedTimer.enabled = True
    try:
        for _ in range(3):
            with ScopedTimer("work", synchronize=True):
                time.sleep(0.002)
        assert ScopedTimer.counts["work"] == 3
        assert ScopedTimer.totals["work"] >= 0.006
        assert "work" in ScopedTimer.report()
    finally:
        ScopedTimer.enabled = False
        ScopedTimer.reset()


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("sync", (False, True))
def test_step_timer(package, sync):
    StepTimer = importlib.import_module(
        f"{package}.utils.profiling").StepTimer

    t = StepTimer(sync=sync)
    t.start()
    time.sleep(0.005)
    dt, fps = t.stop()
    assert dt >= 0.005
    assert fps <= 200


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from real2sim_eval_tpu_torch.experiments.utils.trace_step import (
        parse_trace)
    from real2sim_eval_tpu_torch.utils.profiling import (device_trace,
                                                         sync_devices)

    with device_trace(tmp_path / "t"):
        with torch.profiler.record_function("stage A"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        torch.zeros(8) + 1
    sync_devices()
    sync_devices("cpu")
    (path,) = (tmp_path / "t").glob("*.pt.trace.json")
    assert json.loads(path.read_text())["traceEvents"]
    table = parse_trace(tmp_path / "t")
    assert table.source == "cpu"
    assert table.by_stage["stage A"] > 0 and table.counts["stage A"] >= 2
    assert table.counts["unattributed"] >= 1
    assert table.total_us == pytest.approx(sum(table.by_stage.values()))


def X(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def test_parse_trace_self_times(tmp_path):
    """Device events under the innermost stage around their launch: a
    graph launch's two kernels, a copy, a kernel launched outside every
    stage, one whose launch is missing; the CPU operators are ignored
    when the card's events are there, and read when they are not."""
    from real2sim_eval_tpu_torch.experiments.utils.trace_step import (
        parse_trace)

    ann = [X("user_annotation", "step: other", 0, 100),
           X("user_annotation", "mimic (IK + FK)", 5, 60),
           X("user_annotation", "IK", 10, 50),
           X("user_annotation", "render: other", 200, 100)]
    dev = [X("cuda_runtime", "cudaGraphLaunch", 20, 5, correlation=7),
           X("kernel", "k_a", 1000, 30, pid=0, tid=7, correlation=7),
           X("kernel", "k_b", 1040, 20, pid=0, tid=7, correlation=7),
           X("cuda_runtime", "cudaLaunchKernel", 70, 3, correlation=8),
           X("kernel", "k_c", 1100, 10, pid=0, tid=7, correlation=8),
           X("cuda_runtime", "cudaLaunchKernel", 150, 3, correlation=9),
           X("kernel", "k_d", 1200, 5, pid=0, tid=7, correlation=9),
           X("cuda_runtime", "cudaMemcpyAsync", 250, 3, correlation=10),
           X("gpu_memcpy", "Memcpy DtoH", 1300, 4, pid=0, tid=8,
             correlation=10),
           X("kernel", "k_lost", 1400, 2, pid=0, tid=7, correlation=99),
           X("gpu_user_annotation", "IK", 1000, 60, pid=0, tid=7)]
    cpu = [X("cpu_op", "aten::linear", 30, 20),
           X("cpu_op", "aten::addmm", 32, 15),
           X("cpu_op", "aten::add", 120, 5)]
    meta = [{"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "GPU 0"}}]
    path = tmp_path / "a.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": meta + ann + dev + cpu}))
    t = parse_trace(path)
    assert t.source == "device" and t.n_events == 6
    assert dict(t.by_stage) == {"IK": 50.0, "step: other": 10.0,
                                "render: other": 4.0, "unattributed": 7.0}
    assert dict(t.counts) == {"IK": 2, "step: other": 1, "render: other": 1,
                              "unattributed": 2}
    assert t.by_op[("IK", "k_a")] == 30.0 and t.total_us == 71.0

    path.write_text(json.dumps({"traceEvents": meta + ann + cpu}))
    t = parse_trace(tmp_path)
    assert t.source == "cpu" and t.n_events == 3
    assert dict(t.by_stage) == {"IK": 20.0, "unattributed": 5.0}
    assert t.by_op[("IK", "aten::linear")] == 5.0
    assert t.by_op[("IK", "aten::addmm")] == 15.0


def test_trace_step_main_on_the_cpu(monkeypatch, tmp_path, capsys):
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.experiments.utils import trace_step

    make = tt.make_flagship_assets

    def small(**kw):
        a = make(n_rope=60, **kw)
        return dataclasses.replace(a, opts=dataclasses.replace(
            a.opts, num_substeps=4))

    monkeypatch.setattr(tt, "make_flagship_assets", small)
    monkeypatch.setattr(tt, "CAMERAS", tt.TEST_CAMERAS)
    table = trace_step.main(["--device", "cpu", "--batch", "2", "--iters",
                             "1", "--gaussians", "200", "--out",
                             str(tmp_path / "trace")])
    assert table.source == "cpu"
    for stage in ("IK", "K3 spring_mass_step", "LBS", "K1 tile_composite",
                  "freezes", "step: other", "render: other"):
        assert table.by_stage[stage] > 0, stage
    named = table.total_us - table.by_stage["unattributed"]
    assert named > 0.95 * table.total_us
    out = capsys.readouterr().out
    assert "ms/iter" in out and "top ops per stage" in out


@pytest.mark.parametrize("variant", ("full", "no-selfcollision",
                                     "no-contact", "springs-only"))
def test_profile_physics_variants_match_jax(variant):
    import jax
    import jax.numpy as jnp

    from real2sim_eval_tpu.physics import sdf as jsdf
    from real2sim_eval_tpu.physics import spring_mass as jsm
    from real2sim_eval_tpu.physics.topology import build_rolled_tables
    from real2sim_eval_tpu_torch.experiments.utils import profile_physics as pp

    batch, n, substeps = 2, 60, 4
    _, self_c, has_c = {v[0]: v for v in pp.VARIANTS}[variant]
    sc = pp.profile_scene(batch, n)
    inp = pp.physics_inputs(sc, "cpu")
    step = pp.variant_step(substeps, "cpu", self_c, has_c)
    out = step(inp["params"], inp["colliders"] if has_c else None,
               inp["state"], inp["ctrl"], inp["rest_x"])

    rolled = build_rolled_tables(sc["springs"], sc["rest_lengths"],
                                 sc["spring_Y_log"], n)
    f32 = {k: jnp.asarray(np.float32(v)) for k, v in (
        ("collide_elas", 0.5), ("collide_fric", 0.3),
        ("collide_eef_elas", 0.0), ("collide_eef_fric", 1.0),
        ("collide_self_elas", 0.5), ("collide_self_fric", 0.3))}
    params = jsm.SpringMassParams(
        springs=jnp.asarray(sc["springs"]),
        rest_lengths=jnp.asarray(sc["rest_lengths"]),
        spring_Y_log=jnp.asarray(sc["spring_Y_log"]),
        masses=jnp.ones((n,), jnp.float32),
        nbr_idx=jnp.asarray(sc["nbr_idx"]),
        nbr_rest=jnp.asarray(sc["nbr_rest"]),
        nbr_Y_log=jnp.asarray(sc["nbr_Y_log"]),
        roll_rest=jnp.asarray(rolled[1]) if rolled else None,
        roll_Y_log=jnp.asarray(rolled[2]) if rolled else None,
        roll_offsets=tuple(int(o) for o in rolled[0]) if rolled else (),
        collision_mask=jnp.arange(n, dtype=jnp.int32),
        rest_x=jnp.asarray(sc["rope"]), **f32)
    finger = jsdf.SdfGrid(**{k: jnp.asarray(v)
                             for k, v in sc["finger"].items()})
    static = jsdf.SdfGrid(**{k: jnp.asarray(v)
                             for k, v in sc["static"].items()})
    colliders = jsm.MeshColliderSet(
        fingers=(finger, finger),
        finger_pose_table=jnp.asarray(sc["finger_pose_table"]),
        statics=(static,), static_pose=jnp.asarray(sc["static_pose"]))
    ctrl = jsm.SubstepControls(**{k: jnp.asarray(v)
                                  for k, v in sc["ctrl"].items()})
    state = jsm.SpringMassState(x=jnp.asarray(sc["x"]),
                                v=jnp.zeros((batch, n, 3)),
                                finger_forces=jnp.zeros((batch, 2, 3)))
    opts = jsm.PhysicsOptions(dt=5e-5, num_substeps=substeps, fps=30,
                              self_collision=self_c, n_fingers=2)
    jstep = jsm.make_step_fn(opts, has_colliders=has_c)
    coll = colliders if has_c else None
    ref = jax.jit(jax.vmap(lambda s, c: jstep(params, coll, s, c)))(
        state, ctrl)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=3e-5)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v),
                               atol=3e-5 * 50)
    assert float(np.abs(np.asarray(ref.x) - sc["x"]).max()) > 0.0
