"""Whole runs of a tiny cell on the CPU: the result line, the output
check against the reference (sound, and with the timed path broken
underneath), a refusal without a card, and a cell added from new files
alone."""

import dataclasses
import json
import shutil

import pytest
import torch

from gpu_bench.harness import cell as cell_mod
from gpu_bench.harness import check, main
from gpu_bench.tests.tiny import args, shrink, tiny

CELL = "rope.manipulate64"
PUSHT = "pusht.push64"


@pytest.fixture(autouse=True)
def short(monkeypatch):
    """Four torch threads, and 5 stabilization and 3 warm-up steps."""
    from gpu_bench.harness import bare

    monkeypatch.setattr(bare, "STABILIZE_STEPS", 5)
    monkeypatch.setattr(bare, "WARMUP_STEPS", 3)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_result_line():
    out = main.execute(args(CELL), tiny(CELL), dev="cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "recorded", "compared"}
    assert set(out["metrics"]) == {"env_steps_per_s", "control_step_ms_p95",
                                   "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    # the reference agrees with the program at this size
    assert out["correct"], out["compared"]
    json.dumps(out)


def test_traced_result_line():
    out = main.execute(args(CELL, trace=1), tiny(CELL), dev="cpu")
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "recorded", "compared"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    # a CPU trace has no card events: no device metric is read from it
    assert "kinematics.ik_device_ms" not in out["metrics"]
    assert out["correct"]


def _unchanged(orig):
    def step(self, actions, do_velocity_control=None):
        return self.state
    return step


def _half(orig):
    def step(self, actions, do_velocity_control=None):
        before = self.state
        after = orig(self, actions, do_velocity_control)
        B = after.sm.x.shape[0]
        keep = torch.arange(B, device=after.sm.x.device) < B // 2

        def mix(a, b):
            m = keep.reshape((B,) + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        sm = dataclasses.replace(after.sm, x=mix(after.sm.x, before.sm.x),
                                 v=mix(after.sm.v, before.sm.v))
        self.state = after.replace(sm=sm,
                                   grippers=mix(after.grippers,
                                                before.grippers),
                                   qpos7=mix(after.qpos7, before.qpos7))
        return self.state
    return step


def _frame_altered(orig):
    def render(self):
        rgb, depth, wrgb, wdepth = orig(self)
        rgb = rgb.clone()
        rgb[..., 20:28, 40:48] += 0.25
        return rgb, depth, wrgb, wdepth
    return render


@pytest.mark.parametrize("attr,fault", [
    ("step", _unchanged), ("step", _half), ("render", _frame_altered)],
    ids=["state_unchanged", "half_batch", "frame_altered"])
def test_fault_is_not_correct(monkeypatch, attr, fault):
    """The run with the timed path broken underneath comes out not
    correct (the card check is skipped: the run is on the CPU)."""
    from real2sim_eval_tpu_torch.parallel import batched

    orig = getattr(batched.BatchedEvaluator, attr)
    monkeypatch.setattr(batched.BatchedEvaluator, attr, fault(orig))
    out = main.execute(args(CELL), tiny(CELL), dev="cpu")
    assert not out["correct"], out["compared"]


def _k3(fault):
    """The program's spring-mass step (K3) broken where it produces the
    particles: ``fault(orig, opts, tab, state)`` in its place."""
    def wrap(orig):
        def step(opts, tab, state, *a, **k):
            return fault(orig, opts, tab, state, *a, **k)
        return step
    return wrap


def _k3_unchanged(orig, opts, tab, state, *a, **k):
    out = orig(opts, tab, state, *a, **k)
    return dataclasses.replace(out, x=state.x, v=state.v)


def _k3_no_springs(orig, opts, tab, state, *a, **k):
    tab = dataclasses.replace(tab, nbr_k=torch.zeros_like(tab.nbr_k),
                              nbr_c=torch.zeros_like(tab.nbr_c))
    return orig(opts, tab, state, *a, **k)


def _k3_half(orig, opts, tab, state, *a, **k):
    out = orig(opts, tab, state, *a, **k)
    B = out.x.shape[0]
    keep = (torch.arange(B) < B // 2)[:, None, None]
    return dataclasses.replace(out, x=torch.where(keep, out.x, state.x),
                               v=torch.where(keep, out.v, state.v))


def _k3_bfloat16(orig, opts, tab, state, *a, **k):
    out = orig(opts, tab, state, *a, **k)
    return dataclasses.replace(out, x=out.x.bfloat16().float(),
                               v=out.v.bfloat16().float())


def _k3_particle_moved(orig, opts, tab, state, *a, **k):
    out = orig(opts, tab, state, *a, **k)
    x = out.x.clone()
    x[:, 7, 2] += 1e-3
    return dataclasses.replace(out, x=x)


@pytest.mark.parametrize("fault", [
    _k3_unchanged, _k3_no_springs, _k3_half, _k3_bfloat16,
    _k3_particle_moved],
    ids=["unchanged", "no_springs", "half_batch", "bfloat16",
         "particle_moved"])
def test_k3_fault_is_not_correct(monkeypatch, fault):
    """The spring-mass step broken underneath, with everything else of the
    control step sound, comes out not correct on push-T, whose limits
    hold the particles' positions (rope's hold only their velocities,
    which these faults at this size leave within them)."""
    from real2sim_eval_tpu_torch.physics import fused_step

    monkeypatch.setattr(fused_step, "spring_mass_step",
                        _k3(fault)(fused_step.spring_mass_step))
    out = main.execute(args(PUSHT), tiny(PUSHT), dev="cpu")
    assert not out["correct"], out["compared"]


def test_control_is_not_correct():
    """The control (the reference a precision lower, in the program's
    place) fails push-T's limits; the program passes them."""
    cell = tiny(PUSHT)
    out = main.execute(args(PUSHT, control=1), cell, dev="cpu")
    assert out["correct"], out["compared"]
    ok, rows = check.verdict(dict(out["control"], start_gap=0.0),
                             cell.limits)
    assert not ok, rows


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main.main(["--workload", CELL, "--seed", "1", "--seconds", "1"])
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == ""
    assert "no card" in cap.err


def test_cell_from_new_files(tmp_path):
    """A cell whose traffic, limits and entry are new files and entries,
    with no edit to a file of the benchmark, runs."""
    files = tmp_path / "gpu_bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(cell_mod.BENCH / sub, files / sub)
    hold = json.loads((files / "traffic" / "manipulate.json").read_text())
    hold["lanes"] = 4
    for ph in hold["cycle"]["phases"]:
        ph.update(grip=0, z=[0.1])
        ph.pop("xy", None)
    (files / "traffic" / "hold.json").write_text(json.dumps(hold))
    shutil.copy(files / "limits" / f"{CELL}.json",
                files / "limits" / "rope.hold4.json")
    bench = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "rope.hold4", "config": "rope",
                               "traffic": "hold", "chips": 1,
                               "why": "the eef held above the rope"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("rope.hold4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = shrink(cell_mod.find("rope.hold4", root=tmp_path, files=files))
    assert cell.traffic["cycle"]["phases"][0]["z"] == [0.1]
    out = main.execute(args("rope.hold4"), cell, dev="cpu")
    assert set(out["metrics"]) == {"env_steps_per_s", "control_step_ms_p95",
                                   "setup_s"}
    assert out["correct"]
