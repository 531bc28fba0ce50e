"""Each per-layer metric's reader on a small synthetic trace, and the
trace reading under them."""

import json

import pytest

from gpu_bench.harness import cell as cell_mod
from gpu_bench.harness import trace as tr
from gpu_bench.harness.outputs import Run

# host spans (us) of two control steps on one thread, and the kernels
# each launched: (span, launch ts, kernel ts, kernel dur)
SPANS = [("window", 0, 2000),
         ("step: other", 0, 500), ("mimic (IK + FK)", 10, 200),
         ("IK", 20, 150), ("grasp + controls", 200, 250),
         ("freezes", 250, 300), ("K3 spring_mass_step", 300, 480),
         ("render: other", 500, 1000), ("compose_dyn", 510, 700),
         ("IK", 520, 600), ("LBS", 610, 650), ("articulation", 650, 690),
         ("wrist pipeline", 700, 990), ("K1 tile_composite", 900, 980),
         ("step: other", 1000, 1500), ("render: other", 1500, 2000)]
KERNELS = [("IK", 30, 40, 100), ("IK", 530, 540, 50),
           ("grasp + controls", 210, 230, 10), ("freezes", 260, 300, 20),
           ("K3 spring_mass_step", 310, 330, 150),
           ("LBS", 620, 660, 20), ("articulation", 660, 700, 10),
           ("compose_dyn", 695, 712, 5),
           ("K1 tile_composite", 910, 950, 30),
           ("wrist pipeline", 710, 800, 40),
           ("render: other", 995, 1000, 4),
           ("step: other", 1010, 1020, 400),
           ("render: other", 1510, 1520, 300)]


def write_trace(path):
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
               "dur": b - a, "pid": 1, "tid": 1} for n, a, b in SPANS]
    for i, (_, launch, ts, dur) in enumerate(KERNELS):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                       "pid": 1, "tid": 1, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{i}",
                       "ts": ts, "dur": dur, "pid": 0, "tid": 7,
                       "args": {"correlation": i}})
    path.write_text(json.dumps({"traceEvents": events}))
    return path


@pytest.fixture
def run(tmp_path):
    path = write_trace(tmp_path / "t.pt.trace.json")
    traced = {"table": tr.parse_trace(path), "missing": [], "steps": 2,
              **tr.busy_and_gaps(path, tr.window_of(path))}
    return Run(lanes=2, steps=2, window_s=0.002, step_ms=[1.0, 1.0],
               setup_s=1.0, attempted=4, failed=0, memory_peak=0,
               traced=traced, check_lanes=[0, 1], episode_ids=[0, 1],
               init_state={}, samples=[],
               extra={"dirty_tiles": 12.5,
                      "k3_problem": {"lanes": 2, "particles": 100,
                                     "springs": 300, "substeps": 10,
                                     "self_pairs": 4.0,
                                     "self_collision": True}})


def read(name, run):
    return cell_mod.load_module(cell_mod.BENCH / "metrics" / f"{name}.py",
                                name).read(run)


def test_trace_reading(run):
    t = run.traced
    assert t["table"].source == "device"
    assert t["table"].by_stage["IK"] == pytest.approx(150.0)
    assert t["busy_s"] == pytest.approx(sum(k[3] for k in KERNELS) / 1e6)
    assert t["window_s"] == pytest.approx(2000 / 1e6)
    names = [n for n, _ in t["idle_gaps"]]
    assert "step: other" in names or "render: other" in names


def test_readers(run):
    assert read("kinematics.ik_device_ms", run) == pytest.approx(0.075)
    assert read("physics.device_ms", run) == pytest.approx(0.09)
    render = 20 + 10 + 5 + 30 + 40 + 4 + 300
    assert read("renderer.device_ms", run) == pytest.approx(render / 2e3)
    assert read("renderer.dirty_tiles", run) == 12.5
    busy = sum(k[3] for k in KERNELS)
    assert read("device.idle_pct.bare", run) == pytest.approx(
        100 * (1 - busy / 2000))
    k3 = read("kernels.k3_roofline_pct", run)
    ops = 10 * 2 * (2 * 300 * 30 + 100 * 30) + 10 * 4.0 * 45
    assert k3 == pytest.approx(100 * (ops / 67e12 * 1e3) / 0.075)


def test_missing_stage_reads_nothing(run):
    run.traced["missing"] = ["IK"]
    assert read("kinematics.ik_device_ms", run) is None
    assert read("physics.device_ms", run) is not None
    run.traced = None
    for name in ("kinematics.ik_device_ms", "physics.device_ms",
                 "renderer.device_ms", "kernels.k3_roofline_pct",
                 "device.idle_pct.bare"):
        assert read(name, run) is None


def test_every_metric_has_a_reader():
    bench = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (cell_mod.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_tally_fails_only_a_state_that_is_not_finite():
    from types import SimpleNamespace as NS

    import torch

    from gpu_bench.harness.outputs import Tally

    def post(capped, nan):
        x = torch.zeros(4, 5, 3)
        x[nan, 0, 0] = float("nan")
        tele = torch.zeros(4, 4, dtype=torch.int32)
        tele[capped, 2] = 7
        return NS(sm=NS(x=x, v=torch.zeros(4, 5, 3), telemetry=tele,
                        finger_forces=torch.zeros(4, 2, 3)),
                  grasp=NS(grasped=torch.zeros(4)),
                  grippers=torch.zeros(4, 14))

    render = (torch.zeros(1, 4, 3, dtype=torch.int32),
              torch.zeros(1, 4, dtype=torch.int32))
    tally = Tally()
    tally.add(post([0, 1], [3]), render, torch.zeros(4, 13))
    tally.add(post([1], []), render, torch.zeros(4, 13))
    attempted, failed, by = tally.failed()
    assert (attempted, failed) == (8, 1)
    assert by == {"contact_particles_dropped": 3, "not_finite": 1}
