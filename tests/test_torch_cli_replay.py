"""The port's ``replay.cli`` against the JAX package's at one episode, on
the CPU, in both recorded formats: ``ee_pos`` and ``qpos`` (the FK of the
tools' ``KinHelper``).

The scene and config are torch_cli_scene.py's; the recorded trajectory
descends 5 mm a step over 5 steps (tests/test_cli_e2e.py's), its qpos by
the port's ``KinHelper`` IK. Each replay runs once per package. Held: the
same files; ``renderer.x`` within 5e-5 at every step; the robot JSONs
(the eef among them) within 1e-5; the eef below its start."""

import json
from pathlib import Path

import pytest

from torch_cli_scene import assert_runs_match, one_thread, write_cfg, \
    write_descent

STEPS = 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from real2sim_eval_tpu.experiments import replay as jcli
    from real2sim_eval_tpu_torch.config import save_config
    from real2sim_eval_tpu_torch.experiments import replay as tcli

    root = tmp_path_factory.mktemp("replay_cli")
    cfg = write_cfg(root, gt_dir=str(root / "gt"), use_qpos=False,
                    randomize=False)
    save_config(cfg, root / "cfg" / "replay.yaml")
    write_descent(root / "gt", STEPS)
    out = {}
    with one_thread():
        for fmt in ("ee_pos", "qpos"):
            args = ["--config-path", str(root / "cfg"), f"timestamp={fmt}",
                    f"use_qpos={fmt == 'qpos'}"]
            out[fmt] = (
                Path(jcli.cli(args + [f"exp_root={root / 'jax'}"])),
                Path(tcli.cli(args + [f"exp_root={root / 'port'}",
                                      "--device", "cpu"])))
    return out


@pytest.mark.parametrize("fmt", ["ee_pos", "qpos"])
def test_replay_matches_jax(runs, fmt):
    jax_run, port_run = runs[fmt]
    assert_runs_match(jax_run, port_run, STEPS)
    robot = sorted((port_run / "episode_0000" / "robot").glob("*.json"))
    first, last = (json.load(open(p))["obs.ee_pos"][2]
                   for p in (robot[0], robot[-1]))
    assert last < first - 0.005
    assert (port_run / "final_images" / "episode_0000_camera_1.jpg").exists()
