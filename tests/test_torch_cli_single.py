"""The port's single-env CLIs against the JAX package's at one episode, on
the CPU: ``eval_policy.cli`` and the keyboard teleop's
``InteractivePlayground`` with a programmatic ``KeySource``.

The scene and config are torch_cli_scene.py's. Each CLI runs once per
package. Held: the same files; ``renderer.x`` within 5e-5 at every step;
the robot JSONs (the eef among them) within 1e-5; random variables and
calibration equal; the port's loop split and final particles; the
teleop's eef within 1e-5 of the JAX one's and moved +x."""

from pathlib import Path

import numpy as np
import pytest

from torch_cli_scene import STEPS, assert_runs_match, one_thread, write_cfg


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from real2sim_eval_tpu_torch.config import save_config

    root = tmp_path_factory.mktemp("single_cli")
    cfg = write_cfg(root, policy=dict(builtin="hold", n_episodes=1,
                                      inference_cfg_path=None,
                                      checkpoint_path=None))
    save_config(cfg, root / "cfg" / "eval_policy.yaml")
    save_config(cfg, root / "cfg" / "keyboard_teleop.yaml")
    return root


@pytest.fixture(scope="module")
def eval_runs(workspace):
    from real2sim_eval_tpu.experiments import eval_policy as jcli
    from real2sim_eval_tpu_torch.experiments import eval_policy as tcli

    args = ["--config-path", str(workspace / "cfg")]

    def on_mark(name, env):
        if name == "looped":
            stats["particles"] = env.unwrapped.get_state()["renderer"]["x"]

    stats = {"on_mark": on_mark}
    with one_thread():
        jax_run = jcli.cli(args + [f"exp_root={workspace / 'jax'}"])
        port_run = tcli.cli(args + [f"exp_root={workspace / 'port'}",
                                    "--device", "cpu"], stats=stats)
    return Path(jax_run), Path(port_run), stats


def test_eval_policy_matches_jax(eval_runs):
    jax_run, port_run, _ = eval_runs
    assert_runs_match(jax_run, port_run, STEPS)
    assert (port_run / "episode_0000" / "vis_camera_1.mp4").exists()


def test_eval_policy_stats(eval_runs):
    import pickle

    _, port_run, stats = eval_runs
    assert {k: len(v) for k, v in stats["ms"].items()} == {
        k: STEPS for k in ("write_images", "policy_inputs", "policy",
                           "write_robot_state", "env_step", "get_obs")}
    assert list(stats["marks"]) == ["start", "built", "stabilized", "looped",
                                    "done"]
    before_last = pickle.load(open(
        port_run / "episode_0000/state/000029.pkl", "rb"))["renderer"]["x"]
    assert stats["particles"].shape == tuple(before_last.shape)
    assert np.isfinite(stats["particles"]).all()


def test_teleop_matches_jax(workspace):
    from real2sim_eval_tpu.config import load_config as jload
    from real2sim_eval_tpu.experiments import keyboard_teleop as jtel
    from real2sim_eval_tpu_torch.config import load_config as tload
    from real2sim_eval_tpu_torch.experiments import keyboard_teleop as ttel
    from real2sim_eval_tpu_torch.utils.device import to_numpy

    eefs = []
    for mod, load, kw in ((jtel, jload, {}), (ttel, tload, {"device": "cpu"})):
        keys = mod.KeySource()
        for k in "wwwq":      # +x three times, +z once
            keys.push(k)
        cfg = load(workspace / "cfg", "keyboard_teleop")
        with one_thread():
            obs = mod.InteractivePlayground(cfg, key_source=keys,
                                            max_steps=3, show=False,
                                            **kw).run()
        eefs.append(to_numpy(obs["robot"]["eef_xyz"])[0])
    np.testing.assert_allclose(eefs[1], eefs[0], atol=1e-5)
    assert eefs[1][0] > 0.2568
