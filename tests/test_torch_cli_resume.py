"""Mid-episode checkpoint and resume of the port's batched CLI, on the CPU
(tests/test_resume.py's case on the port alone): killed at step 12 after
the step-10 checkpoint landed, a resumed run completes all 30 steps,
leaves the step-9 artifact untouched, writes the batch's done marker and
removes the checkpoint; a second call is a no-op."""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest

from torch_cli_scene import one_thread, write_cfg


def test_kill_and_resume_mid_episode(tmp_path):
    from real2sim_eval_tpu_torch.experiments import eval_policy_batched as epb

    cfg = write_cfg(tmp_path, timestamp="resumerun", batch_size=2,
                    checkpoint_every=5, telemetry_every=10, resume=True,
                    policy=dict(builtin="hold", n_episodes=2,
                                inference_cfg_path=None,
                                checkpoint_path=None))
    orig = epb.EpisodeWriter.write_robot

    def bomb(self, step, *a, **kw):
        if step >= 12:
            raise KeyboardInterrupt("simulated crash")
        return orig(self, step, *a, **kw)

    run = Path(cfg.exp_root) / "output_eval_policy" / "resumerun"
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setattr(epb.EpisodeWriter, "write_robot", bomb)
        with pytest.raises(KeyboardInterrupt):
            epb.main(cfg, device="cpu")
        mp.undo()
        ckpt = run / "batch_00000.ckpt.pkl"
        with open(ckpt, "rb") as f:
            assert pickle.load(f)["extra"]["next_step"] == 10
        step9 = (run / "episode_0000/robot/000009.json").read_bytes()
        out = epb.main(cfg, device="cpu")              # resume
        assert epb.main(cfg, device="cpu") == out       # done: a no-op
    ep = Path(out) / "episode_0000"
    assert len(list((ep / "robot").glob("*.json"))) == 30
    assert len(list((ep / "state").glob("*.pkl"))) == 30
    assert (ep / "robot/000009.json").read_bytes() == step9
    with open(ep / "robot" / "000011.json") as f:
        after = json.load(f)
    np.testing.assert_allclose(json.loads(step9)["obs.ee_pos"],
                               after["obs.ee_pos"], atol=5e-3)
    assert not ckpt.exists()
    assert (run / "batch_00000.done").exists()
