"""Policy inference protocol + built-in test policies (the JAX package's
experiments/policy_api.py).

The reference consumes an external ``policy/`` git submodule exposing
``PolicyInferenceWrapper(inference_cfg_path, checkpoint_path, local_rank)``
with ``.inference(obs_dict) -> (n, 8)`` cartesian actions, ``.reset()`` and
``.visualize_overlay(img)`` (reference: experiments/eval_policy.py:22,58-62,
181,255; checkpoints: ACT / Diffusion Policy / pi0 / SmolVLA).

Here the same contract is a small protocol. ``load_policy`` resolves, in
order: the external ``policy`` package if importable (drop-in for users of
the reference), a dotted ``wrapper_class`` from the config, or a named
built-in (scripted/hold) for testing and benchmarks.

obs_dict keys (eval_policy.py:175-178), host numpy arrays:
  observation.state           (n, 8) [xyz, quat_wxyz, gripper(policy space)]
  observation.images.front    (1, 3, H, W)
  observation.images.wrist    (1, 3, H, W)
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class PolicyProtocol(Protocol):
    def inference(self, obs_dict: dict): ...

    def reset(self) -> None: ...

    def visualize_overlay(self, image): ...


def load_policy(policy_cfg, local_rank: int = 0) -> PolicyProtocol:
    name = policy_cfg.get("builtin")
    if name:
        return _BUILTINS[name](policy_cfg)
    wrapper_class = policy_cfg.get("wrapper_class")
    if wrapper_class:
        module, _, cls = wrapper_class.rpartition(".")
        klass = getattr(importlib.import_module(module), cls)
        return klass(
            inference_cfg_path=policy_cfg.get("inference_cfg_path"),
            checkpoint_path=policy_cfg.get("checkpoint_path"),
            local_rank=local_rank)
    try:
        from policy.inference.inference_wrapper import PolicyInferenceWrapper
    except ImportError as e:
        raise ImportError(
            "no policy available: install the policy submodule, set "
            "policy.wrapper_class, or choose a policy.builtin "
            f"({sorted(_BUILTINS)})") from e
    return PolicyInferenceWrapper(
        inference_cfg_path=policy_cfg.get("inference_cfg_path"),
        checkpoint_path=policy_cfg.get("checkpoint_path"),
        local_rank=local_rank)


class HoldPolicy:
    """Holds the current eef pose (smoke-test policy)."""

    def __init__(self, policy_cfg=None):
        pass

    def inference(self, obs_dict):
        state = np.asarray(obs_dict["observation.state"]).astype(np.float32)
        if state.shape[-1] == 2:  # pusher mode: state is eef (x, y)
            pad = np.zeros((state.shape[0], 6), np.float32)
            pad[:, 0] = 0.22  # the caller reads xyz and imposes level height
            return np.concatenate([state, pad], axis=1)
        return state.reshape(-1, 8)

    def reset(self):
        pass

    def visualize_overlay(self, image):
        return image


class ScriptedPolicy:
    """Replays actions from a json file: a list of 8-d cartesian actions
    [xyz, quat_wxyz, gripper(policy space)] — lets eval_policy run without
    a learned checkpoint."""

    def __init__(self, policy_cfg):
        path = policy_cfg.get("script_path") or policy_cfg.get("checkpoint_path")
        with open(path) as f:
            self.actions = np.asarray(json.load(f), np.float32)
        self.t = 0

    def inference(self, obs_dict):
        a = self.actions[min(self.t, len(self.actions) - 1)]
        self.t += 1
        return a.reshape(1, 8)

    def reset(self):
        self.t = 0

    def visualize_overlay(self, image):
        return image


_BUILTINS = {"hold": HoldPolicy, "scripted": ScriptedPolicy}
