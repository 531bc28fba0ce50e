"""Interactive keyboard teleoperation (the JAX package's
experiments/keyboard_teleop.py).

Keys accumulate eef translation / rotation / gripper deltas which feed the
single env as 13-d cartesian actions (tensors on the env's device) while
the views are shown in a cv2 window when a display exists. The key
listener is pluggable: pynput when importable, raw-terminal stdin
otherwise, or a programmatic queue (used by tests). pynput and cv2 are
optional.

Bindings (reference keyboard_teleop.py:158-181):
  w/s: +-x   a/d: +-y   q/e: +-z
  i/k: pitch  j/l: yaw  u/o: roll
  f/g: close/open gripper   r: reset pose   esc: quit
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..utils import transforms as tf
from ..utils.device import resolve_device, to_numpy
from .cli import hydra_like_main, raster_config_from, run_name_for
from .eval_policy import env_action, robot_obs

KEY_BINDINGS = {
    "w": ("trans", np.array([1, 0, 0])), "s": ("trans", np.array([-1, 0, 0])),
    "a": ("trans", np.array([0, 1, 0])), "d": ("trans", np.array([0, -1, 0])),
    "q": ("trans", np.array([0, 0, 1])), "e": ("trans", np.array([0, 0, -1])),
    "i": ("rot", np.array([0, 1, 0])), "k": ("rot", np.array([0, -1, 0])),
    "j": ("rot", np.array([0, 0, 1])), "l": ("rot", np.array([0, 0, -1])),
    "u": ("rot", np.array([1, 0, 0])), "o": ("rot", np.array([-1, 0, 0])),
    "f": ("grip", -1.0), "g": ("grip", 1.0),
}


class KeySource:
    """Queue of pressed keys; backends push into it."""

    def __init__(self):
        self.keys: queue.Queue[str] = queue.Queue()
        self._stop = threading.Event()

    def push(self, key: str):
        self.keys.put(key)

    def drain(self) -> list[str]:
        out = []
        while True:
            try:
                out.append(self.keys.get_nowait())
            except queue.Empty:
                return out

    def start_listener(self):
        try:
            from pynput import keyboard  # noqa

            def on_press(key):
                try:
                    self.push(key.char)
                except AttributeError:
                    if key == keyboard.Key.esc:
                        self.push("\x1b")

            listener = keyboard.Listener(on_press=on_press)
            listener.daemon = True
            listener.start()
            return
        except ImportError:
            pass
        if sys.stdin.isatty():
            t = threading.Thread(target=self._stdin_loop, daemon=True)
            t.start()

    def _stdin_loop(self):
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while not self._stop.is_set():
                ch = sys.stdin.read(1)
                self.push(ch)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)


class InteractivePlayground:
    def __init__(self, cfg, key_source: KeySource | None = None,
                 max_steps: int | None = None, show: bool | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.keys = key_source or KeySource()
        self.max_steps = max_steps
        self.show = (os.environ.get("DISPLAY") is not None
                     if show is None else show)

        self.trans_step = float(cfg.get("translation_step", 0.01))
        self.rot_step = float(cfg.get("rotation_step", 0.05))
        self.grip_step = float(cfg.get("gripper_step", 0.05))
        self.save_states = bool(cfg.get("save_states", False))

    def run(self):
        import real2sim_eval_tpu_torch.envs as envs

        cfg = self.cfg
        env = envs.make(cfg.env_name, max_episode_steps=1_000_000, cfg=cfg,
                        randomize=False, exp_root=cfg.exp_root,
                        raster_config=raster_config_from(cfg),
                        device=self.device)
        obs, _ = env.reset(seed=0)
        self.keys.start_listener()

        xyz, quat, gripper = robot_obs(obs)
        init_xyz, init_quat = xyz[0], quat[0]
        trans = init_xyz.copy()
        rot = _quat_to_rot(init_quat)
        grip = float(gripper[0, 0])

        states = []
        step = 0
        while self.max_steps is None or step < self.max_steps:
            for key in self.keys.drain():
                if key == "\x1b":
                    self._save_states(states)
                    return
                if key == "r":
                    trans = init_xyz.copy()
                    rot = _quat_to_rot(init_quat)
                    grip = 1.0
                    continue
                binding = KEY_BINDINGS.get(key)
                if binding is None:
                    continue
                kind, delta = binding
                if kind == "trans":
                    trans = trans + delta * self.trans_step
                elif kind == "rot":
                    dR = tf.axis_angle_to_rot(torch.as_tensor(
                        delta * self.rot_step, dtype=torch.float32)).numpy()
                    rot = dR @ rot
                else:
                    grip = float(np.clip(grip + delta * self.grip_step, 0, 1))

            action = np.concatenate([trans, rot.reshape(-1), [grip]])[None]
            env.step({"action": env_action(action, self.device),
                      "do_velocity_control":
                          bool(cfg.env.robot.do_velocity_control)})
            obs = env.unwrapped.get_obs()
            if self.save_states:
                states.append(env.unwrapped.get_state())
            self._display(obs)
            step += 1
        self._save_states(states)
        return obs

    def _display(self, obs):
        if not self.show:
            return
        import cv2

        panes = []
        if obs["image_list"]:
            panes.append(to_numpy(obs["image_list"][0]))
        if obs["image_wrist_list"]:
            panes.append(to_numpy(obs["image_wrist_list"][0]))
        if not panes:
            return
        img = np.concatenate([p.transpose(1, 2, 0) for p in panes], axis=1)
        cv2.imshow("teleop", (img[:, :, ::-1] * 255).astype(np.uint8))
        cv2.waitKey(1)

    def _save_states(self, states):
        if not self.save_states or not states:
            return
        import pickle

        out = Path(self.cfg.exp_root) / "output_teleop"
        out.mkdir(parents=True, exist_ok=True)
        with open(out / f"{run_name_for(self.cfg)}_states.pkl", "wb") as f:
            pickle.dump(states, f)


def _quat_to_rot(quat: np.ndarray) -> np.ndarray:
    """Host f32 rotation of a wxyz quaternion (the JAX tool's f32 math)."""
    return tf.quat_to_rot(torch.as_tensor(quat, dtype=torch.float32)).numpy()


def main(cfg, device="cuda"):
    InteractivePlayground(cfg, device=device).run()


cli = hydra_like_main("keyboard_teleop")(main)

if __name__ == "__main__":
    cli()
