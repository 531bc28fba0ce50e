"""BaseEnv: the env that binds physics and renderer for one episode.

Counterpart of the JAX package's envs/base_env.py: reset / get_obs / step
/ get_state / render / close with the same dict layouts. Observations hold
tensors on the env's device. ``reset(seed=...)`` draws the episode's
randomization from ``np.random.RandomState(seed)`` and leaves numpy's
global generator alone.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..physics.dynamics import PhysTwinDynamics
from ..renderer.renderer import GSRenderer
from ..utils import transforms as tf
from .registration import gym, register_env

_EnvBase = gym.Env if gym is not None else object


@register_env("BaseEnv-v0", max_episode_steps=2000)
class BaseEnv(_EnvBase):

    def __init__(self, cfg, exp_root: str | Path = "log/experiments",
                 randomize: bool = False, local_rank: int = 0,
                 raster_config=None, device="cuda", **kwargs):
        self.cfg = cfg
        self.renderer = GSRenderer(cfg, local_rank,
                                   raster_config=raster_config, device=device)
        self.physics = PhysTwinDynamics(cfg, exp_root, cfg.physics.ckpt_path,
                                        cfg.physics.case_name, local_rank,
                                        device=device)
        self.randomize = randomize

    def reset(self, *, seed=None, options=None):
        rng = np.random.RandomState(seed)
        skip_obs = bool(options and options.get("skip_obs"))
        self.renderer.load_scaniverse(rng, randomize=self.randomize,
                                      index=seed)
        self.renderer.set_all_cameras()
        self.renderer.reset_state(visualize_image=False,
                                  skip_compose=skip_obs)
        phystwin_pts = self.physics.reset(
            self.renderer.get_state(),
            init_meshes_dict=self.renderer.meshes_canonical,
            mesh_poses=self.renderer.mesh_poses,
            robot=self.renderer.robot,
            eef_pts_func=self.renderer.eef_pts_func,
            kin_helper=_KinAdapter(self.renderer),
            init_eef_xyz=self.renderer.init_eef_xyz,
            pose_obj=self.renderer.pose_obj)
        self.renderer.update_phystwin_pts(phystwin_pts)
        if skip_obs:
            return None, {}   # asset-building resets render nothing
        return self.get_obs(), {}

    def get_obs(self, render_extra: bool = False):
        state = self.renderer.get_state()
        im_list, depth_list = self.renderer.render_fixed_cameras()
        im_wrist_list, depth_wrist_list = self.renderer.render_wrist_cameras()
        im_extra = depth_extra = None
        if render_extra:
            im_extra, depth_extra = self.renderer.render()
        return {
            "image_list": im_list,
            "depth_list": depth_list,
            "image_wrist_list": im_wrist_list,
            "depth_wrist_list": depth_wrist_list,
            "image_extra": im_extra,
            "depth_extra": depth_extra,
            "robot": {
                "eef_xyz": state["eef_xyz"],
                "eef_quat": state["eef_quat"],
                "eef_gripper": state["eef_gripper"],
            },
        }

    def get_language_instruction(self):
        return None

    def render(self):
        return self.renderer.render()

    def close(self):
        return None

    def step(self, action_dict):
        state = self.renderer.get_state()
        action = action_dict["action"]
        if action_dict.get("do_velocity_control", True):
            action = self.renderer.mimic_velocity_control(action)
        state = self.physics.step(state, action)
        self.renderer.update_state(state)
        return None, None, None, None, None

    def get_state(self):
        physics_state = self.physics.get_state()
        return {
            "renderer": {"x": self.renderer.get_state()["x"].cpu().numpy()},
            "physics": {
                "static_meshes": physics_state["static_meshes"],
                "init_springs": physics_state["init_springs"].cpu().numpy(),
            },
        }


class _KinAdapter:
    """The renderer's kinematics under the kin_helper protocol that
    PhysTwinDynamics expects (a chain + an IK call)."""

    def __init__(self, renderer: GSRenderer):
        self.chain = renderer.sample_robot.chain
        self._renderer = renderer

    def compute_ik_sapien(self, initial_qpos, cartesian):
        dev = self._renderer.device
        target = torch.eye(4, device=dev)
        target[:3, :3] = tf.euler_to_rot(torch.as_tensor(
            np.asarray(cartesian[3:6], np.float32), device=dev))
        target[:3, 3] = torch.as_tensor(np.asarray(cartesian[:3], np.float32),
                                        device=dev)
        q0 = torch.as_tensor(np.asarray(initial_qpos, np.float32), device=dev)
        return self._renderer._ik(q0[None], target[None])[0].cpu().numpy()
