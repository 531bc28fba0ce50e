"""Closed-loop policy evaluation, one episode at a time on the single env
(the JAX package's experiments/eval_policy.py).

Per episode: build the policy and the env, a grid- or uniform-randomized
reset, 30 stabilization steps, then the 30 Hz closed loop: observation ->
``policy.inference`` -> cartesian action -> ``env.step``, saving images,
robot JSONs, state pickles and videos in the reference's layout. The
policy gets host numpy arrays; the actions go back as tensors on the
env's device.

Usage:
  python -m real2sim_eval_tpu_torch.experiments.eval_policy gs=rope \\
      policy.builtin=hold exp_root=log/experiments [--device cpu]
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..config import save_config
from ..utils import transforms_np as tnp
from ..utils.device import resolve_device, to_numpy
from .cli import PhaseTimer, hydra_like_main, raster_config_from, run_name_for
from .episode_io import EpisodeWriter
from .policy_api import load_policy
from .utils.dir_utils import mkdir


def n_grid_episodes(cfg) -> int:
    """Episode count implied by the grid randomization
    (eval_policy.py:29-38)."""
    obj_grid = cfg.gs.object.grid_randomization
    len_grid = (len(obj_grid.xy) if obj_grid.one_to_one
                else len(obj_grid.xy) * len(obj_grid.theta))
    len_mesh = 1
    for mesh_cfg in cfg.gs.meshes or []:
        g = mesh_cfg.get("grid_randomization")
        if g:
            len_mesh *= (len(g.xy) if g.one_to_one
                         else len(g.xy) * len(g.theta))
    return len_grid * len_mesh


def pusher_level_action(eef_xyz: np.ndarray) -> np.ndarray:
    """Pusher runs level at fixed height with a fixed downward orientation
    (eval_policy.py:117-122,183-190)."""
    rot = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    n = eef_xyz.shape[0]
    action = np.zeros((n, 13), np.float32)
    action[:, :3] = eef_xyz
    action[:, 2] = 0.22
    action[:, 3:12] = rot.reshape(-1)
    action[:, 12] = 1.0  # always open (sim space)
    return action


def robot_obs(obs) -> tuple:
    """The observation's eef xyz, quat and gripper as host arrays."""
    r = obs["robot"]
    return (to_numpy(r["eef_xyz"]), to_numpy(r["eef_quat"]),
            to_numpy(r["eef_gripper"]))


def env_action(action: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(action, np.float32), device=device)


def run_episode(cfg, episode_id: int, out_dir: Path, policy, local_rank=0,
                device="cuda", stats: dict | None = None):
    import real2sim_eval_tpu_torch.envs as envs

    timer = PhaseTimer(stats, device)
    timer.mark("start")
    frame_rate = int(cfg.physics.fps)
    duration = int(cfg.env.sim.duration)
    use_pusher = bool(cfg.env.robot.use_pusher)

    env = envs.make(cfg.env_name, max_episode_steps=frame_rate * duration + 30,
                    cfg=cfg, randomize=True, exp_root=cfg.exp_root,
                    local_rank=local_rank,
                    raster_config=raster_config_from(cfg), device=device)
    obs, _ = env.reset(seed=episode_id)
    timer.mark("built", env)

    writer = EpisodeWriter(out_dir, episode_id, cfg.env.cameras)
    writer.write_calibration()

    # initial stabilization action from the reset pose (eval_policy.py:106-126)
    eef_xyz, eef_quat, eef_gripper = robot_obs(obs)
    eef_rot = tnp.quat_to_rot(eef_quat)
    action = np.concatenate(
        [eef_xyz, eef_rot.reshape(eef_rot.shape[0], -1), eef_gripper], axis=1)
    if use_pusher:
        action = pusher_level_action(eef_xyz)

    for _ in range(30):  # stabilize for 1 s
        env.step({"action": env_action(action, device),
                  "do_velocity_control": False})
    obs = env.unwrapped.get_obs()
    timer.mark("stabilized", env)

    writer.write_random_variables(env.unwrapped.renderer.random_variables)

    max_steps = frame_rate * duration
    for cnt in range(max_steps):
        t0 = time.perf_counter()
        with timer("write_images"):
            writer.write_images(obs, cnt, overlay_fn=policy.visualize_overlay,
                                start_final="start" if cnt == 0 else None)

        with timer("policy_inputs"):
            pos, quat, gripper = robot_obs(obs)
            gripper_qpos = 1.0 - gripper
            if use_pusher:
                state_vec = pos[:, :2]
            else:
                state_vec = np.concatenate([pos, quat, gripper_qpos], axis=1)
            obs_dict = {
                "observation.state": state_vec,
                "observation.images.front":
                    to_numpy(obs["image_list"][0])[None],
                "observation.images.wrist":
                    to_numpy(obs["image_wrist_list"][0])[None],
            }
        with timer("policy"):
            cartesian = np.asarray(policy.inference(obs_dict))

        if use_pusher:
            act_xyz = cartesian[:, :3]
            act_rot = np.tile(np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None],
                              (act_xyz.shape[0], 1, 1))
            act_quat = tnp.rot_to_quat(act_rot)
            act_gripper = np.zeros_like(cartesian[:, :1])
        else:
            act_xyz = cartesian[:, :3]
            act_quat = cartesian[:, 3:7]
            act_rot = tnp.quat_to_rot(act_quat)
            act_gripper = cartesian[:, 7:8]

        with timer("write_robot_state"):
            writer.write_robot(cnt, pos[0], quat[0], gripper_qpos[0],
                               act_xyz[0], act_quat[0], act_gripper[0])
            writer.write_state(cnt, env.unwrapped.get_state())

        sim_gripper = 1.0 - act_gripper  # policy space -> sim space
        action = np.concatenate(
            [act_xyz, act_rot.reshape(act_rot.shape[0], -1), sim_gripper], axis=1)
        with timer("env_step"):
            env.step({"action": env_action(action, device),
                      "do_velocity_control":
                          bool(cfg.env.robot.do_velocity_control)})
        with timer("get_obs"):
            obs = env.unwrapped.get_obs()

        if cnt == max_steps - 1:
            writer.write_images(obs, cnt + 1,
                                overlay_fn=policy.visualize_overlay,
                                start_final="final")
            policy.reset()
        dt = time.perf_counter() - t0
        print(f"Episode: {episode_id}, step: {cnt}, time: {dt:.4f}, "
              f"fps: {1 / max(dt, 1e-9):.2f}")

    timer.mark("looped", env)
    writer.finalize_videos(frame_rate)
    timer.mark("done")


def main(cfg, episode_list=None, local_rank: int = 0, run_name=None,
         device="cuda", stats: dict | None = None):
    """Evaluate the episodes one by one; returns the run directory.
    ``stats``, when given, collects the loop's per-phase milliseconds and
    marks (``cli.PhaseTimer``, whose ``on_mark`` gets the episode's env)."""
    device = resolve_device(device)
    if bool(cfg.gs.get("use_grid_randomization", False)):
        cfg.policy.n_episodes = n_grid_episodes(cfg)
    print("Total episodes:", cfg.policy.n_episodes)

    run_name = run_name or run_name_for(cfg)
    out_path = Path(cfg.exp_root) / "output_eval_policy" / run_name
    mkdir(out_path, resume=episode_list is not None, overwrite=True,
          interactive=False)
    save_config(cfg, out_path / "hydra.yaml")

    episodes = (episode_list if episode_list is not None
                else range(int(cfg.policy.n_episodes)))
    for episode_id in episodes:
        policy = load_policy(cfg.policy, local_rank=local_rank)
        run_episode(cfg, episode_id, out_path, policy, local_rank, device,
                    stats)
    return out_path


cli = hydra_like_main("eval_policy")(main)

if __name__ == "__main__":
    cli()
