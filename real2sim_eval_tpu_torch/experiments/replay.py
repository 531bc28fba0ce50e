"""Open-loop trajectory replay (the JAX package's experiments/replay.py).

Replays recorded per-frame robot JSONs (qpos, cartesian or planar xy) as
actions through the single env, dumping images, robot JSONs, state
pickles and a video per camera: the reference's sim-fidelity check
against real rollouts (README "replay" workflow).

Usage:
  python -m real2sim_eval_tpu_torch.experiments.replay gt_dir=... gs=rope \\
      [--device cpu]
"""

from __future__ import annotations

import glob
import json
import time
from pathlib import Path

import numpy as np

from ..config import save_config
from ..kinematics import KinHelper
from ..utils import transforms_np as tnp
from ..utils.device import resolve_device
from .cli import hydra_like_main, raster_config_from, run_name_for
from .episode_io import EpisodeWriter
from .eval_policy import env_action, robot_obs
from .utils.dir_utils import mkdir

_kin_helper: KinHelper | None = None


def compute_fk(qpos: np.ndarray):
    """(n, >=7) qpos -> (n,3) xyz + (n,3,3) rot via the module KinHelper
    (replay.py:27-39)."""
    assert _kin_helper is not None
    xyz, rot = [], []
    for i in range(qpos.shape[0]):
        T = _kin_helper.compute_fk_sapien_links(
            qpos[i][:7], [_kin_helper.sapien_eef_idx])[0]
        xyz.append(T[:3, 3])
        rot.append(T[:3, :3])
    return (np.asarray(xyz, np.float32).reshape(-1, 3),
            np.asarray(rot, np.float32).reshape(-1, 3, 3))


def load_robot_json(path, use_qpos: bool = True, prefix: str = "action"):
    """One recorded frame -> (trans (1,3), rot (1,3,3), gripper (1,))
    handling the reference's three formats (replay.py:42-78)."""
    with open(path) as f:
        robot = json.load(f)

    if f"{prefix}.xy" in robot:  # planar pushing
        if use_qpos:
            trans, rot = compute_fk(np.array(robot[f"{prefix}.qpos"]).reshape(1, -1))
        else:
            xy = np.array(robot[f"{prefix}.xy"]).reshape(-1, 2)
            trans = np.zeros((1, 3), np.float32)
            trans[:, :2] = xy
            trans[:, 2] = 0.22  # fixed pusher height
            rot = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None]
        gripper = np.array([1.0], np.float32).reshape(-1)
    else:
        if use_qpos:
            trans, rot = compute_fk(np.array(robot[f"{prefix}.qpos"]).reshape(1, -1))
        elif f"{prefix}.cartesian" in robot:
            e2b = np.array(robot[f"{prefix}.cartesian"]).reshape(4, 4)
            rot = e2b[:3, :3][None].astype(np.float32)
            trans = e2b[:3, 3].reshape(1, 3).astype(np.float32)
        else:
            trans = np.array(robot[f"{prefix}.ee_pos"], np.float32).reshape(1, 3)
            quat = np.array(robot[f"{prefix}.ee_quat"], np.float32).reshape(1, 4)
            rot = tnp.quat_to_rot(quat)
        gripper = 1.0 - np.array(robot[f"{prefix}.gripper_qpos"],
                                 np.float32).reshape(-1)
    return trans, rot, gripper


def load_episode_trajectory(episode_dir: Path, use_qpos: bool):
    paths = sorted(glob.glob(str(Path(episode_dir) / "robot" / "*.json")))
    trans, rots, grips = [], [], []
    for p in paths:
        t, r, g = load_robot_json(p, use_qpos=use_qpos)
        trans.append(t)
        rots.append(r)
        grips.append(g)
    return (np.stack(trans), np.stack(rots), np.stack(grips))


def main(cfg, device="cuda"):
    global _kin_helper
    import real2sim_eval_tpu_torch.envs as envs

    device = resolve_device(device)
    gt_dir = Path(cfg.gt_dir)
    assert gt_dir.exists(), f"GT directory {cfg.gt_dir} does not exist"

    urdf = Path(cfg.env.urdf.ik_urdf_path).parent / "xarm7.urdf"
    _kin_helper = KinHelper(str(urdf) if urdf.exists()
                            else cfg.env.urdf.ik_urdf_path, device=device)

    if (gt_dir / "episode_0000").exists():
        n_episodes = len(sorted(glob.glob(str(gt_dir / "episode_*"))))
        episode_dirs = [gt_dir / f"episode_{i:04d}" for i in range(n_episodes)]
    else:
        episode_dirs = [gt_dir]

    run_name = run_name_for(cfg)
    out_path = Path(cfg.exp_root) / "output_replay"
    mkdir(out_path / run_name, resume=False, overwrite=True, interactive=False)
    save_config(cfg, out_path / run_name / "hydra.yaml")

    frame_rate = int(cfg.physics.fps)
    for episode_id, episode_gt_dir in enumerate(episode_dirs):
        if not (Path(episode_gt_dir) / "robot").exists():
            print(f"Episode directory {episode_gt_dir} has no robot/ dir")
            continue
        traj, rots, grips = load_episode_trajectory(episode_gt_dir, cfg.use_qpos)
        n_steps = len(traj)
        print(f"Replaying {n_steps} steps from {episode_gt_dir}")

        env = envs.make(cfg.env_name, max_episode_steps=n_steps + 30, cfg=cfg,
                        randomize=bool(cfg.get("randomize", True)),
                        exp_root=cfg.exp_root,
                        raster_config=raster_config_from(cfg), device=device)
        obs, _ = env.reset(seed=episode_id)

        writer = EpisodeWriter(out_path / run_name, episode_id, cfg.env.cameras)
        writer.write_calibration()
        writer.write_random_variables(env.unwrapped.renderer.random_variables)

        # stabilize for 1 s at the initial pose (replay.py:190-191)
        eef_xyz0, eef_quat0, eef_gripper0 = robot_obs(obs)
        eef_rot0 = tnp.quat_to_rot(eef_quat0)
        action = np.concatenate([
            eef_xyz0, eef_rot0.reshape(eef_rot0.shape[0], -1), eef_gripper0],
            axis=1)
        for _ in range(30):
            env.step({"action": env_action(action, device),
                      "do_velocity_control": False})
        obs = env.unwrapped.get_obs()

        n_grippers = traj.shape[1]
        for cnt in range(n_steps):
            t0 = time.perf_counter()
            writer.write_images(obs, cnt,
                                start_final="start" if cnt == 0 else None)

            eef_xyz = traj[cnt].reshape(n_grippers, 3)
            eef_rot = rots[cnt].reshape(n_grippers, 3, 3)
            eef_gripper = grips[cnt].reshape(n_grippers, 1)
            eef_quat = tnp.rot_to_quat(eef_rot)

            pos, quat, gripper = robot_obs(obs)
            writer.write_robot(cnt, pos[0], quat[0], 1.0 - gripper[0],
                               eef_xyz[0], eef_quat[0], 1.0 - eef_gripper[0])
            writer.write_state(cnt, env.unwrapped.get_state())

            action = np.concatenate(
                [eef_xyz, eef_rot.reshape(n_grippers, -1), eef_gripper], axis=1)
            env.step({"action": env_action(action, device),
                      "do_velocity_control": bool(cfg.env.robot.do_velocity_control)})
            obs = env.unwrapped.get_obs()

            if cnt == n_steps - 1:
                writer.write_images(obs, cnt + 1, start_final="final")
            dt = time.perf_counter() - t0
            print(f"Episode: {episode_id}, step: {cnt}, time: {dt:.4f}, "
                  f"fps: {1 / max(dt, 1e-9):.2f}")

        writer.finalize_videos(frame_rate)
    return out_path / run_name


cli = hydra_like_main("replay")(main)

if __name__ == "__main__":
    cli()
