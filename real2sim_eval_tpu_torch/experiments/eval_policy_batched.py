"""Batched policy evaluation: B episodes in lockstep on one card (the JAX
package's experiments/eval_policy_batched.py); given several devices, the
batches are dealt out to one worker process each (``fan_out``).

One ``BatchedEvaluator`` advances all B randomized episodes of a batch,
the policy runs on their stacked observations (host numpy arrays, as the
JAX CLI hands it), and each episode's artifacts are written from the
host. A step's frames for the writers are converted to uint8 on the card
and copied to the host once (``episode_io.step_frames``).

Usage:
  python -m real2sim_eval_tpu_torch.experiments.eval_policy_batched \\
      gs=rope policy.builtin=hold batch_size=16 [--device cpu]
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..config import save_config
from ..parallel import BatchedEvaluator
from ..utils import transforms_np as tnp
from ..utils.device import resolve_device, to_numpy
from .cli import PhaseTimer, hydra_like_main, raster_config_from, run_name_for
from .episode_io import EpisodeWriter, step_frames
from .eval_policy import n_grid_episodes
from .policy_api import load_policy
from .utils.dir_utils import mkdir


def actions_from_policy(cartesian: np.ndarray, use_pusher: bool) -> np.ndarray:
    """(B, 8) policy output -> (B, 13) sim actions (eval_policy.py:183-221)."""
    B = cartesian.shape[0]
    if use_pusher:
        rot = np.tile(np.diag([1.0, -1.0, -1.0]).astype(np.float32).reshape(-1),
                      (B, 1))
        grip = np.ones((B, 1), np.float32)  # always open in sim space
        return np.concatenate([cartesian[:, :3], rot, grip], axis=1)
    rot = tnp.quat_to_rot(cartesian[:, 3:7])
    grip = 1.0 - cartesian[:, 7:8]
    return np.concatenate([cartesian[:, :3], rot.reshape(B, -1), grip],
                          axis=1).astype(np.float32)


def hold_actions(grippers: np.ndarray) -> np.ndarray:
    """(B, 14) gripper state -> (B, 13) actions that hold the pose
    (the stabilization, eval_policy.py:124-126)."""
    rot0 = tnp.quat_to_rot(grippers[:, 6:10])
    return np.concatenate([grippers[:, :3], rot0.reshape(len(grippers), -1),
                           grippers[:, 13:14]], axis=1)


def check_saturation(ev, cnt):
    """Loudly surface any clipped physics or render budget: telemetry is
    read in production, not only in tests."""
    drops = {k: v for k, v in ev.render_drops().items() if v}
    phys = {k: int(np.sum(v)) for k, v in ev.telemetry().items()
            if np.any(v)}
    if drops or phys:
        print(f"WARNING step {cnt}: budget saturation — work was clipped! "
              f"render={drops} physics={phys} "
              "(raise the PhysicsOptions caps)", file=sys.stderr, flush=True)
    return drops, phys


def main(cfg, device="cuda", stats: dict | None = None, devices=None,
         worker: tuple[int, int] = (0, 1)):
    """Evaluate every batch of episodes on ``device``; returns the run
    directory.

    ``devices``, a list of more than one device, fans the batches out to
    one worker process per entry instead (``fan_out``); ``worker`` =
    (k, n) runs only the k-th of every n batches, as worker k of n does.
    ``stats``, when given, collects the loop's per-phase milliseconds, its
    byte counts and marks (``cli.PhaseTimer``, whose ``on_mark`` gets the
    batch's evaluator); it covers one process."""
    if devices is not None and len(devices) > 1:
        if stats is not None:
            raise ValueError("stats covers one process; the fan-out "
                             "runs several")
        return fan_out(cfg, devices)
    if devices:
        (device,) = devices
    device = resolve_device(device)
    timer = PhaseTimer(stats, device)
    if bool(cfg.gs.get("use_grid_randomization", False)):
        n_episodes = n_grid_episodes(cfg)
    else:
        n_episodes = int(cfg.policy.n_episodes)
    batch_size = min(int(cfg.get("batch_size", 16)), n_episodes)
    start = int(cfg.get("episode_start", 0))
    # mid-episode checkpoint cadence: a killed run resumes losing <= K
    # steps. 0 disables.
    ckpt_every = int(cfg.get("checkpoint_every", 100))
    resume = bool(cfg.get("resume", False))
    telemetry_every = int(cfg.get("telemetry_every", 30))

    run_name = run_name_for(cfg)
    out_path = Path(cfg.exp_root) / "output_eval_policy" / run_name
    mkdir(out_path, resume=True, interactive=False)
    save_config(cfg, out_path / "hydra.yaml")

    frame_rate = int(cfg.physics.fps)
    duration = int(cfg.env.sim.duration)
    n_steps = frame_rate * duration
    use_pusher = bool(cfg.env.robot.use_pusher)

    k, n_workers = worker
    batch_starts = list(range(start, n_episodes, batch_size))
    for batch_start in batch_starts[k::n_workers]:
        episode_ids = list(range(batch_start,
                                 min(batch_start + batch_size, n_episodes)))
        done_marker = out_path / f"batch_{batch_start:05d}.done"
        if resume and done_marker.exists():
            print(f"Batch {episode_ids[0]}..{episode_ids[-1]} already done")
            continue
        print(f"Batch {episode_ids[0]}..{episode_ids[-1]} "
              f"({len(episode_ids)} episodes)")
        timer.mark("start")
        ev = BatchedEvaluator(cfg, episode_ids,
                              raster_config=raster_config_from(cfg),
                              device=device)
        policy = load_policy(cfg.policy)
        ckpt_path = out_path / f"batch_{batch_start:05d}.ckpt.pkl"
        start_cnt = 0
        if resume and ckpt_path.exists():
            extra = ev.load_state(ckpt_path)
            start_cnt = int(extra.get("next_step", 0))
            print(f"resumed mid-episode from {ckpt_path} at step {start_cnt}")

        writers = []
        for lane, ep in enumerate(episode_ids):
            w = EpisodeWriter(out_path, ep, cfg.env.cameras)
            w.write_calibration()
            w.write_random_variables(ev.random_variables[lane])
            writers.append(w)
        timer.mark("built", ev)

        if start_cnt == 0:
            # stabilization: hold the reset pose 1 s (eval_policy.py:124-126)
            hold = torch.as_tensor(hold_actions(to_numpy(ev.state.grippers)),
                                   dtype=torch.float32, device=device)
            for _ in range(30):
                ev.step(hold, do_velocity_control=False)
        timer.mark("stabilized", ev)

        for cnt in range(start_cnt, n_steps):
            t0 = time.perf_counter()
            with timer("observations"):
                obs = ev.observations()
            with timer("copy_state"):
                state_vec = to_numpy(obs["observation.state"])
            with timer("copy_policy_images"):
                front = to_numpy(obs["observation.images.front"])
                wrist = obs["observation.images.wrist"]
                wrist = None if wrist is None else to_numpy(wrist)
            timer.count("policy_image_bytes", front.nbytes + (
                0 if wrist is None else wrist.nbytes))
            with timer("frames_uint8"):
                frames = step_frames(cfg.env.cameras, obs["images"],
                                     obs["wrist_images"])
            timer.count("frame_bytes", sum(f.nbytes for f in frames))
            with timer("encode_write_images"):
                for lane, w in enumerate(writers):
                    w.write_frames([f[lane] for f in frames], cnt,
                                   start_final="start" if cnt == 0 else None)

            with timer("policy"):
                cartesian = np.asarray(policy.inference({
                    "observation.state": (state_vec[:, :2] if use_pusher
                                          else state_vec),
                    "observation.images.front": front,
                    "observation.images.wrist": wrist,
                }))
                if cartesian.shape[0] == 1 and len(episode_ids) > 1:
                    cartesian = np.tile(cartesian, (len(episode_ids), 1))

            with timer("state_dumps"):
                dumps = ev.get_state_dumps()
            with timer("write_robot_state"):
                for lane, w in enumerate(writers):
                    w.write_robot(cnt, state_vec[lane, :3],
                                  state_vec[lane, 3:7], state_vec[lane, 7:8],
                                  cartesian[lane, :3], cartesian[lane, 3:7],
                                  cartesian[lane, 7:8])
                    w.write_state(cnt, dumps[lane])

            actions = actions_from_policy(cartesian, use_pusher)
            with timer("step"):
                ev.step(torch.as_tensor(actions, device=device))
            if telemetry_every and cnt % telemetry_every == 0:
                with timer("check_saturation"):
                    check_saturation(ev, cnt)
            if ckpt_every and (cnt + 1) % ckpt_every == 0:
                with timer("save_state"):
                    ev.save_state(ckpt_path, extra={"next_step": cnt + 1})
            dt = time.perf_counter() - t0
            print(f"step {cnt}: {dt:.3f}s "
                  f"({len(episode_ids) / max(dt, 1e-9):.1f} env-steps/s)")
        timer.mark("looped", ev)

        obs = ev.observations()
        frames = step_frames(cfg.env.cameras, obs["images"],
                             obs["wrist_images"])
        for lane, w in enumerate(writers):
            w.write_frames([f[lane] for f in frames], n_steps,
                           start_final="final")
            w.finalize_videos(frame_rate)
        policy.reset()
        done_marker.touch()
        if ckpt_path.exists():
            ckpt_path.unlink()
        timer.mark("done")
    return out_path


def _worker(cfg, device: str, worker: tuple, threads: int):
    torch.set_num_threads(threads)
    return str(main(cfg, device=device, worker=worker))


def fan_out(cfg, devices) -> Path:
    """Run the config's batches on ``devices``, one spawned worker process
    per entry, batch k on worker k mod n, as the reference deals its
    episodes out (eval_policy_parallel.py:266-287); returns the run
    directory. A batch's files, checkpoint and ``.done`` marker belong to
    one worker, so ``resume`` works as in one process. A worker that fails
    fails the run, after the others have finished."""
    devices = [resolve_device(d) for d in devices]
    cfg = cfg.copy()
    if not cfg.get("timestamp"):
        cfg.timestamp = run_name_for(cfg)     # one run directory for all
    if any(d.type == "cuda" for d in devices):
        from .. import ext

        ext.load()    # build the kernels once, before the workers load them
    n = len(devices)
    # spawn: a CUDA context cannot be forked
    with ProcessPoolExecutor(max_workers=n,
                             mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(_worker, cfg, str(d), (k, n),
                               torch.get_num_threads())
                   for k, d in enumerate(devices)]
        runs, failed = [], []
        for k, f in enumerate(futures):
            try:
                runs.append(f.result())
            except Exception as e:    # a worker's error, or its death
                failed.append((k, e))
    if failed:
        k, e = failed[0]
        raise RuntimeError(
            f"{len(failed)} of {n} eval workers failed; worker {k} on "
            f"{devices[k]}: {e!r}") from e
    return Path(runs[0])


cli = hydra_like_main("eval_policy_batched")(main)

if __name__ == "__main__":
    cli()
