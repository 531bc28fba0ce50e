"""The ``bare`` entry: the lockstep evaluator driven directly.

``BatchedEvaluator(cfg, episode_ids)`` is built from the config the
benchmark wrote, holds the reset pose for the 30 stabilization steps
(``eval_policy.py:124-126``, as the CLI does), takes WARMUP_STEPS
control steps of the policy, then runs the window: each control step hands the
policy's actions (through the port's ``actions_from_policy``) to
``ev.step``, calls ``ev.render`` and synchronises once, as a policy that
reads its observation must. With ``trace`` the window is a few control
steps under ``torch.profiler`` with the stage spans on.
"""

from __future__ import annotations

import collections
import importlib
import time
from pathlib import Path

from . import outputs
from .device import process_age_s

# control steps before the window: the policy's first steps bring every
# lane's eef from the reset pose into its cycle, so that the window
# measures manipulation and not the approach from the reset pose
WARMUP_STEPS = 40
STABILIZE_STEPS = 30
TRACED_STEPS = 3
RING = 2              # control steps kept for the output check


def run(cell, scene: dict, cfg_dir: Path, seed: int, seconds: float,
        trace_dir: Path | None, device: str = "cuda") -> outputs.Run:
    import torch

    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.experiments.eval_policy_batched import (
        actions_from_policy, hold_actions)
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator

    from . import trace as tr

    tr_ = cell.traffic
    episode_ids = list(range(int(tr_["lanes"])))
    cfg = load_config(cfg_dir, "run")
    dev = torch.device(device)
    parts = {"before_build": process_age_s()}
    ev = BatchedEvaluator(cfg, episode_ids, device=device)
    parts["build"] = process_age_s() - parts["before_build"]
    init_state = ev.state
    use_pusher = bool(cfg.env.robot.use_pusher)
    generator = importlib.import_module(f".{tr_['generator']}", __package__)
    policy = generator.make(tr_, scene["cfg"], cell.spec,
                            scene["particles"], episode_ids, seed)

    hold = torch.as_tensor(hold_actions(ev.state.grippers.cpu().numpy()),
                           dtype=torch.float32, device=dev)
    t = process_age_s()
    for _ in range(STABILIZE_STEPS):
        ev.step(hold, do_velocity_control=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    parts["stabilize"] = process_age_s() - t

    ring = collections.deque(maxlen=RING)
    tally = outputs.Tally()          # the window's steps, on the card
    counting = False

    def control_step():
        acts = torch.as_tensor(
            actions_from_policy(policy.inference(None), use_pusher),
            dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        pre = ev.state
        ev.step(acts)
        post = ev.state
        frames = ev.render()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ring.append((pre, acts, post, ev.state, frames))
        if counting:
            tally.add(post, ev.render_telemetry, acts)
        return t0, t1

    t = process_age_s()
    for _ in range(WARMUP_STEPS):
        control_step()
    parts["warm_up"] = process_age_s() - t
    counting = True

    step_ms, traced = [], None
    if trace_dir is None:
        setup_s = process_age_s()
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            t0, t1 = control_step()
            step_ms.append((t1 - t0) * 1e3)
            if t1 >= deadline:
                break
        window_s = t1 - start
    else:
        missing = tr.missing_stages(ev)
        setup_s = process_age_s()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        start = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof, tr.spans(ev):
            with torch.profiler.record_function("window"):
                for _ in range(TRACED_STEPS):
                    t0, t1 = control_step()
                    step_ms.append((t1 - t0) * 1e3)
        window_s = time.perf_counter() - start
        trace_dir.mkdir(parents=True, exist_ok=True)
        path = trace_dir / "window.pt.trace.json"
        prof.export_chrome_trace(str(path))
        traced = {"table": tr.parse_trace(path), "missing": missing,
                  "steps": TRACED_STEPS,
                  **tr.busy_and_gaps(path, tr.window_of(path))}
        path.unlink()

    memory = outputs.memory_peak(dev)
    lanes = outputs.check_lanes(len(episode_ids), seed)
    attempted, failed, why = tally.failed()
    run_ = outputs.Run(
        lanes=len(episode_ids), steps=len(step_ms), window_s=window_s,
        step_ms=step_ms, setup_s=setup_s, attempted=attempted,
        failed=failed, memory_peak=memory, traced=traced,
        check_lanes=lanes, episode_ids=episode_ids,
        init_state=outputs.state_numpy(init_state, lanes),
        samples=[outputs.sample_numpy(r, lanes) for r in ring],
        extra={"dirty_tiles": tally.dirty_tiles(), "by_reason": why,
               "setup_parts": parts, "motion": tally.motion(),
               "k3_problem": outputs.k3_problem([r[0] for r in ring],
                                                scene)})
    del ev, ring, tally, init_state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return run_
