"""What a run hands on after its window: the counts, the failed
env-steps, and the host copies of what the output check compares."""

from __future__ import annotations

import dataclasses

import numpy as np

from .scene import rng_of


@dataclasses.dataclass
class Run:
    lanes: int
    steps: int                 # control (or loop) steps in the window
    window_s: float
    step_ms: list
    setup_s: float
    attempted: int             # env-steps of the window
    failed: int
    memory_peak: int
    traced: dict | None        # the parsed trace of a traced run
    check_lanes: list
    episode_ids: list
    init_state: dict           # the program's state after its build
    samples: list              # per checked step: host copies (lanes)
    extra: dict


def memory_peak(dev) -> int:
    import torch

    if dev.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(dev))


def check_lanes(batch: int, seed: int, n: int = 4) -> list:
    """The lanes the output check compares: one drawn from the seed in
    each of n equal parts of the batch, so that every half is held."""
    rng = rng_of(seed, 4)
    n = min(n, batch)
    edges = np.linspace(0, batch, n + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges, edges[1:])]


def _leaves(obj, prefix: str = "") -> dict:
    """A (nested) state dataclass as {"a/b": tensor}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}/"))
        elif v is not None and hasattr(v, "shape"):
            out[prefix + f.name] = v
    return out


def state_numpy(state, lanes: list) -> dict:
    """The batched state's leaves at ``lanes`` as host arrays, in the
    format of the evaluator's snapshots ({"sm/x": ..., "step": n})."""
    import torch

    idx = torch.as_tensor(lanes, device=state.sm.x.device)
    out = {k: v.index_select(0, idx).cpu().numpy()
           for k, v in _leaves(state).items()}
    out["step"] = int(state.step)
    return out


def frames_numpy(frames, lanes: list) -> list:
    import torch

    out = []
    for f in frames:
        idx = torch.as_tensor(lanes, device=f.device)
        out.append(f.index_select(0, idx).cpu().numpy())
    return out


def sample_numpy(rec, lanes: list) -> dict:
    """One kept control step: the state before it, its actions, the
    state after ``step`` (which the render starts from), after
    ``render``, and the frames."""
    pre, acts, post, rendered, frames = rec
    post = state_numpy(post, lanes)
    return {"pre": state_numpy(pre, lanes),
            "actions": acts[lanes].cpu().numpy(),
            "post": post, "render_in": post,
            "rendered": state_numpy(rendered, lanes),
            "frames": frames_numpy(frames, lanes)}


# the evaluator's physics telemetry lanes (K3's fixed caps, which the
# reference shares), then the render's drops and a state that is not finite
REASONS = ("self_candidates_dropped", "self_particles_dropped",
           "contact_particles_dropped", "patch_escapes", "render_drops",
           "not_finite")


class Tally:
    """What the window's control steps did, summed on the card as they
    come (no synchronise, and no state kept past its step), read after
    the window: the failed env-steps, the dirty tiles and the traffic's
    motion."""

    def __init__(self):
        self.steps = 0

    def add(self, post, telemetry, acts) -> None:
        """One control step: the state after ``step``, the render's
        telemetry (fixed, wrist) and the step's actions."""
        import torch

        fixed, wrist = telemetry
        t = post.sm.telemetry
        x = post.sm.x
        by = [t[:, i] > 0 for i in range(4)]
        by.append((fixed[..., 1:].sum((0, 2)) > 0) | (wrist.sum(0) > 0))
        by.append(~(torch.isfinite(x).all(2).all(1)
                    & torch.isfinite(post.sm.v).all(2).all(1)))
        by = torch.stack(by).to(torch.int64)            # (reasons, B)
        bad = by[-1]
        top = x[..., 2].amax(1)
        dirty = (fixed[..., 0].float().mean() if fixed.numel()
                 else torch.zeros((), device=x.device))
        tally = {"by": by, "bad": bad, "dirty": dirty,
                 "rise": torch.zeros_like(top),
                 "grasped": post.grasp.grasped.float(),
                 "closed": (post.grippers[:, 13] < 0.5).float(),
                 "force": post.sm.finger_forces.norm(dim=-1).amax(),
                 "lag": (post.grippers[:, :3] - acts[:, :3]).norm(dim=-1)}
        if self.steps == 0:
            self.top0, self.xy0 = top, x[..., :2].mean(1)
            self.sum = tally
        else:
            tally["rise"] = top - self.top0
            for k in ("by", "bad", "dirty", "grasped", "closed", "lag"):
                self.sum[k] = self.sum[k] + tally[k]
            for k in ("rise", "force"):
                self.sum[k] = torch.maximum(self.sum[k], tally[k])
        self.xy = x[..., :2].mean(1)
        self.steps += 1

    def failed(self) -> tuple[int, int, dict]:
        """(env-steps, failed env-steps, env-steps by reason): an env-step
        fails where its state is not finite. A saturation counter above
        zero (a physics cap or a render drop) is counted by reason only:
        the step still ends, with the work the program's fixed caps let
        through, as the reference's step does."""
        if not self.steps:
            return 0, 0, {}
        by = self.sum["by"].sum(1).tolist()
        return (self.steps * int(self.sum["bad"].numel()),
                int(self.sum["bad"].sum()),
                {k: int(v) for k, v in zip(REASONS, by) if v})

    def dirty_tiles(self) -> float | None:
        """Mean dirty 8x128 tiles per env, fixed camera and step."""
        return float(self.sum["dirty"]) / self.steps if self.steps else None

    def motion(self) -> dict | None:
        """What the traffic did over the window, for the record: the
        share of lane-steps with the grasp machine holding the object and
        with the fingers under half open, the largest finger force, the
        highest rise of a lane's top particle over its start (m), the
        widest shift of a lane's particle centroid in the table plane
        (m), the lanes that rose or moved over 2 cm, and the eef's mean
        distance from its command."""
        if not self.steps:
            return None
        n, s = self.steps, self.sum
        shift = (self.xy - self.xy0).norm(dim=-1)
        return {"grasped_share": float(s["grasped"].mean()) / n,
                "closed_share": float(s["closed"].mean()) / n,
                "finger_force_max": float(s["force"]),
                "rise_m": float(s["rise"].max()),
                "lanes_risen_2cm": int((s["rise"] > 0.02).sum()),
                "centroid_shift_m": float(shift.max()),
                "lanes_moved_2cm": int((shift > 0.02).sum()),
                "eef_lag_m": float(s["lag"].mean()) / n}


def k3_problem(states: list, scene: dict) -> dict | None:
    """What the spring-mass step of these states poses, counted from the
    problem and not from the program's tables: per control step the
    lanes, particles, springs, substeps and the self-collision pairs the
    states need (pairs closer than the collision distance whose rest
    distance is at least five times it), averaged over the states."""
    import torch

    if not states:
        return None
    phys = scene["cfg"]["physics"]
    dist = float(phys["collision_dist"])
    substeps = round(1.0 / float(phys["fps"]) / float(phys["dt"]))
    rest = torch.as_tensor(np.asarray(scene["particles"], np.float32),
                           device=states[0].sm.x.device)
    far = torch.cdist(rest, rest) >= 5.0 * dist
    pairs = []
    for st in states:
        n = 0
        for x in st.sm.x:
            close = (torch.cdist(x, x) < dist) & far
            n += int(close.sum())           # ordered pairs: both ends
        pairs.append(n)
    B, N, _ = states[0].sm.x.shape
    return {"lanes": int(B), "particles": int(N),
            "springs": int(len(scene["springs"])), "substeps": substeps,
            "self_pairs": float(np.mean(pairs)),
            "self_collision": bool(phys["self_collision"])}
