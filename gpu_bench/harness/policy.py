"""The traffic generator ``policy``: a scripted policy read from a
traffic file.

A traffic file (``gpu_bench/traffic/<mix>.json``) says how a cell is
driven: its ``entry`` (a module of ``gpu_bench/harness`` that runs the
window), its ``generator`` (a module of ``gpu_bench/harness`` whose
``make`` builds the policy from the file; ``policy`` is this one), its
``lanes``, and here one cycle of eef waypoints that every lane repeats,
the lanes' phases evenly spaced over the cycle and dealt out by the
seed, so that at every step the batch is spread over the whole cycle
alike for every seed. The schedule is open loop: each lane's waypoints
are planned from the object's initial pose and particles and the seed,
not from what the object does. The policy implements the policy
protocol (``inference(obs) -> (n, 8)``: xyz, quaternion wxyz, gripper in
policy space, 1 closed) and reads nothing the program computed: each
lane's object pose and the pose of each attached mesh are worked out in
numpy from the run config the benchmark wrote, by the scene's own grid
walk (``grid_pose``, ``mesh_pose``: a one-to-one grid pairs ``xy[i]``
with ``theta[i]``; a mesh with a grid takes its cell from the episode
index left over by the object's grid and the meshes before it), once,
when the policy is built; its particles come from the benchmark's own
arrays.

The cycle (``traffic["cycle"]``):

- ``draws``: name -> [lo, hi], drawn uniformly per lane and cycle;
- ``anchor``: ``{"along": <expr>}``, the point at that fraction of the
  object's extent along its long axis, on the axis through its particles'
  centroid (0.5: the centroid);
- ``heading``: the cycle's direction in the table plane, ``{"toward":
  "mesh:<name>", "stop_short": m}`` (toward a mesh of the config where
  the lane's episode puts it, no heading term of turn 0 bringing a
  waypoint within ``stop_short`` of it) or ``{"angle": <expr>}``
  (degrees);
- ``yaw``: ``{"follow": "object", "offset": <expr>}`` (the eef's x axis
  along the object's long axis at the anchor) or ``{"fixed": deg}``;
- ``phases``: each ``{"steps": n, "grip": 0 or 1, "xy": [[turn, length],
  ...], "z": [<expr>, ...]}``: a waypoint reached linearly over ``steps``
  control steps, at anchor + sum of length * dir(heading + turn) in the
  plane and at the sum of ``z`` (m) above the table, as the tool tip's
  height (the configuration's ``tool_offset_m`` below the eef).

An expression is a number, a draw's name, or ``-`` and a draw's name.
The commanded eef moves at most ``max_step_m`` a control step: a lane
that falls behind its schedule catches up at that speed.
"""

from __future__ import annotations

import numpy as np

from .scene import rng_of

DOWN = np.diag([1.0, -1.0, -1.0])      # the eef pointing at the table


def _cells(grid: dict) -> int:
    """A grid's cells: one per ``xy`` entry where it is one-to-one, else
    one per pair of an ``xy`` entry and a ``theta`` entry."""
    if grid.get("one_to_one", False):
        return len(grid["xy"])
    return len(grid["xy"]) * len(grid["theta"])


def _cell_pose(pose, grid: dict, cell: int) -> np.ndarray:
    """``pose`` (16 numbers) moved to ``cell`` of ``grid`` as the scene's
    grid randomization moves it: the cell's offset added to the
    translation and its yaw applied before the rotation; one-to-one,
    cell i is ``xy[i]`` with ``theta[i]``, else ``xy[cell // n_theta]``
    with ``theta[cell % n_theta]``."""
    if grid.get("one_to_one", False):
        (rx, ry), deg = grid["xy"][cell], grid["theta"][cell]
    else:
        rx, ry = grid["xy"][cell // len(grid["theta"])]
        deg = grid["theta"][cell % len(grid["theta"])]
    a = deg * np.pi / 180.0
    p = np.array(pose, np.float64).reshape(4, 4)
    p[:3, 3] += [rx, ry, 0.0]
    p[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0.0],
                          [np.sin(a), np.cos(a), 0.0],
                          [0.0, 0.0, 1.0]]) @ p[:3, :3]
    return p


def grid_pose(cfg: dict, episode: int) -> np.ndarray:
    """Episode's object pose (4, 4), world frame, worked out from the
    config alone: the object grid's cell ``episode % cells``."""
    g = cfg["gs"]["object"]["grid_randomization"]
    return _cell_pose(cfg["gs"]["object"]["pose"], g, episode % _cells(g))


def mesh_pose(cfg: dict, name: str, episode: int) -> np.ndarray:
    """Episode's pose (4, 4) of the attached mesh ``name``, world frame,
    by the scene's walk: ``m = episode // (the object grid's cells)``;
    each mesh with a grid, in config order, takes cell ``m % its cells``
    and leaves ``m // its cells`` to the next. A mesh without a grid
    keeps its base pose."""
    m = episode // _cells(cfg["gs"]["object"]["grid_randomization"])
    for mesh in cfg["gs"]["meshes"]:
        g = mesh.get("grid_randomization")
        if mesh["name"] == name:
            if not g:
                return np.array(mesh["pose"], np.float64).reshape(4, 4)
            return _cell_pose(mesh["pose"], g, m % _cells(g))
        if g:
            m //= _cells(g)
    raise KeyError(f"no mesh {name!r} in the config")


def reset_eef_xyz() -> np.ndarray:
    """Where a reset puts the eef (link7): the built-in arm at its
    canonical pose, by the reference copy's forward kinematics."""
    from ..reference.plain.kinematics.robot import (CANONICAL_ARM_QPOS,
                                                    RobotModel)
    from ..reference.plain.utils.urdf import BUILTIN_URDF

    robot = RobotModel(BUILTIN_URDF)
    q = np.concatenate([CANONICAL_ARM_QPOS,
                        np.zeros(robot.chain.n_dof - 7)])
    return np.asarray(robot.fk_numpy(q)[robot.chain.link_index("link7")]
                      [:3, 3], np.float64)


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> quaternion wxyz."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


def _dir(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    return np.array([np.cos(a), np.sin(a)])


class CyclePolicy:
    """The scripted policy of one traffic file over ``lanes`` lanes."""

    def __init__(self, traffic: dict, cfg: dict, spec: dict,
                 particles: np.ndarray, episode_ids, seed: int):
        self.cycle = traffic["cycle"]
        self.max_step = float(traffic["max_step_m"])
        self.seed = int(seed)
        self.tool = float(spec["tool_offset_m"])
        self.table_z = float(cfg["physics"].get("table_height", 0.0))
        self.lanes = len(episode_ids)
        self.length = sum(int(p["steps"]) for p in self.cycle["phases"])
        # lane phases evenly spaced over the cycle, dealt to the lanes in
        # an order drawn from the seed and shifted by a draw under one
        # spacing: every seed puts as many lanes in each phase at every
        # step, in another order
        rng = rng_of(seed, 2)
        spaced = (np.arange(self.lanes) * self.length / self.lanes
                  + rng.uniform(0.0, self.length / self.lanes))
        self.offset = spaced.astype(np.int64)[rng.permutation(self.lanes)]
        pts = np.asarray(particles, np.float64)
        self.world = []               # per lane: particles in the world
        for ep in episode_ids:
            P = grid_pose(cfg, int(ep))
            self.world.append(pts @ P[:3, :3].T + P[:3, 3])
        self.meshes = [{m["name"]: mesh_pose(cfg, m["name"], int(ep))[:2, 3]
                        for m in cfg["gs"]["meshes"]}
                       for ep in episode_ids]   # per lane: name -> xy
        self.init = reset_eef_xyz()
        self.cmd = np.tile(self.init, (self.lanes, 1))
        self.t = 0
        self._plans: dict = {}

    # -- one lane's cycle ---------------------------------------------------

    def _expr(self, e, draws: dict) -> float:
        if isinstance(e, str):
            return -draws[e[1:]] if e.startswith("-") else draws[e]
        return float(e)

    def _plan(self, lane: int, c: int) -> list:
        """Lane's waypoints of cycle c: [(end step, xyz, yaw, grip)]."""
        key = (lane, c)
        if key in self._plans:
            return self._plans[key]
        cy = self.cycle
        rng = rng_of(self.seed, 3, lane, c)
        draws = {k: float(rng.uniform(lo, hi))
                 for k, (lo, hi) in sorted(cy["draws"].items())}
        pts = self.world[lane]
        xy = pts[:, :2]
        centre = xy.mean(0)
        # the long axis: the principal direction of the particles
        _, _, vt = np.linalg.svd(xy - centre, full_matrices=False)
        axis = vt[0]
        proj = (xy - centre) @ axis
        u = self._expr(cy["anchor"]["along"], draws)
        anchor = centre + (proj.min() + u * (proj.max() - proj.min())) * axis
        h = cy["heading"]
        short = None
        if "toward" in h:
            goal = self.meshes[lane][h["toward"].split(":", 1)[1]]
            heading = np.rad2deg(np.arctan2(*(goal - anchor)[::-1]))
            short = (goal, float(h.get("stop_short", 0.0)))
        else:
            heading = self._expr(h["angle"], draws)
        y = cy["yaw"]
        if "follow" in y:
            # the tangent at the anchor: nearby particles' principal axis
            near = xy[np.argsort(np.sum((xy - anchor) ** 2, 1))[:21]]
            _, _, vn = np.linalg.svd(near - near.mean(0),
                                     full_matrices=False)
            yaw = (np.rad2deg(np.arctan2(vn[0][1], vn[0][0]))
                   + self._expr(y.get("offset", 0.0), draws))
        else:
            yaw = float(y["fixed"])
        plan, end = [], c * self.length
        for ph in cy["phases"]:
            p = anchor.copy()
            for turn, length in ph.get("xy", []):
                t, L = self._expr(turn, draws), self._expr(length, draws)
                if short is not None and t == 0 and L > 0:
                    room = np.linalg.norm(short[0] - p) - short[1]
                    L = min(L, max(room, 0.0))
                p = p + L * _dir(heading + t)
            z = sum(self._expr(e, draws) for e in ph["z"])
            end += int(ph["steps"])
            plan.append((end, np.array([p[0], p[1], self.table_z + self.tool
                                        + z]), yaw, float(ph["grip"])))
        self._plans[key] = plan
        if len(self._plans) > 4 * self.lanes:
            self._plans.pop(next(iter(self._plans)))
        return plan

    def _target(self, lane: int, t: int):
        """Lane's scheduled eef pose and grip at its step t."""
        c = t // self.length
        plan = self._plan(lane, c)
        start = c * self.length
        prev = self._plan(lane, c - 1)[-1] if c > 0 else (
            start, self.init, plan[0][2], 0.0)
        for end, xyz, yaw, grip in plan:
            if t < end:
                f = (t + 1 - start) / (end - start)
                return prev[1] + f * (xyz - prev[1]), yaw, grip
            start, prev = end, (end, xyz, yaw, grip)
        return plan[-1][1], plan[-1][2], plan[-1][3]

    # -- the policy protocol ------------------------------------------------

    def actions(self) -> np.ndarray:
        """(lanes, 8) commands of the next control step."""
        out = np.zeros((self.lanes, 8), np.float32)
        for lane in range(self.lanes):
            xyz, yaw, grip = self._target(lane, self.t + int(self.offset[lane]))
            step = xyz - self.cmd[lane]
            n = np.linalg.norm(step)
            if n > self.max_step:
                step *= self.max_step / n
            self.cmd[lane] = self.cmd[lane] + step
            a = np.deg2rad(yaw)
            Rz = np.array([[np.cos(a), -np.sin(a), 0.0],
                           [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
            out[lane, :3] = self.cmd[lane]
            out[lane, 3:7] = rot_to_quat(Rz @ DOWN)
            out[lane, 7] = grip
        self.t += 1
        return out

    def inference(self, obs_dict=None) -> np.ndarray:
        return self.actions()

    def reset(self) -> None:
        pass

    def visualize_overlay(self, image):
        return image


def make(traffic: dict, cfg: dict, spec: dict, particles: np.ndarray,
         episode_ids, seed: int) -> CyclePolicy:
    """The generator's policy of ``traffic`` over ``episode_ids``."""
    return CyclePolicy(traffic, cfg, spec, particles, episode_ids, seed)
