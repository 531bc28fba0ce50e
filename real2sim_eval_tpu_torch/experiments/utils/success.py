"""Task success criteria over dumped episode state pkls (the JAX
package's experiments/utils/success.py, numpy alone).

The reference's three metrics with the same thresholds
(experiments/utils/calculate_success_{rope,sloth,T}.py). State pkls may hold
numpy arrays or torch tensors (the port's, the JAX package's and the
reference's dumps) — ``_np`` normalizes both, so each calculator reads
every package's rollouts.

  rope routing  (calculate_success_rope.py:166-167,201-203): >=100 spring
    segments crossing both the bottom and top x-z planes of the clip box on
    >=30 of the last 100 frames (steps >= 800 of ~900).
  sloth packing (calculate_success_sloth.py:140-171,203): >=3050 particles
    inside the box mesh's minimal OBB scaled by 1.05 on >=30 of the last
    100 frames (steps >= 350 of ~450).
  T push        (calculate_success_T.py:16-27,70-76): particle MSE vs the
    target state < 0.002 on >=30 frames from step 1700.
"""

from __future__ import annotations

import glob
import os
import pickle
from pathlib import Path

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "cpu"):
        x = x.cpu().numpy()
    return np.asarray(x)


class _CPUMappedUnpickler(pickle.Unpickler):
    """Unpickler that maps torch CUDA storages to CPU.

    The reference dumps state pkls (and ships T_final_state.pkl) with torch
    tensors still resident on ``cuda:N``; a plain ``pickle.load`` on a machine
    without CUDA raises from torch's storage reconstruction. Routing the
    storage-bytes loader through ``torch.load(map_location='cpu')`` makes the
    reference's real artifacts readable anywhere (verified against the
    released experiments/utils/T_final_state.pkl)."""

    def find_class(self, module, name):
        if module == "torch.storage" and name == "_load_from_bytes":
            import io

            import torch

            return lambda b: torch.load(
                io.BytesIO(b), map_location="cpu", weights_only=False)
        return super().find_class(module, name)


def load_state(path):
    with open(path, "rb") as f:
        try:
            return pickle.load(f)
        except RuntimeError:  # CUDA-tagged torch storages on a CPU host
            f.seek(0)
            return _CPUMappedUnpickler(f).load()


def find_episode_dirs(root) -> list[str]:
    eps = [d for d in glob.glob(os.path.join(str(root), "episode_*"))
           if os.path.isdir(d)]
    return sorted(set(eps))


# ---------------------------------------------------------------------------
# rope routing
# ---------------------------------------------------------------------------

ROPE_CLIP_CENTER = np.array([0.62, 0.05, 0.0])
ROPE_CLIP_HALF_XY = 0.035 / 2
ROPE_CLIP_TOP = 0.03
ROPE_CROSSINGS_REQUIRED = 100


def segment_crossings_y_plane(p0, p1, y_plane, x_range, z_range, eps=1e-12):
    """Count segments p0->p1 crossing plane y=y_plane with the intersection
    inside the x/z rectangle. Coplanar segments count if an endpoint lies in
    the rectangle (the reference's conservative rule,
    calculate_success_rope.py:66-74)."""
    y0, y1 = p0[:, 1], p1[:, 1]
    dy = y1 - y0
    parallel = np.abs(dy) <= eps
    t = np.where(parallel, 0.0, (y_plane - y0) / np.where(parallel, 1.0, dy))
    on_segment = ~parallel & (t >= -eps) & (t <= 1.0 + eps)
    xi = p0[:, 0] + t * (p1[:, 0] - p0[:, 0])
    zi = p0[:, 2] + t * (p1[:, 2] - p0[:, 2])
    in_rect = ((xi >= x_range[0] - eps) & (xi <= x_range[1] + eps)
               & (zi >= z_range[0] - eps) & (zi <= z_range[1] + eps))
    hits = on_segment & in_rect

    coplanar = parallel & (np.abs(y0 - y_plane) <= eps)
    for p in (p0, p1):
        end_in = ((p[:, 0] >= x_range[0] - eps) & (p[:, 0] <= x_range[1] + eps)
                  & (p[:, 2] >= z_range[0] - eps) & (p[:, 2] <= z_range[1] + eps))
        hits |= coplanar & end_in
    return int(np.count_nonzero(hits))


def is_rope_success(state, state_init) -> bool:
    springs = _np(state_init["physics"]["init_springs"])
    x = _np(state["renderer"]["x"])
    p0, p1 = x[springs[:, 0]], x[springs[:, 1]]

    c = ROPE_CLIP_CENTER
    x_range = (c[0] - ROPE_CLIP_HALF_XY, c[0] + ROPE_CLIP_HALF_XY)
    z_range = (c[2], c[2] + ROPE_CLIP_TOP)
    y_min = c[1] - ROPE_CLIP_HALF_XY
    y_max = c[1] + ROPE_CLIP_HALF_XY
    bottom = segment_crossings_y_plane(p0, p1, y_min, x_range, z_range)
    top = segment_crossings_y_plane(p0, p1, y_max, x_range, z_range)
    return bottom >= ROPE_CROSSINGS_REQUIRED and top >= ROPE_CROSSINGS_REQUIRED


# ---------------------------------------------------------------------------
# sloth packing
# ---------------------------------------------------------------------------

SLOTH_POINTS_REQUIRED = 3050
SLOTH_OBB_SCALE = 1.05


def minimal_obb(vertices: np.ndarray):
    """PCA-based oriented bounding box (center, axes(3,3 rows), extents).
    For the box container this equals the minimal OBB the reference gets
    from open3d (calculate_success_sloth.py:155-160)."""
    v = np.asarray(vertices, np.float64)
    center = v.mean(axis=0)
    cov = np.cov((v - center).T)
    _, axes = np.linalg.eigh(cov)
    axes = axes.T  # rows = axes
    local = (v - center) @ axes.T
    lo, hi = local.min(0), local.max(0)
    extent = hi - lo
    obb_center = center + ((lo + hi) / 2) @ axes
    return obb_center, axes, extent


def points_in_obb(points, center, axes, extent, scale=1.0) -> int:
    local = (np.asarray(points, np.float64) - center) @ axes.T
    half = extent * scale / 2
    inside = np.all(np.abs(local) <= half + 1e-12, axis=1)
    return int(np.count_nonzero(inside))


def is_sloth_success(state, state_init) -> bool:
    meshes = state_init["physics"]["static_meshes"]
    assert len(meshes) == 1
    vertices = _np(meshes[0]["vertices"])
    x = _np(state["renderer"]["x"])
    center, axes, extent = minimal_obb(vertices)
    n_in = points_in_obb(x, center, axes, extent, scale=SLOTH_OBB_SCALE)
    return n_in >= SLOTH_POINTS_REQUIRED


# ---------------------------------------------------------------------------
# T push
# ---------------------------------------------------------------------------

T_MSE_THRESHOLD = 0.002


def is_pusht_success(state, x_target, state_init) -> bool:
    assert len(state_init["physics"]["static_meshes"]) == 0
    x = _np(state["renderer"]["x"])
    x_target = _np(x_target)
    assert x.shape[0] == x_target.shape[0]
    mse = ((x - x_target) ** 2).sum(1).mean()
    return bool(mse < T_MSE_THRESHOLD)


# ---------------------------------------------------------------------------
# shared episode sweep
# ---------------------------------------------------------------------------


def evaluate_episodes(data_dir, is_success_fn, start_step: int,
                      frames_required: int = 30) -> list[bool]:
    """Per-episode: success if >= frames_required of the frames from
    start_step satisfy the criterion (the shared pattern across all three
    calculators)."""
    results = []
    for episode_dir in find_episode_dirs(data_dir):
        state_files = sorted(glob.glob(os.path.join(episode_dir, "state/*.pkl")))
        state_init = None
        count = 0
        ok = False
        for sf in state_files:
            step = int(Path(sf).stem)
            if step == 0:
                state_init = load_state(sf)
            if step < start_step:
                continue
            state = load_state(sf)
            if is_success_fn(state, state_init):
                count += 1
            if count >= frames_required:
                ok = True
        results.append(ok)
    return results


def write_success_file(data_dir, results: list[bool], label: str):
    success = np.zeros(len(results) + 2, dtype=int)
    success[:-2] = np.asarray(results, dtype=int)
    success[-2] = success[:-2].sum()
    success[-1] = int(success[:-2].mean() * 100) if results else 0
    np.savetxt(Path(data_dir) / "success.txt", success, fmt="%d")
    print(f"{label} success rate: {success[-2]} / {len(results)} "
          f"= {success[-1]:.1f}%")
    return success
