"""PhysTwin checkpoint I/O (host numpy and pickle).

Counterpart of the JAX package's physics/checkpoints.py. Loads the
three-file checkpoint layout of a PhysTwin reconstruction:
  - ``data/<case>/final_data.pkl``: object_points (T,N,3), object_colors,
    surface_points, interior_points
  - ``experiments_optimization/<case>/optimal_params.pkl``: zeroth-order
    scalars (global_spring_Y, collide_*, ...) that override the physics cfg
  - ``experiments/<case>/train/best_*.pth``: per-spring stiffness +
    collision scalars + num_object_springs

Also provides the fixture writer that the tests and the card run build
their checkpoints with.
"""

from __future__ import annotations

import glob
import pickle
from pathlib import Path

import numpy as np
import torch


def load_final_data(data_path: str | Path, case_name: str) -> dict:
    with open(Path(data_path) / case_name / "final_data.pkl", "rb") as f:
        return pickle.load(f)


def load_optimal_params(ckpt_root: str | Path, case_name: str) -> dict:
    """Zeroth-order params, with the reference's key renames applied."""
    path = Path(ckpt_root) / case_name / "optimal_params.pkl"
    if not path.exists():
        raise FileNotFoundError(f"{case_name}: optimal parameters not found: {path}")
    with open(path, "rb") as f:
        params = pickle.load(f)
    if "global_spring_Y" in params:
        params["init_spring_Y"] = params.pop("global_spring_Y")
    if "collide_object_elas" in params:
        params["collide_self_elas"] = params.pop("collide_object_elas")
    if "collide_object_fric" in params:
        params["collide_self_fric"] = params.pop("collide_object_fric")
    return params


def load_first_order(ckpt_root: str | Path, case_name: str) -> dict:
    """First-order checkpoint (spring stiffness etc). Accepts either a torch
    ``best_*.pth`` (the reference format) or a ``best_*.npz``."""
    train_dir = Path(ckpt_root) / case_name / "train"
    paths = sorted(glob.glob(str(train_dir / "best_*.pth"))) + sorted(
        glob.glob(str(train_dir / "best_*.npz"))
    )
    if not paths:
        raise FileNotFoundError(f"no best_* checkpoint under {train_dir}")
    path = paths[0]
    if path.endswith(".npz"):
        data = dict(np.load(path))
        data["num_object_springs"] = int(data["num_object_springs"])
        return data
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for k, v in ckpt.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else v
    return out


def apply_optimal_params(cfg_physics, optimal: dict) -> None:
    """Override cfg.physics entries with checkpoint values, preserving the
    existing value's type."""
    for key, value in optimal.items():
        if key not in cfg_physics:
            raise KeyError(f"optimal param {key!r} not in physics config")
        current = cfg_physics[key]
        if isinstance(current, bool):
            value = bool(value)
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        cfg_physics[key] = value


def write_phystwin_checkpoint(
    root: str | Path,
    case_name: str,
    object_points: np.ndarray,
    surface_points: np.ndarray,
    interior_points: np.ndarray,
    spring_Y: np.ndarray,
    num_object_springs: int,
    collide_elas: float = 0.5,
    collide_fric: float = 0.3,
    collide_object_elas: float = 0.5,
    collide_object_fric: float = 0.3,
    optimal_params: dict | None = None,
    object_colors: np.ndarray | None = None,
    use_torch: bool = True,
) -> None:
    """Emit a complete synthetic checkpoint tree consumable by
    PhysTwinDynamics (of either package)."""
    root = Path(root)
    data_dir = root / "data" / case_name
    opt_dir = root / "experiments_optimization" / case_name
    train_dir = root / "experiments" / case_name / "train"
    for d in (data_dir, opt_dir, train_dir):
        d.mkdir(parents=True, exist_ok=True)

    n = len(object_points)
    if object_colors is None:
        object_colors = np.full((1, n, 3), 0.5, np.float32)
    final_data = {
        "object_points": object_points[None].astype(np.float32),
        "object_colors": object_colors,
        "surface_points": surface_points.astype(np.float32),
        "interior_points": interior_points.astype(np.float32),
    }
    with open(data_dir / "final_data.pkl", "wb") as f:
        pickle.dump(final_data, f)

    opt = {"global_spring_Y": float(np.exp(np.mean(np.log(np.maximum(spring_Y, 1e-6)))))}
    opt.update(optimal_params or {})
    with open(opt_dir / "optimal_params.pkl", "wb") as f:
        pickle.dump(opt, f)

    ckpt = {
        "spring_Y": np.asarray(spring_Y, np.float32),
        "collide_elas": np.asarray([collide_elas], np.float32),
        "collide_fric": np.asarray([collide_fric], np.float32),
        "collide_object_elas": np.asarray([collide_object_elas], np.float32),
        "collide_object_fric": np.asarray([collide_object_fric], np.float32),
        "num_object_springs": int(num_object_springs),
    }
    if use_torch:
        torch.save({k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                    for k, v in ckpt.items()}, train_dir / "best_0.pth")
        return
    np.savez(train_dir / "best_0.npz", **ckpt)
