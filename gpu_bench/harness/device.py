"""The card: its presence, its record, the run's clocks and caches, and
the guard that no JAX module was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

# top-level module names that may not be loaded in a run's process,
# compared whole: the port's name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "real2sim_eval_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """Raise NoCard unless ``n`` CUDA cards are visible. Never falls back
    to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"asks for {n}")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), so that set-up
    counts the interpreter's start and every import."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit_w() -> float | None:
    """The card's power limit (W) from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def record(n_cards: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n_cards, "power_limit_w": power_limit_w()}


def fix_caches(root: Path) -> None:
    """Keep every kernel cache at a fixed path inside the checkout: the
    port builds its extension into ``real2sim_eval_tpu_torch/_build``
    (fixed in its code); Triton's cache goes to ``gpu_bench/.cache``. A
    ``lock`` left in the build directory by a cut build would make the
    build wait for ever: remove it."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "gpu_bench" / ".cache"
                                         / "triton")
    lock = root / "real2sim_eval_tpu_torch" / "_build" / "lock"
    if lock.exists():
        lock.unlink()
