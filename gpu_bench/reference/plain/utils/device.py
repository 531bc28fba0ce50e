"""Device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """Resolve an entry point's ``device`` argument.

    Entry points default to the card; a CUDA request on a machine without
    one raises instead of falling back, so a CPU run is always one the
    caller asked for (``device="cpu"`` runs the plain PyTorch versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


def to_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)
