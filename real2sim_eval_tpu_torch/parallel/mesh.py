"""Device-mesh helpers for episode parallelism (the JAX package's
parallel/mesh.py) over a list of ``torch.device``s.

The JAX package shards the batched episode state over an ``env`` mesh
axis of TPU chips. Here a mesh is the list of cards the episodes would be
spread over. One card is what the port runs: ``shard_batch`` and
``replicate`` place every tensor of a tree on it. A mesh of more than one
device raises ``NotImplementedError``: spreading episodes over several
cards is ROADMAP §1's later item "multi-card episode fan-out".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FAN_OUT_ITEM = ("spreading episodes over several cards is not ported yet "
                "(ROADMAP §1, multi-card episode fan-out); make one card "
                "visible, e.g. CUDA_VISIBLE_DEVICES=0")


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    devices: tuple


def make_env_mesh(n_devices: int | None = None, devices=None) -> EnvMesh:
    """A mesh over ``devices`` (default: every visible card), cut to
    ``n_devices``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices][:n_devices or None]
    if not devices:
        raise RuntimeError("no CUDA device is available for the mesh")
    if len(devices) > 1:
        raise NotImplementedError(FAN_OUT_ITEM)
    return EnvMesh(tuple(devices))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


def shard_batch(tree, mesh: EnvMesh):
    """Place every array leaf of ``tree`` (its leading axis the envs) on
    the mesh; on one card that is the card itself."""
    (device,) = mesh.devices
    return _tree_map(lambda x: torch.as_tensor(x, device=device), tree)


def replicate(tree, mesh: EnvMesh):
    """Every array leaf of ``tree`` on each of the mesh's devices."""
    return shard_batch(tree, mesh)


def mean_over_envs(values):
    """Mean of a per-env statistic (on one card, no collective)."""
    if torch.is_tensor(values):
        return values.float().mean()
    return np.mean(values)
