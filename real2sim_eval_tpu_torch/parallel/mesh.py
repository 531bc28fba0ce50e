"""Device-mesh helpers for episode parallelism (the JAX package's
parallel/mesh.py) over a list of ``torch.device``s.

The JAX package shards the batched episode state over an ``env`` mesh
axis of TPU chips. Here a mesh is the list of devices the episodes are
spread over; a list may name one device more than once (two workers on
one card). ``shard_batch`` gives each device a contiguous share of the
env axis and ``replicate`` a whole copy: on one device that is the tree
itself on it, on several a list of trees, one per device. Spreading
whole batches of episodes over cards, one worker process each, is
``experiments/eval_policy_parallel.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def _n_envs(tree) -> int | None:
    """The env count: the leading dim of the first array leaf with one."""
    found = []

    def look(x):
        if not found and np.ndim(x) >= 1:
            found.append(x.shape[0])
        return x

    _tree_map(look, tree)
    return found[0] if found else None


def shard_batch(tree, mesh: EnvMesh):
    """Place ``tree`` (array leaves with the envs on their leading axis)
    on the mesh. One device: the tree on it. Several: one tree per
    device, holding a contiguous share of the envs (the first shares one
    env larger when they do not divide evenly); scalars and leaves whose
    leading axis is not the env axis go whole to every share."""
    if len(mesh.devices) == 1:
        (device,) = mesh.devices
        return _tree_map(lambda x: torch.as_tensor(x, device=device), tree)
    n = _n_envs(tree)
    if n is None:
        return replicate(tree, mesh)
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(
        np.arange(n), len(mesh.devices))])

    def share(device, lo, hi):
        def put(x):
            x = torch.as_tensor(x, device=device)
            return x[lo:hi] if x.ndim >= 1 and x.shape[0] == n else x
        return _tree_map(put, tree)

    return [share(d, int(lo), int(hi))
            for d, lo, hi in zip(mesh.devices, bounds[:-1], bounds[1:])]


def replicate(tree, mesh: EnvMesh):
    """Every array leaf of ``tree`` on each of the mesh's devices: the
    tree on the one device, or a list of copies, one per device."""
    copies = [_tree_map(lambda x, d=d: torch.as_tensor(x, device=d), tree)
              for d in mesh.devices]
    return copies[0] if len(copies) == 1 else copies


def mean_over_envs(values):
    """Mean of a per-env statistic (no collective: the caller holds every
    env's value)."""
    if torch.is_tensor(values):
        return values.float().mean()
    return np.mean(values)
