"""Multi-device parallel policy evaluation (the JAX package's
experiments/eval_policy_parallel.py), name-compatible with the
reference's ``experiments/eval_policy_parallel.py``.

The reference forks one process per GPU and deals the episodes out
round robin, every process writing into one run directory
(eval_policy_parallel.py:266-287); the JAX package shards each batch
over its chips. Here the batched evaluator's batches are dealt out:
batch k goes to worker k mod n, one spawned process per device, each
running ``eval_policy_batched.main`` over its own batches into the shared
run directory (``eval_policy_batched.fan_out``). This module names the
devices; ``eval_policy_batched.main`` runs one in this process and fans
several out.

Usage:
  python -m real2sim_eval_tpu_torch.experiments.eval_policy_parallel \\
      [--device cuda | cuda:0,cuda:1 | cpu,cpu] key=value ...

``--device cuda`` (the default) takes every visible card; a comma list
names the devices, one worker each (a device may repeat).
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .cli import hydra_like_main
from .eval_policy_batched import main as batched_main


def device_list(device="cuda") -> list:
    """The devices a ``--device`` string names: "cuda" every visible card,
    else each comma-separated entry; raises without a card unless every
    entry is the CPU."""
    names = [d.strip() for d in str(device).split(",")]
    if names == ["cuda"]:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in names]


def main(cfg, device="cuda", devices=None, **kwargs):
    """Evaluate on ``devices`` (default: the ``device`` string's, every
    visible card for "cuda"): one device runs in this process, several
    fan out."""
    if devices is None:
        devices = device_list(device)
    return batched_main(cfg, devices=devices, **kwargs)


def main_parallel(cfg, device="cuda"):
    """The reference's name (eval_policy_parallel.py:242)."""
    return main(cfg, device=device)


cli = hydra_like_main("eval_policy_batched")(main)

if __name__ == "__main__":
    cli()
