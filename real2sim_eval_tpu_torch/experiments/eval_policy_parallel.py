"""Multi-device parallel policy evaluation (the JAX package's
experiments/eval_policy_parallel.py), name-compatible with the
reference's ``experiments/eval_policy_parallel.py``.

The reference forks one process per GPU over the episodes; the JAX
package shards the batched evaluator's episodes over its device mesh.
Both become the batched evaluator here: this module re-exports its entry
point. Its episodes run on one card (``parallel/mesh.py``).
"""

from __future__ import annotations

from .cli import hydra_like_main
from .eval_policy_batched import main as batched_main


def main(cfg, device="cuda", **kwargs):
    return batched_main(cfg, device=device, **kwargs)


def main_parallel(cfg, device="cuda"):
    """The reference's name (eval_policy_parallel.py:242)."""
    return batched_main(cfg, device=device)


cli = hydra_like_main("eval_policy_batched")(main)

if __name__ == "__main__":
    cli()
