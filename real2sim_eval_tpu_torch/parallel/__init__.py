"""Batched lockstep evaluation over envs."""

from .batched import BatchedAssets, BatchedEvaluator, BatchedState

__all__ = ["BatchedAssets", "BatchedEvaluator", "BatchedState"]
