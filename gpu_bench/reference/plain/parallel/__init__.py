"""Batched lockstep evaluation over envs, and the device mesh it runs on."""

from .batched import BatchedAssets, BatchedEvaluator, BatchedState

__all__ = ["BatchedAssets", "BatchedEvaluator", "BatchedState"]
