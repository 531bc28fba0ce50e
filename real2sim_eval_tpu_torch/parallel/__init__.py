"""Batched lockstep evaluation over envs, and the device mesh it runs on."""

from .batched import BatchedAssets, BatchedEvaluator, BatchedState
from .mesh import (EnvMesh, make_env_mesh, mean_over_envs, replicate,
                   shard_batch)

__all__ = ["BatchedAssets", "BatchedEvaluator", "BatchedState", "EnvMesh",
           "make_env_mesh", "shard_batch", "replicate", "mean_over_envs"]
