"""The single env that binds physics and renderer, and its registry."""

from .base_env import BaseEnv
from .registration import REGISTERED_ENVS, make, register_env

__all__ = ["register_env", "make", "REGISTERED_ENVS", "BaseEnv"]
