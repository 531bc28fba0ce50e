"""Forward and inverse kinematics on torch tensors."""

from .chain import KinematicChain
from .ik import make_ik_fn

__all__ = ["KinematicChain", "make_ik_fn"]
