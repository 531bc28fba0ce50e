"""Forward and inverse kinematics on torch tensors."""

from .chain import KinematicChain
from .ik import KinHelper, ik_damped_ls, make_ik_fn

__all__ = ["KinematicChain", "ik_damped_ls", "make_ik_fn", "KinHelper"]
