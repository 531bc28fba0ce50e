"""Spring-mass physics: topology, SDF colliders, the control step K3."""

from .spring_mass import (MeshColliderSet, PhysicsOptions, SpringMassParams,
                          SpringMassState, SubstepControls)

__all__ = ["MeshColliderSet", "PhysicsOptions", "SpringMassParams",
           "SpringMassState", "SubstepControls"]
