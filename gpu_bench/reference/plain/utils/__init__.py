"""Math, geometry and device helpers shared by the port's modules."""

from .device import resolve_device

__all__ = ["resolve_device"]
