"""Gaussian-splat rendering: preprocess, binning, the tile compositor K1."""

from .camera import Camera, setup_camera
from .raster import RasterConfig, rasterize, rasterize_batch

__all__ = ["Camera", "setup_camera", "RasterConfig", "rasterize",
           "rasterize_batch"]
