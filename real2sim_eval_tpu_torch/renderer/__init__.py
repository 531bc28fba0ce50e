"""Gaussian-splat rendering: preprocess, binning, the tile compositors and
the differentiable render."""

from .camera import Camera, setup_camera
from .diff import rasterize_diff, rasterize_diff_views
from .raster import RasterConfig, rasterize, rasterize_batch

__all__ = ["Camera", "setup_camera", "RasterConfig", "rasterize",
           "rasterize_batch", "rasterize_diff", "rasterize_diff_views"]
