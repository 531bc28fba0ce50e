"""Gaussian-splat rendering: preprocess, binning, the tile compositors
(wide 8x128 and fine 8x16), the incremental render and the differentiable
render."""

from .camera import Camera, setup_camera
from .fine_kernel import rasterize_fine_batch, rasterize_fine_sparse
from .incremental import build_static_raster, render_incremental
from .incremental_fine import (StaticRasterFine, build_static_raster_fine,
                               render_incremental_fine)
from .raster import RasterConfig, rasterize, rasterize_batch

__all__ = ["Camera", "setup_camera", "RasterConfig", "rasterize",
           "rasterize_batch", "rasterize_fine_batch", "rasterize_fine_sparse",
           "build_static_raster", "render_incremental", "StaticRasterFine",
           "build_static_raster_fine", "render_incremental_fine"]
