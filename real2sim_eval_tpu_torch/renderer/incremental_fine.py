"""Incremental (dirty-tile) rendering of fixed cameras on 8x16 fine tiles.

Counterpart of the JAX package's renderer/incremental_fine.py: the wide
incremental render (renderer/incremental.py) with the fine binning
(binning.bin_gaussians_fine, no conic cull) and the fine compositors.
Per fixed camera:

  build (once)
    - preprocess + fine binning of the static gaussians, one K4 launch for
      the cached static frame, and each fine tile's range cut at its
      saturation point (``static_cutoff`` on 8x16 tiles);

  step (all envs and fixed cameras at once)
    - preprocess + fine binning of the dynamic gaussians only;
    - a fine tile is dirty iff it holds >= 1 dynamic pair; the list of
      dirty (instance, fine tile) entries is exact;
    - each dirty fine tile's static and dynamic segments merge in depth
      order, a dynamic pair first on equal depth (``merge_segments``), and
      K5 re-composites the dirty fine tiles on top of a copy of the cached
      frames.

The JAX kernel visits all 8 fine tiles of each dirty 8x128 supertile and
writes the clean ones' cached pixels through; here clean fine tiles are
never touched, which leaves the same pixels. The frames equal the full
fine pipeline's on the [dynamic; static] concatenation bitwise. The JAX
fine path always merges by sort (it has no stream merge), and so does this
one: ``config.merge_kernel`` is not read. Telemetry keeps the JAX shape
and meaning: lane 0 counts the dirty SUPERTILES (8x128 tiles holding a
dirty fine tile) per instance; the drop lanes 1-3 are 0.
"""

from __future__ import annotations

import dataclasses

import torch

from .binning import bin_gaussians_fine
from .camera import Camera
from .fine_kernel import (FINE_W, rasterize_fine_batch,
                          rasterize_fine_sparse)
from .incremental import (StaticRaster, dirty_segments, finish_frames,
                          freeze_static, preprocess_static)
from .raster import RasterConfig, bg_tuple
from .tile_kernel import GROUPS, TILE_H, TILE_W, merge_segments
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class StaticRasterFine(StaticRaster):
    """Frozen static-scene raster state for ONE fixed camera on fine tiles:
    ``n_tiles_x`` counts fine tiles (8 per 8x128 supertile), ``starts`` /
    ``ends`` are per fine tile."""

    @property
    def n_super_x(self) -> int:
        return self.n_tiles_x // GROUPS

    @property
    def n_super_y(self) -> int:
        return self.n_tiles_y

    def bin(self, pre: dict) -> dict:
        return bin_gaussians_fine(pre, self.n_super_x, self.n_super_y)


def build_static_raster_fine(cam: Camera, w2c, scene: dict, sh_degree: int,
                             bg=(0.0, 0.0, 0.0)) -> StaticRasterFine:
    """Preprocess + fine-bin + composite (one K4 launch) the static
    gaussians of an (N, ...) scene dict once, on the scene's device."""
    nsx = -(-cam.width // TILE_W)
    nsy = -(-cam.height // TILE_H)
    pre = preprocess_static(cam, w2c, scene, sh_degree)
    bins = bin_gaussians_fine(pre, nsx, nsy)
    rgb, depth = rasterize_fine_batch(bins["pair_attrs"], bins["tile_starts"],
                                      bins["tile_ends"], nsx, nsy,
                                      bg_tuple(bg))
    return freeze_static(StaticRasterFine, cam, bins, rgb, depth,
                         nsx * GROUPS, nsy, FINE_W)


def render_incremental_fine(cam_static_w2c: list, dyn_scenes: dict,
                            sh_degree: int,
                            config: RasterConfig = RasterConfig(),
                            bg=(0.0, 0.0, 0.0), stats: dict | None = None,
                            groups=None):
    """Render B envs x n fixed cameras incrementally on fine tiles.

    Args mirror ``incremental.render_incremental`` so the evaluator
    dispatches on the kernel family alone; ``cam_static_w2c`` carries
    StaticRasterFine entries (``groups`` stacks one per mesh group), and
    ``config`` is not read (the fine path
    always merges by sort). ``stats``, if given, receives ``merged_pairs``
    (the pairs the dirty fine tiles blend over) and ``dirty_fine_tiles``
    ((n_cams, B) i32).
    Returns:
      (rgb (n_cams, B, 3, h, w) clipped, depth (n_cams, B, h, w),
       telemetry (n_cams, B, 4) i32 [n_dirty_supertiles, dropped_supertiles,
       static_fill_dropped, binning_dropped])
    """
    del config
    seg = dirty_segments(cam_static_w2c, dyn_scenes, sh_degree, groups)
    st0 = cam_static_w2c[0][1]
    nsx, nsy = st0.n_super_x, st0.n_super_y
    idx = ({} if seg["cache_index"] is None
           else {"cache_index": seg["cache_index"]})
    inst, tile = seg["inst"], seg["tile"]
    with span("merge (sort)"):
        merged, m_starts, m_ends = merge_segments(
            seg["data_s"], seg["s_starts"], seg["s_ends"], seg["data_d"],
            seg["d_starts"], seg["d_ends"])
    bg = bg_tuple(bg)
    with span("K5 fine_sparse (incl. cache copy)"):
        rgb, depth = rasterize_fine_sparse(
            merged, inst, tile, m_starts, m_ends, seg["rgb_cache"],
            seg["depth_cache"], nsx, nsy, bg, **idx)
    n_inst = seg["n_cams"] * seg["B"]
    il = inst.long()
    n_super = nsx * nsy
    # the dirty list ascends per instance, so one unique pass finds the
    # distinct (instance, supertile) pairs
    sup = torch.unique(il * n_super + tile.long() // GROUPS)
    n_dirty_super = torch.bincount(sup // n_super, minlength=n_inst)
    if stats is not None:
        stats["merged_pairs"] = int(merged.shape[1])
        stats["dirty_fine_tiles"] = torch.bincount(
            il, minlength=n_inst).to(torch.int32).reshape(seg["n_cams"],
                                                          seg["B"])
    return finish_frames(rgb, depth, seg, n_dirty_super.to(torch.int32))
