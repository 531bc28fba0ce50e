"""Incremental (dirty-tile) splat rendering for fixed cameras.

Counterpart of the JAX package's renderer/incremental.py. For a fixed
camera almost all of every frame is constant: the scene-scan gaussians
(table, attached meshes, the non-articulated scan splats) move neither
across control steps nor across environments; only the object splats (LBS
on the particle state) and the robot-link splats do. So, per fixed camera:

  build (once)
    - preprocess + exact binning of the static gaussians -> a frozen,
      depth-sorted static pair table with per-tile ranges, each range cut
      at the point past which no static pair can contribute
      (``static_cutoff``), and one K1 launch for the cached static frame;

  step (all envs and fixed cameras at once)
    - preprocess + exact binning of the dynamic gaussians only;
    - a tile is dirty iff it holds >= 1 dynamic pair; clean tiles keep the
      cached pixels (their pair set is that of the static-only render);
    - merge each dirty tile's static segment and dynamic segment in depth
      order, a dynamic pair first on equal depth, and re-composite the
      dirty tiles on top of a copy of the cached frames: by a stable sort
      in PyTorch and K2 (``merge_kernel="sort"``, ``merge_segments`` +
      ``rasterize_tiles_sparse``), or inside K6 (``"stream"``,
      ``rasterize_tiles_sparse_merge``).

The merged order is the full pipeline's stable depth sort of the scene
concatenated [dynamic; static], so the frames equal the full pipeline's on
that concatenation bitwise. renderer/incremental_fine.py runs the same
step on 8x16 fine tiles (K4, K5) through the helpers here.

Every buffer is sized from the data: every dirty tile is re-composited
(the JAX package's ``t_budget``), the static fill is exactly the dirty
tiles' truncated segments (``p_mix``) and the dynamic pairs come from the
exact binning. Telemetry keeps the JAX shape (n_cams, B, 4) [n_dirty,
dropped_tiles, static_fill_dropped, binning_dropped]; the three drop lanes
are 0 by construction.
"""

from __future__ import annotations

import dataclasses

import torch

from .binning import bin_gaussians
from .camera import Camera
from .preprocess import preprocess_gaussians
from .raster import RasterConfig, bg_tuple
from .tile_kernel import (ALPHA_MAX, ALPHA_MIN, T_EPS, TILE_H, TILE_W,
                          merge_segments, rasterize_tiles_batch,
                          rasterize_tiles_sparse,
                          rasterize_tiles_sparse_merge)
from ..utils.profiling import span, spanned


@dataclasses.dataclass(frozen=True)
class StaticRaster:
    """Frozen static-scene raster state for ONE fixed camera (8x128
    tiles)."""

    pairs: torch.Tensor        # (10, P_s) per-tile depth-sorted pair table
    starts: torch.Tensor       # (n_tiles,) i32 pair range start per tile
    ends: torch.Tensor         # (n_tiles,) i32, cut at saturation
    rgb_cache: torch.Tensor    # (3, Hp, Wp) static-only frame, unclipped
    depth_cache: torch.Tensor  # (Hp, Wp)
    n_tiles_x: int
    n_tiles_y: int
    max_seg: int               # longest truncated segment
    height: int
    width: int

    def bin(self, pre: dict) -> dict:
        """Exact binning of preprocessed gaussians onto this raster's
        tiles."""
        return bin_gaussians(pre, self.n_tiles_x, self.n_tiles_y, TILE_W,
                             TILE_H)


def static_cutoff(pairs, starts, ends, n_tiles_x: int, n_tiles_y: int,
                  max_seg: int, tile_w: int = TILE_W,
                  tile_h: int = TILE_H) -> torch.Tensor:
    """Per-tile count of leading static pairs that can ever contribute.

    Front-to-back transmittance saturates: once every pixel of a tile is
    done (frozen by the would-done rule), no later pair contributes.
    Inserting dynamic pairs can only lower T pointwise and freeze pixels
    earlier, so pairs past the static-only saturation point are dead in
    every merged stream too: cutting the merge ranges there is pixel-exact.
    The JAX package's ``_static_cutoff`` (an XLA scan), here plain PyTorch
    run once per build: pair p of a tile counts iff the tile still had a
    live pixel before it. Tiles are tile_h x tile_w pixels (8x128, or the
    8x16 fine tiles). Returns (n_tiles,) i32."""
    dev = pairs.device
    n_tiles = n_tiles_x * n_tiles_y
    p_s = pairs.shape[1]
    t = torch.arange(n_tiles, device=dev)
    px = (((t % n_tiles_x) * tile_w)[:, None, None]
          + torch.arange(tile_w, device=dev)[None, None, :]).to(torch.float32)
    py = (((t // n_tiles_x) * tile_h)[:, None, None]
          + torch.arange(tile_h, device=dev)[None, :, None]).to(torch.float32)
    shape = (n_tiles, tile_h, tile_w)
    T = torch.ones(shape, dtype=torch.float32, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    starts, ends = starts.long(), ends.long()
    k_sat = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    for p in range(max_seg):
        in_r = (starts + p) < ends
        live = (T.masked_fill(done, 0.0) >= T_EPS).flatten(1).any(1)
        used = live & in_r
        # past this pair no tile has both a live pixel and a pair left
        if p % 64 == 63 and not bool(used.any()):
            break
        k_sat += used.to(torch.int32)
        a = pairs[:, torch.clamp(starts + p, max=p_s - 1)][:, :, None, None]
        dx = a[0] - px
        dy = a[1] - py
        power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
        alpha = torch.clamp(a[5] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((power <= 0.0) & in_r[:, None, None], alpha,
                            zero)
        alpha_ok = alpha >= ALPHA_MIN
        test_T = T * (1.0 - alpha)
        would_done = alpha_ok & (test_T < T_EPS)
        T = torch.where(alpha_ok & ~would_done & ~done, test_T, T)
        done = done | would_done
    return k_sat


def preprocess_static(cam: Camera, w2c, scene: dict, sh_degree: int):
    """``preprocess_gaussians`` of an (N, ...) static scene dict as one
    instance, on the scene's device."""
    dev = scene["means3D"].device
    shs = scene["shs"] if sh_degree > 0 else scene["shs"][:, :1]
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    return preprocess_gaussians(cam, w2c[None], scene["means3D"][None],
                                scene["scales"][None],
                                scene["rotations"][None],
                                scene["opacities"][None], shs[None],
                                sh_degree)


def freeze_static(cls, cam: Camera, bins: dict, rgb, depth, n_tiles_x: int,
                  n_tiles_y: int, tile_w: int):
    """A ``cls`` static raster from one instance's binning and composited
    frame, each tile's range cut at saturation (``static_cutoff``)."""
    starts, ends = bins["tile_starts"][0], bins["tile_ends"][0]
    max_seg = int((ends - starts).max()) if starts.numel() else 0
    k_sat = static_cutoff(bins["pair_attrs"], starts, ends, n_tiles_x,
                          n_tiles_y, max_seg, tile_w, TILE_H)
    return cls(
        pairs=bins["pair_attrs"], starts=starts, ends=starts + k_sat,
        rgb_cache=rgb[0], depth_cache=depth[0], n_tiles_x=n_tiles_x,
        n_tiles_y=n_tiles_y, max_seg=int(k_sat.max()) if k_sat.numel() else 0,
        height=cam.height, width=cam.width)


def build_static_raster(cam: Camera, w2c, scene: dict, sh_degree: int,
                        bg=(0.0, 0.0, 0.0)) -> StaticRaster:
    """Preprocess + bin + composite (one K1 launch) the static gaussians
    of an (N, ...) scene dict once, on the scene's device."""
    ntx = -(-cam.width // TILE_W)
    nty = -(-cam.height // TILE_H)
    pre = preprocess_static(cam, w2c, scene, sh_degree)
    bins = bin_gaussians(pre, ntx, nty, TILE_W, TILE_H)
    rgb, depth = rasterize_tiles_batch(bins["pair_attrs"], bins["tile_starts"],
                                       bins["tile_ends"], ntx, nty,
                                       bg_tuple(bg))
    return freeze_static(StaticRaster, cam, bins, rgb, depth, ntx, nty,
                         TILE_W)


@spanned("dynamic preprocess + binning")
def bin_dynamic(cam_static_w2c: list, dyn_scenes: dict, sh_degree: int):
    """Preprocess + exact binning of the dynamic gaussians of B envs for
    every fixed camera, onto each static raster's tiles. Returns (pairs
    (10, P_d), tile_starts, tile_ends (I, n_tiles) i32 into P_d, binning
    drops (I,) i32), instances camera-major: i = camera * B + env."""
    B = dyn_scenes["means3D"].shape[0]
    dev = dyn_scenes["means3D"].device
    shs = dyn_scenes["shs"] if sh_degree > 0 else dyn_scenes["shs"][:, :, :1]
    parts, starts, ends, drops = [], [], [], []
    offset = 0
    for cam, static, w2c in cam_static_w2c:
        w2c_b = torch.as_tensor(w2c, dtype=torch.float32,
                                device=dev)[None].expand(B, 4, 4)
        pre = preprocess_gaussians(cam, w2c_b, dyn_scenes["means3D"],
                                   dyn_scenes["scales"],
                                   dyn_scenes["rotations"],
                                   dyn_scenes["opacities"], shs, sh_degree)
        bins = static.bin(pre)
        parts.append(bins["pair_attrs"])
        starts.append(bins["tile_starts"] + offset)
        ends.append(bins["tile_ends"] + offset)
        drops.append(bins["n_large_dropped"])
        offset += bins["pair_attrs"].shape[1]
    return (torch.cat(parts, dim=1), torch.cat(starts), torch.cat(ends),
            torch.cat(drops))


def dirty_tiles(tile_starts, tile_ends):
    """(instance, tile) of every tile holding >= 1 dynamic pair, ascending
    (instance-major): two (n_dirty,) i32."""
    inst, tile = torch.nonzero(tile_ends > tile_starts, as_tuple=True)
    return inst.to(torch.int32), tile.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class GroupedStatics:
    """The fixed cameras' static rasters where the envs' static scenes
    differ (attached meshes posed per episode), stacked once at build:
    raster r = camera * G + mesh group."""

    pairs: torch.Tensor        # (10, P_s) every raster's pair table
    starts: torch.Tensor       # (n_cams * G, n_tiles) i32 into pairs
    ends: torch.Tensor         # (n_cams * G, n_tiles) i32
    rgb_cache: torch.Tensor    # (n_cams * G, 3, Hp, Wp)
    depth_cache: torch.Tensor  # (n_cams * G, Hp, Wp)
    rows: torch.Tensor         # (n_cams * B,) i64 instance i's raster


def group_statics(rasters: list, groups) -> GroupedStatics:
    """Stack ``rasters``, per fixed camera a list of one static raster
    (``StaticRaster`` or ``StaticRasterFine``) per mesh group, for envs
    whose group is ``groups`` (B,) i64."""
    G = len(rasters[0])
    flat = [r for per_cam in rasters for r in per_cam]   # camera-major
    offsets = [0]
    for r in flat[:-1]:
        offsets.append(offsets[-1] + r.pairs.shape[1])
    cams = torch.arange(len(rasters), device=groups.device)
    return GroupedStatics(
        pairs=torch.cat([r.pairs for r in flat], dim=1),
        starts=torch.stack([r.starts + o for r, o in zip(flat, offsets)]),
        ends=torch.stack([r.ends + o for r, o in zip(flat, offsets)]),
        rgb_cache=torch.stack([r.rgb_cache for r in flat]),
        depth_cache=torch.stack([r.depth_cache for r in flat]),
        rows=(cams[:, None] * G + groups[None]).reshape(-1))


def dirty_segments(cam_static_w2c: list, dyn_scenes: dict,
                   sh_degree: int, groups: GroupedStatics | None = None
                   ) -> dict:
    """What the dirty tiles of one incremental step blend over: the
    dynamic binning (``bin_dynamic``), the exact dirty list (``dirty_tiles``)
    and, per dirty entry, its dynamic segment and its camera's truncated
    static segment, plus the cached frames broadcast over the envs.

    ``groups``: the envs' static scenes differ; every dirty entry takes
    its env's group's static segment from the stacked rasters, which share
    each camera's tiles with its entry in ``cam_static_w2c``.

    Returns dict with data_s / data_d ((10, P) f32 tables of all cameras),
    inst / tile ((n_dirty,) i32), s_starts / s_ends / d_starts / d_ends
    ((n_dirty,) i32 ranges into data_s / data_d), rgb_cache (n_cams, B, 3,
    Hp, Wp) and depth_cache (n_cams, B, Hp, Wp) views (with ``groups``:
    its (n_cams * G, ...) tables and ``cache_index`` (I,) i64 into them,
    else ``cache_index`` None), drops (I,) i32 and the frame size h, w,
    n_cams, B."""
    if not cam_static_w2c:
        raise ValueError("need at least one fixed camera")
    cam0, _, _ = cam_static_w2c[0]
    h, w = cam0.height, cam0.width
    for cam, st, _ in cam_static_w2c:
        if {(cam.height, cam.width), (st.height, st.width)} != {(h, w)}:
            raise ValueError("incremental render needs one resolution")
    n_cams = len(cam_static_w2c)
    B = dyn_scenes["means3D"].shape[0]

    data_d, d_tile_starts, d_tile_ends, drops = bin_dynamic(
        cam_static_w2c, dyn_scenes, sh_degree)
    inst, tile = dirty_tiles(d_tile_starts, d_tile_ends)
    il, tl = inst.long(), tile.long()
    common = {"data_d": data_d, "inst": inst, "tile": tile, "drops": drops,
              "h": h, "w": w, "n_cams": n_cams, "B": B}
    if groups is not None:
        with span("mesh groups", traced=True):
            row = groups.rows[il]
            s_starts, s_ends = groups.starts[row, tl], groups.ends[row, tl]
        return dict(common, data_s=groups.pairs, s_starts=s_starts,
                    s_ends=s_ends, d_starts=d_tile_starts[il, tl],
                    d_ends=d_tile_ends[il, tl], rgb_cache=groups.rgb_cache,
                    depth_cache=groups.depth_cache, cache_index=groups.rows)

    # frozen static tables of all cameras, one table with per-camera offsets
    statics = [st for _, st, _ in cam_static_w2c]
    offsets = [0]
    for st in statics[:-1]:
        offsets.append(offsets[-1] + st.pairs.shape[1])
    s_tile_starts = torch.stack([st.starts + o
                                 for st, o in zip(statics, offsets)])
    s_tile_ends = torch.stack([st.ends + o for st, o in zip(statics, offsets)])
    cam_of = il // B
    rgb_cache = torch.stack([st.rgb_cache for st in statics])[:, None]
    depth_cache = torch.stack([st.depth_cache for st in statics])[:, None]
    return dict(
        common, data_s=torch.cat([st.pairs for st in statics], dim=1),
        s_starts=s_tile_starts[cam_of, tl], s_ends=s_tile_ends[cam_of, tl],
        d_starts=d_tile_starts[il, tl], d_ends=d_tile_ends[il, tl],
        rgb_cache=rgb_cache.expand((n_cams, B) + rgb_cache.shape[2:]),
        depth_cache=depth_cache.expand((n_cams, B) + depth_cache.shape[2:]),
        cache_index=None)


def finish_frames(rgb, depth, seg: dict, n_dirty):
    """Crop the padded (I, 3, Hp, Wp) / (I, Hp, Wp) frames of a
    ``dirty_segments`` step to (n_cams, B, ...), clip rgb to [0, 1], and
    build the telemetry (n_cams, B, 4) i32 [n_dirty, 0, 0, binning drops]
    from the (I,) dirty counts."""
    h, w, n_cams, B = seg["h"], seg["w"], seg["n_cams"], seg["B"]
    rgb = torch.clamp(rgb[:, :, :h, :w], 0.0, 1.0).reshape(n_cams, B, 3, h, w)
    depth = depth[:, :h, :w].reshape(n_cams, B, h, w)
    tele = torch.zeros((n_cams * B, 4), dtype=torch.int32,
                       device=rgb.device)
    tele[:, 0] = n_dirty
    tele[:, 3] = seg["drops"]
    return rgb, depth, tele.reshape(n_cams, B, 4)


def render_incremental(cam_static_w2c: list, dyn_scenes: dict,
                       sh_degree: int, config: RasterConfig = RasterConfig(),
                       bg=(0.0, 0.0, 0.0), stats: dict | None = None,
                       groups: GroupedStatics | None = None):
    """Render B envs x n fixed cameras incrementally.

    Args:
      cam_static_w2c: list of (Camera, StaticRaster, w2c (4, 4)) per fixed
        camera (all of one resolution); the static rasters were built with
        the same ``bg``. With ``groups`` (``group_statics``), env b
        blends over its mesh group's static segments and cached frame.
      dyn_scenes: dict of stacked (B, N_dyn, ...) DYNAMIC gaussians only.
      config: ``merge_kernel`` picks the sort merge + K2 or K6.
      stats: if given, receives ``merged_pairs``, the pairs the dirty tiles
        blend over (static segments + dynamic pairs).
    Returns:
      (rgb (n_cams, B, 3, h, w) clipped, depth (n_cams, B, h, w),
       telemetry (n_cams, B, 4) i32 [n_dirty, dropped_tiles,
       static_fill_dropped, binning_dropped])
    """
    seg = dirty_segments(cam_static_w2c, dyn_scenes, sh_degree, groups)
    st0 = cam_static_w2c[0][1]
    ntx, nty = st0.n_tiles_x, st0.n_tiles_y
    idx = ({} if seg["cache_index"] is None
           else {"cache_index": seg["cache_index"]})
    bg = bg_tuple(bg)
    data_s, data_d, inst, tile = (seg[k] for k in ("data_s", "data_d",
                                                   "inst", "tile"))
    s_starts, s_ends, d_starts, d_ends = (
        seg[k] for k in ("s_starts", "s_ends", "d_starts", "d_ends"))
    rgb_cache, depth_cache = seg["rgb_cache"], seg["depth_cache"]
    if config.merge_kernel == "stream":
        with span("K6 tile_sparse_merge (incl. cache copy)"):
            rgb, depth = rasterize_tiles_sparse_merge(
                data_s, data_d, inst, tile, s_starts, s_ends, d_starts,
                d_ends, rgb_cache, depth_cache, ntx, nty, bg, **idx)
        if stats is not None:
            stats["merged_pairs"] = int((s_ends - s_starts).sum()
                                        + (d_ends - d_starts).sum())
    else:
        with span("merge (sort)"):
            merged, m_starts, m_ends = merge_segments(
                data_s, s_starts, s_ends, data_d, d_starts, d_ends)
        with span("K2 tile_sparse (incl. cache copy)"):
            rgb, depth = rasterize_tiles_sparse(
                merged, inst, tile, m_starts, m_ends, rgb_cache,
                depth_cache, ntx, nty, bg, **idx)
        if stats is not None:
            stats["merged_pairs"] = int(merged.shape[1])
    n_dirty = torch.bincount(inst.long(), minlength=seg["n_cams"] * seg["B"])
    return finish_frames(rgb, depth, seg, n_dirty.to(torch.int32))
