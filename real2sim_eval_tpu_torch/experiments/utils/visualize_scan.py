"""Quick splat-scan viewer: orbit views, a .splat export and a browser view.

Counterpart of the JAX package's experiments/utils/visualize_scan.py (the
reference's assets/scans/visualize_scan.py opens a gradio splat viewer):
renders orbit views of one or more scan PLYs to PNGs, exports merged
.splat files for any web viewer, or serves an interactive orbit view over
the stdlib MJPEG server (utils/viser_gui.py). The renders run the port's
``rasterize`` (K1) on ``--device``, the card unless ``--device cpu``.

Usage:
  python -m real2sim_eval_tpu_torch.experiments.utils.visualize_scan \
      scan1.ply [scan2.ply ...] [--out dir] [--splat merged.splat]
      [--serve --port 6789] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _activated(params):
    from ...utils.gs_processor import activate_params
    from ...utils.ply import sh_colors_to_coeffs

    return activate_params(dict(
        params,
        sh_colors=sh_colors_to_coeffs(params["sh_colors"])
        if np.asarray(params["sh_colors"]).ndim == 2
        else params["sh_colors"]))


def _scene(act, dev):
    """The DC-only render inputs of activated params, on ``dev``."""
    import torch

    return [torch.as_tensor(act[k], device=dev)
            for k in ("means3D", "scales", "rotations", "opacities")] + [
        torch.as_tensor(act["shs"][:, :1], device=dev)]


def _frame(im) -> np.ndarray:
    return (np.clip(im.cpu().numpy(), 0, 1).transpose(1, 2, 0) * 255
            ).astype(np.uint8)


def render_orbit_views(params, out_dir: Path, name: str, n_views: int = 4,
                       device="cuda"):
    """``n_views`` 640x480 views around the scan's centroid, each written
    as ``{name}_view{i}.png`` under ``out_dir``."""
    import cv2

    from ...renderer.camera import Camera, orbit_camera_w2c
    from ...renderer.raster import RasterConfig, rasterize
    from ...utils.device import resolve_device

    dev = resolve_device(device)
    act = _activated(params)
    center = act["means3D"].mean(0)
    radius = float(np.linalg.norm(act["means3D"] - center, axis=1).max()) * 1.8
    cam = Camera(width=640, height=480, fx=400.0, fy=400.0, cx=320.0, cy=240.0)
    gs = _scene(act, dev)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n_views):
        w2c = orbit_camera_w2c(tuple(center), max(radius, 0.3), 25,
                               360.0 * i / n_views)
        im, _ = rasterize(cam, w2c, *gs, 0, config=RasterConfig(),
                          device=dev)
        cv2.imwrite(str(out_dir / f"{name}_view{i}.png"),
                    _frame(im)[:, :, ::-1])
    print(f"wrote {n_views} views of {name} to {out_dir}")


def serve_orbit(params, port: int = 6789, w: int = 848, h: int = 480,
                duration: float | None = None, device="cuda"):
    """Interactive in-browser orbit of an arbitrary splat PLY, no episode
    required: mouse drag orbits, wheel zooms.

    Blocks rendering frames until ``duration`` seconds pass (None = run
    until interrupted). Returns the viewer (tests use port=0 + duration).
    """
    import time

    from ...renderer.camera import Camera
    from ...renderer.raster import RasterConfig, rasterize
    from ...utils.device import resolve_device
    from ...utils.viser_gui import ViserViewer, orbit_w2c

    dev = resolve_device(device)
    act = _activated(params)
    center = np.asarray(act["means3D"]).mean(0)
    radius = float(np.linalg.norm(
        np.asarray(act["means3D"]) - center, axis=1).max()) * 1.8
    radius = max(radius, 0.3)
    f = 0.8 * max(w, h)
    cam = Camera(width=w, height=h, fx=f, fy=f, cx=w / 2.0, cy=h / 2.0)
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)

    viewer = ViserViewer(port=port, w=w, h=h)
    viewer.set_metadata(w, h, k, orbit_w2c(0.0, 0.6, radius, center))
    viewer._target = center          # orbit around the scan centroid
    viewer.dist_scale = radius       # client dist=1 frames the whole scan

    gs = _scene(act, dev)
    print(f"orbit viewer on http://0.0.0.0:{viewer.port}/ "
          f"({act['means3D'].shape[0]} gaussians)")
    t_end = None if duration is None else time.time() + duration
    last = None
    t0 = time.time()
    n = 0
    while t_end is None or time.time() < t_end:
        w2c = np.asarray(viewer.get_metadata()["w2c"], np.float32)
        if last is not None and np.array_equal(w2c, last):
            time.sleep(0.03)
            continue
        im, _ = rasterize(cam, w2c, *gs, 0, config=RasterConfig(),
                          device=dev)
        viewer.set_output({"image": _frame(im)})
        n += 1
        viewer.set_fps(n / max(time.time() - t0, 1e-6))
        last = w2c
    return viewer


def main(argv=None):
    from ...utils.device import resolve_device
    from ...utils.gs_processor import GSProcessor

    parser = argparse.ArgumentParser()
    parser.add_argument("scans", nargs="+")
    parser.add_argument("--out", default="log/gs/scan_views")
    parser.add_argument("--splat", default=None,
                        help="also export a merged .splat for web viewers")
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--serve", action="store_true",
                        help="serve an interactive browser orbit view of "
                             "the (merged) scans instead of writing PNGs")
    parser.add_argument("--port", type=int, default=6789)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    args = parser.parse_args(argv)
    resolve_device(args.device)     # refuse before writing anything

    sp = GSProcessor()
    all_params = []
    for scan in args.scans:
        params = sp.load(scan)
        all_params.append(params)
        if not args.serve:
            render_orbit_views(params, Path(args.out), Path(scan).stem,
                               args.views, device=args.device)
    if args.splat:
        sp.save_to_splat(sp.merge(all_params), args.splat)
        print(f"wrote {args.splat}")
    if args.serve:
        merged = (sp.merge(all_params) if len(all_params) > 1
                  else all_params[0])
        serve_orbit(merged, port=args.port, device=args.device)


if __name__ == "__main__":
    main()
