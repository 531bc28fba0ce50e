"""Per-gaussian scene refinement against target images.

Counterpart of the JAX package's experiments/utils/refine_gs.py. Fits
selected splat attributes of a 3DGS PLY to posed target images by
gradient descent through the differentiable rasterizer (renderer/diff.py:
K7 forward, K8 backward): when a scan's colours or opacities do not match
the real camera, refine the gaussians themselves.

Views file (npz):
  k      (C, 3, 3) float  camera intrinsics
  w2c    (C, 4, 4) float  world->camera extrinsics
  images (C, H, W, 3) uint8 or float in [0,1]  target frames

Usage (on the card; ``--device cpu`` runs the kernels' plain versions):
  python -m real2sim_eval_tpu_torch.experiments.utils.refine_gs \
      --ply scan.ply --views views.npz --out refined.ply \
      --attrs colors,opacities --iters 200 --lr 5e-3

Optimization runs in raw parameter space (logit opacities, log scales, SH
coefficients, unnormalized quats); the refined PLY is written back in the
standard 3DGS layout. The JAX tool's pair budget (``--max-pairs-factor``)
and its drop check have no counterpart: the port's buffers are sized from
the data, so binning never drops a pair.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ...renderer.camera import Camera
from ...renderer.diff import rasterize_diff, rasterize_diff_views
from ...utils.device import resolve_device

ATTR_KEYS = {
    "colors": "sh_colors",
    "opacities": "logit_opacities",
    "means": "means3D",
    "scales": "log_scales",
    "rotations": "unnorm_rotations",
}
# raw-space step scale per attribute (3DGS-style: geometry moves slower
# than appearance)
LR_SCALE = {"sh_colors": 1.0, "logit_opacities": 1.0, "means3D": 0.1,
            "log_scales": 0.2, "unnorm_rotations": 0.2}


def load_views(path):
    d = np.load(path)
    imgs = np.asarray(d["images"])
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    return (np.asarray(d["k"], np.float32), np.asarray(d["w2c"], np.float32),
            imgs.astype(np.float32))


def sh_colors_to_coeffs(sh: torch.Tensor) -> torch.Tensor:
    """utils/ply.py's ``sh_colors_to_coeffs`` on tensors, differentiable:
    (N, 3*(D+1)^2) -> (N, (D+1)^2, 3)."""
    n = sh.shape[0]
    rest = sh[:, 3:].reshape(n, 3, -1).transpose(1, 2)
    return torch.cat([sh[:, None, :3], rest], dim=1)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient: half the cotangent at an
    exact tie (torch.maximum/minimum split ties; torch.clamp does not)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def refine(params: dict, ks, w2cs, images, attrs=("colors", "opacities"),
           iters: int = 200, lr: float = 5e-3, bg=(0.0, 0.0, 0.0),
           log_every: int = 25, z_threshold: float = 0.05, device="cuda",
           stats: dict | None = None):
    """Optimize ``attrs`` of raw splat ``params`` (numpy) against target
    views with Adam (one group per attribute at ``lr * LR_SCALE``, as the
    JAX tool's ``optax.adam(lr)`` followed by the scale).

    Returns (refined raw params dict of numpy arrays, the losses at
    iterations 0, log_every, ... and the last). With ``stats`` (a dict),
    also records each iteration's host milliseconds of the forward, the
    backward and the optimizer step, each closed by a device synchronize,
    under "forward_ms", "backward_ms" and "optimizer_ms"."""
    dev = resolve_device(device)
    n_sh = params["sh_colors"].shape[1] // 3
    sh_degree = int(round(np.sqrt(n_sh))) - 1
    if (sh_degree + 1) ** 2 != n_sh:
        raise ValueError(f"sh_colors width {params['sh_colors'].shape[1]} "
                         f"is not 3*(D+1)^2")
    images = np.asarray(images, np.float32)
    cams = [Camera(width=int(images.shape[2]), height=int(images.shape[1]),
                   fx=float(k[0, 0]), fy=float(k[1, 1]), cx=float(k[0, 2]),
                   cy=float(k[1, 2]), z_threshold=z_threshold) for k in ks]
    targets = torch.as_tensor(np.moveaxis(images, -1, 1), device=dev)
    w2cs = torch.as_tensor(np.asarray(w2cs, np.float32), device=dev)

    train_keys = [ATTR_KEYS[a] for a in attrs]
    p = {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                         requires_grad=k in train_keys)
         for k, v in params.items()}
    opt = torch.optim.Adam([{"params": [p[k]], "lr": lr * LR_SCALE[k]}
                            for k in train_keys],
                           betas=(0.9, 0.999), eps=1e-8)
    # scans come from one physical camera, so views almost always share
    # intrinsics: then all C views ride one K7 and one K8 launch
    shared_cam = all(c == cams[0] for c in cams[1:])

    def render_all():
        args = (p["means3D"], torch.exp(p["log_scales"]),
                p["unnorm_rotations"],
                torch.sigmoid(p["logit_opacities"]).reshape(-1),
                sh_colors_to_coeffs(p["sh_colors"]), sh_degree)
        if shared_cam:
            rgb, _ = rasterize_diff_views(cams[0], w2cs, *args, bg=bg,
                                          device=dev)
            return clip01(rgb)
        return torch.stack([clip01(rasterize_diff(cam, w2c, *args, bg=bg,
                                                  device=dev)[0])
                            for cam, w2c in zip(cams, w2cs)])

    def timed(key, fn):
        if stats is None:
            return fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return out

    history = []
    for i in range(iters):
        opt.zero_grad(set_to_none=True)
        loss = timed("forward_ms",
                     lambda: torch.mean((render_all() - targets) ** 2))
        timed("backward_ms", loss.backward)
        timed("optimizer_ms", opt.step)
        if i % log_every == 0 or i == iters - 1:
            history.append(float(loss.detach()))
            print(f"iter {i:5d}  loss {history[-1]:.6f}", flush=True)
    out = dict(params)
    out.update({k: p[k].detach().cpu().numpy() for k in train_keys})
    return out, history


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Refine splat attributes against posed target images")
    ap.add_argument("--ply", required=True)
    ap.add_argument("--views", required=True, help="npz with k/w2c/images")
    ap.add_argument("--out", required=True)
    ap.add_argument("--attrs", default="colors,opacities",
                    help=f"comma list from {sorted(ATTR_KEYS)}")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--bg", default="0,0,0")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from ...utils.ply import load_gaussian_ply, save_gaussian_ply

    attrs = [a.strip() for a in args.attrs.split(",") if a.strip()]
    for a in attrs:
        if a not in ATTR_KEYS:
            ap.error(f"unknown attr {a!r}")
    params = dict(load_gaussian_ply(args.ply))
    ks, w2cs, images = load_views(args.views)
    bg = tuple(float(v) for v in args.bg.split(","))
    refined, history = refine(params, ks, w2cs, images, attrs=attrs,
                              iters=args.iters, lr=args.lr, bg=bg,
                              device=args.device)
    save_gaussian_ply(refined, args.out)
    print(json.dumps({"out": str(Path(args.out).resolve()),
                      "loss_first": history[0], "loss_last": history[-1]}))


if __name__ == "__main__":
    main()
