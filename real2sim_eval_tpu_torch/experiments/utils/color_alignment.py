"""Fit a sim->real colour transform from paired images, numpy only.

Counterpart of the JAX package's experiments/utils/color_alignment.py (the
same arithmetic, so the same images give the same map bit for bit).
Solves a quadratic RGB map real ~ A2 @ sim^2 + A1 @ sim + b (or linear
with --linear) by weighted least squares with Tukey-biweight IRLS, and
prints the ``color_A`` / ``color_b`` yaml block of the gs configs
(cfg/gs/*.yaml, applied by renderer/scene.correct_sh_colors).

Usage:
  python -m real2sim_eval_tpu_torch.experiments.utils.color_alignment \\
      --sim sim.png --real real.png [--mask mask.png] [--linear]
"""

from __future__ import annotations

import argparse

import numpy as np


def solve_color_transform(sim_rgb: np.ndarray, real_rgb: np.ndarray,
                          weights: np.ndarray | None = None,
                          quadratic: bool = True, irls_iters: int = 10,
                          tukey_c: float = 0.2):
    """sim_rgb/real_rgb: (N, 3) in [0, 1]. Returns (A (3, 3 or 6), b (3,)).

    Per-channel weighted lstsq on features [sim^2, sim, 1] (or [sim, 1])
    with Tukey IRLS reweighting of residuals.
    """
    sim_rgb = np.asarray(sim_rgb, np.float64).reshape(-1, 3)
    real_rgb = np.asarray(real_rgb, np.float64).reshape(-1, 3)
    n = len(sim_rgb)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)

    if quadratic:
        X = np.concatenate([sim_rgb ** 2, sim_rgb, np.ones((n, 1))], axis=1)
    else:
        X = np.concatenate([sim_rgb, np.ones((n, 1))], axis=1)

    coef = None
    for _ in range(irls_iters):
        Xw = X * w[:, None]
        coef, *_ = np.linalg.lstsq(Xw.T @ X, Xw.T @ real_rgb, rcond=None)
        resid = np.linalg.norm(X @ coef - real_rgb, axis=1)
        r = resid / tukey_c
        w = np.where(r < 1.0, (1.0 - r ** 2) ** 2, 0.0)
        if w.sum() < 10:
            w = np.ones(n)
            break

    if quadratic:
        A = np.concatenate([coef[:3].T, coef[3:6].T], axis=1)  # (3, 6) [A2|A1]
    else:
        A = coef[:3].T                                         # (3, 3)
    b = coef[-1]
    return A, b


def apply_color_transform(sim_rgb: np.ndarray, A: np.ndarray,
                          b: np.ndarray) -> np.ndarray:
    """The fitted map applied to (N, 3) colours."""
    sim_rgb = np.asarray(sim_rgb, np.float64)
    A = np.asarray(A).reshape(3, -1)
    if A.shape[1] == 6:
        return sim_rgb ** 2 @ A[:, :3].T + sim_rgb @ A[:, 3:].T + b
    return sim_rgb @ A.T + b


def _yaml_block(A, b):
    A = np.asarray(A)
    rows = [", ".join(f"{v:.3f}" for v in row) for row in A]
    lines = ["color_A: ["] + [f"  {r}," for r in rows] + ["]",
             "color_b: [" + ", ".join(f"{v:.3f}" for v in b) + "]"]
    return "\n".join(lines)


def main(argv=None):
    from PIL import Image

    parser = argparse.ArgumentParser()
    parser.add_argument("--sim", required=True)
    parser.add_argument("--real", required=True)
    parser.add_argument("--mask", default=None,
                        help="optional mask image; nonzero pixels are used")
    parser.add_argument("--linear", action="store_true")
    args = parser.parse_args(argv)

    sim = np.asarray(Image.open(args.sim).convert("RGB"), np.float64) / 255.0
    real = np.asarray(Image.open(args.real).convert("RGB"), np.float64) / 255.0
    assert sim.shape == real.shape, "images must be pixel-aligned"
    sim = sim.reshape(-1, 3)
    real = real.reshape(-1, 3)
    if args.mask:
        m = np.asarray(Image.open(args.mask).convert("L")).reshape(-1) > 0
        sim, real = sim[m], real[m]

    A, b = solve_color_transform(sim, real, quadratic=not args.linear)
    fitted = apply_color_transform(sim, A, b)
    rmse = float(np.sqrt(((fitted - real) ** 2).mean()))
    print(f"# fit over {len(sim)} pixels, rmse {rmse:.4f}")
    print(_yaml_block(A, b))


if __name__ == "__main__":
    main()
