"""Point-cloud registration: global init + iterative closest point, numpy
and scipy only (a copy of the JAX package's utils/icp.py, the same
arithmetic in the same order, so the same inputs give the same transform
bit for bit).

  - global_registration: centroid + PCA principal-axes alignment, scored
    over the 4 axis-sign hypotheses with a truncated-NN cost; it is meant
    for a scan cropped to the robot (a whole tabletop scan's principal
    axes are the table's);
  - icp: point-to-point ICP with a cKDTree correspondence search and SVD
    (Kabsch) updates, with distance-threshold trimming; ``thresholds`` is
    the coarse->fine schedule.
"""

from __future__ import annotations

import numpy as np


def _kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    sc = src.mean(0)
    dc = dst.mean(0)
    H = (src - sc).T @ (dst - dc)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = dc - R @ sc
    return T


def _apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def _nn_cost(src, tree, trunc: float) -> float:
    d, _ = tree.query(src, k=1, workers=-1)
    return float(np.minimum(d, trunc).mean())


def global_registration(source: np.ndarray, target: np.ndarray,
                        trunc: float = 0.05) -> np.ndarray:
    """Coarse alignment source->target via centroid + PCA axes, trying the
    four proper-rotation sign combinations and keeping the best NN cost."""
    from scipy.spatial import cKDTree

    def pca_frame(pts):
        c = pts.mean(0)
        _, vecs = np.linalg.eigh(np.cov((pts - c).T))
        axes = vecs[:, ::-1]  # principal first
        if np.linalg.det(axes) < 0:
            axes[:, 2] *= -1
        return c, axes

    cs, As = pca_frame(source)
    ct, At = pca_frame(target)
    tree = cKDTree(target)

    best_T, best_cost = np.eye(4), np.inf
    for sx in (1, -1):
        for sy in (1, -1):
            S = np.diag([sx, sy, sx * sy])  # proper rotations only
            R = At @ S @ As.T
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = ct - R @ cs
            cost = _nn_cost(_apply(T, source), tree, trunc)
            if cost < best_cost:
                best_T, best_cost = T, cost
    return best_T


def icp(source: np.ndarray, target: np.ndarray, init: np.ndarray | None = None,
        thresholds=(0.04, 0.01), max_iter: int = 50,
        tol: float = 1e-7) -> np.ndarray:
    """Trimmed point-to-point ICP. ``thresholds`` is the coarse->fine
    correspondence-distance schedule (the reference's 2-stage ICP,
    icp_utils.py:96-131). Returns the 4x4 source->target transform."""
    from scipy.spatial import cKDTree

    T = np.eye(4) if init is None else np.array(init, np.float64)
    tree = cKDTree(target)
    src0 = np.asarray(source, np.float64)

    for thresh in thresholds:
        prev_err = np.inf
        for _ in range(max_iter):
            cur = _apply(T, src0)
            d, idx = tree.query(cur, k=1, workers=-1)
            keep = d < thresh
            if keep.sum() < 10:
                break
            delta = _kabsch(cur[keep], np.asarray(target)[idx[keep]])
            T = delta @ T
            err = float(d[keep].mean())
            if abs(prev_err - err) < tol:
                break
            prev_err = err
    return T


def registration_error(source, target, T, trunc: float = 0.05) -> float:
    from scipy.spatial import cKDTree

    return _nn_cost(_apply(T, source), cKDTree(target), trunc)
