"""Spring topology construction (host-side numpy, reset time).

Counterpart of the JAX package's physics/topology.py: KD-tree hybrid-search
spring connection (over all points, or inside each group of a mask)
and the per-particle neighbour tables the spring step
gathers through (``nbr_idx``: padded with the particle's own index, -inf
log stiffness in the padding). The offset-structured (rolled) tables and
the RCM reordering are kept for parity with the JAX package; the CUDA
step gathers through ``nbr_idx`` directly and does not need them.
"""

from __future__ import annotations

import numpy as np


def connect_springs(points: np.ndarray, radius: float, max_neighbours: int,
                    rest_points: np.ndarray | None = None,
                    min_rest_length: float = 1e-4):
    """The k nearest neighbours within ``radius`` (k includes self),
    deduplicated, skipping degenerate rest lengths.
    Returns springs (S, 2) int32, rest_lengths (S,) float32."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float64)
    rest_points = (points if rest_points is None
                   else np.asarray(rest_points, np.float64))
    _, idxs = cKDTree(points).query(points, k=max_neighbours,
                                    distance_upper_bound=radius)
    n = len(points)
    seen = set()
    springs, rests = [], []
    for i in range(n):
        for k in range(1, max_neighbours):          # skip self (k=0)
            j = idxs[i, k]
            if j >= n:                  # cKDTree pads missing neighbours
                break
            rest = float(np.linalg.norm(rest_points[i] - rest_points[j]))
            key = (i, j) if i < j else (j, i)
            if key in seen or rest <= min_rest_length:
                continue
            seen.add(key)
            springs.append([i, j])
            rests.append(rest)
    if not springs:
        return np.zeros((0, 2), np.int32), np.zeros((0,), np.float32)
    return np.asarray(springs, np.int32), np.asarray(rests, np.float32)


def connect_springs_grouped(points: np.ndarray, group_mask: np.ndarray,
                            radius: float, max_neighbours: int):
    """``connect_springs`` inside each mask group alone, the groups in
    sorted order. Returns springs (S, 2) int32 (indices into ``points``),
    rest_lengths (S,) float32."""
    springs_all, rests_all = [], []
    for value in np.unique(group_mask):
        sel = np.where(group_mask == value)[0]
        s, r = connect_springs(points[sel], radius, max_neighbours)
        if len(s):
            springs_all.append(sel[s])
            rests_all.append(r)
    if not springs_all:
        return np.zeros((0, 2), np.int32), np.zeros((0,), np.float32)
    return (np.concatenate(springs_all).astype(np.int32),
            np.concatenate(rests_all).astype(np.float32))


def build_neighbor_tables(springs, rest_lengths, spring_Y_log, n_points):
    """Per-particle neighbour formulation: each spring evaluated from both
    ends. Returns (nbr_idx (N, D) i32 padded with the own index,
    nbr_rest (N, D) f32 padded 1.0, nbr_Y_log (N, D) f32 padded -inf)."""
    lists = [[] for _ in range(n_points)]
    for s, (i, j) in enumerate(np.asarray(springs)):
        r, y = float(rest_lengths[s]), float(spring_Y_log[s])
        lists[int(i)].append((int(j), r, y))
        lists[int(j)].append((int(i), r, y))
    deg = max(1, max((len(lst) for lst in lists), default=0))
    nbr_idx = np.tile(np.arange(n_points, dtype=np.int32)[:, None], (1, deg))
    nbr_rest = np.ones((n_points, deg), np.float32)
    nbr_Y = np.full((n_points, deg), -np.inf, np.float32)
    for p, lst in enumerate(lists):
        for d, (j, r, y) in enumerate(lst):
            nbr_idx[p, d] = j
            nbr_rest[p, d] = r
            nbr_Y[p, d] = y
    return nbr_idx, nbr_rest, nbr_Y


def build_rolled_tables(springs, rest_lengths, spring_Y_log, n_points,
                        max_offsets: int = 128):
    """Offset-structured tables for chain-like topologies: for each distinct
    index offset o, row i holds the (i, i+o) spring's params (-inf
    stiffness when absent). Returns (offsets (O,) i32, rest (O, N) f32,
    Y_log (O, N) f32) or None past ``max_offsets`` distinct offsets."""
    springs = np.asarray(springs)
    if len(springs) == 0:
        return None
    offsets = np.unique(np.concatenate([springs[:, 1] - springs[:, 0],
                                        springs[:, 0] - springs[:, 1]]))
    if len(offsets) > max_offsets:
        return None
    off_index = {int(o): k for k, o in enumerate(offsets)}
    rest = np.ones((len(offsets), n_points), np.float32)
    Y = np.full((len(offsets), n_points), -np.inf, np.float32)
    for s, (i, j) in enumerate(springs):
        for a, b in ((int(i), int(j)), (int(j), int(i))):
            k = off_index[b - a]
            rest[k, a] = rest_lengths[s]
            Y[k, a] = spring_Y_log[s]
    return offsets.astype(np.int32), rest, Y


def build_rolled_tables_maybe_reordered(springs, rest_lengths, spring_Y_log,
                                        n_points, max_offsets: int = 128):
    """Rolled tables in checkpoint order, else after RCM reordering.
    Returns (rolled_or_None, perm_or_None)."""
    rolled = build_rolled_tables(springs, rest_lengths, spring_Y_log,
                                 n_points, max_offsets)
    if rolled is not None or len(np.asarray(springs)) == 0:
        return rolled, None
    perm = rcm_order(springs, n_points)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_points, dtype=np.int32)
    rolled_p = build_rolled_tables(inv[np.asarray(springs)], rest_lengths,
                                   spring_Y_log, n_points, max_offsets)
    if rolled_p is None:
        return None, None
    return rolled_p, perm


def rcm_order(springs, n_points: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the spring graph: perm[k] is the
    original index of the particle at new position k."""
    adj = [[] for _ in range(n_points)]
    for i, j in np.asarray(springs):
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    deg = np.array([len(a) for a in adj])
    visited = np.zeros(n_points, bool)
    order = []
    for start in np.argsort(deg):
        if visited[start]:
            continue
        queue = [int(start)]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            for u in sorted((u for u in adj[v] if not visited[u]),
                            key=lambda u: deg[u]):
                visited[u] = True
                queue.append(u)
    return np.asarray(order[::-1], np.int32)
