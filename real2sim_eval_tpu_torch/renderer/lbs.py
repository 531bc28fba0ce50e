"""Linear-blend-skinning motion interpolation (sim particles -> Gaussians).

Counterpart of the JAX package's renderer/lbs.py: kNN bone relations and
inverse-distance weights built once on the rest bones, then per frame a
per-bone rigid fit (Procrustes via Newton's polar iteration with the same
identity bias) and a weighted blend of per-bone SE(3)s. The per-frame
functions take an explicit leading env dimension in place of ``vmap``.
"""

from __future__ import annotations

import torch

from ..utils.profiling import spanned

K_REL = 8       # bone-graph neighbours
K_WGT = 16      # bones blended per particle
K_REL_SIMPLE = 16  # bones blended per point on the non-LBS path


def _pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a[:, None] - b[None]
    return torch.sqrt((diff * diff).sum(-1))


def _top_k_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries per row, as ``lax.top_k(-d, k)``
    orders them: ties to the lower index, NaN ranked first."""
    return torch.sort(-d, dim=1, descending=True,
                      stable=True).indices[:, :k].to(torch.int32)


def knn_relations(bones: torch.Tensor, k: int = K_REL) -> torch.Tensor:
    """(n_bones, k) bone-graph neighbours, excluding self.

    Kept operation for operation with the JAX package, which masks self
    with ``d + eye * inf``: 0 * inf is NaN, so every off-diagonal distance
    becomes NaN and the "neighbours" are the first k other bones by index.
    The port keeps that result for parity (see PERF.md, open questions)."""
    d = _pairwise_dist(bones, bones)
    d = d + torch.eye(bones.shape[0], dtype=d.dtype,
                      device=d.device) * float("inf")
    return _top_k_smallest(d, k)


def knn_weights(bones: torch.Tensor, pts: torch.Tensor, k: int = K_WGT,
                chunk: int = 4096):
    """Per-point inverse-distance weights over the k nearest bones.
    Returns (weights (N, k), indices (N, k) i32)."""
    ws, idxs = [], []
    for p in torch.split(pts, chunk):
        d = _pairwise_dist(p, bones)
        idx = _top_k_smallest(d, k)
        w = 1.0 / (torch.gather(d, 1, idx.long()) + 1e-6)
        ws.append(w / w.sum(-1, keepdim=True))
        idxs.append(idx)
    return torch.cat(ws), torch.cat(idxs)


def _det3(X):
    return (X[..., :, 0] * torch.linalg.cross(X[..., :, 1], X[..., :, 2],
                                              dim=-1)).sum(-1)


def fit_bone_rotations(bones, motions, relations):
    """Per-bone rotation from the neighbourhood displacement (Procrustes).

    bones, motions: (E, n_bones, 3); relations: (n_bones, k).
    Returns (E, n_bones, 3, 3)."""
    rel = relations.long()
    adj = bones[:, rel] - bones[:, :, None]                    # (E, nb, k, 3)
    adj_new = adj + (motions[:, rel] - motions[:, :, None])
    F = torch.einsum("ebki,ebkj->ebij", adj_new, adj)          # (E, nb, 3, 3)

    s = torch.sqrt((F * F).sum(dim=(-2, -1), keepdim=True)) + 1e-12
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    X = F / s + 1e-3 * eye
    d0 = _det3(X)
    X = X + torch.where(d0 < 1e-6, 1.5, 0.0)[..., None, None] * eye

    # component-major Newton iteration X <- (X + X^-T)/2 with determinant
    # scaling, 8 trips (same formulas as the JAX package)
    x = X.permute(2, 3, 0, 1)                                  # (3, 3, E, nb)
    for _ in range(8):
        c0 = _col_cross(x, 1, 2)
        det = x[0, 0] * c0[0] + x[1, 0] * c0[1] + x[2, 0] * c0[2]
        x = x * torch.abs(det) ** (-1.0 / 3.0)
        cof = torch.stack([_col_cross(x, 1, 2), _col_cross(x, 2, 0),
                           _col_cross(x, 0, 1)])      # cof[j][i] = cofactor
        det = x[0, 0] * cof[0, 0] + x[1, 0] * cof[0, 1] + x[2, 0] * cof[0, 2]
        x = 0.5 * (x + cof.transpose(0, 1) / det)
    return x.permute(2, 3, 0, 1)


def _col_cross(x, a, b):
    """Cross product of columns a and b of component-major (3, 3, ...) x."""
    return torch.stack([x[1, a] * x[2, b] - x[2, a] * x[1, b],
                        x[2, a] * x[0, b] - x[0, a] * x[2, b],
                        x[0, a] * x[1, b] - x[1, a] * x[0, b]])


@spanned("LBS")
def interpolate_motions(bones, motions, relations, weights, weights_indices,
                        xyz, env_chunk_bytes: int = 1 << 28):
    """Move gaussians by blended per-bone rigid transforms.

    bones, motions: (E, n_bones, 3); relations: (n_bones, k_rel);
    weights / weights_indices: (N, k) shared; xyz: (E, N, 3).
    Returns (E, N, 3). Envs are processed in chunks so the gathered
    (env, N, k, 15) bone table stays under ``env_chunk_bytes``."""
    R = fit_bone_rotations(bones, motions, relations)          # (E, nb, 3, 3)
    table = torch.cat([bones, motions, R.reshape(*R.shape[:2], 9)], dim=-1)
    n, k = weights_indices.shape
    widx = weights_indices.long()
    per_env = max(n * k * table.shape[-1] * 4, 1)
    step = max(1, env_chunk_bytes // per_env)
    out = []
    for e0 in range(0, table.shape[0], step):
        sel = table[e0:e0 + step, widx]                        # (e, N, k, 15)
        b_sel = sel[..., 0:3]
        m_sel = sel[..., 3:6]
        R_sel = sel[..., 6:15].reshape(*sel.shape[:3], 3, 3)
        local = xyz[e0:e0 + step, :, None] - b_sel
        moved = (R_sel * local[..., None, :]).sum(-1) + b_sel + m_sel
        out.append((moved * weights[None, ..., None]).sum(2))
    return torch.cat(out)


def simple_weights(bones: torch.Tensor, pts: torch.Tensor,
                   k: int = K_REL_SIMPLE, chunk: int = 4096):
    """The non-LBS path (``use_lbs: false``): a pure inverse-distance blend
    of bone positions, no rotations. Same (weights, indices) layout."""
    return knn_weights(bones, pts, k=k, chunk=chunk)


def simple_apply(weights, indices, bones_pred):
    """xyz = sum_k w_k * bones_pred[..., idx_k, :]; ``bones_pred`` may carry
    leading env dims."""
    return (weights[..., None] * bones_pred[..., indices.long(), :]).sum(-2)
