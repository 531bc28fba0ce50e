"""Real spherical-harmonics colour for Gaussian splats, degrees 0-3.

Counterpart of the JAX package's utils/sh.py: the same constants, the same
basis order (the PlenOctree table of the reference's sh_utils.py and its
CUDA twin in forward.cu:20-71), one basis-times-coefficients contraction.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: torch.Tensor, deg: int) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (deg+1)**2) basis values."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree must lie in 0..3, got {deg}")
    basis = [C0 * torch.ones_like(dirs[..., 0])]
    if deg > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        basis += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
    return torch.stack(basis, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Raw SH colour (no +0.5 offset): sh (..., K, C) with K >= (deg+1)**2,
    DC first; dirs (..., 3) unit view directions. Returns (..., C)."""
    k = (deg + 1) ** 2
    return torch.einsum("...k,...kc->...c", sh_basis(dirs, deg),
                        sh[..., :k, :])


def sh_to_rgb_clamped(deg: int, sh: torch.Tensor,
                      dirs: torch.Tensor | None = None) -> torch.Tensor:
    """SH -> RGB with the rasterizer's +0.5 offset and clamp at zero
    (forward.cu:63-70). Degree 0 needs no direction.

    The clamp is ``torch.maximum``, whose gradient at an exact tie is half
    the cotangent, as ``jnp.maximum``'s is (``torch.clamp`` passes all)."""
    raw = C0 * sh[..., 0, :] if deg == 0 else eval_sh(deg, sh, dirs)
    return torch.maximum(raw + 0.5, raw.new_zeros(()))
