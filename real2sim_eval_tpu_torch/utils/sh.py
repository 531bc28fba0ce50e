"""Spherical-harmonics colour for Gaussian splats.

Counterpart of the JAX package's utils/sh.py. The batched evaluator
renders with DC colour only (``use_shs`` off, as the flagship scene is),
so the port carries degree 0: ``C0`` and the clamped DC decode.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814


def sh_to_rgb_clamped(deg: int, sh: torch.Tensor,
                      dirs: torch.Tensor | None = None) -> torch.Tensor:
    """SH -> RGB with the rasterizer's +0.5 offset and clamp at zero.

    sh: (..., K, 3) coefficients, DC first. Only degree 0 is ported; the
    DC term does not depend on the view direction."""
    if deg != 0:
        raise NotImplementedError("only degree-0 SH is ported")
    del dirs
    return torch.clamp(C0 * sh[..., 0, :] + 0.5, min=0.0)
