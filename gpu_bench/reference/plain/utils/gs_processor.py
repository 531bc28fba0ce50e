"""Gaussian-splat parameter processing (load/save/edit), numpy-native.

Counterpart of the JAX package's utils/gs_processor.py, over the port's
utils/ply.py: load/save PLY, crop, merge, rotate, translate, scale,
apply_mask, add_axis, .splat export.
Operates on raw (pre-activation) parameter dicts:
  means3D (N,3), sh_colors (N, 3(D+1)^2), log_scales (N,3),
  unnorm_rotations (N,4), logit_opacities (N,1)
All numpy (this is offline tooling; the render path converts once).
"""

from __future__ import annotations

import numpy as np

from . import ply as plylib
from .sh import C0


def _quat_mult(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _rot_to_quat(R):
    w = np.sqrt(np.maximum(1 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    return np.array([w,
                     (R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)], np.float32)


class GSProcessor:
    """The reference's GSProcessor surface, on numpy arrays."""

    def load(self, path, rot_x_minus90: bool = False) -> dict:
        params = plylib.load_gaussian_ply(path)
        if rot_x_minus90:
            R = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
            params = self.rotate(params, R)
        return params

    def load_phystwin(self, path, max_sh_degrees: int = 3) -> dict:
        """Load a PhysTwin-exported gaussian PLY.

        PhysTwin plys differ from standard splat exports: they carry a
        SINGLE isotropic scale column (expanded to 3), and the
        reference assembles the feature matrix by writing f_dc_0..2 to
        columns 0..2 and then overwriting from column 0 with the f_rest
        sequence (:29-33) — the dc terms survive only when there are no
        rest coefficients. We reproduce that layout faithfully (PhysTwin
        checkpoints were exported under it)."""
        t, n = plylib.read_ply_table(path)
        rest_names = sorted((k for k in t if k.startswith("f_rest_")),
                            key=lambda s: int(s.split("_")[-1]))
        assert len(rest_names) == 3 * (max_sh_degrees + 1) ** 2 - 3, \
            f"unexpected SH layout in {path}"
        features = np.zeros((n, len(rest_names) + 3), np.float32)
        features[:, 0] = t["f_dc_0"]
        features[:, 1] = t["f_dc_1"]
        features[:, 2] = t["f_dc_2"]
        for idx, name in enumerate(rest_names):
            features[:, idx] = t[name]

        scale_names = sorted((k for k in t if k.startswith("scale_")),
                             key=lambda s: int(s.split("_")[-1]))
        scales = np.stack([t[k] for k in scale_names], -1).astype(np.float32)
        if scales.shape[1] == 1:
            scales = np.repeat(scales, 3, axis=1)   # isotropic
        rot_names = sorted((k for k in t if k.startswith("rot")),
                           key=lambda s: int(s.split("_")[-1]))
        rots = np.stack([t[k] for k in rot_names], -1).astype(np.float32)
        return {
            "means3D": np.stack([t["x"], t["y"], t["z"]], -1).astype(
                np.float32),
            "sh_colors": features,
            "log_scales": scales[:, :3],
            "unnorm_rotations": rots,
            "logit_opacities": np.asarray(t["opacity"], np.float32)[:, None],
        }

    def save(self, params, path) -> None:
        plylib.save_gaussian_ply(params, path)

    def save_to_splat(self, params, path, center=True, rotate=True) -> None:
        plylib.save_splat(params, path, center=center, rotate=rotate)

    def rotate(self, params, rot_mat) -> dict:
        R = np.asarray(rot_mat, np.float32)
        out = dict(params)
        out["means3D"] = params["means3D"] @ R.T
        quats = params["unnorm_rotations"]
        quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
        out["unnorm_rotations"] = _quat_mult(_rot_to_quat(R)[None], quats)
        return out

    def translate(self, params, translation) -> dict:
        out = dict(params)
        out["means3D"] = params["means3D"] + np.asarray(translation, np.float32)
        return out

    def scale(self, params, scale) -> dict:
        s = np.asarray(scale, np.float32)
        out = dict(params)
        out["means3D"] = params["means3D"] * s
        out["log_scales"] = np.log(np.exp(params["log_scales"]) * s)
        return out

    def crop(self, params, bbox, invert: bool = False) -> dict:
        pts = params["means3D"]
        bbox = np.asarray(bbox, np.float64)
        mask = np.ones(len(pts), bool)
        for a in range(3):
            mask &= (pts[:, a] >= bbox[a][0]) & (pts[:, a] <= bbox[a][1])
        if invert:
            mask = ~mask
        return self.apply_mask(params, mask)

    def apply_mask(self, params, mask) -> dict:
        return {k: np.asarray(v)[np.asarray(mask)] for k, v in params.items()}

    def merge(self, params_list) -> dict:
        keys = params_list[0].keys()
        return {k: np.concatenate([np.asarray(p[k]) for p in params_list], 0)
                for k in keys}

    def add_axis(self, params, length: float = 0.1) -> dict:
        """Append four opaque axis splats (the origin red, then red, green
        and blue ``length`` along x, y and z), a debug aid."""
        n_rest = params["sh_colors"].shape[1] - 3
        pts = np.array([[0, 0, 0], [length, 0, 0], [0, length, 0],
                        [0, 0, length]], np.float32)
        colors = np.array([[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                          np.float32)
        sh = np.concatenate([(colors - 0.5) / C0,
                             np.zeros((4, n_rest), np.float32)], 1)
        axis = {
            "means3D": pts,
            "sh_colors": sh,
            "log_scales": np.log(np.full((4, 3), 0.01, np.float32)),
            "unnorm_rotations": np.tile(np.array([[1, 0, 0, 0]], np.float32),
                                        (4, 1)),
            "logit_opacities": np.full((4, 1), 12.0, np.float32),  # ~1
        }
        return self.merge([params, axis])


def activate_params(params: dict) -> dict:
    """Raw checkpoint params -> render-ready arrays (exp scales, sigmoid
    opacities, normalized quats, (N,K,3) SH coeffs) as float32 numpy."""
    sh = params["sh_colors"]
    coeffs = plylib.sh_colors_to_coeffs(sh) if sh.ndim == 2 else sh
    quats = np.asarray(params["unnorm_rotations"], np.float32)
    quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    return {
        "means3D": np.asarray(params["means3D"], np.float32),
        "shs": coeffs,
        "scales": np.exp(np.asarray(params["log_scales"], np.float32)),
        "rotations": quats,
        "opacities": 1.0 / (1.0 + np.exp(-np.asarray(params["logit_opacities"],
                                                     np.float32))).reshape(-1, 1),
    }
