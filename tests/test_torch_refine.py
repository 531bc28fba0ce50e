"""The port's refinement tool (experiments/utils/refine_gs.py) and its PLY
I/O (utils/ply.py) against the JAX package's, on the CPU.

Both packages refine the same numpy inputs; the port runs K7's and K8's
plain versions, the JAX package its Pallas kernels in interpret mode.
Adam's first steps move each parameter by about lr * sign(g), so a
parameter whose gradient is ~0 may move in one package and not the other:
the packages are compared on losses, never on parameters after steps.

The JAX tool's pair budget (``max_pairs_factor``) and its test
``test_refine_rejects_saturated_budget`` have no counterpart here: the
port's binning sizes its buffers from the data and drops nothing.
"""

import json

import numpy as np
import pytest
import torch

from real2sim_eval_tpu.utils import ply as jply
from real2sim_eval_tpu_torch.experiments.utils import refine_gs
from real2sim_eval_tpu_torch.renderer import Camera, RasterConfig, rasterize
from real2sim_eval_tpu_torch.utils import ply as tply


def make_raw_params(rng, n=30, sh_k=1):
    """tests/test_refine_gs.py's scene; ``sh_k`` SH coefficients."""
    means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(1.2, 2.5, n)
    return {
        "means3D": means,
        "sh_colors": (rng.normal(size=(n, 3 * sh_k)) * 0.4).astype(
            np.float32),
        "log_scales": np.log(rng.uniform(0.04, 0.12, (n, 3))
                             ).astype(np.float32),
        "unnorm_rotations": np.tile(np.asarray([1, 0, 0, 0], np.float32),
                                    (n, 1)),
        "logit_opacities": rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32),
    }


def make_views(params, h=16, w=256):
    """Targets rendered by the port's dense reference compositor from two
    poses (the second shifted 0.15 m along x)."""
    k = np.asarray([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]],
                   np.float32)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    w2cs[1, 0, 3] = 0.15
    sh = torch.as_tensor(tply.sh_colors_to_coeffs(params["sh_colors"]))
    deg = int(round(np.sqrt(sh.shape[1]))) - 1
    ims = []
    for w2c in w2cs:
        rgb, _ = rasterize(
            Camera(width=w, height=h, fx=40.0, fy=40.0, cx=w / 2, cy=h / 2),
            torch.as_tensor(w2c), torch.as_tensor(params["means3D"]),
            torch.exp(torch.as_tensor(params["log_scales"])),
            torch.as_tensor(params["unnorm_rotations"]),
            torch.sigmoid(torch.as_tensor(params["logit_opacities"])
                          ).reshape(-1), sh, deg,
            config=RasterConfig(backend="reference"), device="cpu")
        ims.append(rgb.permute(1, 2, 0).numpy())
    return np.stack([k, k]), w2cs, np.stack(ims).astype(np.float32)


def perturbed(rng, true, key, sigma=0.3, shift=0.0):
    start = dict(true)
    start[key] = (true[key] + shift + rng.normal(size=true[key].shape)
                  .astype(np.float32) * sigma).astype(np.float32)
    return start


@pytest.mark.parametrize("attrs", [("colors", "opacities"),
                                   ("means", "scales", "rotations")])
def test_losses_match_jax_refine(attrs):
    from real2sim_eval_tpu.experiments.utils.refine_gs import refine as j_ref

    rng = np.random.default_rng(0)
    true = make_raw_params(rng, sh_k=16)
    ks, w2cs, images = make_views(true)
    key = "sh_colors" if "colors" in attrs else "means3D"
    start = perturbed(rng, true, key, sigma=0.3 if "colors" in attrs
                      else 0.03)
    _, h_j = j_ref(start, ks, w2cs, images, attrs=attrs, iters=3,
                   log_every=1, interpret=True)
    _, h_t = refine_gs.refine(start, ks, w2cs, images, attrs=attrs, iters=3,
                              log_every=1, device="cpu")
    assert len(h_t) == len(h_j) == 3
    np.testing.assert_allclose(h_t[0], h_j[0], rtol=1e-5)
    np.testing.assert_allclose(h_t, h_j, rtol=1e-3)
    assert h_t[0] > 1e-4                  # the perturbation shows


def test_refine_recovers_colors():
    rng = np.random.default_rng(1)
    true = make_raw_params(rng)
    ks, w2cs, images = make_views(true)
    start = perturbed(rng, true, "sh_colors")
    refined, hist = refine_gs.refine(start, ks, w2cs, images,
                                     attrs=("colors",), iters=40, lr=2e-2,
                                     log_every=39, device="cpu")
    assert hist[-1] < 0.25 * hist[0], hist
    np.testing.assert_array_equal(refined["means3D"], true["means3D"])


def test_refine_cli_roundtrip(tmp_path, capsys):
    rng = np.random.default_rng(2)
    true = make_raw_params(rng)
    ks, w2cs, images = make_views(true)
    start = dict(true)
    start["logit_opacities"] = true["logit_opacities"] - 1.0
    tply.save_gaussian_ply(start, tmp_path / "start.ply")
    np.savez(tmp_path / "views.npz", k=ks, w2c=w2cs, images=images)
    refine_gs.main(["--ply", str(tmp_path / "start.ply"),
                    "--views", str(tmp_path / "views.npz"),
                    "--out", str(tmp_path / "refined.ply"),
                    "--attrs", "opacities", "--iters", "30", "--lr", "5e-2",
                    "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["loss_last"] < summary["loss_first"]
    out = tply.load_gaussian_ply(tmp_path / "refined.ply")
    err0 = np.abs(start["logit_opacities"] - true["logit_opacities"]).mean()
    err1 = np.abs(out["logit_opacities"] - true["logit_opacities"]).mean()
    assert err1 < 0.6 * err0, (err0, err1)
    np.testing.assert_array_equal(out["means3D"], start["means3D"])


def test_sh_colors_layout_matches_jax():
    rng = np.random.default_rng(3)
    sh = rng.normal(size=(7, 48)).astype(np.float32)
    coeffs = tply.sh_colors_to_coeffs(sh)
    np.testing.assert_array_equal(coeffs, jply.sh_colors_to_coeffs(sh))
    np.testing.assert_array_equal(tply.coeffs_to_sh_colors(coeffs), sh)
    np.testing.assert_array_equal(
        refine_gs.sh_colors_to_coeffs(torch.as_tensor(sh)).numpy(), coeffs)


@pytest.mark.parametrize("coeff_layout", [False, True])
def test_ply_bytes_match_jax(tmp_path, coeff_layout):
    """The port writes the JAX package's bytes, and each loads the other's
    file to the same arrays."""
    rng = np.random.default_rng(4)
    params = make_raw_params(rng, n=25, sh_k=16)
    if coeff_layout:         # (N, K, 3) coefficients are accepted too
        params["sh_colors"] = tply.sh_colors_to_coeffs(params["sh_colors"])
    tply.save_gaussian_ply(params, tmp_path / "port.ply")
    jply.save_gaussian_ply(params, tmp_path / "jax.ply")
    assert ((tmp_path / "port.ply").read_bytes()
            == (tmp_path / "jax.ply").read_bytes())
    got = tply.load_gaussian_ply(tmp_path / "jax.ply")
    want = jply.load_gaussian_ply(tmp_path / "jax.ply")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    table, n = tply.read_ply_table(tmp_path / "jax.ply")
    assert n == 25 and len(table) == 3 + 48 + 1 + 3 + 4


def test_ply_reader_ascii_and_skipped_elements(tmp_path):
    path = tmp_path / "ascii.ply"
    path.write_text("ply\nformat ascii 1.0\ncomment made by hand\n"
                    "element camera 1\nproperty float fx\n"
                    "element vertex 2\nproperty float x\nproperty float y\n"
                    "property float z\nend_header\n7.0\n1 2 3\n4 5 6\n")
    got = tply.read_ply_vertex_table(path)
    want = jply.read_ply_vertex_table(path)
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["z"], [3.0, 6.0])
    (tmp_path / "bad.ply").write_bytes(b"not a ply\n")
    with pytest.raises(ValueError):
        tply.read_ply_vertex_table(tmp_path / "bad.ply")
