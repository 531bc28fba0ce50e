"""The port's differentiable render (renderer/diff.py: K7 forward, K8
backward) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port runs K7's and K8's plain versions (tensors on the CPU); the JAX
package's ``rasterize_diff`` runs its Pallas kernels in interpret mode, as
its own tests do (tests/test_diff.py), and ``jax.grad`` of its dense
compositor (``raster._composite_reference``, plain jnp) is the independent
ground truth for gradients. Gradient tolerances are the JAX suite's:
rtol 2e-3 and atol 1e-4 * max(|g|, 1); the suffix identity divides by
1 - alpha (up to 100x), so f32 cancellation is real and only relative
tolerances hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.renderer.camera import Camera as JCam
from real2sim_eval_tpu.renderer.diff import rasterize_diff as j_diff
from real2sim_eval_tpu.renderer.preprocess import \
    preprocess_gaussians as j_pre
from real2sim_eval_tpu.renderer.raster import RasterConfig as JRC
from real2sim_eval_tpu.renderer.raster import TILE_W, _composite_reference
from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
from real2sim_eval_tpu_torch.renderer.binning import bin_gaussians
from real2sim_eval_tpu_torch.renderer.camera import Camera as TCam
from real2sim_eval_tpu_torch.renderer.diff import (rasterize_diff,
                                                   rasterize_diff_views)
from real2sim_eval_tpu_torch.renderer.preprocess import preprocess_gaussians

J_CFG = JRC(interpret=True)
NAMES = ("means3d", "scales", "quats", "opacities", "shs")
BG = (0.05, 0.0, 0.1)


def cams(w=256, h=16, f=40.0):
    kw = dict(width=w, height=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
              z_threshold=0.05)
    return JCam(**kw), TCam(**kw)


def make_scene(rng, n=60, opac_range=(0.2, 0.9), sh_k=1):
    """tests/test_diff.py's scene, in numpy; ``sh_k`` SH coefficients."""
    means = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(1.0, 3.0, n)
    scales = rng.uniform(0.02, 0.10, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(*opac_range, n).astype(np.float32)
    shs = (rng.normal(size=(n, sh_k, 3)) * 0.3).astype(np.float32)
    return means, scales, quats, opac, shs


def crossing_scene():
    """One opaque splat in front of another (tests/test_diff.py:148)."""
    return (np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 2.0]], np.float32),
            np.full((2, 3), 0.08, np.float32),
            np.asarray([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32),
            np.asarray([0.95, 0.95], np.float32),
            np.zeros((2, 1, 3), np.float32))


def loss_weights(rng, h=16, w=256):
    return (rng.normal(size=(3, h, w)).astype(np.float32),
            rng.normal(size=(h, w)).astype(np.float32))


def sh_degree(shs):
    return int(round(np.sqrt(shs.shape[1]))) - 1


def port_grads(cam, w2c, scene, wr, wd, bg=BG, depth_weight=0.1):
    ts = [torch.tensor(a, requires_grad=True) for a in scene]
    rgb, dep = rasterize_diff(cam, torch.as_tensor(w2c), *ts,
                              sh_degree(scene[4]), bg=bg, device="cpu")
    loss = (rgb * torch.as_tensor(wr)).sum() + depth_weight * (
        dep * torch.as_tensor(wd)).sum()
    loss.backward()
    return [t.grad.numpy() for t in ts]


def jax_dense_render(cam, w2c, means, scales, quats, opac, shs, bg, deg):
    pre = j_pre(cam, w2c, means, scales, quats, opac, shs, deg)
    return _composite_reference(cam, pre, jnp.asarray(bg, jnp.float32),
                                bin_w=TILE_W)


def jax_grads(render, scene, wr, wd, depth_weight=0.1):
    def loss(*args):
        rgb, dep = render(*args)
        return jnp.sum(rgb * wr) + depth_weight * jnp.sum(dep * wd)

    g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in scene])
    return [np.asarray(v) for v in g]


def assert_grads_close(got, want, rtol=2e-3, atol=None):
    for name, a, b in zip(NAMES, got, want):
        tol = atol if atol is not None else 1e-4 * max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=tol,
                                   err_msg=f"grad mismatch: {name}")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def test_forward_matches_jax_rasterize_diff():
    rng = np.random.default_rng(0)
    jc, tc = cams()
    scene = make_scene(rng)
    bg = (0.1, 0.2, 0.3)
    rgb_j, dep_j = j_diff(jc, jnp.eye(4), *[jnp.asarray(a) for a in scene],
                          0, bg=bg, config=J_CFG)
    rgb_t, dep_t, drops = rasterize_diff(
        tc, torch.eye(4), *[torch.as_tensor(a) for a in scene], 0, bg=bg,
        return_drops=True, device="cpu")
    assert int(drops) == 0
    # the port's render tolerances (tests/test_torch_render.py)
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j),
                               atol=2e-3)
    flips = int((np.abs(dep_t.detach().numpy() - np.asarray(dep_j))
                 > 1e-2).sum())
    assert flips <= 5, flips


def test_transmittance_is_its_plain_definition():
    """K7's T is d(rgb)/d(bg): the frames at bg = 1 minus those at bg = 0;
    its rgb and depth are K1's (the plain versions) bitwise."""
    rng = np.random.default_rng(1)
    _, tc = cams(256, 32, 60.0)
    scene = [torch.as_tensor(a) for a in make_scene(rng, n=50)]
    pre = preprocess_gaussians(tc, torch.eye(4)[None],
                               *[s[None] for s in scene], 0)
    bins = bin_gaussians(pre, 2, 4, 128, 8)
    args = (bins["pair_attrs"], bins["tile_starts"], bins["tile_ends"], 2, 4)
    rgb0, dep0, t0 = tk.rasterize_tiles_batch_t(*args, (0.0, 0.0, 0.0))
    rgb1, _, t1 = tk.rasterize_tiles_batch_t(*args, (1.0, 1.0, 1.0))
    np.testing.assert_array_equal(t0.numpy(), t1.numpy())
    for c in range(3):
        np.testing.assert_allclose((rgb1[:, c] - rgb0[:, c]).numpy(),
                                   t0.numpy(), atol=1e-6)
    assert float(t0.min()) < 0.5 and float(t0.max()) == 1.0
    rgb_k1, dep_k1 = tk.rasterize_tiles_batch(*args, (0.0, 0.0, 0.0))
    np.testing.assert_array_equal(rgb0.numpy(), rgb_k1.numpy())
    np.testing.assert_array_equal(dep0.numpy(), dep_k1.numpy())


def make_w2cs():
    w2cs = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    w2cs[1, 0, 3] = 0.2
    w2cs[2, 1, 3] = -0.1
    return w2cs


def test_views_forward_matches_per_view():
    rng = np.random.default_rng(2)
    _, tc = cams()
    scene = [torch.as_tensor(a) for a in make_scene(rng, sh_k=16)]
    w2cs = make_w2cs()
    rgb_b, dep_b, drops = rasterize_diff_views(tc, w2cs, *scene, 3,
                                               bg=(0.1, 0.0, 0.2),
                                               return_drops=True,
                                               device="cpu")
    assert tuple(drops.shape) == (3,) and int(drops.sum()) == 0
    for i in range(3):
        rgb_i, dep_i = rasterize_diff(tc, w2cs[i], *scene, 3,
                                      bg=(0.1, 0.0, 0.2), device="cpu")
        np.testing.assert_allclose(rgb_b[i].detach().numpy(),
                                   rgb_i.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(dep_b[i].detach().numpy(),
                                   dep_i.detach().numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def test_grads_match_jax_rasterize_diff():
    """Against jax.grad of the JAX package's own differentiable render (its
    Pallas backward in interpret mode), at tests/test_diff.py's fast size."""
    rng = np.random.default_rng(3)
    jc, tc = cams()
    scene = make_scene(rng, n=10)
    wr, wd = loss_weights(rng)
    got = port_grads(tc, np.eye(4, dtype=np.float32), scene, wr, wd)
    want = jax_grads(lambda *a: j_diff(jc, jnp.eye(4), *a, 0, bg=BG,
                                       config=J_CFG), scene, wr, wd)
    assert_grads_close(got, want)


@pytest.mark.parametrize("case", ["random", "opaque", "degree3"])
def test_grads_match_jax_dense(case):
    """Against jax.grad of the JAX dense compositor: a random scene, the
    opaque one that drives pixels through the T < 1e-4 freeze and the 0.99
    clamp, and a degree-3 SH scene, whose colour gradient runs through the
    view direction from the camera centre (off-axis camera)."""
    rng = np.random.default_rng({"random": 4, "opaque": 5, "degree3": 6}[case])
    jc, tc = cams()
    scene = {"random": lambda: make_scene(rng, n=60),
             "opaque": lambda: make_scene(rng, n=80,
                                          opac_range=(0.95, 1.0)),
             "degree3": lambda: make_scene(rng, n=40, sh_k=16)}[case]()
    deg = sh_degree(scene[4])
    w2c = np.eye(4, dtype=np.float32)
    if deg:
        c, s = np.cos(0.2), np.sin(0.2)
        w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        w2c[:3, 3] = [0.3, -0.1, 0.2]
    wr, wd = loss_weights(rng)
    got = port_grads(tc, w2c, scene, wr, wd)
    want = jax_grads(lambda *a: jax_dense_render(jc, jnp.asarray(w2c), *a,
                                                 BG, deg), scene, wr, wd)
    assert_grads_close(got, want)
    if deg:         # the higher bands take gradient
        assert np.abs(got[4][:, 1:]).max() > 1e-3


def test_depth_grad_selects_crossing_pair():
    """The median depth's cotangent lands only on the pair crossing T = 0.5
    (tests/test_diff.py:148): port vs jax.grad of the dense compositor."""
    jc, tc = cams()
    scene = crossing_scene()
    wr = np.zeros((3, 16, 256), np.float32)
    wd = np.ones((16, 256), np.float32)
    got = port_grads(tc, np.eye(4, dtype=np.float32), scene, wr, wd,
                     bg=(0.0, 0.0, 0.0), depth_weight=1.0)
    want = jax_grads(lambda *a: jax_dense_render(jc, jnp.eye(4), *a,
                                                 (0.0, 0.0, 0.0), 0),
                     scene, wr, wd, depth_weight=1.0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    assert abs(got[0][0, 2]) > abs(got[0][1, 2])
    assert abs(got[0][0, 2]) > 1.0


def test_finite_difference_opacity():
    rng = np.random.default_rng(7)
    _, tc = cams()
    scene = [torch.as_tensor(a) for a in make_scene(rng, n=20)]
    wr = torch.as_tensor(loss_weights(rng)[0])

    def loss(opac):
        rgb, _ = rasterize_diff(tc, torch.eye(4), scene[0], scene[1],
                                scene[2], opac, scene[4], 0, device="cpu")
        return (rgb * wr).sum()

    opac = scene[3].clone().requires_grad_(True)
    loss(opac).backward()
    eps = 1e-3
    for i in (0, 7, 13):
        d = torch.zeros_like(scene[3])
        d[i] = eps
        with torch.no_grad():
            fd = (loss(scene[3] + d) - loss(scene[3] - d)) / (2 * eps)
        np.testing.assert_allclose(float(opac.grad[i]), float(fd),
                                   rtol=5e-2, atol=1e-3)


def test_views_grads_sum_over_views():
    """tests/test_diff_views.py:38: the one-launch multi-view gradients
    equal the per-view loop's."""
    rng = np.random.default_rng(8)
    _, tc = cams()
    scene = make_scene(rng, n=40)
    w2cs = make_w2cs()
    wr, wd = (torch.as_tensor(a) for a in loss_weights(rng))

    def grads(batched):
        ts = [torch.tensor(a, requires_grad=True) for a in scene]
        if batched:
            rgb, dep = rasterize_diff_views(tc, w2cs, *ts, 0, device="cpu")
            loss = (rgb * wr).sum() + 0.1 * (dep * wd).sum()
        else:
            loss = 0.0
            for w2c in w2cs:
                rgb, dep = rasterize_diff(tc, w2c, *ts, 0, device="cpu")
                loss = loss + (rgb * wr).sum() + 0.1 * (dep * wd).sum()
        loss.backward()
        return [t.grad.numpy() for t in ts]

    for name, a, b in zip(NAMES, grads(True), grads(False)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# K8's plain version
# ---------------------------------------------------------------------------


def k7_inputs(seed, n=60, opac_range=(0.2, 0.9)):
    rng = np.random.default_rng(seed)
    _, tc = cams(256, 32, 60.0)
    scene = [torch.as_tensor(a) for a in make_scene(rng, n, opac_range)]
    w2cs = torch.as_tensor(make_w2cs()[:2])
    pre = preprocess_gaussians(tc, w2cs, *[s[None].expand((2,) + s.shape)
                                           for s in scene], 0)
    bins = bin_gaussians(pre, 2, 4, 128, 8)
    return (bins["pair_attrs"], bins["tile_starts"], bins["tile_ends"],
            rng)


@pytest.mark.parametrize("opaque", [False, True])
def test_backward_plain_is_autograd_of_forward_plain(opaque):
    """K8's per-pair table equals autograd's gradient of K7's plain version
    with respect to the pair table (the same subgradient conventions)."""
    pairs, starts, ends, rng = k7_inputs(9 + opaque, n=80 if opaque else 60,
                                         opac_range=(0.95, 1.0) if opaque
                                         else (0.2, 0.9))
    bg = (0.1, 0.3, 0.2)
    dl_rgb = torch.as_tensor(rng.normal(size=(2, 3, 32, 256)), dtype=torch.float32)
    dl_dep = torch.as_tensor(rng.normal(size=(2, 32, 256)), dtype=torch.float32)
    leaf = pairs.detach().clone().requires_grad_(True)
    rgb, dep, t_fin = tk.composite_tiles_plain(leaf, starts, ends, 2, 4, bg,
                                               with_t=True)
    want, = torch.autograd.grad((rgb * dl_rgb).sum() + (dep * dl_dep).sum(),
                                leaf)
    bg_t = torch.tensor(bg)[None, :, None, None]
    c_fin = (rgb - t_fin[:, None] * bg_t).detach()
    got = tk.composite_backward(pairs.detach(), starts, ends, dl_rgb, dl_dep,
                                c_fin, t_fin.detach(), bg)
    assert got.shape == pairs.shape
    for lane in range(10):
        tol = 1e-4 * max(float(want[lane].abs().max()), 1.0)
        np.testing.assert_allclose(got[lane].numpy(), want[lane].numpy(),
                                   rtol=2e-3, atol=tol, err_msg=f"lane {lane}")
    if opaque:      # stacked splats drive pixels to the T < 1e-4 freeze
        assert float(t_fin.detach().min()) < 1e-2


def test_k7_k8_wrappers_reject_bad_inputs():
    pairs = torch.zeros((10, 8))
    s = torch.zeros((1, 4), dtype=torch.int32)
    frame = torch.zeros((1, 16, 256))
    rgbf = torch.zeros((1, 3, 16, 256))
    with pytest.raises(ValueError):
        tk.rasterize_tiles_batch_t(pairs[:9], s, s, 2, 2)
    with pytest.raises(ValueError):
        tk.rasterize_tiles_batch_t(pairs, s, s, 3, 2)
    with pytest.raises(ValueError):
        tk.composite_backward(pairs, s, s, rgbf[:, :2], frame, rgbf, frame)
    with pytest.raises(ValueError):
        tk.composite_backward(pairs, s, s, rgbf, frame.double(), rgbf, frame)
    with pytest.raises(ValueError):
        tk.composite_backward(pairs, s, s, rgbf[..., :128], frame, rgbf,
                              frame)
