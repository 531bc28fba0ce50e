"""The fine compositors' quadrant cull on the CPU: each warp of K4 and K5
(csrc/fine_composite.cu, csrc/fine_sparse.cu) owns a 4x8 quadrant of its
8x16 fine tile and blends only the pairs that ``block_keep`` keeps for the
quadrant (``tile_kernel.block_cull_keep`` at 4x8 is the same test in
PyTorch), its CTAs taking the fine tiles longest first
(``tile_kernel.longest_first``). The cull may drop only pairs that change
no pixel of the quadrant, so the kernels' frames stay bitwise those of
their plain versions; the walk's PyTorch mirror here is held bitwise to
them and to the JAX package's fine kernels (interpret mode, as its own
tests run them) at the compositor tolerances. A cull margin of -0.05 makes
the bitwise checks fail.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from real2sim_eval_tpu.renderer import incremental_fine as jincf
from real2sim_eval_tpu.renderer import raster as jraster
from real2sim_eval_tpu.renderer.binning_fine import \
    bin_gaussians_fine as j_bin_fine
from real2sim_eval_tpu.renderer.camera import Camera as JCamera
from real2sim_eval_tpu.renderer.camera import setup_camera as j_setup
from real2sim_eval_tpu.renderer.fine_kernel import pack_attr_major
from real2sim_eval_tpu.renderer.fine_kernel import \
    rasterize_fine_batch as j_fine_batch
from real2sim_eval_tpu.renderer.preprocess import \
    preprocess_gaussians as j_pre
from real2sim_eval_tpu_torch.renderer import fine_kernel as fk
from real2sim_eval_tpu_torch.renderer import incremental_fine as tincf
from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
from real2sim_eval_tpu_torch.renderer.camera import setup_camera as t_setup

QH, QW = fk.QUAD_H, fk.QUAD_W
QUADS = [(qx, qy) for qy in range(fk.FINE_H // QH)
         for qx in range(tk.FINE_W // QW)]
NSX, NSY = 2, 8                       # a 256x64 frame of fine tiles
N_FX = NSX * tk.GROUPS
BG = (0.1, 0.2, 0.3)
# the JAX suite's fine exactness config (tests/test_incremental_fine.py CFG)
JCFG = jraster.RasterConfig(backend="pallas", kernel="fine", interpret=True,
                            fine_pairs_factor=40.0, fine_small_tiles=6,
                            fine_max_tiles=128, max_large=4096,
                            pack_payloads=False)


def npy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def reaches(attrs, px, py):
    """power <= 0 and alpha >= ALPHA_MIN, as ``_blend_tiles_plain``
    computes them, of the pairs ``attrs`` (10, ...) at pixels (px, py)."""
    dx = attrs[0] - px
    dy = attrs[1] - py
    power = (-0.5 * (attrs[2] * dx * dx + attrs[4] * dy * dy)
             - attrs[3] * dx * dy)
    alpha = torch.minimum(torch.full_like(power, tk.ALPHA_MAX),
                          attrs[5] * torch.exp(power))
    return (power <= 0.0) & (alpha >= tk.ALPHA_MIN)


def quad_pixels(bx0: float, by0: float):
    """(px, py), each (4, 8) f32, of the quadrant whose first pixel is
    (bx0, by0)."""
    px = bx0 + torch.arange(QW, dtype=torch.float32)[None, :]
    py = by0 + torch.arange(QH, dtype=torch.float32)[:, None]
    return px.expand(QH, -1), py.expand(-1, QW)


def quad_keep(pairs, idx, tile: int, q, n_fx: int = N_FX):
    """block_cull_keep of the pairs pairs[:, idx] for quadrant q = (qx, qy)
    of fine tile ``tile`` of a grid n_fx fine tiles wide; returns (keep,
    bx0, by0)."""
    tx, ty = tile % n_fx, tile // n_fx
    bx0 = float(tx * tk.FINE_W + q[0] * QW)
    by0 = float(ty * fk.FINE_H + q[1] * QH)
    keep = tk.block_cull_keep(pairs[:, idx], torch.tensor(bx0),
                              torch.tensor(by0), QW, QH)
    return keep, bx0, by0


def quad_walk(pairs, inst_ids, tile_ids, starts, ends, rgb_cache,
              depth_cache, n_sup_x, n_sup_y, bg=(0.0, 0.0, 0.0)):
    """The walk of K5's warps (and K4's, given every fine tile) in plain
    PyTorch, with K5's arguments: the entries taken longest first, each
    4x8 quadrant of an entry's fine tile blending only the pairs of its
    range that ``block_cull_keep`` keeps for the quadrant, in order,
    through K5's plain version; each quadrant's pixels then come from its
    own walk. Returns (frames, kept (quadrant, pair) count)."""
    order = tk.longest_first(starts, ends).long()
    frames, n_kept = None, 0
    for q in QUADS:
        rows, off, q_st, q_en = [], 0, [], []
        for k in order.tolist():
            idx = torch.arange(int(starts[k]), int(ends[k]))
            keep, _, _ = quad_keep(pairs, idx, int(tile_ids[k]), q,
                                   n_sup_x * tk.GROUPS)
            rows.append(idx[keep])
            q_st.append(off)
            off += int(keep.sum())
            q_en.append(off)
        n_kept += off
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        kept = pairs[:, torch.cat(rows)] if rows else pairs[:, :0]
        rgb, dep = fk.composite_fine_sparse_plain(
            kept, inst_ids[order], tile_ids[order], i32(q_st), i32(q_en),
            rgb_cache, depth_cache, n_sup_x, n_sup_y, bg)
        if frames is None:
            frames = (rgb.clone(), dep.clone())
        h, w = dep.shape[-2:]
        mine = (((torch.arange(h) % fk.FINE_H) // QH == q[1])[:, None]
                & ((torch.arange(w) % tk.FINE_W) // QW == q[0])[None, :])
        frames[0][:, :, mine] = rgb[:, :, mine]
        frames[1][:, mine] = dep[:, mine]
    return frames, n_kept


def quad_walk_all(pairs, fine_starts, fine_ends, n_sup_x, n_sup_y,
                  bg=(0.0, 0.0, 0.0)):
    """K4's walk: ``quad_walk`` over every (instance, fine tile)."""
    n_inst, n_fine = fine_starts.shape
    g = torch.arange(n_inst * n_fine, dtype=torch.int32)
    cache = torch.zeros((n_inst, 3, n_sup_y * tk.TILE_H, n_sup_x * tk.TILE_W))
    return quad_walk(pairs, g // n_fine, g % n_fine, fine_starts.reshape(-1),
                     fine_ends.reshape(-1), cache, cache[:, 0], n_sup_x,
                     n_sup_y, bg)


def fine_pre(seed: int, n: int = 300) -> dict:
    """A random scene through the JAX preprocess on a 256x64 camera
    (numpy arrays), a few large opaque splats among them so that some
    pixels saturate."""
    rng = np.random.default_rng(seed)
    cam = JCamera(width=256, height=64, fx=80.0, fy=80.0, cx=128.0, cy=32.0,
                  z_threshold=0.05)
    q = rng.normal(size=(n, 4))
    scales = rng.uniform(0.01, 0.08, (n, 3))
    scales[:20] = rng.uniform(0.08, 0.15, (20, 3))
    opac = rng.uniform(0.1, 1.0, n)
    opac[:20] = 1.0
    args = [np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(0.5, 3.0, n)], -1), scales,
            q / np.linalg.norm(q, axis=-1, keepdims=True), opac,
            rng.uniform(-0.5, 0.5, (n, 1, 3))]
    return {k: np.asarray(v) for k, v in j_pre(
        cam, jnp.eye(4), *[jnp.asarray(a.astype(np.float32)) for a in args],
        0).items()}


def fine_tables(seeds):
    """One instance per seed, fine-binned by JAX with budgets that drop
    nothing: (JAX's packed data, the port's (10, P) pairs, starts, ends
    (I, n_fine) i32)."""
    datas, lanes, starts, ends, off = [], [], [], [], 0
    for seed in seeds:
        pre = fine_pre(seed)
        b = j_bin_fine({k: jnp.asarray(v) for k, v in pre.items()}, NSX, NSY,
                       max_pairs=32768, small_tiles=6,
                       max_tiles_per_gaussian=128,
                       max_large=pre["xy"].shape[0], pack_payloads=False)
        assert int(b["n_large_dropped"]) == 0
        datas.append(pack_attr_major(b["pair_lanes"]))
        starts.append(np.asarray(b["fine_starts"]) + off)
        ends.append(np.asarray(b["fine_ends"]) + off)
        lanes.append(np.stack([np.asarray(v) for v in b["pair_lanes"]]))
        off += lanes[-1].shape[1]
    return (jnp.concatenate(datas), torch.as_tensor(np.concatenate(lanes, 1)),
            torch.as_tensor(np.stack(starts), dtype=torch.int32),
            torch.as_tensor(np.stack(ends), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the quadrant test
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_quadrant_cull_drops_no_reaching_pair(seed):
    """Every (quadrant, pair) of the small scene's fine pair table that the
    cull drops has power > 0 or alpha < ALPHA_MIN at every pixel of the
    quadrant; the cull drops something."""
    _, pairs, starts, ends = fine_tables([seed])
    dropped = tested = 0
    for t in range(starts.shape[1]):
        idx = torch.arange(int(starts[0, t]), int(ends[0, t]))
        for q in QUADS:
            keep, bx0, by0 = quad_keep(pairs, idx, t, q)
            tested += keep.numel()
            gone = idx[~keep]
            px, py = quad_pixels(bx0, by0)
            hit = reaches(pairs[:, gone][:, :, None, None], px, py)
            assert not bool(hit.any()), (t, q, gone[hit.flatten(1).any(1)])
            dropped += gone.numel()
    assert tested > 0 and 0 < dropped < tested


def thin_conic(s_long: float, s_short: float, theta: float):
    """f32 conic (a, b, c) of a 2D gaussian with standard deviations
    (s_long, s_short) px rotated by theta, dilated by 0.3 px^2 as the
    preprocess dilates."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    cov = R @ np.diag([s_long ** 2, s_short ** 2]) @ R.T + 0.3 * np.eye(2)
    inv = np.linalg.inv(cov)
    return np.float32(inv[0, 0]), np.float32(inv[0, 1]), np.float32(inv[1, 1])


@settings(max_examples=300, deadline=None, derandomize=True)
@given(s_long=st.floats(2.0, 60.0), s_short=st.floats(0.0, 1.0),
       theta=st.floats(0.0, float(np.pi)),
       op=st.one_of(st.floats(1.0 / 255.0, 1.0001 / 255.0),
                    st.floats(1.0 / 255.0, 1.0)),
       side=st.sampled_from(("left", "right", "top", "bottom")),
       out=st.floats(0.0, 40.0), along=st.floats(-8.0, 16.0),
       scale=st.sampled_from((1.0, 64.0, 4096.0)))
def test_adversarial_splats(s_long, s_short, theta, op, side, out, along,
                            scale):
    """Thin, rotated splats of opacity just above 1/255, centred just
    outside an edge of the quadrant at (520, 260) (a frame offset, so the
    pixel offsets round as far from the origin): wherever the cull drops
    one, no pixel of the quadrant passes power <= 0 and the alpha floor.
    ``scale`` sharpens the conic as a far splat's would be."""
    bx0, by0 = 520.0, 260.0
    ca, cb, cc = (np.float32(v * scale) for v in thin_conic(
        s_long, s_short, theta))
    gx = {"left": bx0 - out,
          "right": bx0 + QW - 1 + out}.get(side, bx0 + along)
    gy = {"top": by0 - out,
          "bottom": by0 + QH - 1 + out}.get(side, by0 + along)
    attrs = torch.tensor([gx, gy, ca, cb, cc, op, 0.5, 0.5, 0.5, 1.0],
                         dtype=torch.float32)
    keep = tk.block_cull_keep(attrs, torch.tensor(bx0), torch.tensor(by0),
                              QW, QH)
    if not bool(keep):
        px, py = quad_pixels(bx0, by0)
        assert not bool(reaches(attrs[:, None, None], px, py).any())


def test_dense_random_splats():
    """200,000 random splats around one quadrant, thin and round, faint and
    opaque: the cull drops only splats that reach no pixel, and drops most
    of the far ones."""
    rng = np.random.default_rng(4)
    n = 200_000
    cov_long = rng.uniform(0.0, 40.0, n) ** 2
    cov_short = rng.uniform(0.0, 2.0, n) ** 2
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    a = c * c * cov_long + s * s * cov_short + 0.3
    b = c * s * (cov_long - cov_short)
    d = s * s * cov_long + c * c * cov_short + 0.3
    det = a * d - b * b
    bx0, by0 = 136.0, 68.0
    op = np.where(rng.random(n) < 0.5, rng.uniform(1 / 255, 1.001 / 255, n),
                  rng.uniform(1 / 255, 1.0, n))
    attrs = torch.tensor(np.stack([
        bx0 + rng.uniform(-60, 68, n), by0 + rng.uniform(-60, 64, n),
        d / det, -b / det, a / det, op, np.zeros(n), np.zeros(n),
        np.zeros(n), np.ones(n)]), dtype=torch.float32)
    keep = tk.block_cull_keep(attrs, torch.tensor(bx0), torch.tensor(by0),
                              QW, QH)
    px, py = quad_pixels(bx0, by0)
    gone = attrs[:, ~keep]
    hit = reaches(gone[:, :, None, None], px, py).flatten(1).any(1)
    assert not bool(hit.any()), gone[:, hit][:, :5].T
    assert int((~keep).sum()) > n // 2


# ---------------------------------------------------------------------------
# the walks of K4 and K5
# ---------------------------------------------------------------------------


def test_longest_first_is_a_stable_descending_order():
    starts = torch.tensor([[0, 5, 5, 9]], dtype=torch.int32)
    ends = torch.tensor([[5, 5, 9, 14]], dtype=torch.int32)
    order = tk.longest_first(starts, ends)
    assert order.dtype == torch.int32
    assert order.tolist() == [0, 3, 2, 1]


@pytest.mark.parametrize("margin", ["exact", "too_much"])
def test_quadrant_walk_is_bitwise_k4(margin, monkeypatch):
    """K4's walk (``quad_walk_all``) on two instances of the small scene is
    bitwise K4's plain version, and within the render tests' tolerance of
    the JAX fine kernel in interpret mode on the same lanes and ranges;
    the cull keeps fewer (quadrant, pair)s than the quadrants' ranges
    hold. With a cull margin of -0.05 the walk is not bitwise. Tolerances:
    the compositor's, 2e-3 rgb and 1e-3 depth (tests/test_raster.py)."""
    data, pairs, starts, ends = fine_tables([2, 3])
    if margin == "too_much":
        monkeypatch.setattr(tk, "CULL_ABS", -0.05)
    (rgb_w, dep_w), n_kept = quad_walk_all(pairs, starts, ends, NSX, NSY, BG)
    rgb_p, dep_p = fk.composite_fine_plain(pairs, starts, ends, NSX, NSY, BG)
    assert n_kept < len(QUADS) * pairs.shape[1]
    bitwise = torch.equal(rgb_w, rgb_p) and torch.equal(dep_w, dep_p)
    assert bitwise == (margin == "exact")
    if margin == "too_much":
        return
    rgb_j, dep_j = j_fine_batch(data, jnp.asarray(starts.numpy()),
                                jnp.asarray(ends.numpy()), NSX, NSY, BG,
                                interpret=True)
    np.testing.assert_allclose(npy(rgb_w), np.asarray(rgb_j), atol=2e-3)
    assert float(np.abs(npy(dep_w) - np.asarray(dep_j)).max()) <= 1e-3


def gaussians(rng, n, center, spread, scale=0.02):
    means = (center + rng.normal(scale=spread, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return {
        "means3D": means,
        "scales": np.full((n, 3), scale, np.float32),
        "rotations": quats,
        "opacities": rng.uniform(0.3, 0.9, (n, 1)).astype(np.float32),
        "shs": rng.normal(scale=0.3, size=(n, 1, 3)).astype(np.float32),
    }


def incremental_scene():
    """tests/test_incremental_fine.py's scene (400 static gaussians, 40
    dynamic ones in 3 envs, shifted per env) and its 128x64 camera."""
    rng = np.random.default_rng(7)
    static = gaussians(rng, 400, np.array([0.0, 0.0, 0.3]), 0.45)
    one = gaussians(rng, 40, np.array([0.05, 0.0, 0.1]), 0.05)
    dyn = {k: np.stack([v] * 3) for k, v in one.items()}
    dyn["means3D"] = dyn["means3D"] + np.float32(
        [[0.0, 0.0, 0.0], [-0.15, 0.2, 0.0], [0.12, -0.25, 0.05]])[:, None]
    k = np.array([[160.0, 0, 64.0], [0, 160.0, 32.0], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -1.2]
    return static, dyn, k, np.linalg.inv(c2w)


@pytest.mark.parametrize("margin", ["exact", "too_much"])
def test_quadrant_walk_is_bitwise_k5(margin, monkeypatch):
    """K5's walk (``quad_walk`` over the step's dirty fine tiles) in the
    port's fine incremental render: bitwise K5's plain version on the same
    inputs, the frames it gives bitwise the plain render's and within the
    render tests' tolerance of the JAX package's fine incremental render
    (its fine kernels in interpret mode). With a cull margin of -0.05 the
    walk is not bitwise."""
    static, dyn, k, w2c = incremental_scene()
    cam, tw2c = t_setup(128, 64, k, w2c)
    tw2c = torch.as_tensor(np.asarray(tw2c, np.float32))
    st_t = tincf.build_static_raster_fine(
        cam, tw2c, {key: torch.as_tensor(v) for key, v in static.items()}, 0)
    cams = [(cam, st_t, tw2c)]
    dyn_t = {key: torch.as_tensor(v) for key, v in dyn.items()}
    if margin == "too_much":
        monkeypatch.setattr(tk, "CULL_ABS", -0.05)
    seen = {}

    def walked(*args):
        seen["args"] = args
        out, seen["kept"] = quad_walk(*args)
        return out

    plain = tincf.rasterize_fine_sparse
    monkeypatch.setattr(tincf, "rasterize_fine_sparse", walked)
    rgb_w, dep_w, _ = tincf.render_incremental_fine(cams, dyn_t, 0)
    monkeypatch.setattr(tincf, "rasterize_fine_sparse", plain)
    rgb_p, dep_p, _ = tincf.render_incremental_fine(cams, dyn_t, 0)
    args = seen["args"]
    rows = int((args[4] - args[3]).sum())
    assert 0 < int(args[1].numel()) < 3 * 8 * 8
    assert seen["kept"] < len(QUADS) * rows       # the cull cuts
    frames_w = quad_walk(*args)[0]
    frames_p = fk.composite_fine_sparse_plain(*args)
    bitwise = (torch.equal(frames_w[0], frames_p[0])
               and torch.equal(frames_w[1], frames_p[1])
               and torch.equal(rgb_w, rgb_p) and torch.equal(dep_w, dep_p))
    assert bitwise == (margin == "exact")
    if margin == "too_much":
        return
    jcam, jw2c = j_setup(128, 64, k, w2c)
    js = jincf.build_static_raster_fine(
        jcam, jw2c, {key: jnp.asarray(v) for key, v in static.items()}, 0,
        JCFG)
    rgb_j, dep_j, _ = jincf.render_incremental_fine(
        [(jcam, js, jw2c)], {key: jnp.asarray(v) for key, v in dyn.items()},
        0, JCFG, t_budget=32, p_mix=8192)
    np.testing.assert_allclose(npy(rgb_w), np.asarray(rgb_j), atol=2e-3)
    assert float(np.abs(npy(dep_w) - np.asarray(dep_j)).max()) <= 1e-3
