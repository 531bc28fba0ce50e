"""The port's scene- and asset-building tools against the JAX package's.

Each case gives both packages the same inputs, made from a seed with
numpy, on the built-in arm (simple_arm.urdf). The numpy and scipy tools
are held bitwise: ICP (tests/test_tools.py's three cases), the colour fit
(its three cases), the colormap, ``sample_surface_poisson`` (with
test_io.py's spread check), the ``.splat`` writers (equal bytes),
``add_axis``, ``connect_springs_grouped``, the robot point clouds and
posed meshes, ``create_rigid_phystwin`` (its checkpoint read back by both
packages' loaders), and construct_scene's sampling, alignment (with and
without the crop) and segmentation, and its ``main`` (equal PLY bytes and
masks). construct_scene's ``GRIPPER_LINKS`` name the xArm's links, which
the built-in arm lacks, so ``main`` runs in both packages with it patched
to the built-in arm's ten collision links (``testing.SCAN_LINKS``). The
re-poses (``articulate_preview``, ``xarm_transforms``) are held within
1e-5 of the JAX ones; the preview's image, at a small camera (``Camera``
patched in both packages' camera modules, ``small_renders``), within
2e-3 rgb and 1e-3 depth of the JAX reference backend
(tests/test_raster.py:162-169). A 2-lane
``BatchedEvaluator`` over a constructed scene holds its robot and static
rows to the JAX evaluator's."""

import sys

import numpy as np
import pytest

from real2sim_eval_tpu_torch import testing as tt

SCAN_T = np.array([[np.cos(0.5), -np.sin(0.5), 0.0, 0.1],
                   [np.sin(0.5), np.cos(0.5), 0.0, -0.2],
                   [0.0, 0.0, 1.0, 0.05],
                   [0.0, 0.0, 0.0, 1.0]])


def rigid(aa, t):
    from real2sim_eval_tpu_torch.utils.transforms_np import axis_angle_to_rot

    T = np.eye(4)
    T[:3, :3] = axis_angle_to_rot(np.asarray(aa, np.float64))
    T[:3, 3] = t
    return T


def both(name):
    """The JAX package's module ``name`` and the port's."""
    import importlib

    return (importlib.import_module(f"real2sim_eval_tpu.{name}"),
            importlib.import_module(f"real2sim_eval_tpu_torch.{name}"))


# ---------------------------------------------------------------------------
# ICP, colour alignment, colormap
# ---------------------------------------------------------------------------


def l_cloud(rng, n=800):
    # an L-shaped slab: asymmetric so registration is well-posed
    a = rng.random((n // 2, 3)) * [0.4, 0.1, 0.05]
    b = rng.random((n // 2, 3)) * [0.1, 0.3, 0.05] + [0.0, 0.1, 0.0]
    return np.concatenate([a, b])


def icp_small(J, T, rng):
    src = l_cloud(rng)
    T_true = rigid([0.0, 0.0, 0.2], [0.03, -0.02, 0.01])
    tgt = src @ T_true[:3, :3].T + T_true[:3, 3]
    out = [m.icp(src, tgt, thresholds=(0.1, 0.02)) for m in (J, T)]
    np.testing.assert_allclose(out[1], T_true, atol=5e-3)
    return out


def icp_large(J, T, rng):
    src = l_cloud(rng)
    T_true = rigid([0.0, 0.0, 2.0], [0.5, 0.3, -0.2])
    tgt = src @ T_true[:3, :3].T + T_true[:3, 3]
    out = []
    for m in (J, T):
        T0 = m.global_registration(src, tgt)
        out += [T0, m.icp(src, tgt, init=T0, thresholds=(0.1, 0.02))]
    assert T.registration_error(src, tgt, out[3], trunc=0.5) < 2e-3
    assert (J.registration_error(src, tgt, out[1], trunc=0.5)
            == T.registration_error(src, tgt, out[3], trunc=0.5))
    return out[::2], out[1::2]


def icp_outliers(J, T, rng):
    src = l_cloud(rng)
    T_true = rigid([0.0, 0.0, 0.1], [0.02, 0.0, 0.0])
    tgt = src @ T_true[:3, :3].T + T_true[:3, 3]
    tgt = np.concatenate([tgt, rng.random((200, 3)) * 2.0])  # clutter
    out = [m.icp(src, tgt, thresholds=(0.05, 0.01)) for m in (J, T)]
    np.testing.assert_allclose(out[1], T_true, atol=2e-2)
    return out


@pytest.mark.parametrize("case", [icp_small, icp_large, icp_outliers],
                         ids=lambda f: f.__name__)
def test_icp_bitwise(rng, case):
    J, T = both("utils.icp")
    out = case(J, T, rng)
    pairs = out if isinstance(out, tuple) else [out]
    for j, t in pairs:
        np.testing.assert_array_equal(t, j)


def color_linear(rng):
    A_true = np.array([[0.9, 0.05, 0.0], [0.0, 0.85, 0.05], [0.0, 0.0, 0.8]])
    sim = rng.random((5000, 3))
    real = sim @ A_true.T + np.array([0.05, 0.02, 0.01])
    return sim, real, dict(quadratic=False), None


def color_quadratic(rng):
    A2 = np.diag([0.2, -0.1, 0.15])
    A1 = np.diag([0.8, 0.9, 0.7])
    sim = rng.random((8000, 3))
    real = sim ** 2 @ A2.T + sim @ A1.T + np.array([0.05, 0.0, 0.03])
    return sim, real, dict(quadratic=True), None


def color_outliers(rng):
    sim = rng.random((5000, 3))
    real = sim @ np.diag([0.9, 0.9, 0.9]).T
    idx = rng.choice(5000, 500, replace=False)
    real[idx] = rng.random((500, 3))
    return sim, real, dict(quadratic=False), np.setdiff1d(np.arange(5000),
                                                          idx)


@pytest.mark.parametrize("case", [color_linear, color_quadratic,
                                  color_outliers], ids=lambda f: f.__name__)
def test_color_alignment_bitwise(rng, case):
    J, T = both("experiments.utils.color_alignment")
    sim, real, kw, clean = case(rng)
    Aj, bj = J.solve_color_transform(sim, real, **kw)
    At, bt = T.solve_color_transform(sim, real, **kw)
    np.testing.assert_array_equal(At, Aj)
    np.testing.assert_array_equal(bt, bj)
    keep = slice(None) if clean is None else clean
    fitted = T.apply_color_transform(sim[keep], At, bt)
    np.testing.assert_array_equal(
        fitted, J.apply_color_transform(sim[keep], Aj, bj))
    assert np.abs(fitted - real[keep]).max() < (0.02 if clean is not None
                                                else 1e-5)
    assert T._yaml_block(At, bt) == J._yaml_block(Aj, bj)


def test_color_alignment_cli_matches_jax(tmp_path, monkeypatch, capsys,
                                         rng):
    """``main`` of both packages on the same PNGs and mask print the same
    fit and YAML block."""
    cv2 = pytest.importorskip("cv2")
    J, T = both("experiments.utils.color_alignment")
    sim = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    real = np.clip(sim * 0.8 + 20, 0, 255).astype(np.uint8)
    mask = (rng.random((24, 32)) > 0.2).astype(np.uint8) * 255
    for name, im in (("sim", sim), ("real", real), ("mask", mask)):
        cv2.imwrite(str(tmp_path / f"{name}.png"), im)
    argv = ["--sim", str(tmp_path / "sim.png"), "--real",
            str(tmp_path / "real.png"), "--mask", str(tmp_path / "mask.png")]
    monkeypatch.setattr(sys, "argv", ["color_alignment"] + argv)
    J.main()
    j_out = capsys.readouterr().out
    T.main(argv)
    assert capsys.readouterr().out == j_out
    assert "color_A: [" in j_out


def test_colormap():
    J, T = both("utils.colormap")
    np.testing.assert_array_equal(T.COLORMAP, J.COLORMAP)
    mask = np.array([-1, 0, 1, 2, 30, -7, 23, 24])
    colors = T.colorize_mask(mask)
    np.testing.assert_array_equal(colors, J.colorize_mask(mask))
    assert colors.shape == (8, 3)
    np.testing.assert_allclose(colors[0], [0.3, 0.3, 0.3])
    for i in (0, 5, 24, 47):
        np.testing.assert_array_equal(T.color_for(i), J.color_for(i))


# ---------------------------------------------------------------------------
# host leftovers: mesh sampling, .splat export, add_axis, topology, robot
# ---------------------------------------------------------------------------


def test_poisson_sampling_bitwise_and_spread(rng):
    J, T = both("utils.mesh")
    seed = int(rng.integers(1 << 30))
    for n in (200, 50):
        pj = J.make_box((1.0, 1.0, 1.0)).sample_surface_poisson(
            n, np.random.default_rng(seed))
        pt = T.make_box((1.0, 1.0, 1.0)).sample_surface_poisson(
            n, np.random.default_rng(seed))
        np.testing.assert_array_equal(pt, pj)
        assert pt.dtype == np.float32
    box = T.make_box((1.0, 1.0, 1.0))
    pts = box.sample_surface_poisson(200, rng)
    assert 50 <= len(pts) <= 200
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 0.01
    sph = T.make_sphere(0.1)
    np.testing.assert_array_equal(sph.sample_surface_poisson(300),
                                  J.make_sphere(0.1).sample_surface_poisson(
                                      300))


def splat_params(rng, n=7, degree=3):
    return {
        "means3D": rng.normal(size=(n, 3)).astype(np.float32),
        "sh_colors": rng.normal(size=(n, 3 * (degree + 1) ** 2)).astype(
            np.float32),
        "log_scales": rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
        - 4.0,
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
    }


@pytest.mark.parametrize("flags", [dict(), dict(center=False),
                                   dict(rotate=False),
                                   dict(center=False, rotate=False)],
                         ids=lambda d: "-".join(d) or "default")
def test_splat_export_bytes_equal_jax(tmp_path, rng, flags):
    (Jp, Tp), (Jg, Tg) = both("utils.ply"), both("utils.gs_processor")
    params = splat_params(rng, n=37)
    Jp.save_splat(params, tmp_path / "j.splat", **flags)
    Tp.save_splat(params, tmp_path / "t.splat", **flags)
    data = (tmp_path / "t.splat").read_bytes()
    assert len(data) == 37 * 32
    assert data == (tmp_path / "j.splat").read_bytes()
    # SH as (N, K, 3) coefficients, through GSProcessor
    coeffs = dict(params, sh_colors=Tp.sh_colors_to_coeffs(
        params["sh_colors"]))
    Jg.GSProcessor().save_to_splat(coeffs, tmp_path / "jg.splat", **flags)
    Tg.GSProcessor().save_to_splat(coeffs, tmp_path / "tg.splat", **flags)
    assert ((tmp_path / "tg.splat").read_bytes()
            == (tmp_path / "jg.splat").read_bytes() == data)


@pytest.mark.parametrize("degree", [0, 3])
def test_add_axis_matches_jax(rng, degree):
    Jg, Tg = both("utils.gs_processor")
    params = splat_params(rng, n=5, degree=degree)
    out = Tg.GSProcessor().add_axis(params, length=0.2)
    ref = Jg.GSProcessor().add_axis(params, length=0.2)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
        assert out[k].dtype == ref[k].dtype
    assert len(out["means3D"]) == 9
    np.testing.assert_allclose(out["means3D"][5:], [[0, 0, 0], [0.2, 0, 0],
                                                    [0, 0.2, 0], [0, 0, 0.2]])


def test_connect_springs_grouped_bitwise(rng):
    J, T = both("physics.topology")
    pts = rng.random((300, 3)) * 0.2
    groups = rng.integers(0, 4, 300)
    for radius, k in ((0.05, 12), (0.5, 50), (1e-4, 5)):
        sj, rj = J.connect_springs_grouped(pts, groups, radius, k)
        st, rt = T.connect_springs_grouped(pts, groups, radius, k)
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(rt, rj)
        assert st.dtype == np.int32 and rt.dtype == np.float32
        if len(st):
            assert (groups[st[:, 0]] == groups[st[:, 1]]).all()


@pytest.fixture(scope="module")
def robots():
    J, T = both("kinematics.robot")
    return J.RobotModel(tt.BUILTIN_URDF), T.RobotModel(tt.BUILTIN_URDF)


def test_robot_point_clouds_bitwise(robots):
    jr, tr = robots
    for kw in (dict(), dict(link_names=tt.SCAN_LINKS[:3], num_pts=[50, 80,
                                                                  120])):
        pj = jr.sample_pc(rng=np.random.default_rng(3), **kw)
        pt = tr.sample_pc(rng=np.random.default_rng(3), **kw)
        assert list(pt) == list(pj)
        for k in pj:
            np.testing.assert_array_equal(pt[k], pj[k])
    q = np.concatenate([np.array([10, -20, 30, 15, 4, 54, 20]) * np.pi / 180,
                        np.full(tr.chain.n_dof - 7, 0.3)])
    for kw in (dict(), dict(link_names=tt.SCAN_LINKS, num_pts=300),
               dict(link_names=["link2", "left_finger"], num_pts=[40, 90],
                    pcd_name="pc")):
        for _ in range(2):       # the second call reads the named cache
            np.testing.assert_array_equal(tr.compute_robot_pcd(q, **kw),
                                          jr.compute_robot_pcd(q, **kw))
    assert set(tr._pcd_cache) == set(jr._pcd_cache) == {
        ("pc", "link2", 40), ("pc", "left_finger", 90)}


@pytest.mark.parametrize("which", ["gripper", "pusher"])
def test_robot_posed_meshes_bitwise(robots, which):
    jr, tr = robots
    q7 = np.array([5, -30, 10, 40, -5, 70, 3]) * np.pi / 180
    if which == "gripper":
        calls = [dict(), dict(gripper_openness=0.3, arm_qpos=q7)]
        fn = "get_gripper_meshes"
    else:
        calls = [dict(), dict(arm_qpos=q7)]
        fn = "get_pusher_meshes"
    for kw in calls:
        mj, mt = getattr(jr, fn)(**kw), getattr(tr, fn)(**kw)
        assert len(mt) == len(mj) == len(tr.meshes)
        for a, b in zip(mt, mj):
            np.testing.assert_array_equal(a.vertices, b.vertices)
            np.testing.assert_array_equal(a.faces, b.faces)


# ---------------------------------------------------------------------------
# xarm_transforms on the built-in arm (tests/test_kinematics.py:157-215)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xarm_robots():
    J, T = both("kinematics.robot")
    fingers = ["left_finger", "right_finger"]
    return ((J.RobotModel(tt.BUILTIN_URDF),
             J.RobotModel(tt.BUILTIN_URDF, link_names=fingers)),
            (T.RobotModel(tt.BUILTIN_URDF),
             T.RobotModel(tt.BUILTIN_URDF, link_names=fingers)))


@pytest.mark.parametrize("which", ["gripper", "pusher"])
def test_transform_gs_moves_link_splats(xarm_robots, which):
    import torch

    J, T = both("kinematics.xarm_transforms")
    (j_sample, _), (t_sample, _) = xarm_robots
    from real2sim_eval_tpu_torch.kinematics.robot import CANONICAL_ARM_QPOS

    rng = np.random.default_rng(0)
    n = 50
    params = {"means3D": rng.random((n, 3)).astype(np.float32),
              "rotations": np.tile([[1, 0, 0, 0]], (n, 1)).astype(
                  np.float32)}
    mask = np.zeros(n, np.int32)
    mask[:20] = 5   # link4 splats
    mask[20:25] = 11   # left_finger splats
    mask[25:27] = -1
    q2 = CANONICAL_ARM_QPOS.copy()
    q2[1] += 0.4
    for q, counts in ((CANONICAL_ARM_QPOS.copy(), 750.0), (q2, 750.0),
                      (q2, 300.0)):
        if which == "gripper":
            out = T.transform_gs_xarm_gripper(q, counts, dict(params), mask,
                                              sample_robot=t_sample,
                                              device="cpu")
            ref = J.transform_gs_xarm_gripper(q, counts, dict(params), mask,
                                              sample_robot=j_sample)
        else:
            out = T.transform_gs_xarm_pusher(q, dict(params), mask,
                                             sample_robot=t_sample,
                                             device="cpu")
            ref = J.transform_gs_xarm_pusher(q, dict(params), mask,
                                             sample_robot=j_sample)
        for k in ("means3D", "rotations"):
            assert isinstance(out[k], torch.Tensor)
            assert out[k].device.type == "cpu"
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-5)
        moved = np.linalg.norm(out["means3D"].numpy() - params["means3D"],
                               axis=-1)
        if q is not q2:
            if which == "gripper":
                np.testing.assert_allclose(out["means3D"].numpy(),
                                           params["means3D"], atol=1e-5)
        else:
            assert moved[:20].min() > 1e-3    # masked splats moved
            assert moved[27:].max() < 1e-6    # others untouched


def test_eef_points_match_jax(xarm_robots):
    from real2sim_eval_tpu.kinematics import KinHelper as JKin
    from real2sim_eval_tpu_torch.kinematics import KinHelper as TKin
    from real2sim_eval_tpu_torch.kinematics.robot import CANONICAL_ARM_QPOS

    J, T = both("kinematics.xarm_transforms")
    (j_sample, j_robot), (t_sample, t_robot) = xarm_robots
    jk, tk = JKin(tt.BUILTIN_URDF), TKin(tt.BUILTIN_URDF, device="cpu")
    eef_xyz = np.array([0.2568, 0.0, 0.4005], np.float32)
    eef_quat = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    pts, fn = T.get_eef_pts_xarm_gripper(
        eef_xyz, eef_quat, np.array([1.0]), t_robot, t_sample, tk,
        CANONICAL_ARM_QPOS)
    pts_j, fn_j = J.get_eef_pts_xarm_gripper(
        eef_xyz, eef_quat, np.array([1.0]), j_robot, j_sample, jk,
        CANONICAL_ARM_QPOS)
    for o in (1.0, 0.0, 0.37):
        np.testing.assert_allclose(fn(o), fn_j(o), atol=1e-5)
    np.testing.assert_allclose(pts, pts_j, atol=1e-5)
    open_pts, closed_pts = fn(1.0), fn(0.0)
    assert open_pts.shape == closed_pts.shape
    assert np.abs(open_pts[:, :2].mean(0) - eef_xyz[:2]).max() < 0.1
    assert np.ptp(closed_pts[:, 1]) < np.ptp(open_pts[:, 1])
    p, pf = T.get_eef_pts_xarm_pusher(eef_xyz, eef_quat, t_robot, t_sample,
                                      tk, CANONICAL_ARM_QPOS)
    pj, _ = J.get_eef_pts_xarm_pusher(eef_xyz, eef_quat, j_robot, j_sample,
                                      jk, CANONICAL_ARM_QPOS)
    np.testing.assert_allclose(p, pj, atol=1e-5)
    np.testing.assert_array_equal(pf(), p)
    q = np.array([5, -30, 10, 40, -5, 70, 3]) * np.pi / 180
    np.testing.assert_array_equal(
        T.transform_eef_pts_xarm_gripper(t_robot, q, 400.0),
        J.transform_eef_pts_xarm_gripper(j_robot, q, 400.0))
    np.testing.assert_array_equal(
        T.transform_eef_pts_xarm_pusher(t_robot, q),
        J.transform_eef_pts_xarm_pusher(j_robot, q))


# ---------------------------------------------------------------------------
# create_rigid_phystwin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["box", "t_block"])
def test_create_rigid_phystwin_matches_jax(tmp_path, capsys, mesh):
    (Jc, Tc), (Jk, Tk) = (both("experiments.utils.create_rigid_phystwin"),
                          both("physics.checkpoints"))
    from real2sim_eval_tpu_torch.utils.mesh import make_box

    m = make_box((0.06, 0.06, 0.06)) if mesh == "box" else tt.make_t_block()
    kw = dict(spring_radius=0.05, max_neighbours=30, grid_size=0.015,
              n_surface=300)
    pj, sj = Jc.create_rigid_phystwin(m, tmp_path / "j", "case", **kw)
    j_out = capsys.readouterr().out
    pt, st = Tc.create_rigid_phystwin(m, tmp_path / "t", "case", **kw)
    assert capsys.readouterr().out.replace(str(tmp_path / "t"),
                                           str(tmp_path / "j")) == j_out
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(st, sj)
    assert len(pt) > 50 and len(st) > len(pt)
    for ck in (Jk, Tk):          # each package reads both checkpoints
        for d in ("j", "t"):
            data = ck.load_final_data(tmp_path / d / "data", "case")
            first = ck.load_first_order(tmp_path / d / "experiments", "case")
            np.testing.assert_array_equal(data["object_points"][0], pt)
            assert first["num_object_springs"] == len(st)
    surf_j, int_j = Jc.sample_rigid_points(m, 300, 0.015, seed=4)
    surf_t, int_t = Tc.sample_rigid_points(m, 300, 0.015, seed=4)
    np.testing.assert_array_equal(surf_t, surf_j)
    np.testing.assert_array_equal(int_t, int_j)


def test_create_rigid_phystwin_cli_matches_jax(tmp_path, monkeypatch):
    """Both ``main``s through argv, on an OBJ file: the same checkpoint
    files, byte for byte."""
    Jc, Tc = both("experiments.utils.create_rigid_phystwin")
    from real2sim_eval_tpu_torch.utils.mesh import save_obj

    save_obj(tt.make_t_block(), tmp_path / "T.obj")
    args = ["--mesh", str(tmp_path / "T.obj"), "--case", "T",
            "--spring_Y", "2e3", "--grid_size", "0.02", "--n_surface", "400",
            "--spring_radius", "0.06", "--max_neighbours", "20"]
    monkeypatch.setattr(sys, "argv", ["x", "--out", str(tmp_path / "j")]
                        + args)
    Jc.main()
    Tc.main(["--out", str(tmp_path / "t")] + args)
    for rel in ("data/T/final_data.pkl",
                "experiments_optimization/T/optimal_params.pkl"):
        assert ((tmp_path / "t" / rel).read_bytes()
                == (tmp_path / "j" / rel).read_bytes()), rel


# ---------------------------------------------------------------------------
# construct_scene
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_scan(tmp_path_factory):
    """A raw scan (400 table splats, 300 on each of the built-in arm's ten
    collision links) moved by SCAN_T, its true ids and its crop box."""
    from real2sim_eval_tpu_torch.utils.gs_processor import GSProcessor

    root = tmp_path_factory.mktemp("scan")
    ids = tt.make_raw_scan(root / "raw.ply", SCAN_T, n_table=400,
                           pts_per_link=300, seed=1)
    means = GSProcessor().load(root / "raw.ply")["means3D"]
    rob = means[ids > 0]
    crop = np.stack([rob.min(0) - 0.05, rob.max(0) + 0.05], -1)
    return root, ids, means, crop


@pytest.fixture(scope="module")
def robot_points():
    J, T = both("experiments.utils.construct_scene")
    pj, _ = J.sample_robot_points(tt.BUILTIN_URDF, tt.SCAN_LINKS)
    pt, robot = T.sample_robot_points(tt.BUILTIN_URDF, tt.SCAN_LINKS)
    return pj, pt, robot


def test_sample_robot_points_bitwise(robot_points):
    pj, pt, robot = robot_points
    np.testing.assert_array_equal(pt, pj)
    assert pt.shape == (len(tt.SCAN_LINKS) * 2000, 3)
    assert list(robot.meshes) == tt.SCAN_LINKS


@pytest.mark.parametrize("crop", [True, False], ids=["crop", "whole"])
def test_align_scan_bitwise(small_scan, robot_points, crop):
    J, T = both("experiments.utils.construct_scene")
    _, ids, means, box = small_scan
    pj, pt, _ = robot_points
    bb = box if crop else None
    Tj = J.align_scan_to_robot(means, pj, bb)
    Tt = T.align_scan_to_robot(means, pt, bb)
    np.testing.assert_array_equal(Tt, Tj)
    if crop:      # the cropped fit recovers the scan's pose
        np.testing.assert_allclose(Tt, np.linalg.inv(SCAN_T), atol=2e-3)


def test_segment_robot_bitwise(small_scan, robot_points):
    J, T = both("experiments.utils.construct_scene")
    _, ids, means, _ = small_scan
    pj, pt, _ = robot_points
    Tinv = np.linalg.inv(SCAN_T)
    params = {"means3D": means @ Tinv[:3, :3].T + Tinv[:3, 3]}
    for pusher in (False, True):
        mj, rj = J.segment_robot(params, pj, tt.SCAN_LINKS, pusher)
        mt, rt = T.segment_robot(params, pt, tt.SCAN_LINKS, pusher)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(rt, rj)
    robot = ids > 0
    assert (mt[~robot] == -1).all()
    assert (mt[robot] == ids[robot]).mean() > 0.9
    # every link found; link1's base disc sits at the robot box's z cut
    assert sorted(set(mt[robot].tolist()) - {-1}) == [2, 3, 4, 5, 6, 7, 8,
                                                      10, 11, 12]


@pytest.fixture(scope="module")
def constructed(small_scan, tmp_path_factory):
    """construct_scene.main of both packages on the small scan with the
    crop, GRIPPER_LINKS patched to the built-in arm's links."""
    J, T = both("experiments.utils.construct_scene")
    root, _, _, box = small_scan
    out = tmp_path_factory.mktemp("constructed")
    mp = pytest.MonkeyPatch()
    try:
        for m in (J, T):
            mp.setattr(m, "GRIPPER_LINKS", list(tt.SCAN_LINKS))
        args = ["--scan", str(root / "raw.ply"), "--urdf", tt.BUILTIN_URDF,
                "--crop", *map(str, box.reshape(-1))]
        mp.setattr(sys, "argv", ["x", "--out", str(out / "j.ply"),
                                 "--mask", str(out / "j.npy")] + args)
        J.main()
        T.main(["--out", str(out / "t.ply"), "--mask", str(out / "t.npy")]
               + args)
    finally:
        mp.undo()
    return out


def test_construct_scene_main_matches_jax(constructed, small_scan):
    out = constructed
    assert (out / "t.ply").read_bytes() == (out / "j.ply").read_bytes()
    mt = np.load(out / "t.npy")
    np.testing.assert_array_equal(mt, np.load(out / "j.npy"))
    _, ids, _, _ = small_scan
    assert ((mt >= 0) == (ids > 0)).mean() > 0.98
    assert (mt[ids > 0] == ids[ids > 0]).mean() > 0.9


def test_construct_scene_cli_refuses_without_the_card(constructed,
                                                      monkeypatch, small_scan):
    """``--visualize`` runs on the card unless ``--device cpu``; without a
    card it raises before writing anything."""
    import torch

    from real2sim_eval_tpu_torch.experiments.utils import construct_scene

    root, _, _, _ = small_scan
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = constructed / "refused.ply"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        construct_scene.main(["--scan", str(root / "raw.ply"), "--out",
                              str(out), "--mask", str(out) + ".npy",
                              "--urdf", tt.BUILTIN_URDF, "--visualize",
                              str(constructed / "p.png")])
    assert not out.exists()


class SmallCamera:
    """A stand-in for a package's ``Camera`` at 1/``factor`` of the size
    (the full-size views run on the card only)."""

    def __init__(self, orig, factor):
        self.orig, self.factor = orig, factor

    def __call__(self, width, height, fx, fy, cx, cy, **kw):
        f = self.factor
        return self.orig(width=width // f, height=height // f, fx=fx / f,
                         fy=fy / f, cx=cx / f, cy=cy / f, **kw)


def small_renders(monkeypatch, factor):
    """Patch both packages' ``Camera`` to SmallCamera and record each
    ``rasterize`` call's (arguments, output); returns the JAX and the
    port's lists."""
    import importlib

    seen = {"jax": [], "port": []}
    for key, pkg in (("jax", "real2sim_eval_tpu"),
                     ("port", "real2sim_eval_tpu_torch")):
        cam = importlib.import_module(f"{pkg}.renderer.camera")
        raster = importlib.import_module(f"{pkg}.renderer.raster")
        monkeypatch.setattr(cam, "Camera", SmallCamera(cam.Camera, factor))
        orig = raster.rasterize

        def wrapper(*args, _orig=orig, _out=seen[key], **kwargs):
            out = _orig(*args, **kwargs)
            _out.append((args, out))
            return out

        monkeypatch.setattr(raster, "rasterize", wrapper)
    return seen["jax"], seen["port"]


def test_articulate_preview_matches_jax(constructed, tmp_path, monkeypatch):
    """The re-posed robot splats within 1e-5 of the JAX preview's, the
    image at a small camera within 2e-3 rgb / 1e-3 depth of the JAX
    reference backend; the PNG is written."""
    from real2sim_eval_tpu_torch.utils.gs_processor import GSProcessor

    J, T = both("experiments.utils.construct_scene")
    params = GSProcessor().load(constructed / "t.ply")
    mask = np.load(constructed / "t.npy")
    seen_j, seen_t = small_renders(monkeypatch, 16)
    qpos, grip = [10, -20, 30, 15, 4, 54, 20], 100
    J.articulate_preview(params, mask, tt.BUILTIN_URDF, qpos, grip,
                         tmp_path / "j.png")
    T.articulate_preview(params, mask, tt.BUILTIN_URDF, qpos, grip,
                         tmp_path / "t.png", device="cpu")
    (aj, (im_j, dep_j)), (at, (im_t, dep_t)) = seen_j[0], seen_t[0]
    robot = mask > 0
    for i in (2, 4):            # means, quats
        np.testing.assert_allclose(at[i].numpy(), np.asarray(aj[i]),
                                   atol=1e-5)
    moved = np.linalg.norm(at[2].numpy() - params["means3D"], axis=-1)
    assert moved[robot].max() > 0.05 and moved[~robot].max() == 0.0
    assert tuple(im_t.shape) == (3, 30, 53)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=2e-3)
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j), atol=1e-3)
    assert (tmp_path / "t.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# the evaluator over a constructed scene
# ---------------------------------------------------------------------------


def test_evaluator_rows_over_a_constructed_scene(constructed, tmp_path):
    """A 2-lane evaluator built from a config whose scan is construct_scene's
    output (ids -1 off the robot): the robot rows (mask > 0) and static
    rows of the port's composed scene against the JAX evaluator's, and the
    port's incremental split over the same rows."""
    import torch

    from real2sim_eval_tpu.parallel import BatchedEvaluator as JEval
    from real2sim_eval_tpu.renderer import RasterConfig as JRC
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval
    from real2sim_eval_tpu_torch.renderer import RasterConfig

    rope = tt.make_rope_points(n=60, length=0.2)
    tt.write_fixture_checkpoint(tmp_path, "rope", rope, spring_Y=2e3)
    gs = tt.make_synthetic_scene(tmp_path / "obj", rope_pts=rope, n_table=10)
    gs["scene"] = dict(table_splat_path=str(constructed / "t.ply"),
                       total_mask_path=str(constructed / "t.npy"))
    cfg = tt.full_cfg(tmp_path, "rope", gs=gs, cameras=tt.TEST_CAMERAS,
                      physics_over=dict(dt=2e-4))
    jev = JEval(cfg, episode_ids=[0, 1], raster_config=JRC(
        backend="reference"), physics_backend="xla")
    tev = TEval(cfg, [0, 1], raster_config=RasterConfig(incremental="on"),
                device="cpu")
    mask = np.load(constructed / "t.npy")
    robot = np.where(mask > 0)[0]
    static = np.where(mask <= 0)[0]
    assert (mask < 0).any() and len(robot) > 0
    np.testing.assert_array_equal(tev._robot_rows.numpy(), robot)
    np.testing.assert_array_equal(tev._static_rows.numpy(), static)
    np.testing.assert_allclose(tev.state.qpos7.numpy(),
                               np.asarray(jev.state.qpos7), atol=1e-4)
    tev.state = tev.state.replace(qpos7=torch.tensor(
        np.asarray(jev.state.qpos7)))
    ts, js = tev.compose_scenes(), jev.compose_scenes()
    n_obj = len(rope) + sum(pm["means3D"].shape[-2]
                            for pm in tev.assets.mesh_params.values())
    for k in ("means3D", "rotations"):
        t_tab = ts[k][:, n_obj:].numpy()
        j_tab = np.asarray(js[k])[:, n_obj:]
        np.testing.assert_array_equal(t_tab[:, static], j_tab[:, static])
        np.testing.assert_allclose(t_tab[:, robot], j_tab[:, robot],
                                   atol=1e-5)
    dyn, _ = tev.compose_dyn(tev.state)
    for k in ("means3D", "rotations"):
        np.testing.assert_array_equal(dyn[k][:, len(rope):].numpy(),
                                      ts[k][:, n_obj:][:, robot].numpy())
