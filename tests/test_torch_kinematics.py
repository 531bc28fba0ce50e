"""Port vs JAX package: FK and IK on the built-in arm, LBS, robot-splat
articulation and the grid randomization, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.kinematics.chain import KinematicChain as JChain
from real2sim_eval_tpu.kinematics.ik import make_ik_fn as j_make_ik
from real2sim_eval_tpu.kinematics.robot import RobotModel
from real2sim_eval_tpu.renderer import lbs as jlbs
from real2sim_eval_tpu.renderer import scene as jscene
from real2sim_eval_tpu.testing import BUILTIN_URDF as J_URDF
from real2sim_eval_tpu_torch.kinematics import KinematicChain as TChain
from real2sim_eval_tpu_torch.kinematics import make_ik_fn as t_make_ik
from real2sim_eval_tpu_torch.kinematics.robot import RobotModel as TRobotModel
from real2sim_eval_tpu_torch.renderer import lbs as tlbs
from real2sim_eval_tpu_torch.renderer import scene as tscene
from real2sim_eval_tpu_torch.utils.urdf import BUILTIN_URDF as T_URDF

Q0 = np.array([0, -45, 0, 30, 0, 75, 0]) * np.pi / 180.0


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def chains():
    return JChain.from_urdf_file(J_URDF), TChain.from_urdf_file(T_URDF)


def test_urdf_tables_match():
    jc, tc = chains()
    assert jc.link_names == tc.link_names and jc.n_dof == tc.n_dof
    for k in ("parent", "joint_type", "origins", "axes", "dof_index",
              "topo_order", "lower", "upper"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k), k)


def test_fk_all_links_and_fk_link():
    jc, tc = chains()
    rng = np.random.default_rng(0)
    q = (rng.uniform(-1, 1, (6, jc.n_dof)) + np.r_[Q0, np.zeros(jc.n_dof - 7)]
         ).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.vmap(jc.fk)(jnp.asarray(q)))
        want7 = np.asarray(jax.vmap(lambda x: jc.fk_link(x, "link7"))(
            jnp.asarray(q)))
    np.testing.assert_allclose(tc.fk(T(q)).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tc.fk_link(T(q), "link7").numpy(), want7,
                               atol=1e-5)
    np.testing.assert_allclose(tc.fk_numpy(q[0]),
                               RobotModel(J_URDF).fk_numpy(q[0]), atol=1e-12)


def test_ik_matches_jax():
    """Targets a few cm/degrees off the start pose: both solvers take the
    same damped Gauss-Newton path (forward-mode Jacobians), so they land
    on the same arm pose, not just on a pose that reaches the target."""
    jc, tc = chains()
    eef = jc.link_index("link7")
    rng = np.random.default_rng(1)
    q_init = np.tile(Q0.astype(np.float32), (4, 1))
    q_goal = q_init + rng.uniform(-0.15, 0.15, q_init.shape).astype(np.float32)
    targets = np.array(jax.vmap(lambda x: jc.fk_link(x, eef))(
        jnp.asarray(q_goal)))
    targets[3, :3, 3] += 0.5          # unreachable: falls back to q_init
    j_ik = j_make_ik(jc, eef, n_active=7)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.vmap(j_ik)(jnp.asarray(q_init),
                                         jnp.asarray(targets)))
    got = t_make_ik(tc, eef, n_active=7)(T(q_init), T(targets)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got[3], q_init[3])


def lbs_inputs(seed=2, n_bones=60, n_pts=300, n_env=3):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 0.3, n_bones)
    bones = np.stack([t, 0.01 * np.sin(20 * t), np.zeros(n_bones)], -1)
    bones = (bones + rng.normal(scale=1e-3, size=bones.shape)).astype(np.float32)
    pts = (bones[rng.integers(0, n_bones, n_pts)]
           + rng.normal(scale=0.01, size=(n_pts, 3))).astype(np.float32)
    motions = rng.normal(scale=0.01, size=(n_env, n_bones, 3)).astype(np.float32)
    return bones, pts, motions


def test_lbs_matches_jax():
    bones, pts, motions = lbs_inputs()
    rel_j = jlbs.knn_relations(jnp.asarray(bones))
    w_j, wi_j = jlbs.knn_weights(jnp.asarray(bones), jnp.asarray(pts))
    rel_t = tlbs.knn_relations(T(bones))
    w_t, wi_t = tlbs.knn_weights(T(bones), T(pts))
    np.testing.assert_array_equal(rel_t.numpy(), np.asarray(rel_j))
    np.testing.assert_array_equal(wi_t.numpy(), np.asarray(wi_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)

    with jax.default_matmul_precision("highest"):
        R_j = np.stack([np.asarray(jlbs.fit_bone_rotations(
            jnp.asarray(bones), jnp.asarray(m), rel_j)) for m in motions])
        xyz_j = np.stack([np.asarray(jlbs.interpolate_motions(
            jnp.asarray(bones), jnp.asarray(m), rel_j, w_j, wi_j,
            jnp.asarray(pts))[0]) for m in motions])
    bones_b = T(np.broadcast_to(bones, motions.shape))
    R_t = tlbs.fit_bone_rotations(bones_b, T(motions), rel_t)
    np.testing.assert_allclose(R_t.numpy(), R_j, atol=1e-5)
    xyz_t = tlbs.interpolate_motions(bones_b, T(motions), rel_t, w_t, wi_t,
                                     T(np.broadcast_to(pts, (3,) + pts.shape)),
                                     env_chunk_bytes=1)   # one env per chunk
    np.testing.assert_allclose(xyz_t.numpy(), xyz_j, atol=1e-5)


def test_articulation_matches_jax():
    robot = RobotModel(J_URDF)
    jc, tc = chains()
    link_ids = tuple(i for i in jscene.XARM_GRIPPER_LINK_IDS
                     if i < len(jc.link_names))
    base_q = np.concatenate([Q0, np.full(jc.n_dof - 7, 0.05)])
    art_j = jscene.RobotArticulation.build(robot, link_ids, base_q)
    art_t = tscene.RobotArticulation.build(TRobotModel(T_URDF), link_ids,
                                           base_q, device="cpu")
    np.testing.assert_allclose(art_t.base_inv.numpy(),
                               np.asarray(art_j.base_inv), atol=1e-6)
    rng = np.random.default_rng(3)
    n = 200
    means = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    quats = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    mask = rng.integers(0, len(jc.link_names), n).astype(np.int32)
    q7 = (Q0 + rng.uniform(-0.3, 0.3, (2, 7))).astype(np.float32)
    counts = np.array([750.0, 300.0], np.float32)
    with jax.default_matmul_precision("highest"):
        outs = [art_j.apply(art_j.full_qpos(jnp.asarray(q7[e]), counts[e]),
                            jnp.asarray(means), jnp.asarray(quats),
                            jnp.asarray(mask)) for e in range(2)]
    m_t, q_t = art_t.apply(art_t.full_qpos(T(q7), T(counts)), T(means),
                           T(quats), T(mask, torch.int32))
    np.testing.assert_allclose(m_t.numpy(), np.stack([np.asarray(o[0])
                                                      for o in outs]),
                               atol=1e-5)
    np.testing.assert_allclose(q_t.numpy(), np.stack([np.asarray(o[1])
                                                      for o in outs]),
                               atol=1e-5)


def test_grid_random_values():
    xy, theta = [[-0.05, -0.05], [0.0, 0.0], [0.05, 0.05]], [-10, 0, 10]
    for i in range(9):
        for one in (False, True):
            if one and i >= 3:
                continue
            assert (tscene.grid_random_values(i, xy, theta, one)
                    == jscene.grid_random_values(i, xy, theta, one))


def test_written_out_jacobian_matches_autodiff():
    """The IK's written-out forward mode against torch.func's forward-mode
    AD of the same error function (per-env blocks of the batched
    Jacobian)."""
    from real2sim_eval_tpu_torch.kinematics.ik import (_pose_error,
                                                       fk_link_jvp,
                                                       pose_error_jvp)

    _, tc = chains()
    eef = tc.link_index("link7")
    rng = np.random.default_rng(5)
    q = T(Q0 + rng.uniform(-0.8, 0.8, (5, 7)))
    target = tc.fk_link(T(Q0 + rng.uniform(-0.5, 0.5, (5, 7))), eef)
    target[4] = tc.fk_link(q[4:5], eef)[0]      # zero error: the log's limit

    def err(qq):
        return _pose_error(tc.fk_link(qq, eef), target)

    full = torch.func.jacfwd(err)(q)                       # (E, 6, E, 7)
    want = full.diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    P, dP = fk_link_jvp(tc, q, eef, 7)
    e, de = pose_error_jvp(P, dP, target)
    np.testing.assert_allclose(e.numpy(), err(q).numpy(), atol=1e-6)
    np.testing.assert_allclose(de.permute(1, 2, 0).numpy(), want.numpy(),
                               atol=2e-5)


def test_chain_device_constants_are_built_once():
    """FK and IK read each link's origin and axis from device tables that
    the chain makes once per (device, dtype): they equal the numpy
    tables, the second call returns the same tensors, and FK, the IK's
    forward-mode FK and a whole IK solve give bitwise what tables copied
    from numpy on every call give."""
    from real2sim_eval_tpu_torch.kinematics.ik import fk_link_jvp

    _, tc = chains()
    dev = torch.device("cpu")
    origins, axes = tc.device_tables(dev, torch.float32)
    np.testing.assert_array_equal(origins.numpy(),
                                  tc.origins.astype(np.float32))
    np.testing.assert_array_equal(axes.numpy(), tc.axes.astype(np.float32))
    again = tc.device_tables(dev, torch.float32)
    assert again[0] is origins and again[1] is axes
    assert list(tc._device) == [(dev, torch.float32)]

    rng = np.random.default_rng(5)
    q = T(rng.uniform(-1, 1, (4, tc.n_dof)) + np.r_[Q0, np.zeros(
        tc.n_dof - 7)])
    target = tc.fk_link(q + 0.05, "link7")
    link7 = tc.link_index("link7")
    outs = {}
    for name in ("cached", "copied"):
        if name == "copied":      # the tables copied anew at every read
            object.__setattr__(tc, "device_tables", lambda d, t: (
                torch.as_tensor(tc.origins, dtype=t, device=d),
                torch.as_tensor(tc.axes, dtype=t, device=d)))
        outs[name] = (tc.fk(q), tc.fk_link(q, "link7"),
                      *fk_link_jvp(tc, q, link7, 7),
                      t_make_ik(tc, "link7", n_active=7)(q, target))
    assert list(tc._device) == [(dev, torch.float32)]    # not rebuilt
    for a, b in zip(outs["cached"], outs["copied"]):
        assert torch.equal(a, b)


def test_ik_solver_on_the_cpu_is_the_eager_solve(monkeypatch):
    """On a CPU tensor the solver ``make_ik_fn`` returns runs the eager
    solve, bitwise, fallback rows included, and never touches the kernel
    extension."""
    from real2sim_eval_tpu_torch import ext

    def no_build():
        raise AssertionError("the CPU solve loaded the extension")

    monkeypatch.setattr(ext, "load", no_build)
    launches = dict(ext.LAUNCHES)
    jc, tc = chains()
    eef = tc.link_index("link7")
    rng = np.random.default_rng(6)
    q = T(np.tile(Q0, (5, 1)) + rng.uniform(-0.1, 0.1, (5, 7)))
    target = tc.fk_link(q + T(rng.uniform(-0.15, 0.15, (5, 7))), eef)
    target[4, :3, 3] += 0.5          # unreachable: falls back to q_init
    solver = t_make_ik(tc, eef, n_active=7)
    got = solver(q, target)
    assert torch.equal(got, solver.eager(q, target))
    assert torch.equal(got[4], q[4]) and not torch.equal(got[0], q[0])
    assert ext.LAUNCHES == launches


def packed_fk(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., 4, 4): the pose at the end of a packed path, from
    its table alone, by the operations of ``chain.fk_link``."""
    from real2sim_eval_tpu_torch.kinematics.chain import (_prismatic,
                                                          _rot_about_axis)

    pose = None
    for row in table:
        local = row[5:21].reshape(4, 4)
        jt = int(row[0])
        if jt:
            axis, v = row[2:5], q[..., int(row[1])]
            local = local @ (_rot_about_axis(axis, v) if jt == 1
                             else _prismatic(axis, v))
        pose = local if pose is None else pose @ local
    return pose.expand(q.shape[:-1] + (4, 4))


def rail_chain(tmp_path):
    from real2sim_eval_tpu_torch.testing import write_rail_pusher_urdf

    return TChain.from_urdf_file(write_rail_pusher_urdf(
        tmp_path / "rail.urdf"))


@pytest.mark.parametrize("arm,width", [("builtin", 7), ("builtin", 9),
                                       ("rail", 8)])
def test_packed_table_gives_fk_link(tmp_path, arm, width):
    """The table the IK kernel reads (``pack_chain``: the path root ->
    eef, a row a link), read back in plain PyTorch (``packed_fk`` here), gives
    bitwise ``chain.fk_link`` on the built-in arm (the evaluator's 7-wide
    q and the full 9) and on the rail arm with its pusher tip (a
    prismatic joint and fixed links that are no identities on the path);
    each row holds the link's joint type, dof, axis and origin."""
    from real2sim_eval_tpu_torch.kinematics.ik import chain_path, pack_chain

    chain = chains()[1] if arm == "builtin" else rail_chain(tmp_path)
    eef = chain.link_index("link7" if arm == "builtin" else "pusher_tip")
    table = pack_chain(chain, eef)
    path = chain_path(chain, eef)
    assert table.shape == (len(path), 24) and table.dtype == np.float32
    for row, i in zip(table, path):
        assert row[0] == chain.joint_type[i] and row[1] == chain.dof_index[i]
        np.testing.assert_array_equal(row[2:5], chain.axes[i].astype(
            np.float32))
        np.testing.assert_array_equal(row[5:21], chain.origins[i].astype(
            np.float32).ravel())
    assert (table[:, 21:] == 0).all()
    rng = np.random.default_rng(8)
    q = T(rng.uniform(-1.5, 1.5, (6, width)))
    got = packed_fk(torch.as_tensor(table), q)
    assert torch.equal(got, chain.fk_link(q, eef))


def ik_wrapper_inputs(case):
    """Inputs of ``ik_solve`` right but for ``case``, on the CPU (where the
    kernel cannot run: a right set raises for its device alone)."""
    from real2sim_eval_tpu_torch.kinematics.ik import pack_chain

    tc = chains()[1]
    table = torch.as_tensor(pack_chain(tc, tc.link_index("link7")))
    q = torch.zeros(4, 7)
    target = torch.eye(4).expand(4, 4, 4).contiguous()
    n_active = 7
    if case == "q_dtype":
        q = q.double()
    elif case == "target_dtype":
        target = target.half()
    elif case == "table_width":
        table = table[:, :20].contiguous()
    elif case == "long_path":
        table = table.repeat(4, 1)
    elif case == "q_narrower_than_the_path":
        q = torch.zeros(4, 6)
    elif case == "target_lanes":
        target = target[:3]
    elif case == "target_rank":
        target = target[:, :3].contiguous()
    elif case == "n_active":
        n_active = 8
    elif case == "q_strided":
        q = torch.zeros(7, 4).t()
    elif case == "target_strided":
        target = torch.eye(4).expand(4, 4, 4)
    elif case == "device_mix":
        table = table.to("meta")
    return table, q, target, n_active


@pytest.mark.parametrize("case,message", [
    ("q_dtype", "q_init must be float32"),
    ("target_dtype", "target must be float32"),
    ("table_width", "table must be"),
    ("long_path", "table must be"),
    ("q_narrower_than_the_path", "q_init must be"),
    ("target_lanes", "target must be"),
    ("target_rank", "target must be"),
    ("n_active", "n_active must lie"),
    ("q_strided", "q_init must be contiguous"),
    ("target_strided", "target must be contiguous"),
    ("device_mix", "table is on meta"),
    ("on_the_cpu", "runs on a CUDA device"),
])
def test_ik_kernel_wrapper_checks_its_inputs(monkeypatch, case, message):
    """The kernel reads its inputs unchecked, so ``ik_solve`` raises on a
    wrong dtype, shape, stride or device before anything is built or
    launched."""
    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.kinematics.ik import ik_solve

    def no_build():
        raise AssertionError("checked after the build")

    monkeypatch.setattr(ext, "load", no_build)
    table, q, target, n_active = ik_wrapper_inputs(case)
    with pytest.raises(ValueError, match=message):
        ik_solve(table, q, target, n_active, 7, 32, 1e-4, 1.0, 0.01, 0.01)
