"""Port vs JAX package: FK and IK on the built-in arm, LBS, robot-splat
articulation and the grid randomization, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
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


def test_ik_solver_on_the_cpu_is_the_eager_solve():
    """On a CPU tensor the solver ``make_ik_fn`` returns runs the eager
    solve (no graph is captured), bitwise, fallback rows included."""
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
    assert solver.graph.captures == 0 and solver.graph.replays == 0


def test_graph_replays_copy_inputs_and_return_clones(monkeypatch):
    """The graph helper's contract with a stand-in for the CUDA capture
    (a replay that runs the function on the static inputs into the static
    output): each call copies its inputs into the static inputs, one
    capture per input signature, and the returned tensor is a clone, so a
    result kept across calls is not overwritten by the next replay. A
    helper that skipped the copy would return the first call's result for
    the second input."""
    from real2sim_eval_tpu_torch.utils import graph as graph_mod

    def fake_record(fn, static_in):
        out = fn(*static_in)

        def replay():
            out.copy_(fn(*static_in))
        return replay, out

    monkeypatch.setattr(graph_mod, "_record", fake_record)

    def fn(a, b):
        return a * 2.0 + b

    g = graph_mod.Graphed(fn)
    rng = np.random.default_rng(7)
    x1, y1, x2, y2 = (T(rng.normal(size=(4, 3))) for _ in range(4))
    r1 = g(x1, y1)
    keep = r1.clone()
    r2 = g(x2, y2)
    assert torch.equal(r1, keep) and torch.equal(r1, fn(x1, y1))
    assert torch.equal(r2, fn(x2, y2))
    static_in, _, out = g._graphs[graph_mod.signature((x1, y1))]
    assert r2.data_ptr() != out.data_ptr()
    assert torch.equal(static_in[0], x2) and static_in[0].data_ptr() != \
        x2.data_ptr()
    r3 = g(x1[:2], y1[:2])                    # a new shape: its own graph
    assert torch.equal(r3, fn(x1[:2], y1[:2]))
    assert (g.captures, g.replays) == (2, 3)
