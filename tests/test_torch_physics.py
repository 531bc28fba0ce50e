"""Port vs JAX package: spring topology tables (bitwise), SDF queries, the
spring-mass control step (the port's fused step, whose K3 wrapper takes the
plain version on the CPU) against the JAX ``make_step_fn`` and the JAX
Pallas step in interpret mode, and the grasp/control build.

Fixtures follow tests/test_pallas_step.py: a rope of 40 particles,
58 substeps, with and without self-collision, a static box and a sweeping
finger collider."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.physics import dynamics as jdyn
from real2sim_eval_tpu.physics import multi_sdf as jmsdf
from real2sim_eval_tpu.physics import pallas_step
from real2sim_eval_tpu.physics import sdf as jsdf
from real2sim_eval_tpu.physics import spring_mass as jsm
from real2sim_eval_tpu.physics import topology as jtopo
from real2sim_eval_tpu.utils import mesh as jmesh
from real2sim_eval_tpu_torch.physics import dynamics as tdyn
from real2sim_eval_tpu_torch.physics import fused_step
from real2sim_eval_tpu_torch.physics import multi_sdf as tmsdf
from real2sim_eval_tpu_torch.physics import sdf as tsdf
from real2sim_eval_tpu_torch.physics import spring_mass as tsm
from real2sim_eval_tpu_torch.physics import topology as ttopo
from real2sim_eval_tpu_torch.utils import mesh as tmesh


def T(a, dtype=None):
    a = np.array(a)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    return torch.as_tensor(a, dtype=dtype)


# ---------------------------------------------------------------------------
# topology (bitwise)
# ---------------------------------------------------------------------------


def test_topology_tables_bitwise():
    rng = np.random.default_rng(0)
    rope = np.stack([np.linspace(0, 0.3, 80), np.zeros(80), np.zeros(80)], -1)
    rope = (rope + rng.normal(scale=1e-3, size=rope.shape)).astype(np.float32)
    g = np.linspace(0, 0.08, 6)
    blob = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    blob = blob[rng.permutation(len(blob))].astype(np.float32)
    for pts, radius, k in ((rope, 0.02, 30), (blob, 0.02, 8)):
        sj, rj = jtopo.connect_springs(pts, radius, k)
        st, rt = ttopo.connect_springs(pts, radius, k)
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(rt, rj)
        ylog = np.log(rng.uniform(1e3, 1e4, len(sj))).astype(np.float32)
        for a, b in zip(ttopo.build_neighbor_tables(st, rt, ylog, len(pts)),
                        jtopo.build_neighbor_tables(sj, rj, ylog, len(pts))):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ttopo.rcm_order(st, len(pts)),
                                      jtopo.rcm_order(sj, len(pts)))
        rolled_t, perm_t = ttopo.build_rolled_tables_maybe_reordered(
            st, rt, ylog, len(pts))
        rolled_j, perm_j = jtopo.build_rolled_tables_maybe_reordered(
            sj, rj, ylog, len(pts))
        assert (perm_t is None) == (perm_j is None)
        if perm_t is not None:
            np.testing.assert_array_equal(perm_t, perm_j)
        for a, b in zip(rolled_t, rolled_j):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# SDF (1e-6)
# ---------------------------------------------------------------------------


def port_grid(g):
    return tsdf.SdfGrid(origin=T(g.origin), inv_spacing=T(g.inv_spacing),
                        values=T(g.values), corners=T(g.corners))


def test_sdf_grid_and_queries():
    box_j = jsdf.build_sdf_grid(jmesh.make_box((0.1, 0.06, 0.04)),
                                voxel_size=0.004)
    box_t = tsdf.build_sdf_grid(tmesh.make_box((0.1, 0.06, 0.04)),
                                voxel_size=0.004)
    np.testing.assert_array_equal(box_t.values.numpy(), np.asarray(box_j.values))
    np.testing.assert_array_equal(box_t.corners.numpy(),
                                  np.asarray(box_j.corners))
    fin_j = jsdf.build_sdf_grid(jmesh.make_box((0.02, 0.02, 0.06)),
                                voxel_size=0.003)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.08, 0.08, (2, 400, 3)).astype(np.float32)
    d_j, n_j = jsdf.sdf_query(box_j, jnp.asarray(pts[0]))
    d_t, n_t = tsdf.sdf_query(port_grid(box_j), T(pts[0]))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6)
    combo_j = jmsdf.combine_grids((fin_j, box_j))
    combo_t = tmsdf.combine_grids((port_grid(fin_j), port_grid(box_j)))
    d_j, n_j = jmsdf.multi_sdf_query(combo_j, jnp.asarray(pts))
    d_t, n_t = tmsdf.multi_sdf_query(combo_t, T(pts))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6)


# ---------------------------------------------------------------------------
# the control step
# ---------------------------------------------------------------------------


def rope_params(n=40, length=0.4, Y=2e3, fold=False, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, length, n)
    rest = np.stack([t, np.zeros(n), np.full(n, 0.05)], -1)
    rest = (rest + rng.normal(scale=1e-3, size=rest.shape)).astype(np.float32)
    springs, rl = jtopo.connect_springs(rest, radius=0.035, max_neighbours=6)
    y_log = np.full(len(springs), np.log(Y), np.float32)
    nbr = jtopo.build_neighbor_tables(springs, rl, y_log, n)
    rolled = jtopo.build_rolled_tables(springs, rl, y_log, n)
    x = rest.copy()
    if fold:
        half = n // 2
        x[half:] = x[2 * half - 1 - np.arange(half, n) + half]
        x[half:, 1] += 0.004
    common = dict(
        masses=np.ones(n, np.float32), nbr_idx=nbr[0], nbr_rest=nbr[1],
        nbr_Y_log=nbr[2], collision_mask=np.arange(n, dtype=np.int32),
        rest_x=rest, springs=springs, rest_lengths=rl, spring_Y_log=y_log,
        collide_elas=np.float32(0.5), collide_fric=np.float32(0.3),
        collide_eef_elas=np.float32(0.0), collide_eef_fric=np.float32(1.0),
        collide_self_elas=np.float32(0.5), collide_self_fric=np.float32(0.3))
    pj = jsm.SpringMassParams(
        **{k: jnp.asarray(v) for k, v in common.items()},
        roll_rest=jnp.asarray(rolled[1]), roll_Y_log=jnp.asarray(rolled[2]),
        roll_offsets=tuple(int(o) for o in rolled[0]))
    pt = tsm.SpringMassParams(**{k: T(v) for k, v in common.items()})
    return pj, pt, x


def controls(B, n_f, eef_xyz=(0.1, 0.0, 0.2), eef_vel=(0, 0, 0),
             openness=(1.0, 1.0)):
    one = dict(eef_xyz=np.asarray(eef_xyz, np.float32),
               eef_vel=np.asarray(eef_vel, np.float32),
               eef_rot=np.eye(3, dtype=np.float32),
               eef_rot_vel=np.zeros(3, np.float32),
               openness_start=np.float32(openness[0]),
               openness_end=np.float32(openness[1]),
               dyn_lin_vel=np.tile(np.asarray(eef_vel, np.float32) * 0.5,
                                   (n_f, 1)),
               dyn_omega=np.zeros(3, np.float32))
    b = {k: np.broadcast_to(np.asarray(v)[None], (B,) + np.shape(v))
         for k, v in one.items()}
    return (jsm.SubstepControls(**{k: jnp.asarray(v) for k, v in b.items()}),
            tsm.SubstepControls(**{k: T(v) for k, v in b.items()}))


def small_opts(mod, **kw):
    base = dict(num_substeps=58, self_collision=False, n_fingers=0,
                max_candidates=8, max_self_particles=128,
                max_contact_particles=128, max_self_slots=4)
    base.update(kw)
    return mod.PhysicsOptions(**base)


def box_collider(size, voxel, pose=None, finger=False):
    grid = jsdf.build_sdf_grid(jmesh.make_box(size), voxel_size=voxel)
    table = np.tile(np.eye(4, dtype=np.float32), (1, 101, 1, 1))
    if finger:
        return (jsm.MeshColliderSet(fingers=(grid,),
                                    finger_pose_table=jnp.asarray(table),
                                    statics=(), static_pose=jnp.zeros((0, 4, 4))),
                (port_grid(grid),), (), table, np.zeros((0, 4, 4), np.float32))
    return (jsm.MeshColliderSet(fingers=(), finger_pose_table=jnp.zeros(
        (1, 101, 4, 4)), statics=(grid,), static_pose=jnp.asarray(pose[None])),
            (), (port_grid(grid),), np.zeros((1, 101, 4, 4), np.float32),
            pose[None])


def static_pose_box():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, 0.0, -0.045]     # box top face just under the rope
    return pose


CASES = {
    # name: (fold, opts kw, collider builder, ctrl kw, x0 shift)
    "springs_gravity_ground": (False, {}, None, {}, 0.0),
    "self_collision": (True, dict(self_collision=True), None, {}, 0.0),
    "static_collider": (False, {}, lambda: box_collider(
        (0.1, 0.1, 0.1), 0.004, static_pose_box()), {}, 0.0),
    "finger_collider": (False, dict(n_fingers=1, self_collision=True),
                        lambda: box_collider((0.04, 0.04, 0.08), 0.003,
                                             finger=True),
                        dict(eef_xyz=(0.2, 0.0, 0.0455),
                             eef_vel=(0.0, 0.0, 0.3)), 0.04),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case):
    fold, okw, coll_fn, ckw, shift = CASES[case]
    pj, pt, x0 = rope_params(fold=fold)
    B, n = 2, x0.shape[0]
    x0_b = np.tile(x0[None], (B, 1, 1))
    x0_b[1, :, 2] += 0.005
    x0_b[..., 2] += shift
    oj, ot = small_opts(jsm, **okw), small_opts(tsm, **okw)
    n_f = max(oj.n_fingers, 1)
    cj, ct = controls(B, n_f, **ckw)
    rest_b = np.broadcast_to(x0_b[:1] * 0 + np.asarray(pj.rest_x), x0_b.shape)
    if coll_fn is None:
        colj = col_t = None
        sp_b = np.zeros((B, 0, 4, 4), np.float32)
    else:
        colj, fingers, statics, table, sp = coll_fn()
        sp_b = np.broadcast_to(sp[None], (B,) + sp.shape)
        col_t = tsm.MeshColliderSet(fingers=fingers,
                                    finger_pose_table=T(table),
                                    statics=statics, static_pose=T(sp_b))
    has_coll = colj is not None

    sj = jsm.SpringMassState(x=jnp.asarray(x0_b), v=jnp.zeros((B, n, 3)),
                             finger_forces=jnp.zeros((B, n_f, 3)))
    sp_j = jnp.asarray(sp_b)
    step_j = jsm.make_step_fn(oj, has_colliders=has_coll)

    def one_env(sp_e, sm_e, ctrl_e):
        c = colj.replace(static_pose=sp_e) if has_coll else None
        return step_j(pj, c, sm_e, ctrl_e)

    ref = jax.jit(lambda sm, c: jax.vmap(one_env)(sp_j, sm, c))
    pal = pallas_step.make_pallas_step_fn(oj, pj, colj, batch=B,
                                          interpret=True)
    pal_step = jax.jit(lambda sm, c: pal(pj, sp_j if has_coll else None,
                                         jnp.asarray(rest_b), sm, c))
    st = tsm.SpringMassState(x=T(x0_b), v=torch.zeros((B, n, 3)),
                             finger_forces=torch.zeros((B, n_f, 3)))
    fused = fused_step.make_fused_step_fn(ot, has_colliders=has_coll,
                                          device="cpu")

    s_ref, s_pal, s_plain = sj, sj, st
    for _ in range(3):
        s_ref = ref(s_ref, cj)
        s_pal = pal_step(s_pal, cj)
        s_plain = fused(pt, col_t, s_plain, ct, T(rest_b))
    assert int(np.asarray(s_pal.telemetry)[:, 3].sum()) == 0   # no escapes
    for name, s in (("jax make_step_fn", s_ref), ("jax pallas", s_pal)):
        np.testing.assert_allclose(s_plain.x.numpy(), np.asarray(s.x),
                                   atol=3e-5, err_msg=f"x vs {name}")
        np.testing.assert_allclose(s_plain.v.numpy(), np.asarray(s.v),
                                   atol=3e-5 * 50, err_msg=f"v vs {name}")
        np.testing.assert_array_equal(s_plain.telemetry.numpy()[:, :3],
                                      np.asarray(s.telemetry)[:, :3])
    if case == "finger_collider":
        assert float(np.abs(np.asarray(s_ref.finger_forces)).max()) > 0.0
        np.testing.assert_allclose(s_plain.finger_forces.numpy(),
                                   np.asarray(s_ref.finger_forces),
                                   rtol=2e-3, atol=1.0)
    if case == "static_collider":
        assert float(s_plain.x[..., 2].min()) > -0.02   # no tunnelling


def test_pusher_margin_matches_jax():
    """tests/test_pallas_step.py:234 (test_pusher_margin): a 0.06 m box
    tool at 4 mm voxels as the one finger with ``use_pusher`` (the 1 mm
    margin on the dynamic collider), its bottom face 1.5 mm above the rope
    and descending at 0.2 m/s; two control steps of the port's fused step
    against the JAX ``make_step_fn`` within 5e-5 on positions."""
    pj, pt, x0 = rope_params()
    B, n = 1, x0.shape[0]
    okw = dict(n_fingers=1, use_pusher=True)
    oj, ot = small_opts(jsm, **okw), small_opts(tsm, **okw)
    cj, ct = controls(B, 1, eef_xyz=(0.2, 0.0, 0.0815),
                      eef_vel=(0.0, 0.0, -0.2))
    colj, fingers, _, table, _ = box_collider((0.06, 0.06, 0.06), 0.004,
                                              finger=True)
    col_t = tsm.MeshColliderSet(fingers=fingers, finger_pose_table=T(table),
                                statics=(),
                                static_pose=torch.zeros((B, 0, 4, 4)))
    step_j = jsm.make_step_fn(oj, has_colliders=True)
    ref = jax.jit(jax.vmap(lambda sm, c: step_j(pj, colj, sm, c)))
    fused = fused_step.make_fused_step_fn(ot, has_colliders=True,
                                          device="cpu")
    s_ref = jsm.SpringMassState(x=jnp.asarray(x0[None]),
                                v=jnp.zeros((B, n, 3)),
                                finger_forces=jnp.zeros((B, 1, 3)))
    s_port = tsm.SpringMassState(x=T(x0[None]), v=torch.zeros((B, n, 3)),
                                 finger_forces=torch.zeros((B, 1, 3)))
    # the same step with the fingers' 5 mm margin: the pusher's margin
    # must change the result (the tool reaches the rope)
    finger = fused_step.make_fused_step_fn(
        dataclasses.replace(ot, use_pusher=False), has_colliders=True,
        device="cpu")
    s_finger = s_port
    for _ in range(2):
        s_ref = ref(s_ref, cj)
        s_port = fused(pt, col_t, s_port, ct, T(x0[None]))
        s_finger = finger(pt, col_t, s_finger, ct, T(x0[None]))
    assert float((s_port.x - s_finger.x).abs().max()) > 1e-4
    np.testing.assert_allclose(s_port.x.numpy(), np.asarray(s_ref.x),
                               atol=5e-5)
    np.testing.assert_allclose(s_port.v.numpy(), np.asarray(s_ref.v),
                               atol=5e-5 * 50)


def dense_tables(n: int, D: int, seed: int):
    """Random (n, D) neighbour tables as ``freeze`` makes them: slot ids,
    rest lengths, stiffness and damping, about a third of the slots
    inactive (0, 0; padding: own id, rest 1), some stiffness-only and
    damping-only slots, and particles 0 and n // 2 with no springs."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, D))
    rest = rng.uniform(0.005, 0.02, (n, D)).astype(np.float32)
    k = rng.uniform(1e3, 1e4, (n, D)).astype(np.float32)
    c = np.full((n, D), 100.0, np.float32)
    off = rng.random((n, D)) < 0.35
    off[[0, n // 2]] = True
    k[off], c[off] = 0.0, 0.0
    idx[off] = np.arange(n)[:, None].repeat(D, 1)[off]
    rest[off] = 1.0
    k[rng.random((n, D)) < 0.05] = 0.0           # damping only
    c[(rng.random((n, D)) < 0.05) & (k > 0)] = 0.0   # stiffness only
    return (torch.as_tensor(idx), torch.as_tensor(rest), torch.as_tensor(k),
            torch.as_tensor(c))


@pytest.mark.parametrize("n", [300, 1500])
def test_spring_records_hold_the_active_slots(n):
    """K3's compacted table: exactly the slots with stiffness or damping
    nonzero (the slots the kernel does not skip), in ascending slot order
    per particle, with their neighbour, stiffness, damping and rest; a
    particle without springs has an empty row. n 1500 is over the
    kernel's 1024 threads (a thread takes two particles)."""
    D = 12
    idx, rest, k, c = dense_tables(n, D, seed=n)
    rec = fused_step.spring_records(idx, rest, k, c)
    active = ((k != 0) | (c != 0)).numpy()
    rp = rec.row_ptr.numpy()
    assert rec.row_ptr.dtype == torch.int32 and rp[0] == 0
    np.testing.assert_array_equal(np.diff(rp), active.sum(1))
    assert rp[1] == rp[0] and rp[n // 2 + 1] == rp[n // 2]
    r = rec.records
    assert r.dtype == torch.float32 and tuple(r.shape) == (rp[-1], 4)
    j = r[:, 0].contiguous().view(torch.int32).numpy()
    for i in (1, n // 3, n - 1):
        slots = np.nonzero(active[i])[0]
        rows = slice(rp[i], rp[i + 1])
        np.testing.assert_array_equal(rec.slot.numpy()[rows], i * D + slots)
        np.testing.assert_array_equal(j[rows], idx.numpy()[i, slots])
        for q, t in ((1, k), (2, c), (3, rest)):
            np.testing.assert_array_equal(r[rows, q].numpy(),
                                          t.numpy()[i, slots])
    i_all, d_all = np.nonzero(active)
    np.testing.assert_array_equal(rec.slot.numpy(), i_all * D + d_all)


def test_record_spring_force_is_the_dense_force():
    """The spring + dashpot force over the compacted records is the dense
    plain force (``spring_mass.spring_forces``) exactly."""
    n, D, B = 1500, 12, 2
    idx, rest, k, c = dense_tables(n, D, seed=7)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(scale=0.05, size=(B, n, 3)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.normal(scale=0.1, size=(B, n, 3)),
                        dtype=torch.float32)
    tab = tsm.StepTables(masses=torch.ones(n), nbr_idx=idx, nbr_rest=rest,
                         nbr_k=k, nbr_c=c, scal=torch.zeros(8),
                         telemetry=torch.zeros((B, 4), dtype=torch.int32))
    dense = tsm.spring_forces(tab, x, v)
    rec = fused_step.spring_records(idx, rest, k, c)
    assert float(dense.abs().max()) > 0.0
    assert torch.equal(fused_step.spring_forces_records(rec, x, v, D), dense)


def test_fused_step_rejects_bad_state():
    _, pt, x0 = rope_params()
    ot = small_opts(tsm)
    _, ct = controls(1, 1)
    st = tsm.SpringMassState(x=T(x0[None]).double(),
                             v=torch.zeros((1, 40, 3), dtype=torch.float64),
                             finger_forces=torch.zeros((1, 1, 3)))
    with pytest.raises(ValueError):
        fused_step.make_fused_step_fn(ot, False, device="cpu")(
            pt, None, st, ct, T(x0[None]))


def finger_tables():
    """Frozen tables of the finger-collider case with self-collision."""
    _, pt, x0 = rope_params()
    ot = small_opts(tsm, n_fingers=1, self_collision=True)
    _, fingers, _, table, _ = box_collider((0.04, 0.04, 0.08), 0.003,
                                           finger=True)
    col = tsm.MeshColliderSet(fingers=fingers, finger_pose_table=T(table),
                              statics=(), static_pose=torch.zeros((1, 0, 4, 4)))
    _, ct = controls(1, 1, eef_xyz=(0.2, 0.0, 0.0455))
    st = tsm.SpringMassState(x=T(x0[None]), v=torch.zeros((1, 40, 3)),
                             finger_forces=torch.zeros((1, 1, 3)))
    return ot, tsm.freeze(pt, ot, col, st, ct, T(x0[None])), st


def _drop_last(t):
    return t[..., :-1].contiguous()


BAD_TABLES = {
    "nbr_k": lambda tab, st: (dataclasses.replace(
        tab, nbr_k=_drop_last(tab.nbr_k)), st),
    "sc_idx": lambda tab, st: (dataclasses.replace(
        tab, sc_idx=tab.sc_idx[:, :-1]), st),
    "pose": lambda tab, st: (dataclasses.replace(
        tab, pose=_drop_last(tab.pose)), st),
    "dyn_lin": lambda tab, st: (dataclasses.replace(
        tab, dyn_lin=torch.zeros((1, 2, 3))), st),
    "finger_forces": lambda tab, st: (tab, dataclasses.replace(
        st, finger_forces=torch.zeros((1, 3, 3)))),
}


@pytest.mark.parametrize("field", list(BAD_TABLES))
def test_fused_step_rejects_bad_tables(field):
    opts, tab, st = finger_tables()
    out = fused_step.spring_mass_step(opts, tab, st)   # the good tables run
    assert bool(torch.isfinite(out.x).all())
    bad_tab, bad_st = BAD_TABLES[field](tab, st)
    with pytest.raises(ValueError, match=field):
        fused_step.spring_mass_step(opts, bad_tab, bad_st)


# ---------------------------------------------------------------------------
# grasp machine + control build (1e-6)
# ---------------------------------------------------------------------------


def test_grasp_and_ctrl_builder():
    rng = np.random.default_rng(4)
    B = 6
    table = np.tile(np.eye(4, dtype=np.float32), (2, 101, 1, 1))
    table[0, :, 1, 3] = np.linspace(0.0, 0.04, 101)
    table[1, :, 1, 3] = -np.linspace(0.0, 0.04, 101)
    cur = rng.uniform(0, 1, B).astype(np.float32)
    grasped = np.array([0, 1, 1, 0, 1, 0], bool)
    init = np.array([0, 1, 1, 1, 1, 1], bool)
    forces = rng.uniform(0, 5e4, (B, 2, 3)).astype(np.float32)
    forces[3] = 0.0
    cmd = rng.uniform(0, 1, B).astype(np.float32)
    R = np.asarray(jax.vmap(lambda a: jnp.eye(3))(jnp.zeros(B)))
    xyz = rng.normal(size=(B, 3)).astype(np.float32)
    vel = rng.normal(size=(B, 3)).astype(np.float32)
    rvel = rng.normal(size=(B, 3)).astype(np.float32)
    cent = rng.normal(scale=0.01, size=(2, 3)).astype(np.float32)
    opts_j, opts_t = jsm.PhysicsOptions(), tsm.PhysicsOptions()
    build_j = jdyn.make_ctrl_builder(opts_j, 3e4)
    build_t = tdyn.make_ctrl_builder(opts_t, 3e4)
    colj = jsm.MeshColliderSet(fingers=(), finger_pose_table=jnp.asarray(table),
                               statics=(), static_pose=jnp.zeros((0, 4, 4)))
    outs_j = [build_j(colj, jsm.SpringMassState(
        x=None, v=None, finger_forces=jnp.asarray(forces[b])),
        jdyn.GraspState(current_openness=jnp.asarray(cur[b]),
                        grasped=jnp.asarray(grasped[b]),
                        initialized=jnp.asarray(init[b])),
        jnp.asarray(xyz[b]), jnp.asarray(R[b]), jnp.asarray(vel[b]),
        jnp.asarray(rvel[b]), jnp.asarray(cmd[b]), jnp.asarray(cent))
        for b in range(B)]
    colt = tsm.MeshColliderSet(fingers=(), finger_pose_table=T(table),
                               statics=(), static_pose=torch.zeros((B, 0, 4, 4)))
    ctrl_t, grasp_t, o_end_t = build_t(
        colt, tsm.SpringMassState(x=None, v=None, finger_forces=T(forces)),
        tdyn.GraspState(current_openness=T(cur), grasped=T(grasped),
                        initialized=T(init)),
        T(xyz), T(R), T(vel), T(rvel), T(cmd), T(cent))
    for b, (cj, gj, oj) in enumerate(outs_j):
        for f in ("openness_start", "openness_end", "dyn_lin_vel",
                  "dyn_omega"):
            np.testing.assert_allclose(getattr(ctrl_t, f)[b].numpy(),
                                       np.asarray(getattr(cj, f)), atol=1e-6,
                                       err_msg=f)
        assert bool(grasp_t.grasped[b]) == bool(gj.grasped)
        np.testing.assert_allclose(float(grasp_t.current_openness[b]),
                                   float(gj.current_openness), atol=1e-6)
        np.testing.assert_allclose(float(o_end_t[b]), float(oj), atol=1e-6)
