"""Spring-mass soft-body control step, batched over envs.

Counterpart of the JAX package's physics/spring_mass.py (which carries
the reference citations). A control step is two parts:

  1. once-per-control-step freezes (``freeze``): self-collision candidate
     slots, contact-candidate particles and the per-substep collider poses,
     collected in ``StepTables``;
  2. the ``num_substeps`` substep loop over those tables: in plain PyTorch
     ops here (``run_substeps_plain``), in the CUDA kernel K3 on the card.
     ``fused_step.make_fused_step_fn`` joins the two parts; built for the
     CPU it is the batched twin of the JAX ``make_step_fn``.

Reference quirks kept: with colliders, positions advance by v*dt in the
contact phase AND again in the ground integration (an effective 2x dt);
finger forces hold the last substep's contact forces; only the frozen
contact candidates run the contact math, everyone else only advects.
Every tensor here carries a leading env dim B unless noted "shared".
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import transforms as tf
from .multi_sdf import combine_grids, multi_sdf_query


@dataclasses.dataclass(frozen=True)
class PhysicsOptions:
    """Static physics configuration (cfg/physics/default.yaml)."""

    dt: float = 5e-5
    num_substeps: int = 667
    fps: float = 30.0
    dashpot_damping: float = 100.0
    drag_damping: float = 3.0
    spring_Y_min: float = 0.0
    spring_Y_max: float = 1e5
    collision_dist: float = 0.005
    reverse_factor: float = 1.0
    self_collision: bool = True
    max_candidates: int = 32
    candidate_chunk: int = 256
    use_pusher: bool = False
    n_fingers: int = 2
    ground_height: float = 0.0
    max_self_pairs: int = 2048
    max_contact_particles: int = 512
    max_self_particles: int = 256
    max_self_slots: int = 8


@dataclasses.dataclass(frozen=True)
class SpringMassParams:
    """Per-episode arrays, shared by the envs of a batch."""

    springs: torch.Tensor          # (S, 2) i32
    rest_lengths: torch.Tensor     # (S,)
    spring_Y_log: torch.Tensor     # (S,)
    masses: torch.Tensor           # (N,)
    nbr_idx: torch.Tensor          # (N, D) i32 neighbour ids (pad: self)
    nbr_rest: torch.Tensor         # (N, D) rest lengths (pad: 1)
    nbr_Y_log: torch.Tensor        # (N, D) log stiffness (pad: -inf)
    collision_mask: torch.Tensor   # (N,) i32
    rest_x: torch.Tensor           # (N, 3) or per env (B, N, 3)
    collide_elas: torch.Tensor     # () f32
    collide_fric: torch.Tensor
    collide_eef_elas: torch.Tensor
    collide_eef_fric: torch.Tensor
    collide_self_elas: torch.Tensor
    collide_self_fric: torch.Tensor
    # (N, N) bool: same collision group or resting pair (episode constant)
    cand_invalid: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class MeshColliderSet:
    """Dynamic fingers + static meshes as SDF grids (fingers first).
    ``finger_pose_table``: (n_fingers, 101, 4, 4) link->eef pose per
    openness sample; ``static_pose``: (B, n_statics, 4, 4)."""

    fingers: tuple
    finger_pose_table: torch.Tensor
    statics: tuple
    static_pose: torch.Tensor

    def replace(self, **kw) -> "MeshColliderSet":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SubstepControls:
    """Per-control-step command (leading env dim B)."""

    eef_xyz: torch.Tensor        # (B, 3)
    eef_vel: torch.Tensor        # (B, 3)
    eef_rot: torch.Tensor        # (B, 3, 3)
    eef_rot_vel: torch.Tensor    # (B, 3) axis-angle rate
    openness_start: torch.Tensor  # (B,)
    openness_end: torch.Tensor   # (B,)
    dyn_lin_vel: torch.Tensor    # (B, n_fingers, 3)
    dyn_omega: torch.Tensor      # (B, 3)


@dataclasses.dataclass(frozen=True)
class SpringMassState:
    x: torch.Tensor               # (B, N, 3)
    v: torch.Tensor               # (B, N, 3)
    finger_forces: torch.Tensor   # (B, n_fingers, 3) last-substep forces
    # (B, 4) i32 saturation counters of the last control step: self
    # candidates dropped, self particles dropped, contact particles
    # dropped, SDF patch escapes (0: the CUDA step samples whole grids)
    telemetry: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class StepTables:
    """Everything the substep loop reads, frozen for one control step."""

    masses: torch.Tensor          # shared (N,)
    nbr_idx: torch.Tensor         # shared (N, D) i64
    nbr_rest: torch.Tensor        # shared (N, D)
    nbr_k: torch.Tensor           # shared (N, D) clipped stiffness, 0 inactive
    nbr_c: torch.Tensor           # shared (N, D) dashpot damping, 0 inactive
    scal: torch.Tensor            # (8,) elas/fric ground, eef, self; decay
    telemetry: torch.Tensor       # (B, 4) i32
    sc_sel: torch.Tensor | None = None    # (B, M) i64
    sc_idx: torch.Tensor | None = None    # (B, M, Ks) i64
    sc_ok: torch.Tensor | None = None     # (B, M, Ks) bool
    sc_invm: torch.Tensor | None = None   # (B, M, Ks) 1/m_i + 1/m_j
    sc_msel: torch.Tensor | None = None   # (B, M) m_i
    cand: torch.Tensor | None = None      # (B, PM) i64 contact candidates
    cand_ok: torch.Tensor | None = None   # (B, PM) bool
    pose: torch.Tensor | None = None      # (B, S, C, 24) [Tinv|R|centre]
    dyn_lin: torch.Tensor | None = None   # (B, max(n_f, 1), 3)
    dyn_omega: torch.Tensor | None = None  # (B, 3)
    combo: dict | None = None             # combine_grids table
    n_f: int = 0
    # the kernel's compacted spring table (fused_step.SpringRecords), built
    # once per SpringMassParams by make_fused_step_fn; None: built per call
    records: object | None = None


# ---------------------------------------------------------------------------
# once-per-control-step freezes
# ---------------------------------------------------------------------------


def _norm3(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d * d).sum(-1))


def static_candidate_invalid(params: SpringMassParams, opts: PhysicsOptions,
                             rest_x: torch.Tensor) -> torch.Tensor:
    """(..., N, N) bool: same collision group or resting pair."""
    if params.cand_invalid is not None:
        return params.cand_invalid
    same = params.collision_mask[:, None] == params.collision_mask[None, :]
    d0 = _norm3(rest_x[..., :, None, :] - rest_x[..., None, :, :])
    return same | (d0 < opts.collision_dist * 5.0)


def build_candidate_slots(params: SpringMassParams, opts: PhysicsOptions,
                          x: torch.Tensor, rest_x: torch.Tensor):
    """Self-collision slot table: the kp nearest valid candidates of every
    particle (ties to the lower index), then the M particles with the
    nearest active candidate. Validity: other collision group, not a
    resting pair, within collision_dist.

    Returns (sel (B, M) i64, slot_idx (B, M, kp) i64, slot_ok (B, M, kp)
    bool, n_drop_cand (B,) i32, n_drop_part (B,) i32)."""
    B, n, _ = x.shape
    kp = min(opts.max_self_slots, n)
    m = min(opts.max_self_particles, n)
    inv_static = static_candidate_invalid(params, opts, rest_x)
    d = _norm3(x[:, :, None, :] - x[:, None, :, :])               # (B, N, N)
    invalid = inv_static | (d >= opts.collision_dist)
    sc = torch.where(invalid, torch.full_like(d, float("inf")), d)
    n_valid = (~invalid).sum(-1)
    slot_d, slot_idx = torch.sort(sc, dim=-1, stable=True)
    slot_d, slot_idx = slot_d[..., :kp], slot_idx[..., :kp]
    n_drop_cand = torch.clamp(n_valid - kp, min=0).sum(-1).to(torch.int32)
    slot_ok = torch.isfinite(slot_d)

    dsel, sel = torch.sort(slot_d[..., 0], dim=-1, stable=True)
    dsel, sel = dsel[:, :m], sel[:, :m]
    n_active = torch.isfinite(slot_d[..., 0]).sum(-1)
    n_drop_part = torch.clamp(n_active - m, min=0).to(torch.int32)
    gi = sel[..., None].expand(B, m, kp)
    return (sel, torch.gather(slot_idx, 1, gi),
            torch.gather(slot_ok, 1, gi) & torch.isfinite(dsel)[..., None],
            n_drop_cand, n_drop_part)


def interp_finger_pose(table: torch.Tensor, openness: torch.Tensor):
    """Lerp the (F, 101, 4, 4) pose table at openness (...) in [0, 1].
    Returns (..., F, 4, 4)."""
    u = torch.clamp(openness, 0.0, 1.0) * 100.0
    i0 = torch.clamp(torch.floor(u).long(), 0, 99)
    frac = (u - i0.to(u.dtype))[..., None, None, None]
    t0 = table[:, i0].movedim(0, -3)
    t1 = table[:, i0 + 1].movedim(0, -3)
    return t0 * (1.0 - frac) + t1 * frac


def substep_pose_tables(opts: PhysicsOptions, colliders: MeshColliderSet,
                        ctrl: SubstepControls):
    """Every substep's collider poses, vectorized over substeps.
    Returns T_all (B, S, C, 4, 4) (fingers then statics), Tinv_all, and the
    eef centre (B, S, 3)."""
    n = opts.num_substeps
    dev, dt = ctrl.eef_xyz.device, ctrl.eef_xyz.dtype
    frac = (torch.arange(n, dtype=dt, device=dev) + 1.0) / n
    t_sub = frac * (n * opts.dt)
    eef_xyz_s = ctrl.eef_xyz[:, None] + ctrl.eef_vel[:, None] * t_sub[:, None]
    rot_delta = tf.axis_angle_to_rot(ctrl.eef_rot_vel[:, None]
                                     * t_sub[:, None])
    eef_rot_s = rot_delta.transpose(-1, -2) @ ctrl.eef_rot[:, None]
    T_eef = tf.make_se3(eef_rot_s, eef_xyz_s)                     # (B, S, 4, 4)
    parts = []
    if len(colliders.fingers):
        openness_s = (ctrl.openness_start[:, None]
                      + (ctrl.openness_end - ctrl.openness_start)[:, None]
                      * frac)
        T_fe = interp_finger_pose(colliders.finger_pose_table, openness_s)
        parts.append(T_eef[:, :, None] @ T_fe)
    sp = colliders.static_pose
    if sp.shape[-3]:
        parts.append(sp[:, None].expand(-1, n, -1, -1, -1).to(dt))
    T_all = torch.cat(parts, dim=2)
    return T_all, tf.se3_inverse(T_all), eef_xyz_s


def select_contact_particles(opts: PhysicsOptions, combo: dict, x, v, T_all):
    """The ``max_contact_particles`` particles nearest any collider's grid
    box, after a conservative approach: the exact swept displacement of
    each collider over the control step and twice each particle's own
    travel. Returns (cand (B, PM) i64, cand_ok (B, PM) bool,
    n_dropped (B,) i32)."""
    half = (combo["hi"].to(x.dtype)
            / combo["inv_spacing"][:, None]) * 0.5                  # (C, 3)
    center_local = combo["origin"] + half
    R_bound = _norm3(half)
    T0 = T_all[:, 0]                                               # (B, C, 4, 4)
    diff = x[:, None] - T0[:, :, None, :3, 3]                      # (B, C, N, 3)
    p_loc = torch.einsum("bcji,bcnj->bcni", T0[..., :3, :3], diff)
    q = torch.abs(p_loc - center_local[None, :, None]) - half[None, :, None]
    d_box = _norm3(torch.clamp(q, min=0.0))                        # (B, C, N)
    cw = (torch.einsum("bscij,cj->bsci", T_all[..., :3, :3], center_local)
          + T_all[..., :3, 3])                                     # (B, S, C, 3)
    d_tr = _norm3(cw - cw[:, :1])
    tr_rel = (T_all[..., :3, :3] * T_all[:, :1, :, :3, :3]).sum((-1, -2))
    ang = torch.arccos(torch.clamp((tr_rel - 1.0) * 0.5, -1.0, 1.0))
    sweep = (d_tr + ang * R_bound).amax(dim=1)                     # (B, C)
    horizon = opts.num_substeps * opts.dt
    travel = 2.0 * _norm3(v) * horizon                             # (B, N)
    d_adj = (d_box - sweep[:, :, None]).amin(dim=1) - travel
    reach = 0.02 + 0.05
    pm = min(opts.max_contact_particles, x.shape[1])
    d_s, cand = torch.sort(d_adj, dim=-1, stable=True)
    d_s, cand = d_s[:, :pm], cand[:, :pm]
    n_in_reach = (d_adj < reach - 0.05).sum(-1)
    return (cand, d_s < reach,
            torch.clamp(n_in_reach - pm, min=0).to(torch.int32))


def freeze(params: SpringMassParams, opts: PhysicsOptions,
           colliders: MeshColliderSet | None, state: SpringMassState,
           ctrl: SubstepControls, rest_x: torch.Tensor) -> StepTables:
    """Once-per-control-step tables for the substep loop."""
    x, v = state.x, state.v
    B = x.shape[0]
    dev = x.device
    tele = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    Y = torch.exp(params.nbr_Y_log)
    active = Y > opts.spring_Y_min
    zero = torch.zeros_like(Y)
    clip = lambda t, lo, hi: torch.clamp(t, lo, hi)  # noqa: E731
    scal = torch.stack([
        clip(params.collide_elas, 0.0, 1.0), clip(params.collide_fric, 0.0, 2.0),
        clip(params.collide_eef_elas, 0.0, 1.0),
        clip(params.collide_eef_fric, 0.0, 2.0),
        clip(params.collide_self_elas, 0.0, 1.0),
        clip(params.collide_self_fric, 0.0, 2.0),
        torch.exp(torch.full((), -opts.dt * opts.drag_damping,
                             dtype=torch.float32, device=dev)),
        torch.zeros((), dtype=torch.float32, device=dev)]).to(torch.float32)
    kw = dict(
        masses=params.masses, nbr_idx=params.nbr_idx.long(),
        nbr_rest=params.nbr_rest,
        nbr_k=torch.where(active, torch.clamp(Y, opts.spring_Y_min,
                                              opts.spring_Y_max), zero),
        nbr_c=torch.where(active, torch.full_like(Y, opts.dashpot_damping),
                          zero),
        scal=scal)
    if opts.self_collision:
        sel, sidx, sok, n_dc, n_dp = build_candidate_slots(params, opts, x,
                                                           rest_x)
        tele[:, 0] = n_dc
        tele[:, 1] = n_dp
        m = params.masses
        kw.update(sc_sel=sel, sc_idx=sidx, sc_ok=sok,
                  sc_invm=1.0 / m[sel][..., None] + 1.0 / m[sidx],
                  sc_msel=m[sel])
    has_coll = colliders is not None and bool(
        len(colliders.fingers) + len(colliders.statics))
    if has_coll:
        n_f = len(colliders.fingers)
        combo = combine_grids(tuple(colliders.fingers)
                              + tuple(colliders.statics))
        T_all, Tinv_all, center = substep_pose_tables(opts, colliders, ctrl)
        cand, cand_ok, n_dct = select_contact_particles(opts, combo, x, v,
                                                        T_all)
        tele[:, 2] = n_dct
        C = T_all.shape[2]
        pose = torch.cat([
            Tinv_all[..., :3, :4].reshape(*T_all.shape[:3], 12),
            T_all[..., :3, :3].reshape(*T_all.shape[:3], 9),
            center[:, :, None].expand(-1, -1, C, -1)], dim=-1)
        kw.update(cand=cand, cand_ok=cand_ok, pose=pose.contiguous(),
                  dyn_lin=ctrl.dyn_lin_vel[:, :max(n_f, 1)],
                  dyn_omega=ctrl.dyn_omega, combo=combo, n_f=n_f)
    return StepTables(telemetry=tele, **kw)


# ---------------------------------------------------------------------------
# the substep loop, plain PyTorch
# ---------------------------------------------------------------------------


def spring_forces(tab: StepTables, x, v):
    """Per-particle spring + dashpot force through the neighbour table."""
    xj = x[:, tab.nbr_idx]                                         # (B, N, D, 3)
    vj = v[:, tab.nbr_idx]
    dis = xj - x[:, :, None]
    dis_len = _norm3(dis)
    d = dis / torch.clamp(dis_len, min=1e-6)[..., None]
    spring_f = (tab.nbr_k * (dis_len / tab.nbr_rest - 1.0))[..., None] * d
    v_rel = ((vj - v[:, :, None]) * d).sum(-1)
    dashpot_f = (tab.nbr_c * v_rel)[..., None] * d
    return (spring_f + dashpot_f).sum(2)


def velocity_update(tab: StepTables, opts: PhysicsOptions, v, f):
    g = torch.tensor([0.0, 0.0, -9.8], dtype=f.dtype,
                     device=f.device) * opts.reverse_factor
    m = tab.masses[:, None]
    a = (f + m * g) / m
    return (v + a * opts.dt) * tab.scal[6]


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, k), idx (B, ...) -> (B, ..., k)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(t, 1, flat[..., None].expand(-1, -1, t.shape[-1]))
    return out.reshape(*idx.shape, t.shape[-1])


def _scatter_rows(t: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    return t.scatter(1, idx[..., None].expand(-1, -1, t.shape[-1]), src)


def self_collision_slots_impulse(tab: StepTables, opts: PhysicsOptions, x, v):
    """Impulse over the frozen slot table: per particle, the average
    impulse over its hitting candidates (positions at the substep start,
    post-force velocities)."""
    elas, fric = tab.scal[4], tab.scal[5]
    xv = torch.cat([x, v], dim=-1)
    g = _gather_rows(xv, torch.cat([tab.sc_sel[..., None], tab.sc_idx], -1))
    xi, vi = g[:, :, 0, :3], g[:, :, 0, 3:]
    xj, vj = g[:, :, 1:, :3], g[:, :, 1:, 3:]
    dis = xj - xi[:, :, None]
    dis_len = _norm3(dis)
    rel_v = vj - vi[:, :, None]
    hit = (tab.sc_ok & (dis_len < opts.collision_dist)
           & ((dis * rel_v).sum(-1) < -1e-4))
    normal = dis / torch.clamp(dis_len, min=1e-6)[..., None]
    vn_mag = (rel_v * normal).sum(-1)
    v_n = vn_mag[..., None] * normal
    inv_m = tab.sc_invm[..., None]
    impulse_n = -(1.0 + elas) * v_n / inv_m
    v_t = rel_v - v_n
    v_t_len = torch.clamp(_norm3(v_t), min=1e-6)
    a = torch.clamp(1.0 - fric * (1.0 + elas) * torch.abs(vn_mag) / v_t_len,
                    min=0.0)
    impulse_t = (a - 1.0)[..., None] * v_t / inv_m
    J = torch.where(hit[..., None], impulse_n + impulse_t,
                    torch.zeros_like(v_t))
    count = hit.sum(-1).to(x.dtype)
    J_avg = J.sum(2) / torch.clamp(count, min=1.0)[..., None]
    v_sel = torch.where((count > 0)[..., None],
                        vi - J_avg / tab.sc_msel[..., None], vi)
    return _scatter_rows(v, tab.sc_sel, v_sel)


def mesh_collision_multi(tab: StepTables, opts: PhysicsOptions, rows, x, v,
                         ok):
    """SDF contact response of candidate particles against all colliders
    at one substep. rows: (B, C, 24) this substep's pose rows; x, v:
    (B, P, 3); ok: (B, P). Returns (x_out, v_out, finger forces (B, F, 3))."""
    dt = opts.dt
    n_f = tab.n_f
    B, C = rows.shape[:2]
    Tinv = rows[..., :12].reshape(B, C, 3, 4)
    R = rows[..., 12:21].reshape(B, C, 3, 3)
    center = rows[:, 0, 21:24]
    next_x = x + v * dt

    def query(pts, n_c):
        p = ((Tinv[:, :n_c, None, :, :3] * pts[:, None, :, None, :]).sum(-1)
             + Tinv[:, :n_c, None, :, 3])
        dist, nrm_local = multi_sdf_query(tab.combo, p)            # (B, c, P)
        nrm = (R[:, :n_c, None] * nrm_local[..., None, :]).sum(-1)
        return dist, nrm

    D, NRM = query(next_x, C)
    dist, best = torch.min(D, dim=1)                               # (B, P)
    normal = torch.gather(NRM, 1, best[:, None, :, None].expand(
        -1, 1, -1, 3))[:, 0]
    is_dyn = best < n_f
    finger = torch.clamp(best, max=max(n_f - 1, 0))
    in_range = torch.abs(dist) < 0.02
    margin = torch.where(is_dyn & (not opts.use_pusher),
                         torch.full_like(dist, 0.005),
                         torch.full_like(dist, 0.001))
    err = dist - margin
    contact = in_range & (err < 0.0) & ok

    lin = _gather_rows(tab.dyn_lin, finger)                        # (B, P, 3)
    v_surface = lin + torch.linalg.cross(
        tab.dyn_omega[:, None].expand_as(x), x - center[:, None], dim=-1)
    dyn3 = is_dyn[..., None]
    v_rel = torch.where(dyn3, v - v_surface, v)
    elas = torch.where(is_dyn, tab.scal[2], tab.scal[0])
    fric = torch.where(is_dyn, tab.scal[3], tab.scal[1])
    vn_mag = (v_rel * normal).sum(-1)
    v_n = vn_mag[..., None] * normal
    v_t = v_rel - v_n
    v_t_len = torch.clamp(_norm3(v_t), min=1e-6)
    v_n_new = -elas[..., None] * v_n
    a = torch.clamp(1.0 - fric * (1.0 + elas) * torch.abs(vn_mag) / v_t_len,
                    min=0.0)
    v_resp = v_n_new + a[..., None] * v_t
    v_resp = torch.where(dyn3, v_resp + v_surface, v_resp)
    v_new = torch.where(contact[..., None], v_resp, v)

    x_static = next_x - normal * err[..., None]
    next_x2 = x + v_new * dt
    if n_f > 0:
        D2, N2 = query(next_x2, n_f)
        d2 = torch.gather(D2, 1, finger[:, None])[:, 0]
        nrm2 = torch.gather(N2, 1, finger[:, None, :, None].expand(
            -1, 1, -1, 3))[:, 0]
        err2 = d2 - margin
        hit2 = (torch.abs(d2) < 0.02) & (err2 < 0.0)
        x_dyn = torch.where(hit2[..., None], next_x2 - nrm2 * err2[..., None],
                            next_x2)
    else:
        x_dyn = next_x2
    x_out = torch.where(contact[..., None],
                        torch.where(dyn3, x_dyn, x_static), next_x)

    delta_vn = (v_n_new - v_n) / dt
    contrib = torch.where((contact & is_dyn)[..., None], delta_vn,
                          torch.zeros_like(delta_vn))
    if n_f > 0:
        onehot = (finger[:, None] == torch.arange(
            n_f, device=x.device)[None, :, None]).to(x.dtype)      # (B, F, P)
        forces = (onehot[..., None] * contrib[:, None]).sum(2)
    else:
        forces = torch.zeros((B, 1, 3), dtype=x.dtype, device=x.device)
    return x_out, v_new, forces


def ground_collision_integrate(tab: StepTables, opts: PhysicsOptions, x, v):
    """Ground response with time-of-impact integration."""
    rev = opts.reverse_factor
    normal = torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype,
                          device=x.device) * rev
    x_z, v_z = x[..., 2], v[..., 2]
    colliding = (((x_z + v_z * opts.dt) * rev < opts.ground_height)
                 & (v_z * rev < -1e-4))
    elas, fric = tab.scal[0], tab.scal[1]
    vn_mag = (v * normal).sum(-1)
    v_n = vn_mag[..., None] * normal
    v_t = v - v_n
    v_t_len = torch.clamp(_norm3(v_t), min=1e-6)
    v_n_new = -elas * v_n
    a = torch.clamp(1.0 - fric * (1.0 + elas) * torch.abs(vn_mag) / v_t_len,
                    min=0.0)
    v_new = torch.where(colliding[..., None], v_n_new + a[..., None] * v_t, v)
    toi = torch.where(colliding, -(x_z - opts.ground_height) / v_z,
                      torch.zeros_like(x_z))[..., None]
    return x + v * toi + v_new * (opts.dt - toi), v_new


def run_substeps_plain(opts: PhysicsOptions, tab: StepTables,
                       state: SpringMassState,
                       store: torch.dtype | None = None) -> SpringMassState:
    """The substep loop in plain PyTorch ops (the CPU path of K3).
    ``store``: a lower precision that positions and velocities are kept
    in between substeps (the output check's control); None keeps the
    state's own."""
    x, v = state.x, state.v
    forces = torch.zeros_like(state.finger_forces)
    for s in range(opts.num_substeps):
        f = spring_forces(tab, x, v)
        v1 = velocity_update(tab, opts, v, f)
        if tab.sc_sel is not None:
            v1 = self_collision_slots_impulse(tab, opts, x, v1)
        if tab.cand is not None:
            x_adv = x + v1 * opts.dt
            xc_new, vc_new, fc = mesh_collision_multi(
                tab, opts, tab.pose[:, s], _gather_rows(x, tab.cand),
                _gather_rows(v1, tab.cand), tab.cand_ok)
            x = _scatter_rows(x_adv, tab.cand, xc_new)
            v1 = _scatter_rows(v1, tab.cand, vc_new)
            forces = fc.expand_as(forces)
        x, v = ground_collision_integrate(tab, opts, x, v1)
        if store is not None:
            x, v = x.to(store).to(state.x.dtype), v.to(store).to(state.v.dtype)
    return SpringMassState(x=x, v=v, finger_forces=forces.contiguous(),
                           telemetry=tab.telemetry)


def check_state_device(state: SpringMassState, dev: torch.device):
    if state.x.device.type != dev.type:
        raise ValueError(f"state lives on {state.x.device}, the step was "
                         f"built for {dev}")

