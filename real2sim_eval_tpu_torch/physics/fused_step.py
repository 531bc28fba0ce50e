"""Spring-mass control step K3: the whole substep loop in one CUDA launch.

Counterpart of the JAX package's physics/pallas_step.py
(``make_pallas_step_fn``). The per-control-step freezes stay plain
PyTorch (``spring_mass.freeze``), as they stay XLA outside the Pallas
kernel; ``spring_mass_step`` then runs every substep: the hand-written
kernel (``csrc/spring_mass_step.cu``, a cluster of two CTAs per env) for
tensors on the card, ``spring_mass.run_substeps_plain`` for tensors on the
CPU.

The kernel walks a compacted spring table (``spring_records``): per
particle, the neighbour slots whose stiffness or damping is nonzero, one
16-byte record {j, k, c, rest} each, in ascending slot order. The table
depends only on the episode's parameters, so ``make_fused_step_fn``
builds it once and every control step reuses it.

The TPU design's SDF patches, rolled spring tables and RCM permutation are
Mosaic workarounds for the missing gather and are not carried: the kernel
gathers neighbours from shared memory and samples whole SDF grids, so the
``patch_escapes`` telemetry lane is 0 by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import ext
from ..utils.device import resolve_device
from ..utils.profiling import count, counting, span, spanned
from .spring_mass import (PhysicsOptions, SpringMassState, StepTables,
                          check_state_device, freeze, run_substeps_plain)


MAX_COLLIDERS = 8      # kMaxColliders of csrc/spring_mass_step.cu
# the kernel's shared memory per CTA (the card's 227 KB less its static
# 1,056 bytes): 15 N + 3 M + 4 PM words
MAX_SHARED_BYTES = 232448 - 1056
# CTAs per env of the main path's launch: 2 (a thread-block cluster), or 1,
# which gives bitwise the same step (chip_smoke.py holds the two together)
K3_RANKS = 2


@dataclasses.dataclass(frozen=True)
class SpringRecords:
    """The compacted spring table of K3's phase A.

    row_ptr (N + 1,) i32: particle i's records are [row_ptr[i],
    row_ptr[i + 1]); records (R, 4) f32: {j (i32 bits), stiffness, damping,
    rest length}, one per slot with stiffness or damping nonzero (the
    slots the dense loop does not skip), in ascending slot order per
    particle; slot (R,) i64: each record's slot in the dense (N, D) table."""

    row_ptr: torch.Tensor
    records: torch.Tensor
    slot: torch.Tensor


def spring_records(nbr_idx: torch.Tensor, nbr_rest: torch.Tensor,
                   nbr_k: torch.Tensor, nbr_c: torch.Tensor) -> SpringRecords:
    """The records of the (N, D) neighbour tables (synchronises once, for
    the record count)."""
    N, D = nbr_k.shape
    active = (nbr_k != 0) | (nbr_c != 0)
    row_ptr = torch.zeros(N + 1, dtype=torch.int32, device=nbr_k.device)
    row_ptr[1:] = torch.cumsum(active.sum(1), 0)
    i, d = active.nonzero(as_tuple=True)       # row-major: i, then slot
    j = nbr_idx[i, d].to(torch.int32)
    rec = torch.stack([j.view(torch.float32), nbr_k[i, d], nbr_c[i, d],
                       nbr_rest[i, d]], dim=1).contiguous()
    return SpringRecords(row_ptr=row_ptr, records=rec, slot=i * D + d)


def spring_forces_records(rec: SpringRecords, x: torch.Tensor,
                          v: torch.Tensor, D: int) -> torch.Tensor:
    """Per-particle spring + dashpot force (B, N, 3) from the records, in
    plain PyTorch: each record's term by ``spring_mass.spring_forces``'
    operations, placed at its dense slot (an inactive slot adds 0) and
    summed over slots as that function sums them."""
    B, N, _ = x.shape
    i = rec.slot // D
    j = rec.records[:, 0].contiguous().view(torch.int32).long()
    kk, cc, rest = (rec.records[:, q] for q in (1, 2, 3))
    dis = x[:, j] - x[:, i]
    dis_len = torch.sqrt((dis * dis).sum(-1))
    d = dis / torch.clamp(dis_len, min=1e-6)[..., None]
    spring_f = (kk * (dis_len / rest - 1.0))[..., None] * d
    v_rel = ((v[:, j] - v[:, i]) * d).sum(-1)
    dashpot_f = (cc * v_rel)[..., None] * d
    terms = torch.zeros((B, N * D, 3), dtype=x.dtype, device=x.device)
    terms[:, rec.slot] = spring_f + dashpot_f
    return terms.reshape(B, N, D, 3).sum(2)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _expect(name: str, t: torch.Tensor, shape: tuple, dev: torch.device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")


def check_tables(opts: PhysicsOptions, tab: StepTables,
                 state: SpringMassState) -> None:
    """Raise ValueError unless ``tab`` and ``state`` have the shapes the
    substep loop reads (both versions index through them unchecked)."""
    x = state.x
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B, N, 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, N, _ = x.shape
    dev = x.device
    _expect("v", state.v, x.shape, dev)
    _expect("masses", tab.masses, (N,), dev)
    D = tab.nbr_idx.shape[-1]
    for name in ("nbr_idx", "nbr_rest", "nbr_k", "nbr_c"):
        _expect(name, getattr(tab, name), (N, D), dev)
    if tab.records is not None:
        _expect("row_ptr", tab.records.row_ptr, (N + 1,), dev)
        _expect("records", tab.records.records,
                (tab.records.records.shape[0], 4), dev)
    _expect("scal", tab.scal, (8,), dev)
    _expect("telemetry", tab.telemetry, (B, 4), dev)
    if tab.sc_sel is not None:
        M, Ks = tab.sc_sel.shape[-1], tab.sc_idx.shape[-1]
        _expect("sc_sel", tab.sc_sel, (B, M), dev)
        _expect("sc_msel", tab.sc_msel, (B, M), dev)
        for name in ("sc_idx", "sc_ok", "sc_invm"):
            _expect(name, getattr(tab, name), (B, M, Ks), dev)
    F = state.finger_forces.shape[1]
    if tab.cand is not None:
        PM = tab.cand.shape[1]
        C = tab.pose.shape[2]
        n_f = tab.n_f
        _expect("cand", tab.cand, (B, PM), dev)
        _expect("cand_ok", tab.cand_ok, (B, PM), dev)
        _expect("pose", tab.pose, (B, opts.num_substeps, C, 24), dev)
        _expect("dyn_lin", tab.dyn_lin, (B, max(n_f, 1), 3), dev)
        _expect("dyn_omega", tab.dyn_omega, (B, 3), dev)
        _expect("finger_forces", state.finger_forces, (B, max(n_f, 1), 3),
                dev)
        combo = tab.combo
        dims = np.asarray(combo["dims"])
        if dims.shape != (C, 3) or n_f > C:
            raise ValueError(f"{C} colliders posed, {dims.shape[0]} grids, "
                             f"{n_f} fingers")
        _expect("origin", combo["origin"], (C, 3), dev)
        _expect("inv_spacing", combo["inv_spacing"], (C,), dev)
        _expect("cell_offset", combo["cell_offset"], (C,), dev)
        _expect("dims_i32", combo["dims_i32"], (C, 3), dev)
        cells = int(np.prod(dims - 1, axis=1).sum())
        _expect("corners", combo["corners"], (cells, 8), dev)
    else:
        _expect("finger_forces", state.finger_forces, (B, F, 3), dev)


@spanned("K3 spring_mass_step")
def spring_mass_step(opts: PhysicsOptions, tab: StepTables,
                     state: SpringMassState, ranks: int | None = None,
                     drift_ns: int = 0) -> SpringMassState:
    """Run all ``opts.num_substeps`` substeps over the frozen tables.

    On the card ``ranks`` (default ``K3_RANKS``) picks the launch: one CTA
    per env, or a cluster of two; ``drift_ns`` > 0 delays the cluster's
    CTAs against each other at every phase boundary (the drift test of
    chip_smoke.py), which must not change the result."""
    check_tables(opts, tab, state)
    x = state.x
    if x.device.type != "cuda":
        return run_substeps_plain(opts, tab, state)

    B, N, _ = x.shape
    dev = x.device
    if tab.cand is not None and tab.pose.shape[2] > MAX_COLLIDERS:
        raise ValueError(f"the kernel takes at most {MAX_COLLIDERS} "
                         f"colliders, got {tab.pose.shape[2]}")
    M = tab.sc_sel.shape[1] if tab.sc_sel is not None else 0
    PM = tab.cand.shape[1] if tab.cand is not None else 0
    if 4 * (15 * N + 3 * M + 4 * PM) > MAX_SHARED_BYTES:
        raise ValueError(f"{N} particles, {M} self-collision rows and {PM} "
                         f"contact slots exceed the kernel's shared memory")
    rec = tab.records
    if rec is None:
        rec = spring_records(tab.nbr_idx, tab.nbr_rest, tab.nbr_k, tab.nbr_c)
    empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
    if tab.sc_sel is not None:
        sc = (_i32(tab.sc_sel), _i32(tab.sc_idx), _i32(tab.sc_ok),
              tab.sc_invm.contiguous(), tab.sc_msel.contiguous())
    else:
        z = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        sc = (z, torch.zeros((B, 0, 1), dtype=torch.int32, device=dev),
              torch.zeros((B, 0, 1), dtype=torch.int32, device=dev),
              torch.zeros((B, 0, 1), dtype=torch.float32, device=dev),
              torch.zeros((B, 0), dtype=torch.float32, device=dev))
    if tab.cand is not None:
        pm = tab.cand.shape[1]
        c_inv = torch.full((B, N), -1, dtype=torch.int64, device=dev)
        c_inv.scatter_(1, tab.cand, torch.arange(
            pm, device=dev).expand(B, pm))
        combo = tab.combo
        contact = (_i32(c_inv), _i32(tab.cand_ok), tab.pose,
                   tab.dyn_lin.contiguous(), tab.dyn_omega.contiguous(),
                   combo["corners"].contiguous(),
                   combo["origin"].contiguous(),
                   combo["inv_spacing"].contiguous(), combo["dims_i32"],
                   combo["cell_offset"])
    else:
        contact = (torch.full((B, N), -1, dtype=torch.int32, device=dev),
                   torch.zeros((B, 0), dtype=torch.int32, device=dev),
                   empty_f, torch.zeros((B, 1, 3), device=dev),
                   torch.zeros((B, 3), device=dev), empty_f, empty_f,
                   empty_f, torch.zeros(0, dtype=torch.int32, device=dev),
                   torch.zeros(0, dtype=torch.int64, device=dev))
    x_out = torch.empty_like(x)
    v_out = torch.empty_like(x)
    ff_out = torch.empty_like(state.finger_forces)
    gz = float(np.float32(-9.8) * np.float32(opts.reverse_factor))
    ext.load().spring_mass_step(
        x.contiguous(), state.v.contiguous(), tab.masses.contiguous(),
        rec.row_ptr, rec.records, tab.scal, *sc, *contact, int(tab.n_f),
        int(opts.num_substeps), float(opts.dt), gz,
        float(opts.reverse_factor), float(opts.ground_height),
        float(opts.collision_dist), bool(opts.use_pusher),
        int(K3_RANKS if ranks is None else ranks), int(drift_ns), x_out,
        v_out, ff_out)
    ext.LAUNCHES["spring_mass_step"] += 1
    return SpringMassState(x=x_out, v=v_out, finger_forces=ff_out,
                           telemetry=tab.telemetry)


def count_tables(tab: StepTables) -> None:
    """The control step's counters (``utils.profiling.count``), from its
    frozen tables: its env-steps, those in which one of K3's caps dropped
    work (telemetry above 0), and its live contact slots and self-collision
    rows, summed on the card."""
    count("env_steps", tab.telemetry.shape[0])
    count("capped_env_steps", (tab.telemetry > 0).any(1).sum())
    if tab.cand_ok is not None:
        count("contact_slots", tab.cand_ok.sum())
    if tab.sc_ok is not None:
        count("self_rows", tab.sc_ok.any(-1).sum())


def make_fused_step_fn(opts: PhysicsOptions, has_colliders: bool = True,
                       device="cuda"):
    """Fused control step ``step(params, colliders, state, ctrl, rest_x)``:
    the freezes, then K3. Built for the CPU, it runs K3's plain version
    and is the batched twin of the JAX ``make_step_fn``. On the card the
    spring records are built at the first step of a ``params`` and reused
    while the same object comes back."""
    dev = resolve_device(device)
    cache = {"params": None, "records": None}

    def step(params, colliders, state, ctrl, rest_x):
        check_state_device(state, dev)
        with span("freezes"):
            tab = freeze(params, opts, colliders if has_colliders else None,
                         state, ctrl, rest_x)
        if counting():
            count_tables(tab)
        if dev.type == "cuda":
            if cache["params"] is not params:
                cache.update(params=params, records=spring_records(
                    tab.nbr_idx, tab.nbr_rest, tab.nbr_k, tab.nbr_c))
            tab = dataclasses.replace(tab, records=cache["records"])
        return spring_mass_step(opts, tab, state)

    return step
