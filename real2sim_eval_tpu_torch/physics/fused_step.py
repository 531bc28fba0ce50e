"""Spring-mass control step K3: the whole substep loop in one CUDA launch.

Counterpart of the JAX package's physics/pallas_step.py
(``make_pallas_step_fn``). The per-control-step freezes stay plain
PyTorch (``spring_mass.freeze``), as they stay XLA outside the Pallas
kernel; ``spring_mass_step`` then runs every substep: the hand-written
kernel (``csrc/spring_mass_step.cu``, one CTA per env) for tensors on the
card, ``spring_mass.run_substeps_plain`` for tensors on the CPU.

The TPU design's SDF patches, rolled spring tables and RCM permutation are
Mosaic workarounds for the missing gather and are not carried: the kernel
gathers neighbours from shared memory and samples whole SDF grids, so the
``patch_escapes`` telemetry lane is 0 by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ext
from ..utils.device import resolve_device
from .spring_mass import (PhysicsOptions, SpringMassState, StepTables,
                          check_state_device, freeze, run_substeps_plain)


MAX_COLLIDERS = 8      # kMaxColliders of csrc/spring_mass_step.cu


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
        cells = int(np.prod(dims - 1, axis=1).sum())
        _expect("corners", combo["corners"], (cells, 8), dev)
    else:
        _expect("finger_forces", state.finger_forces, (B, F, 3), dev)


def spring_mass_step(opts: PhysicsOptions, tab: StepTables,
                     state: SpringMassState) -> SpringMassState:
    """Run all ``opts.num_substeps`` substeps over the frozen tables."""
    check_tables(opts, tab, state)
    x = state.x
    if x.device.type != "cuda":
        return run_substeps_plain(opts, tab, state)

    B, N, _ = x.shape
    dev = x.device
    if tab.cand is not None and tab.pose.shape[2] > MAX_COLLIDERS:
        raise ValueError(f"the kernel takes at most {MAX_COLLIDERS} "
                         f"colliders, got {tab.pose.shape[2]}")
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
                   combo["inv_spacing"].contiguous(),
                   torch.as_tensor(np.asarray(combo["dims"]), dtype=torch.int32,
                                   device=dev),
                   combo["cell_offset"].to(torch.int64).contiguous())
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
        _i32(tab.nbr_idx.T), tab.nbr_rest.T.contiguous(),
        tab.nbr_k.T.contiguous(), tab.nbr_c.T.contiguous(), tab.scal,
        *sc, *contact, int(tab.n_f), int(opts.num_substeps), float(opts.dt),
        gz, float(opts.reverse_factor), float(opts.ground_height),
        float(opts.collision_dist), bool(opts.use_pusher),
        x_out, v_out, ff_out)
    ext.LAUNCHES["spring_mass_step"] += 1
    return SpringMassState(x=x_out, v=v_out, finger_forces=ff_out,
                           telemetry=tab.telemetry)


def make_fused_step_fn(opts: PhysicsOptions, has_colliders: bool = True,
                       device="cuda"):
    """Fused control step ``step(params, colliders, state, ctrl, rest_x)``:
    the freezes, then K3. Built for the CPU, it runs K3's plain version
    and is the batched twin of the JAX ``make_step_fn``."""
    dev = resolve_device(device)

    def step(params, colliders, state, ctrl, rest_x):
        check_state_device(state, dev)
        tab = freeze(params, opts, colliders if has_colliders else None,
                     state, ctrl, rest_x)
        return spring_mass_step(opts, tab, state)

    return step
