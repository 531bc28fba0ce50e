"""Damped-least-squares inverse kinematics, batched over envs.

Counterpart of the JAX package's kinematics/ik.py: a fixed number of
Gauss-Newton steps on the 6D twist error, then the verify-and-fallback
contract: a solution more than 1 cm or 0.01 (Frobenius) off the target
returns the initial qpos.

The JAX package gets the error's Jacobian by forward-mode AD. Here the same
forward mode is written out: every quantity carries its derivative along
the active joints as a leading tangent dim (``d*`` below), through the FK
product chain and the rotation log. Forward-mode AD from ``torch.func``
computes the same Jacobian (the tests hold them together) but dispatches
each of the ~250 ops of one evaluation through its interpreter, which cost
tens of milliseconds per Gauss-Newton step on the host.

On the card the whole solve is one launch of a hand-written kernel
(``csrc/ik_solve.cu``: a warp per lane) over the chain's path packed into
a table (``pack_chain``), bitwise the eager solve; on the CPU it is the
eager solve, which stays as the kernel's plain version.

``KinHelper`` is the reference's numpy-in, numpy-out facade over the FK
and this solve, for the tools (replay's ``qpos`` format).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import ext
from ..utils import transforms as tf
from ..utils.device import resolve_device
from ..utils.profiling import count, spanned
from .chain import KinematicChain, _prismatic, _rot_about_axis

# csrc/ik_solve.h: floats per path link, and the kernel's limits
TABLE_WIDTH = 24
MAX_PATH, MAX_ACTIVE, MAX_DOF = 32, 31, 64


def _pose_error(T_cur: torch.Tensor, T_target: torch.Tensor) -> torch.Tensor:
    """6D twist error (translation, rotation vector) of current vs target."""
    dt = T_target[..., :3, 3] - T_cur[..., :3, 3]
    R_err = T_target[..., :3, :3] @ T_cur[..., :3, :3].transpose(-1, -2)
    return torch.cat([dt, tf.rot_to_axis_angle(R_err)], dim=-1)


def _rot_about_axis_d(axis: torch.Tensor, angle: torch.Tensor):
    """d/d(angle) of ``_rot_about_axis``: (..., 4, 4), zero last row/col."""
    x, y, z = axis.unbind(0)
    c, s = torch.cos(angle), torch.sin(angle)
    zero = torch.zeros_like(c)
    rows = [
        [-s + x * x * s, x * y * s - z * c, x * z * s + y * c, zero],
        [x * y * s + z * c, -s + y * y * s, y * z * s - x * c, zero],
        [x * z * s - y * c, y * z * s + x * c, -s + z * z * s, zero],
        [zero, zero, zero, zero],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _prismatic_d(axis: torch.Tensor, disp: torch.Tensor):
    zero = torch.zeros_like(disp)
    one = torch.ones_like(disp)
    rows = [[zero, zero, zero, axis[0] * one], [zero, zero, zero, axis[1] * one],
            [zero, zero, zero, axis[2] * one], [zero, zero, zero, zero]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def fk_link_jvp(chain: KinematicChain, q: torch.Tensor, link: int,
                n_active: int):
    """Pose of ``link`` (E, 4, 4), the same ops as ``chain.fk_link``, and
    its derivative along q[:, :n_active], (n_active, E, 4, 4), by the
    product rule down the ancestor path."""
    E = q.shape[0]
    origins, axes = chain.device_tables(q.device, q.dtype)
    P = None
    dP = q.new_zeros((n_active, E, 4, 4))
    for i in chain_path(chain, link):
        L = origins[i]
        dL, k = None, int(chain.dof_index[i])
        jt = int(chain.joint_type[i])
        if jt:
            axis = axes[i]
            motion, d_motion = ((_rot_about_axis(axis, q[:, k]),
                                 _rot_about_axis_d(axis, q[:, k])) if jt == 1
                                else (_prismatic(axis, q[:, k]),
                                      _prismatic_d(axis, q[:, k])))
            dL = L @ d_motion
            L = L @ motion
        if P is None:
            P = L.expand(E, 4, 4)
            if dL is not None and k < n_active:
                dP[k] = dL
        else:
            dP = dP @ L
            if dL is not None and k < n_active:
                dP[k] = dP[k] + P @ dL
            P = P @ L
    return P, dP


def _sqrt_clamped_jvp(x, dx, eps):
    v = torch.sqrt(torch.clamp(x, min=eps))
    return v, torch.where(x > eps, dx / (2.0 * v), torch.zeros_like(dx))


def _rot_to_quat_jvp(R, dR, eps: float = 1e-12):
    """``tf.rot_to_quat`` (same ops) and its derivative along dR
    (n, ..., 3, 3)."""
    m = [[R[..., a, b] for b in range(3)] for a in range(3)]
    dm = [[dR[..., a, b] for b in range(3)] for a in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    dtr = dm[0][0] + dm[1][1] + dm[2][2]

    def quot(a, da, s, ds):              # a / s and its derivative
        return a / s, da / s - a * ds / (s * s)

    def cand(pivot, dpivot, idx, others):
        """Candidate quaternion with 0.25 * s at ``idx`` and the (sum or
        difference) entries ``others`` divided by s = 2 sqrt(pivot)."""
        r, dr = _sqrt_clamped_jvp(pivot, dpivot, eps)
        s, ds = r * 2.0, dr * 2.0
        vals, dvals = [None] * 4, [None] * 4
        vals[idx], dvals[idx] = 0.25 * s, 0.25 * ds
        for j, (a, da) in others.items():
            vals[j], dvals[j] = quot(a, da, s, ds)
        return torch.stack(vals, -1), torch.stack(dvals, -1)

    def diff(a, b, sign):
        (i, j), (k, l) = a, b
        return (m[i][j] + sign * m[k][l], dm[i][j] + sign * dm[k][l])

    q0 = cand(1.0 + tr, dtr, 0, {1: diff((2, 1), (1, 2), -1),
                                 2: diff((0, 2), (2, 0), -1),
                                 3: diff((1, 0), (0, 1), -1)})
    q1 = cand(1.0 + m[0][0] - m[1][1] - m[2][2],
              dm[0][0] - dm[1][1] - dm[2][2], 1,
              {0: diff((2, 1), (1, 2), -1), 2: diff((0, 1), (1, 0), 1),
               3: diff((0, 2), (2, 0), 1)})
    q2 = cand(1.0 - m[0][0] + m[1][1] - m[2][2],
              -dm[0][0] + dm[1][1] - dm[2][2], 2,
              {0: diff((0, 2), (2, 0), -1), 1: diff((0, 1), (1, 0), 1),
               3: diff((1, 2), (2, 1), 1)})
    q3 = cand(1.0 - m[0][0] - m[1][1] + m[2][2],
              -dm[0][0] - dm[1][1] + dm[2][2], 3,
              {0: diff((1, 0), (0, 1), -1), 1: diff((0, 2), (2, 0), 1),
               2: diff((1, 2), (2, 1), 1)})
    scores = torch.stack([tr, m[0][0] - m[1][1] - m[2][2],
                          m[1][1] - m[0][0] - m[2][2],
                          m[2][2] - m[0][0] - m[1][1]], -1)
    best = torch.argmax(scores, dim=-1)[..., None, None]
    cands = torch.stack([q0[0], q1[0], q2[0], q3[0]], dim=-2)
    dcands = torch.stack([q0[1], q1[1], q2[1], q3[1]], dim=-2)
    q = torch.gather(cands, -2, best.expand(best.shape[:-2] + (1, 4)))[..., 0, :]
    dq = torch.gather(dcands, -2, best.expand(dcands.shape[:-2] + (1, 4))
                      )[..., 0, :]
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    qn = q / torch.clamp(n, min=eps)
    dqn = (dq - qn * (qn * dq).sum(-1, keepdim=True)) / n
    return qn, dqn


def _rot_to_axis_angle_jvp(R, dR, eps: float = 1e-8):
    """``tf.rot_to_axis_angle`` and its derivative along dR."""
    q, dq = _rot_to_quat_jvp(R, dR)
    sign = torch.where(q[..., :1] < 0, -1.0, 1.0)
    q, dq = q * sign, dq * sign
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    dw = torch.where((q[..., 0] > -1.0) & (q[..., 0] < 1.0), dq[..., 0],
                     torch.zeros_like(dq[..., 0]))
    xyz, dxyz = q[..., 1:], dq[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    dn = (xyz * dxyz).sum(-1) / torch.clamp(n, min=eps)
    theta = 2.0 * torch.atan2(n, w)
    dtheta = 2.0 * (w * dn - n * dw) / (n * n + w * w)
    small = n < eps
    nc = torch.clamp(n, min=eps)
    scale = torch.where(small, torch.full_like(n, 2.0), theta / nc)
    dscale = torch.where(small, torch.zeros_like(dn),
                         (dtheta * nc - theta * dn) / (nc * nc))
    return xyz * scale[..., None], dxyz * scale[..., None] + xyz * dscale[
        ..., None]


def pose_error_jvp(P, dP, target):
    """``_pose_error`` and its derivative: (E, 6), (n, E, 6)."""
    R_t = target[..., :3, :3]
    R_err = R_t @ P[..., :3, :3].transpose(-1, -2)
    dR_err = R_t @ dP[..., :3, :3].transpose(-1, -2)
    aa, daa = _rot_to_axis_angle_jvp(R_err, dR_err)
    e = torch.cat([target[..., :3, 3] - P[..., :3, 3], aa], dim=-1)
    return e, torch.cat([-dP[..., :3, 3], daa], dim=-1)


def chain_path(chain: KinematicChain, link: int) -> list:
    """The links from the root down to ``link``."""
    path = []
    i = int(link)
    while i >= 0:
        path.append(i)
        i = int(chain.parent[i])
    return path[::-1]


def pack_chain(chain: KinematicChain, link: int) -> np.ndarray:
    """The kernel's table of the path from the root to ``link``: (n_path,
    24) float32, a row a link, root first: [joint type (0 fixed, 1
    revolute, 2 prismatic), dof index (-1 if fixed), axis x y z, origin
    (4 x 4, row-major), 0, 0, 0], the float32 of the chain's tables as
    ``device_tables`` makes them."""
    path = chain_path(chain, link)
    table = np.zeros((len(path), TABLE_WIDTH), np.float32)
    for r, i in enumerate(path):
        table[r, 0] = chain.joint_type[i]
        table[r, 1] = chain.dof_index[i]
        table[r, 2:5] = np.asarray(chain.axes[i], np.float32)
        table[r, 5:21] = np.asarray(chain.origins[i], np.float32).ravel()
    return table


def check_ik_inputs(table: torch.Tensor, q_init: torch.Tensor,
                    target: torch.Tensor, n_active: int, width: int) -> None:
    """Raise ValueError unless the kernel can take these: float32,
    contiguous, on one CUDA device; table (n_path, 24) with n_path <= 32,
    q_init (E, n) with ``width`` <= n <= 64 (``width``: one more than the
    path's largest dof index), target (E, 4, 4), 0 <= n_active <= min(31,
    n). The kernel reads them unchecked."""
    for name, x in (("table", table), ("q_init", q_init),
                    ("target", target)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q_init.device:
            raise ValueError(f"{name} is on {x.device}, q_init on "
                             f"{q_init.device}")
    if (table.dim() != 2 or table.shape[1] != TABLE_WIDTH
            or not 1 <= table.shape[0] <= MAX_PATH):
        raise ValueError(f"table must be (n_path, {TABLE_WIDTH}) with 1 <= "
                         f"n_path <= {MAX_PATH}, got {tuple(table.shape)}")
    if q_init.dim() != 2 or not width <= q_init.shape[1] <= MAX_DOF:
        raise ValueError(f"q_init must be (E, n) with {width} <= n <= "
                         f"{MAX_DOF}, got {tuple(q_init.shape)}")
    E, n = q_init.shape
    if tuple(target.shape) != (E, 4, 4):
        raise ValueError(f"target must be ({E}, 4, 4), got "
                         f"{tuple(target.shape)}")
    if not 0 <= n_active <= min(MAX_ACTIVE, n):
        raise ValueError(f"n_active must lie in [0, {min(MAX_ACTIVE, n)}], "
                         f"got {n_active}")
    if q_init.device.type != "cuda":
        raise ValueError(f"the IK kernel runs on a CUDA device, got "
                         f"{q_init.device}")


def ik_solve(table, q_init, target, n_active: int, width: int, iters: int,
             damping: float, step_scale: float, pos_tol: float,
             rot_tol: float) -> torch.Tensor:
    """The solve of ``make_ik_fn`` in one launch of the kernel
    (``csrc/ik_solve.cu``) on the current stream: a fresh (E, n) output;
    the inputs are only read."""
    check_ik_inputs(table, q_init, target, n_active, width)
    q_out = torch.empty_like(q_init)
    ext.load().ik_solve(table, q_init, target, int(n_active), int(iters),
                        float(damping), float(step_scale), float(pos_tol),
                        float(rot_tol), q_out)
    ext.LAUNCHES["ik_solve"] += 1
    count("ik_launches")
    return q_out


def make_ik_fn(chain: KinematicChain, eef_link, n_active: int | None = None,
               iters: int = 32, damping: float = 1e-4,
               step_scale: float = 1.0, pos_tol: float = 0.01,
               rot_tol: float = 0.01):
    """Build ``solve(q_init (E, n), target (E, 4, 4)) -> qpos (E, n)``.

    On a CUDA tensor the solve (the Gauss-Newton iterations and the
    verify-and-fallback) is one launch of the IK kernel over the path's
    packed table, bitwise the eager solve; on a CPU tensor it runs
    eagerly. The returned function keeps the eager solve as ``.eager``."""
    if isinstance(eef_link, str):
        eef_link = chain.link_index(eef_link)
    n_active = chain.n_dof if n_active is None else n_active

    def solve(q_init: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        q_init = q_init.to(torch.float32)
        target = target.to(torch.float32)
        qa = q_init[:, :n_active]
        qr = q_init[:, n_active:]
        eye = damping * torch.eye(6, dtype=q_init.dtype,
                                  device=q_init.device)
        for _ in range(iters):
            P, dP = fk_link_jvp(chain, torch.cat([qa, qr], dim=-1),
                                eef_link, n_active)
            e, de = pose_error_jvp(P, dP, target)
            J = de.permute(1, 2, 0)                                # (E, 6, n)
            JJt = J @ J.transpose(-1, -2) + eye
            sol = torch.linalg.solve_ex(JJt, e[..., None])[0]
            qa = qa - step_scale * (J.transpose(-1, -2) @ sol)[..., 0]
        q = torch.cat([qa, qr], dim=-1)
        T_fk = chain.fk_link(q, eef_link)
        pos_diff = torch.linalg.vector_norm(
            T_fk[:, :3, 3] - target[:, :3, 3], dim=-1)
        rot_diff = torch.linalg.matrix_norm(
            T_fk[:, :3, :3] - target[:, :3, :3])
        ok = (pos_diff <= pos_tol) & (rot_diff <= rot_tol)
        return torch.where(ok[:, None], q, q_init)

    packed = pack_chain(chain, eef_link)
    width = int(packed[:, 1].max()) + 1
    tables = {}           # device -> the packed table there, made once

    @spanned("IK")
    def solver(q_init: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if q_init.device.type != "cuda":
            return solve(q_init, target)
        table = tables.get(q_init.device)
        if table is None:
            table = tables[q_init.device] = torch.as_tensor(
                packed, device=q_init.device)
        return ik_solve(table, q_init.to(torch.float32).contiguous(),
                        target.to(torch.float32).contiguous(), n_active,
                        width, iters, damping, step_scale, pos_tol, rot_tol)

    solver.eager = solve
    return solver


def ik_damped_ls(chain, eef_link, q_init, target_se3, **kwargs):
    """One-shot convenience wrapper around :func:`make_ik_fn`."""
    return make_ik_fn(chain, eef_link, **kwargs)(q_init, target_se3)


class KinHelper:
    """The reference's ``KinHelper`` facade (kinematics_utils.py:6-84) on
    the port's FK and IK; numpy in, numpy out.

    ``compute_fk_sapien_links(qpos, link_idx)`` returns 4x4 matrices;
    ``compute_ik_sapien(initial_qpos, cartesian)`` takes x, y, z and
    static-xyz Euler angles. The solve runs on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, robot_name_or_urdf: str, eef_name: str = "link7",
                 assets_root: str | None = None, device="cuda"):
        path = Path(robot_name_or_urdf)
        if not path.suffix == ".urdf":
            root = Path(assets_root or "assets")
            path = root / "robots/xarm/xarm7.urdf"
        self.device = resolve_device(device)
        self.chain = KinematicChain.from_urdf_file(path)
        self.eef_name = eef_name
        self.sapien_eef_idx = self.chain.link_index(eef_name)
        self._ik = make_ik_fn(self.chain, self.sapien_eef_idx, n_active=7)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def compute_fk_sapien_links(self, qpos, link_idx):
        q = self._tensor(qpos)
        return [self.chain.fk_link(q, int(i)).cpu().numpy() for i in link_idx]

    def compute_ik_sapien(self, initial_qpos, cartesian, verbose: bool = False):
        target = torch.eye(4, device=self.device)
        target[:3, :3] = tf.euler_to_rot(self._tensor(cartesian[3:6]))
        target[:3, 3] = self._tensor(cartesian[0:3])
        q = self._ik(self._tensor(initial_qpos)[None], target[None])[0]
        return q.cpu().numpy()
