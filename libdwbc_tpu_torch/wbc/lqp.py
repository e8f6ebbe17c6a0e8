"""Lexicographic QP cascade in torch, batch-major (counterpart of
``libdwbc_tpu/wbc/lqp.py``): the acceleration-level LQP of the reference's
``HQP``/``HQP_Hierarch`` (src/dwbc_hqp.cpp) and its problem builder
``ConfigureLQP`` (src/dwbc.cpp:4304-4430).

Each level carries the inequality ``A y + a ≤ v`` and the equality
``B y + b = w`` over y = [q̈; f_c].  Levels are solved in turn in the null
space of every higher-priority equality: Z_0 = null(B_0), Z_i =
Z_{i-1}·null(B_i Z_{i-1}); level i minimizes ‖B_i(y + Z u) + b_i‖² (+ the
level's regularizer) + ‖v‖² under its own and every earlier level's
inequalities, those with their slacks frozen.

* The depth and every block's shape are static; the null bases come from
  SVDs with statically known ranks (the equality stacks have full row rank
  by construction) instead of a rank-revealing COD.
* Each level's QP goes to ``ops/qp.py::solve_qp``, with the caller's
  ``backend``: under ``backend="cuda"`` a CUDA float32 level that
  ``qp_cuda.kernel_takes`` accepts runs the ``qp_solve`` kernel (the
  facade's reduced cascade has one, 18 variables and 92 rows on the
  flagship); the wider ones (up to 131 variables) take the torch loop, as
  the JAX router sends them to XLA.  The SVD null basis is unique only up
  to a rotation within the null space, so y and τ are what two
  implementations share, not Z.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Sequence

import torch

from ..ops.qp import _mv, solve_qp


@dataclasses.dataclass
class LQPLevel:
    """One priority level.  Tensors may carry leading batch dims."""

    A: torch.Tensor | None     # (mi, nv) inequality  A y + a ≤ v
    a: torch.Tensor | None
    B: torch.Tensor            # (me, nv) equality    B y + b = w
    b: torch.Tensor
    rank: int                  # static row rank of B (after nulling)
    H: torch.Tensor | None = None   # optional quadratic regularizer on y
    normalize: bool = True


def _row_normalize(M, v):
    n = torch.linalg.vector_norm(M, dim=-1, keepdim=True)
    n = torch.where(n > 0, n, torch.ones_like(n))
    return M / n, v / n[..., 0]


def _null_basis(B, rank: int):
    """Orthonormal null basis of B (static rank) by SVD."""
    _, _, Vh = torch.linalg.svd(B, full_matrices=True)
    return Vh.transpose(-1, -2)[..., :, rank:]


class LQPResult(NamedTuple):
    y: torch.Tensor            # the solution [q̈; f_c]
    v_slacks: tuple            # per-level inequality slacks
    gap: torch.Tensor
    primal_res: torch.Tensor


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def solve_cascade(levels: Sequence[LQPLevel], y0, solve_level0: bool = False,
                  qp_iters: int = 25, timers: list | None = None,
                  backend: str = "torch") -> LQPResult:
    """Run the lexicographic cascade.

    y0: a seed satisfying level 0's equality (the reference seeds
    y = [−A⁻¹B; 0], src/dwbc.cpp:4381, and skips solving level 0 unless
    ``solvefirst``: solve_level0=True).

    timers: when a list, each solved level appends ``{"level",
    "update_us", "solve_us"}``, the host's wall times of its QP assembly
    and solve (the reference's per-hierarchy qp_update_time_step_ /
    qp_solve_time_step_, include/dwbc_hqp.h:98-102); the card is
    synchronised around each only then.  backend: solve_qp's routing
    ("cuda": eligible levels on the ``qp_solve`` kernel)."""
    nv = y0.shape[-1]
    dtype, dev = y0.dtype, y0.device
    batch = y0.shape[:-1]
    kw = dict(dtype=dtype, device=dev)

    lv = []
    for L in levels:
        A, a, B, b = L.A, L.a, L.B, L.b
        if L.normalize:
            B, b = _row_normalize(B, b)
            if A is not None:
                A, a = _row_normalize(A, a)
        lv.append(dataclasses.replace(L, A=A, a=a, B=B, b=b))

    # the null-space chain (static ranks)
    Zs = [_null_basis(lv[0].B, lv[0].rank)]
    for L in lv[1:]:
        Zs.append(Zs[-1] @ _null_basis(L.B @ Zs[-1], L.rank))

    def level_qp(i, y, extra_prev):
        t_start = time.perf_counter() if timers is not None else 0.0
        L = lv[i]
        Z = Zs[i - 1] if i > 0 else torch.eye(nv, **kw)
        nu = Z.shape[-1]
        mi = L.A.shape[-2] if L.A is not None else 0
        nvar = nu + mi

        T = L.B @ Z
        t2 = _mv(L.B, y) + L.b
        Huu = T.transpose(-1, -2) @ T
        gu = _mv(T.transpose(-1, -2), t2)
        if L.H is not None:
            Huu = Huu + Z.transpose(-1, -2) @ L.H @ Z
            gu = gu + _mv(Z.transpose(-1, -2), _mv(L.H, y))
        H = torch.zeros(batch + (nvar, nvar), **kw)
        g = torch.zeros(batch + (nvar,), **kw)
        H[..., :nu, :nu] = Huu
        g[..., :nu] = gu
        if mi:
            H[..., nu:, nu:] += torch.eye(mi, **kw)

        rows, ubs = [], []
        eye_mi = torch.eye(mi, **kw)
        if mi:
            AZ = L.A @ Z
            rows.append(torch.cat([AZ, -eye_mi.expand(AZ.shape[:-2] + (mi, mi))], dim=-1))
            ubs.append(-_mv(L.A, y) - L.a)
            # v ≥ 0 (qpOASES box bounds in the reference; implicit under
            # OSQP through the ‖v‖² objective)
            vrows = torch.zeros(batch + (mi, nvar), **kw)
            vrows[..., :, nu:] = -eye_mi
            rows.append(vrows)
            ubs.append(torch.zeros(batch + (mi,), **kw))
        for Aj, aj, vj in extra_prev:
            AjZ = Aj @ Z
            rows.append(torch.cat([AjZ, AjZ.new_zeros(AjZ.shape[:-1] + (mi,))], dim=-1))
            ubs.append(vj - _mv(Aj, y) - aj)

        if rows:
            bs = torch.broadcast_shapes(*(r.shape[:-2] for r in rows))
            Am = torch.cat([r.expand(bs + r.shape[-2:]) for r in rows], dim=-2)
            ub = torch.cat([u.expand(bs + u.shape[-1:]) for u in ubs], dim=-1)
            if timers is not None:
                _sync(Am)
                t_upd = time.perf_counter()
            sol = solve_qp(H, g, Am, None, ub, iters=qp_iters, backend=backend)
            x = sol.x
            if timers is not None:
                _sync(x)
                timers.append(dict(level=i, update_us=round((t_upd - t_start) * 1e6, 1),
                                   solve_us=round((time.perf_counter() - t_upd) * 1e6, 1)))
            sgap, spres = sol.gap, sol.primal_res
        else:
            # equality least squares alone: u = −(Huu)⁻¹ gu, regularized
            if timers is not None:
                _sync(gu)
                t_upd = time.perf_counter()
            x = -torch.linalg.solve(Huu + 1e-10 * torch.eye(nu, **kw), gu[..., None])[..., 0]
            if timers is not None:
                _sync(x)
                timers.append(dict(level=i, update_us=round((t_upd - t_start) * 1e6, 1),
                                   solve_us=round((time.perf_counter() - t_upd) * 1e6, 1)))
            sgap = torch.zeros(batch, **kw)
            spres = torch.zeros(batch, **kw)

        u = x[..., :nu]
        v = x[..., nu:] if mi else torch.zeros(batch + (0,), **kw)
        return y + _mv(Z, u), v, sgap, spres

    y = y0
    v_ans, prev_ineq = [], []
    gap = torch.zeros(batch, **kw)
    pres = torch.zeros(batch, **kw)
    for i, L in enumerate(lv):
        if i == 0 and not solve_level0:
            v = torch.zeros(batch + (L.A.shape[-2] if L.A is not None else 0,), **kw)
            v_ans.append(v)
            if L.A is not None:
                prev_ineq.append((L.A, L.a, v))
            continue
        if i == 0:
            # solvefirst (src/dwbc_hqp.cpp:222-289): full-space LS + slacks
            y, v, sgap, spres = level_qp(0, torch.zeros_like(y), [])
        else:
            y, v, sgap, spres = level_qp(i, y, prev_ineq)
        gap = torch.maximum(gap, sgap)
        pres = torch.maximum(pres, spres)
        v_ans.append(v)
        if L.A is not None:
            prev_ineq.append((L.A, L.a, v))
    return LQPResult(y=y, v_slacks=tuple(v_ans), gap=gap, primal_res=pres)


# ---------------------------------------------------------------------------
# Problem builders (ConfigureLQP, src/dwbc.cpp:4304-4430)
# ---------------------------------------------------------------------------

def build_lqp_levels(A_mat, B_vec, J_C, contact_const_mat, task_Js, task_fstars,
                     torque_limit: float = 200.0, acc_limit: float = 5.0):
    """Full-coordinate LQP levels over y = [q̈ (n); f_c (c)].

    L0: τ limits on the actuated rows of the equations of motion; eq: the
    floating base's Newton-Euler rows.  L1: contact cones and joint
    acceleration limits; eq: J_C q̈ = 0.  L2+: one per task, eq J_task q̈ =
    f*.  contact_const_mat: (10·nc, c) = −A_const·A_rot
    (getContactConstraintMatrix)."""
    n = A_mat.shape[-1]
    c = J_C.shape[-2]
    m = n - 6
    nv = n + c
    batch = A_mat.shape[:-2]
    kw = dict(dtype=A_mat.dtype, device=A_mat.device)

    def z(*shape):
        return torch.zeros(batch + shape, **kw)

    JCT = J_C.transpose(-1, -2)
    # level 0
    B0 = torch.cat([A_mat[..., 0:6, :], JCT[..., 0:6, :]], dim=-1)
    b0 = B_vec[..., 0:6]
    tl = torch.full(batch + (m,), torque_limit, **kw)
    act = torch.cat([A_mat[..., 6:, :], JCT[..., 6:, :]], dim=-1)
    A0 = torch.cat([act, -act], dim=-2)
    a0 = torch.cat([-tl + B_vec[..., 6:], -tl - B_vec[..., 6:]], dim=-1)
    cost_h = z(nv, nv)
    cost_h[..., :n, :n] = A_mat / torch.linalg.matrix_norm(A_mat, keepdim=True) * 5.0
    lv0 = LQPLevel(A=A0, a=a0, B=B0, b=b0, rank=6)

    # level 1
    k = contact_const_mat.shape[-2]
    eye_m = torch.eye(m, **kw)
    A1 = z(k + 2 * m, nv)
    A1[..., :k, n:] = contact_const_mat
    A1[..., k:k + m, 6:n] = eye_m
    A1[..., k + m:, 6:n] = -eye_m
    a1 = z(k + 2 * m)
    a1[..., k:] = -acc_limit
    B1 = z(c, nv)
    B1[..., :, :n] = J_C
    lv1 = LQPLevel(A=A1, a=a1, B=B1, b=z(c), rank=c, H=cost_h)

    levels = [lv0, lv1]
    for Jt, fs in zip(task_Js, task_fstars):
        Bt = z(Jt.shape[-2], nv)
        Bt[..., :, :n] = Jt
        levels.append(LQPLevel(A=None, a=None, B=Bt, b=-fs, rank=Jt.shape[-2], H=cost_h))
    return levels


def lqp_torque_from_solution(y, A_mat, B_vec, J_C):
    """The actuated torque of [q̈; f_c]: (A q̈ + B + J_Cᵀ f_c), actuated rows."""
    n = A_mat.shape[-1]
    full = _mv(A_mat, y[..., :n]) + B_vec + _mv(J_C.transpose(-1, -2), y[..., n:])
    return full[..., 6:]
