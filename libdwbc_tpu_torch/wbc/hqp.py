"""Torque-level hierarchical QP assembly in torch (counterpart of
``libdwbc_tpu/wbc/hqp.py``):

* ``solve_task_level_qp`` — one hierarchy level (``CalcSingleTaskTorqueWithQP``,
  src/dwbc.cpp:941-1127): x = [δf*; f_c,red], minimize ½‖δf*‖² (the f_c
  block of H exactly zero, as the reference's) under torque limits and the
  contact cone/ZMP rows on the resulting torque;
* ``solve_contact_redistribution_qp`` — the final QP over f_c,red
  (``CalcContactRedistribute``, src/dwbc.cpp:1372-1620).

The ± torque-limit rows come as a mirrored pair over the m actuated dofs,
so ``mirror`` is passed to the solver (the ``qp_solve`` kernel folds
them): m, or ``len(limit_rows)`` where ``limit_rows`` keeps the pairs of
those torque rows alone (the reduced tick: the actuated contact-chain rows;
its virtual lumped-body rows carry no limit and are dropped statically).
``constraint_row_mask`` (masked ticks) lifts the cone/ZMP rows of inactive
contacts to ub = +inf, which the solver turns into 0·x ≤ 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.qp import solve_qp

_INF = 1.0e30


def contact_constraint_blocks(const_mats, rot_blocks):
    """Stack per-contact constraint blocks into (n_const, total_cdof) and the
    block-diagonal world→contact rotation (…, total_cdof, total_cdof)."""
    k_tot = sum(m.shape[0] for m in const_mats)
    d_tot = sum(m.shape[1] for m in const_mats)
    batch = torch.broadcast_shapes(*(rb.shape[:-2] for rb in rot_blocks))
    ref = rot_blocks[0]
    A_const = ref.new_zeros((k_tot, d_tot))
    A_rot = ref.new_zeros(batch + (d_tot, d_tot))
    r = c = 0
    for m, rb in zip(const_mats, rot_blocks):
        k_i, d_i = m.shape
        A_const[r:r + k_i, c:c + d_i] = m
        A_rot[..., c:c + d_i, c:c + d_i] = rb
        r += k_i
        c += d_i
    return A_const, A_rot


def _mask_rows(ub_c, row_mask):
    """Inactive contacts' cone/ZMP rows → ub = +inf (dropped by solve_qp)."""
    if row_mask is None:
        return ub_c
    return torch.where(row_mask > 0.5, ub_c, torch.full_like(ub_c, _INF))


def _limit_pairs(rows, ubs, blk, torque_limit, tau, limit_rows):
    """Append the ± torque-limit pair (blk x ≤ lim − τ, −blk x ≤ lim + τ),
    cut to ``limit_rows`` when given; returns its row count, the
    ``mirror`` the solver folds (0 without a limit)."""
    if torque_limit is None:
        return 0
    if limit_rows is not None:
        li = list(limit_rows)
        blk, torque_limit, tau = blk[..., li, :], torque_limit[..., li], tau[..., li]
    rows += [blk, -blk]
    ubs += [torque_limit - tau, torque_limit + tau]
    return blk.shape[-2]


class TaskQPResult(NamedTuple):
    f_star_delta: torch.Tensor   # (t,)
    contact_qp: torch.Tensor     # (c-6,)
    gap: torch.Tensor
    primal_res: torch.Tensor
    x: torch.Tensor              # (t+cfree,) full primal (warm-start carry)
    lam: torch.Tensor            # (rows,) dual (warm-start carry)


def solve_task_level_qp(
    Ntorque_task,    # (...,m,t)  task_null_prev @ J_kt @ Λ_t
    f_star,          # (...,t)
    torque_prev,     # (...,m)
    NwJw,            # (...,m,cfree)
    J_C_INV_T,       # (...,c,n)
    P_C,             # (...,c)
    A_const,         # (k,6nc)
    A_rot,           # (...,6nc,6nc)
    torque_limit,    # (m,) or None
    iters: int = 25,
    warm=None,
    backend: str = "torch",
    constraint_row_mask=None,  # (...,k) 1 = live cone/ZMP row (masked ticks)
    limit_rows=None,  # static indices of the torque rows with ± limit pairs
) -> TaskQPResult:
    """One hierarchy level's QP (src/dwbc.cpp:941-1127)."""
    m, t = Ntorque_task.shape[-2], Ntorque_task.shape[-1]
    cfree = NwJw.shape[-1]
    dtype, dev = Ntorque_task.dtype, Ntorque_task.device
    nv = t + cfree

    # ½‖δf*‖²: the f_c block of H stays exactly zero (src/dwbc.cpp:988-991)
    H = torch.zeros((nv, nv), dtype=dtype, device=dev)
    H[:t, :t] = torch.eye(t, dtype=dtype, device=dev)
    g = torch.zeros(nv, dtype=dtype, device=dev)

    tau_base = torque_prev + (Ntorque_task @ f_star[..., None])[..., 0]

    rows, ubs = [], []
    n_lim = _limit_pairs(rows, ubs, torch.cat([Ntorque_task, NwJw], dim=-1), torque_limit,
                         tau_base, limit_rows)

    # contact cone/ZMP rows: −(A_const A_rot J̄ᵀ_act)[Ntorque | NwJw] x ≤ −bA
    CM = A_const @ A_rot
    Atemp = CM @ J_C_INV_T[..., :, -m:]
    rows.append(-torch.cat([Atemp @ Ntorque_task, Atemp @ NwJw], dim=-1))
    bA = (CM @ P_C[..., None])[..., 0] - (Atemp @ tau_base[..., None])[..., 0]
    ubs.append(_mask_rows(-bA, constraint_row_mask))

    batch = torch.broadcast_shapes(*(r.shape[:-2] for r in rows))
    A = torch.cat([r.expand(batch + r.shape[-2:]) for r in rows], dim=-2)
    ub = torch.cat([u.expand(batch + u.shape[-1:]) for u in ubs], dim=-1)
    sol = solve_qp(H, g, A, None, ub, iters=iters, warm=warm, backend=backend, mirror=n_lim)
    return TaskQPResult(f_star_delta=sol.x[..., :t], contact_qp=sol.x[..., t:],
                        gap=sol.gap, primal_res=sol.primal_res, x=sol.x, lam=sol.lam)


def solve_contact_redistribution_qp(
    torque_input,    # (...,m) τ_grav + τ_task + τ_contact so far
    NwJw,            # (...,m,cfree)
    J_C_INV_T,       # (...,c,n)
    P_C,             # (...,c)
    A_const,
    A_rot,
    torque_limit,
    iters: int = 25,
    tangential_weight: bool = False,
    warm=None,
    backend: str = "torch",
    constraint_row_mask=None,
    limit_rows=None,
):
    """Final redistribution QP over f_c,red (src/dwbc.cpp:1396-1561).
    tangential_weight=True minimizes the tangential contact-force components
    instead of ‖f_c,red‖² (``CalcContactRedistributeR``,
    src/dwbc.cpp:4814-4848)."""
    m, cfree = NwJw.shape[-2], NwJw.shape[-1]
    dtype, dev = NwJw.dtype, NwJw.device
    JT_act = J_C_INV_T[..., :, -m:]

    if tangential_weight:
        nc6 = A_rot.shape[-1]
        RotW = torch.ones(nc6, dtype=dtype, device=dev)
        for i in range(nc6 // 6):
            RotW[6 * i + 2] = 0.0             # contact-frame fz rows dropped
        crot = A_rot * RotW[:, None]
        H_temp = crot @ JT_act @ NwJw
        H = (H_temp.transpose(-1, -2) @ H_temp
             + 1e-8 * torch.eye(cfree, dtype=dtype, device=dev))
        cf_now = (crot @ JT_act @ torque_input[..., None])[..., 0] \
            - (crot @ P_C[..., None])[..., 0]
        g = (H_temp.transpose(-1, -2) @ cf_now[..., None])[..., 0]
    else:
        H = torch.eye(cfree, dtype=dtype, device=dev)
        g = torch.zeros(cfree, dtype=dtype, device=dev)

    rows, ubs = [], []
    n_lim = _limit_pairs(rows, ubs, NwJw, torque_limit, torque_input, limit_rows)

    CM = -(A_const @ A_rot)
    rows.append(CM @ JT_act @ NwJw)
    ubs.append(_mask_rows((CM @ P_C[..., None])[..., 0]
                          - (CM @ JT_act @ torque_input[..., None])[..., 0],
                          constraint_row_mask))

    batch = torch.broadcast_shapes(*(r.shape[:-2] for r in rows))
    A = torch.cat([r.expand(batch + r.shape[-2:]) for r in rows], dim=-2)
    ub = torch.cat([u.expand(batch + u.shape[-1:]) for u in ubs], dim=-1)
    return solve_qp(H, g, A, None, ub, iters=iters, warm=warm, backend=backend, mirror=n_lim)
