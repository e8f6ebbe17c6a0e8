"""MaskedTick: one WBC tick over every contact mode of a candidate set
(counterpart of ``libdwbc_tpu/wbc/masked.py``).

The reference switches contact modes by resizing its matrices.  Here the
contacts are a candidate set padded to 6 jacobian rows and 10 constraint
rows each, and a per-scenario ``contact_mask`` selects the active subset, so
every scenario of a batch can be in a different mode.  Masking, step by
step:

* Λ_c: inactive rows of J_C are zero; the contact Gram gets +1 on their
  diagonal (the active block then inverts exactly) and Λ_c is re-masked;
* the kernel basis V2: single-pass Gram-Schmidt with rank dropout gives
  orthonormal-or-zero columns, compacted to the left;
* W⁺ = (W + V2ᵀV2)⁻¹ − V2ᵀV2 holds for any orthonormal kernel basis, and
  zero columns add nothing;
* NwJw: normalised against the first (c_act − 6) ACTIVE rows of J̄_cᵀ
  through a selection matrix, the inner system's dead rows and columns
  padded with identity;
* QPs: the cone/ZMP rows of inactive contacts get ub = +inf.

This is the batched tensor formulation beside the element-leading masked
``FusedTick``, against which the masked CUDA tick is held.  With
``backend="cuda"`` its SPD inverses of 16 ≤ n ≤ 64 run the ``psd_inverse``
kernel and its QPs the ``qp_solve`` kernel, as in ``CompiledTick``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kin.engine import FK, Kinematics
from ..ops import smallmat as sm
from ..ops.tick_kernel import _CROW_MASK, _ROW_MASK
from . import dynamics as dyn
from . import types as T
from .dynamics import ContactSpace, _psd_inv
from .hqp import solve_contact_redistribution_qp, solve_task_level_qp
from .pipeline import (_SIX_MODES, TickResult, _apply_servos, _plan_jacobians,
                       _resolve_task_jacobian, qp_error_flag, servos_to)


def _orthonormalize_drop(V):
    """Single-pass modified Gram-Schmidt over the columns of V (..., n, k):
    a column whose residual norm is at most 1e-8 comes back as zeros."""
    out = []
    for j in range(V.shape[-1]):
        v = V[..., :, j]
        for u in out:
            v = v - (u * v).sum(-1, keepdim=True) * u
        nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        keep = nrm > 1e-8
        out.append(torch.where(keep, v / torch.where(keep, nrm, 1.0), 0.0))
    return torch.stack(out, dim=-1)


def _compact_columns(V):
    """Shift the nonzero columns of V (..., n, k) to the left, in order,
    through a 0/1 permutation built from a prefix count; returns
    (V compacted, number of nonzero columns)."""
    k = V.shape[-1]
    nz = torch.linalg.vector_norm(V, dim=-2) > 1e-10             # (..., k)
    pos = torch.cumsum(nz.to(torch.int64), dim=-1) - 1           # target slot
    tgt = torch.arange(k, device=V.device)
    P = (pos[..., :, None] == tgt) & nz[..., :, None]            # P[j, t]
    return V @ P.to(V.dtype), nz.sum(-1)


def _selection_first_k(row_mask, k_limit):
    """(..., c) boolean mask and a per-scenario count limit → (..., c, c)
    selection S with S[t, i] = 1 iff row i is the t-th active row and
    t < limit."""
    c = row_mask.shape[-1]
    idx = torch.cumsum(row_mask.to(torch.int64), dim=-1) - 1     # (..., c)
    t = torch.arange(c, device=row_mask.device)
    S = (idx[..., None, :] == t[:, None]) & row_mask[..., None, :]
    S = S & (t[:, None] < k_limit[..., None, None])
    return S


def masked_contact_space(J_C, A_inv, row_mask, backend="torch") -> ContactSpace:
    """Contact-space factorization with per-scenario active-row masking.
    J_C (..., c_max, n) padded stacked contact jacobian, row_mask (..., c_max)
    0/1; at least one active 6D contact (``CalculateContactConstraint``,
    src/wbd.cpp:108-143, under masks)."""
    c, n = J_C.shape[-2], J_C.shape[-1]
    dtype, dev = J_C.dtype, J_C.device
    rmask = row_mask.to(dtype)
    J_C = J_C * rmask[..., :, None]
    JCT = J_C.transpose(-1, -2)

    JAinv = J_C @ A_inv
    Mc = JAinv @ JCT
    Mc = 0.5 * (Mc + Mc.transpose(-1, -2))
    Mc = Mc + torch.diag_embed(1.0 - rmask)       # the active block inverts exactly
    # inactive rows give unit pivots: only the active block sets the health
    Jb = J_C[..., :, 0:6]
    health = torch.minimum(dyn._chol_health(Mc),
                           dyn._chol_health(Jb.transpose(-1, -2) @ Jb))
    Lambda_c = _psd_inv(Mc, backend) * rmask[..., :, None] * rmask[..., None, :]
    J_C_INV_T = Lambda_c @ JAinv
    N_C = torch.eye(n, dtype=dtype, device=dev) - JCT @ J_C_INV_T
    A_inv_N_C = A_inv @ N_C
    W = A_inv_N_C[..., 6:, 6:]
    W = 0.5 * (W + W.transpose(-1, -2))

    # kernel basis of W, padded to width c_max − 6
    Ny = sm.complete_basis(Jb)[..., :, 6:]                       # (..., c, c-6)
    V2T, _ = _compact_columns(_orthonormalize_drop(J_C[..., :, 6:].transpose(-1, -2) @ Ny))
    P_k = V2T @ V2T.transpose(-1, -2)
    W_inv = _psd_inv(W + P_k, backend) - P_k
    V2 = V2T.transpose(-1, -2)

    # NwJw against the first (c_act − 6) ACTIVE rows of J̄_cᵀ (src/wbd.cpp:128)
    cfree = c - 6
    if cfree > 0:
        c_act = rmask.sum(-1)
        S = _selection_first_k(rmask > 0.5, c_act - 6.0)[..., :cfree, :].to(dtype)
        inner = S @ J_C_INV_T[..., :, 6:] @ V2T                  # (..., cfree, cfree)
        live = (torch.arange(cfree, device=dev) < (c_act - 6.0)[..., None]).to(dtype)
        inner = inner * live[..., :, None] * live[..., None, :] + torch.diag_embed(1.0 - live)
        NwJw = V2T @ sm.qr_pinv(inner) * live[..., None, :]
    else:
        NwJw = W.new_zeros(W.shape[:-2] + (n - 6, 0))
    return ContactSpace(Lambda_c, J_C_INV_T, N_C, A_inv_N_C, W, W_inv, V2, NwJw, health)


class MaskedTick(nn.Module):
    """One WBC tick over ALL contact modes of a candidate set.

    ``cfg.contacts`` is the candidate set; the per-call ``contact_mask``
    (..., n_candidates) selects the active subset per scenario.  The same
    serving contract as ``CompiledTick`` (``init_warm``, ``_tick_impl`` with
    the mask as the 4th positional argument, warm (x, λ) per QP)."""

    def __init__(self, model, cfg, device, dtype=torch.float32, backend="cuda"):
        super().__init__()
        device = torch.device(device)
        if backend not in ("torch", "cuda"):
            raise ValueError(f"backend must be 'torch' or 'cuda', got {backend!r}")
        if backend == "cuda":
            if not torch.cuda.is_available() or device.type != "cuda":
                raise RuntimeError("MaskedTick(backend='cuda') needs a CUDA device")
            if dtype != torch.float32:
                raise TypeError("the CUDA kernels of MaskedTick are float32")
        if device.type == "cuda":
            # exact float32 products on the card (no TF32 rounding)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        self.backend = backend
        self.kin = Kinematics(model, backend=backend)
        self._J_bodies, self._points, self._task_slots = _plan_jacobians(model, cfg)
        nc = len(cfg.contacts)
        m = model.model_dof
        cfree, k = 6 * nc - 6, 10 * nc
        lim_rows = 2 * m if cfg.torque_limit is not None else 0
        self._dims = [(sum(6 if spec[0] in _SIX_MODES else 3 for spec in level) + cfree,
                       lim_rows + k) for level in cfg.task_specs]
        self._dims.append((cfree, lim_rows + k))

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

        self.register_buffer("axis", t(model.axis), persistent=False)
        self.register_buffer("tlim", None if cfg.torque_limit is None else t(cfg.torque_limit),
                             persistent=False)
        self.register_buffer("type_mask", t(np.concatenate(
            [_ROW_MASK[c.contact_type] for c in cfg.contacts])), persistent=False)
        self.register_buffer("type_crow", t(np.concatenate(
            [_CROW_MASK[c.contact_type] for c in cfg.contacts])), persistent=False)
        # padded (10, 6) [ZMP; cone] block per candidate, block-diagonal
        A_const = torch.zeros((k, 6 * nc), dtype=dtype, device=device)
        for i, c in enumerate(cfg.contacts):
            A_const[10 * i:10 * i + 10, 6 * i:6 * i + 6] = torch.cat([
                dyn.zmp_const_matrix(c.plane_x, c.plane_y, dtype, device),
                dyn.force_const_matrix(c.friction_ratio, c.friction_ratio_z, dtype, device)], 0)
        self.register_buffer("A_const", A_const, persistent=False)

    def init_warm(self, batch=()):
        """Cold warm state: per QP (zeros (batch, n), ones (batch, m)) at the
        padded shapes (cfree = 6·nc − 6, 10 constraint rows per candidate)."""
        batch = tuple(batch)
        kw = dict(dtype=self.dtype, device=self.device)
        return tuple((torch.zeros(batch + (nv,), **kw), torch.ones(batch + (rows,), **kw))
                     for nv, rows in self._dims)

    def _tick_impl(self, q, qdot, fstars, contact_mask, warm=None, qp_iters=None,
                   servos=None):
        """q (B, nq) or (nq,), q̇ alike, f* per level, contact_mask
        (B, nc) or (nc,), warm per QP (x, λ) or None → TickResult, and the
        warm state out when warm was given.  servos: as ``CompiledTick``'s."""
        cfg, bk = self.cfg, self.backend
        m = self.model.model_dof
        nc = len(cfg.contacts)

        def as_t(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        q, qdot, cmask = as_t(q), as_t(qdot), as_t(contact_mask)
        fstars = tuple(as_t(f) for f in fstars)
        if warm is not None:
            warm = tuple((as_t(x), as_t(lam)) for x, lam in warm)
        servos = servos_to(servos, self.dtype, self.device)
        st = self.kin.update(q, qdot, J_bodies=self._J_bodies, points=self._points)
        fk = FK(R=st.R, p=st.p, axis_w=(st.R @ self.axis[..., None])[..., 0], com_w=st.com_w)
        batch = torch.broadcast_shapes(q.shape[:-1], cmask.shape[:-1])

        # padded contact jacobian (LINE moment rows turned contact-local, so
        # the statically dead row is the local-x moment) and its row mask
        Js = []
        for i, c in enumerate(cfg.contacts):
            J = st.J_pts[..., i, :, :]
            if c.contact_type == T.CONTACT_LINE:
                RT = st.R[..., c.link, :, :].transpose(-1, -2)
                J = torch.cat([J[..., 0:3, :], RT @ J[..., 3:6, :]], dim=-2)
            Js.append(J)
        row_mask = torch.repeat_interleave(cmask, 6, dim=-1) * self.type_mask
        J_C = torch.cat(Js, dim=-2) * row_mask[..., :, None]

        cs = masked_contact_space(J_C, st.A_inv, row_mask, backend=bk)
        torque_grav, P_C = dyn.gravity_compensation(st.A_inv, cs.W_inv, cs.N_C,
                                                    cs.J_C_INV_T, st.G)

        # world → contact rotations; LINE moment rows are already local
        A_rot = torch.zeros(batch + (6 * nc, 6 * nc), dtype=self.dtype, device=self.device)
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        for i, c in enumerate(cfg.contacts):
            RT = st.R[..., c.link, :, :].transpose(-1, -2)
            A_rot[..., 6 * i:6 * i + 3, 6 * i:6 * i + 3] = RT
            A_rot[..., 6 * i + 3:6 * i + 6, 6 * i + 3:6 * i + 6] = (
                eye3 if c.contact_type == T.CONTACT_LINE else RT)
        crow_mask = torch.repeat_interleave(cmask, 10, dim=-1) * self.type_crow

        kw = dict(dtype=self.dtype, device=self.device)
        torque_task = torch.zeros(batch + (m,), **kw)
        torque_contact = torch.zeros(batch + (m,), **kw)
        gap = torch.zeros(batch, **kw)
        pres = torch.zeros(batch, **kw)
        iters = cfg.qp_iters if qp_iters is None else qp_iters
        warm_out = []

        prev_null = torch.eye(m, **kw).expand(batch + (m, m))
        for h in range(len(cfg.task_specs)):
            J_task = _resolve_task_jacobian(self.kin, self.model, cfg, self._task_slots,
                                            st, fk, h, self.dtype)
            tf = dyn.task_jkt(J_task, st.A_inv, cs.N_C, cs.W_inv, backend=bk)
            fstar = fstars[h]
            if servos is not None and servos[h] is not None:
                fstar = _apply_servos(self.model, cfg, self.dtype, st, h, fstar, servos[h])
            JktL = tf.J_kt @ tf.Lambda_task
            if cfg.use_hqp:
                res = solve_task_level_qp(
                    prev_null @ JktL, fstar, torque_grav + torque_task, cs.NwJw,
                    cs.J_C_INV_T, P_C, self.A_const, A_rot, self.tlim, iters=iters,
                    warm=None if warm is None else warm[h], backend=bk,
                    constraint_row_mask=crow_mask)
                warm_out.append((res.x, res.lam))
                torque_h = (JktL @ (fstar + res.f_star_delta)[..., None])[..., 0]
                torque_contact = (cs.NwJw @ res.contact_qp[..., None])[..., 0]
                gap = torch.maximum(gap, res.gap)
                pres = torch.maximum(pres, res.primal_res)
            else:
                torque_h = (JktL @ fstar[..., None])[..., 0]
            if h == 0:
                torque_task = torque_h
            else:
                torque_task = torque_task + (prev_null @ torque_h[..., None])[..., 0]
            prev_null = dyn.task_null_space(tf.J_kt, tf.Lambda_task, J_task,
                                            cs.A_inv_N_C, prev_null)

        if cfg.use_hqp and cs.NwJw.shape[-1] > 0:
            sol = solve_contact_redistribution_qp(
                torque_grav + torque_task + torque_contact, cs.NwJw, cs.J_C_INV_T, P_C,
                self.A_const, A_rot, self.tlim, iters=iters,
                warm=None if warm is None else warm[len(cfg.task_specs)], backend=bk,
                constraint_row_mask=crow_mask)
            warm_out.append((sol.x, sol.lam))
            torque_contact = torque_contact + (cs.NwJw @ sol.x[..., None])[..., 0]
            # the reference's redistribution guard (src/dwbc.cpp:1424): a
            # single-support lane has no redistribution problem, and the
            # padded QP's ε-infeasible dead rows must not reach its diagnostics
            live_redis = (row_mask.sum(-1) > 6.5).to(self.dtype)
            gap = torch.maximum(gap, sol.gap * live_redis)
            pres = torch.maximum(pres, sol.primal_res * live_redis)

        torque_cmd = torque_grav + torque_task + torque_contact
        result = TickResult(
            torque_grav=torque_grav,
            torque_task=torque_task,
            torque_contact=torque_contact,
            torque_cmd=torque_cmd,
            contact_force=dyn.contact_force_from_torque(torque_cmd, cs.J_C_INV_T, P_C),
            qp_gap=gap,
            qp_primal_res=pres,
            contact_rank_health=cs.rank_health,
            qp_error=qp_error_flag(gap, pres, torque_cmd, cfg),
        )
        return (result, tuple(warm_out)) if warm is not None else result

    def forward(self, q, qdot, fstars, contact_mask, warm=None, qp_iters=None, servos=None):
        return self._tick_impl(q, qdot, fstars, contact_mask, warm=warm, qp_iters=qp_iters,
                               servos=servos)
