"""``ReducedTick``: the reduced-dimension tick in the serving shape
(counterpart of ``libdwbc_tpu/wbc/reduced_tick.py``).

The reference's ``_R`` path (``ReducedDynamicsCalculate`` →
``ReducedCalcContactConstraint`` → ``ReducedCalcGravCompensation`` →
``ReducedCalcTaskSpace`` → ``ReducedCalcTaskControlTorque`` →
``ReducedCalcContactRedistribute``, src/dwbc.cpp:2752-3770) as one batched,
warm-startable tick with ``CompiledTick``'s contract (``init_warm``,
``_tick_impl(q, q̇, f*, warm=, qp_iters=, servos=)``, warm (x, λ) per QP).

* The task hierarchy runs in ``reduced_model_dof = co_dof + 6``
  coordinates (18 on the flagship's double support) instead of
  ``model_dof`` (33).
* The QPs carry ``2·co_dof`` ± torque-limit rows instead of
  ``2·model_dof``: the virtual lumped-body dofs are unbounded and their
  rows are dropped statically (``limit_rows``), not lifted to +inf.
* Chain (co / nc) and level (co / nc / cmm) classification is static per
  configuration.

Beyond the full tick it computes the nc-chain lumping
(``wbc/reduced.py``), a partial full-system contact space (Λ_c, J̄_cᵀ,
N_C, A⁻¹N_C: non-contact-chain task levels need them, src/dwbc.cpp:
3104-3110), the nc levels' resultant QP and the recomposition.

With ``backend="cuda"`` its SPD inverses of 16 ≤ n ≤ 64 (A at 39, A_R at
co_dof + 12 and, with more than one contact, W + V2ᵀV2 at co_dof + 6) run
the ``psd_inverse`` kernel and every QP the ``qp_solve`` kernel; everything
else is torch ops on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kin.engine import FK, Kinematics
from ..ops.qp import _mv
from . import dynamics as dyn
from .hqp import contact_constraint_blocks, solve_contact_redistribution_qp, solve_task_level_qp
from .pipeline import (
    _SIX_MODES, TickResult, _apply_servos, _plan_jacobians, _resolve_task_jacobian,
    qp_error_flag, servos_to,
)
from .reduced import classify_chains, reduced_contact_space, reduced_dynamics


class ReducedTick(nn.Module):
    """One reduced-coordinate WBC tick for a fixed configuration, batched
    over leading dims of (q, q̇, f*).  Needs a model whose non-contact
    chain is not empty (otherwise the reduction is degenerate: serve
    ``CompiledTick``).

    tangential_weight: True (the reference's ``_R`` default) makes the
    redistribution QP minimize the tangential contact forces
    (``CalcContactRedistributeR``, src/dwbc.cpp:4814-4848); False is the
    full tick's min-norm objective."""

    def __init__(self, model, cfg, device, dtype=torch.float32, backend="cuda",
                 tangential_weight=True):
        super().__init__()
        device = torch.device(device)
        if backend not in ("torch", "cuda"):
            raise ValueError(f"backend must be 'torch' or 'cuda', got {backend!r}")
        if backend == "cuda":
            if not torch.cuda.is_available() or device.type != "cuda":
                raise RuntimeError("ReducedTick(backend='cuda') needs a CUDA device")
            if dtype != torch.float32:
                raise TypeError("the CUDA kernels of ReducedTick are float32")
        if device.type == "cuda":
            # exact float32 products on the card (no TF32 rounding)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        self.backend = backend
        self.tangential_weight = tangential_weight
        self.kin = Kinematics(model, backend=backend)
        self.ridx = classify_chains(model, [c.link for c in cfg.contacts])
        if self.ridx.nc_dof == 0:
            raise ValueError(
                "every joint is on the contact chain — the reduction is "
                "degenerate (nothing to lump); use CompiledTick")
        # static actuated-joint index maps (the reference assumes the co
        # joints are the first actuated ones, src/dwbc.cpp:3766)
        self._co_act = np.asarray(self.ridx.co_joints) - 6
        self._nc_act = np.asarray(self.ridx.nc_joints) - 6
        self._limit_rows = (tuple(range(self.ridx.co_dof))
                            if cfg.torque_limit is not None else None)
        # static level classification (ReducedCalcTaskSpace,
        # src/dwbc.cpp:3165-3228)
        co_set = set(self.ridx.co_links)
        self._level_kind = []
        for level in cfg.task_specs:
            links = [spec[1] for spec in level]
            is_cmm = any(link == model.nbody for link in links)
            is_co = any(link in co_set and link != model.nbody for link in links)
            is_nc = any(link not in co_set and link != model.nbody for link in links)
            if is_co and is_nc:
                raise NotImplementedError(
                    "a task level spanning both chains is undefined in the "
                    "reduced formulation (reference 'UNDEFINED TASK TYPE', "
                    "src/task.cpp:134-143)")
            self._level_kind.append("cmm" if is_cmm else ("nc" if is_nc else "co"))
        self._nc_levels = [h for h, k in enumerate(self._level_kind) if k == "nc"]
        for a, b in zip(self._nc_levels, self._nc_levels[1:]):
            if b != a + 1:
                raise NotImplementedError(
                    "non-consecutive nc task levels: the second-nc null-space "
                    "correction reads the immediately previous level's nc "
                    "task (src/dwbc.cpp:3292-3335)")
        # the jacobian narrowing plan, with a guaranteed base-origin slot
        jb, self._points, self._task_slots = _plan_jacobians(model, cfg)
        if jb is not None and 0 not in jb:
            jb = jb + (0,)
        self._J_bodies = jb
        self._base_slot = None if jb is None else jb.index(0)
        self._dims = self._level_dims()

        kw = dict(dtype=dtype, device=device)
        self.register_buffer("axis", torch.as_tensor(
            np.asarray(model.axis, np.float64), **kw), persistent=False)
        tlim = None
        if cfg.torque_limit is not None:
            co = self.ridx.co_dof
            tl = np.full(co + 6, np.inf)
            tl[:co] = np.asarray(cfg.torque_limit, np.float64)[self._co_act]
            tlim = torch.as_tensor(tl, **kw)
        self.register_buffer("tlim", tlim, persistent=False)
        self._consts = [dyn.contact_constraint_block(
            c.contact_type, c.plane_x, c.plane_y, c.friction_ratio, c.friction_ratio_z, **kw)
            for c in cfg.contacts]

    # ----------------------------------------------------- warm-start carry
    def _level_dims(self):
        """(nv, rows) of each QP the tick runs, in call order: one per co
        or cmm level, the nc levels' resultant QP, then the redistribution.
        Every entry must be a QP that ``_tick_impl`` runs (and so a warm
        slot it emits): with use_hqp=False it runs none, and it skips the
        redistribution when the contact free space is empty (one 6D
        contact); an extra slot breaks warm-chained loops with a carry
        structure mismatch."""
        cfg = self.cfg
        cfree = sum(c.contact_dof for c in cfg.contacts) - 6
        k = sum(c.constraint_number for c in cfg.contacts)
        rows = (2 * self.ridx.co_dof if cfg.torque_limit is not None else 0) + k
        if not cfg.use_hqp:
            return []
        dims = [(sum(6 if spec[0] in _SIX_MODES else 3 for spec in level) + cfree, rows)
                for h, level in enumerate(cfg.task_specs) if self._level_kind[h] != "nc"]
        if self._nc_levels:
            dims.append((6 + cfree, rows))
        if cfree > 0:
            dims.append((cfree, rows))
        return dims

    def init_warm(self, batch=()):
        """Cold warm state: per QP (zeros (batch, n), ones (batch, m))."""
        batch = tuple(batch)
        kw = dict(dtype=self.dtype, device=self.device)
        return tuple((torch.zeros(batch + (nv,), **kw), torch.ones(batch + (rows,), **kw))
                     for nv, rows in self._dims)

    # ------------------------------------------------------------- helpers
    def _jkt_r(self, J_task_R, csr):
        """CalculateJKT_R (src/wbd.cpp:220-226) in reduced coordinates."""
        bk = self.backend
        JAN = J_task_R @ csr.A_inv_N_C
        M = JAN @ J_task_R.transpose(-1, -2)
        Lam = dyn._psd_inv_reg(0.5 * (M + M.transpose(-1, -2)), bk)
        Q = (Lam @ JAN)[..., :, 6:]
        QT = Q.transpose(-1, -2)
        QWQ = Q @ csr.W_inv @ QT
        J_kt = csr.W_inv @ QT @ dyn._psd_inv_reg(0.5 * (QWQ + QWQ.transpose(-1, -2)), bk)
        return J_kt, Lam

    # ---------------------------------------------------------------- tick
    def _tick_impl(self, q, qdot, fstars, warm=None, qp_iters=None, servos=None):
        """q (B, nq) or (nq,), q̇ alike, f* per level (B, t) or (t,), warm per
        QP (x, λ) or None → TickResult, and the warm state out when warm was
        given.  servos: per level None or a tuple of per-spec ServoParams
        or None."""
        cfg, idx, model, bk = self.cfg, self.ridx, self.model, self.backend
        dtype, dev = self.dtype, self.device
        kw = dict(dtype=dtype, device=dev)
        co, ncd = idx.co_dof, idx.nc_dof
        r_model = idx.reduced_model_dof
        ncj = torch.as_tensor(idx.nc_joints, device=dev)
        vcj = torch.as_tensor(idx.vc_joints, device=dev)
        co_act = torch.as_tensor(self._co_act, device=dev)
        nc_act = torch.as_tensor(self._nc_act, device=dev)
        iters = cfg.qp_iters if qp_iters is None else qp_iters

        def as_t(x):
            return torch.as_tensor(x, **kw)

        q, qdot = as_t(q), as_t(qdot)
        fstars = tuple(as_t(f) for f in fstars)
        if warm is not None:
            warm = tuple((as_t(x), as_t(lam)) for x, lam in warm)
        servos = servos_to(servos, dtype, dev)
        st = self.kin.update(q, qdot, J_bodies=self._J_bodies, points=self._points)
        fk = FK(R=st.R, p=st.p, axis_w=(st.R @ self.axis[..., None])[..., 0], com_w=st.com_w)
        batch = q.shape[:-1]

        # ---- reduced dynamics and the reduced contact space
        rd = reduced_dynamics(model, idx, st, backend=bk)
        J_C = torch.cat([dyn.contact_jacobian_rows(st.J_pts[..., i, :, :],
                                                   st.R[..., c.link, :, :], c.contact_type)
                         for i, c in enumerate(cfg.contacts)], dim=-2)
        csr, _ = reduced_contact_space(idx, J_C, rd, backend=bk)

        # ---- the partial full contact space: nc-task Λ needs A⁻¹N_C
        # (src/dwbc.cpp:3104-3110; W, V2 and NwJw are not computed)
        JAinv = J_C @ st.A_inv
        Mc = JAinv @ J_C.transpose(-1, -2)
        Lambda_c = dyn._psd_inv(0.5 * (Mc + Mc.transpose(-1, -2)), bk)
        J_C_INV_T_full = Lambda_c @ JAinv
        N_C_full = torch.eye(model.ndof, **kw) - J_C.transpose(-1, -2) @ J_C_INV_T_full
        A_inv_N_C_full = st.A_inv @ N_C_full
        P_C_full = _mv(J_C_INV_T_full, st.G)

        # ---- gravity (ReducedCalcGravCompensation, src/dwbc.cpp:3144-3150)
        NG = _mv(csr.N_C, rd.G_R)
        tg_R = _mv(csr.W_inv, _mv(rd.A_R_inv[..., -r_model:, :], NG))
        P_CR = _mv(csr.J_C_INV_T, rd.G_R)
        torque_grav = torch.zeros(batch + (model.model_dof,), **kw)
        torque_grav[..., co_act] = tg_R[..., :co]
        torque_grav[..., nc_act] = rd.G_NC.expand(batch + (ncd,))

        # ---- the base link's reduced JKT (the nc tasks' torque coupling,
        # src/dwbc.cpp:3159-3160)
        J0 = st.J[..., 0 if self._base_slot is None else self._base_slot, :, :]
        J_base_R = torch.zeros(batch + (6, idx.reduced_system_dof), **kw)
        J_base_R[..., :, 0:6] = J0[..., :, 0:6]
        J_base_R_kt, _ = self._jkt_r(J_base_R, csr)

        A_const, A_rot = contact_constraint_blocks(
            self._consts, [dyn.contact_rotation_block(c.contact_type, st.R[..., c.link, :, :])
                           for c in cfg.contacts])
        R0 = st.R[..., 0, :, :]

        def to_world6(v):
            """[force; R0 · moment] of a 6-row base-frame resultant."""
            return torch.cat([v[..., 0:3], _mv(R0, v[..., 3:6])], dim=-1)

        torque_task_R = torch.zeros(batch + (r_model,), **kw)
        torque_task_NC = torch.zeros(batch + (ncd,), **kw)
        force_on_nc = torch.zeros(batch + (6,), **kw)
        gap = torch.zeros(batch, **kw)
        pres = torch.zeros(batch, **kw)
        warm_out = []

        def next_warm():
            return None if warm is None else warm[len(warm_out)]

        def qp_level(Ntorque, fstar, torque_prev):
            return solve_task_level_qp(
                Ntorque, fstar, torque_prev, csr.NwJw, csr.J_C_INV_T, P_CR, A_const, A_rot,
                self.tlim, iters=iters, warm=next_warm(), backend=bk,
                limit_rows=self._limit_rows)

        # per-level bookkeeping for the nc null-space corrections
        nulls = []                # the reduced null projector after each level
        nc_entries = []           # (reduced torque, nc torque) of each nc level
        prev_nc = None            # (J_task, J_task's nc columns, Λ) of the last nc level
        eye_r = torch.eye(r_model, **kw).expand(batch + (r_model, r_model))
        prev_null = eye_r

        for h in range(len(cfg.task_specs)):
            kind = self._level_kind[h]
            J_task = _resolve_task_jacobian(self.kin, model, cfg, self._task_slots, st, fk, h,
                                            dtype)
            fstar = fstars[h]
            if servos is not None and servos[h] is not None:
                fstar = _apply_servos(model, cfg, dtype, st, h, fstar, servos[h])

            if kind == "nc":
                # the nc chain's analytic torque and resultant-force
                # bookkeeping (src/dwbc.cpp:3292-3335)
                Lam = dyn._psd_inv_reg(J_task @ A_inv_N_C_full @ J_task.transpose(-1, -2), bk)
                temp = _mv(J_task.transpose(-1, -2), _mv(Lam, fstar))
                torque_nc = temp[..., ncj]
                f_on = to_world6(temp)
                th_R = torch.cat([_mv(J_base_R_kt, f_on)[..., :co],
                                  _mv(rd.J_I_nc_inv_T, torque_nc)], dim=-1)
                if prev_nc is None:
                    force_on_nc = force_on_nc + f_on
                    nc_entries.append((_mv(prev_null, th_R), torque_nc))
                else:
                    # a later nc level: subtract the previous nc task's
                    # null-space force coupling (src/dwbc.cpp:3307-3335)
                    Jp, Jp_NC, Lam_p = prev_nc
                    null_force = _mv(Lam_p, _mv(Jp, _mv(A_inv_N_C_full, temp)))
                    temp2 = _mv(Jp.transpose(-1, -2), null_force)
                    temp2_6 = to_world6(temp2)
                    nthr = torch.cat([
                        th_R[..., :co] - _mv(J_base_R_kt, temp2_6)[..., :co],
                        _mv(rd.J_I_nc_inv_T,
                            torque_nc - _mv(Jp_NC.transpose(-1, -2), null_force)),
                    ], dim=-1)
                    force_on_nc = force_on_nc + f_on - temp2_6
                    nc_entries.append((_mv(prev_null, nthr), torque_nc - temp2[..., ncj]))
                prev_nc = (J_task, J_task[..., ncj], Lam)
                nulls.append(prev_null)           # nc levels take no null space
                continue

            # ---- a co or cmm level: the reduced JKT and its QP
            JR = torch.zeros(batch + (J_task.shape[-2], idx.reduced_system_dof), **kw)
            JR[..., :, :idx.vc_dof] = J_task[..., vcj]
            if kind == "cmm":
                JR[..., :, idx.vc_dof:] = J_task[..., ncj] @ rd.J_I_nc_inv_T.transpose(-1, -2)
            J_kt_R, Lam = self._jkt_r(JR, csr)
            if cfg.use_hqp:
                res = qp_level(prev_null @ J_kt_R @ Lam, fstar, tg_R + torque_task_R)
                warm_out.append((res.x, res.lam))
                gap = torch.maximum(gap, res.gap)
                pres = torch.maximum(pres, res.primal_res)
                th_R = _mv(J_kt_R @ Lam, fstar + res.f_star_delta)
            else:
                th_R = _mv(J_kt_R @ Lam, fstar)
            torque_task_R = torque_task_R + _mv(prev_null, th_R)
            prev_null = dyn.task_null_space(J_kt_R, Lam, JR, csr.A_inv_N_C, prev_null)
            nulls.append(prev_null)

        # ---- the nc resultant-force QP (CalcSingleTaskTorqueWithQP_R_NC,
        # src/dwbc.cpp:3419-3428, 3601-3756)
        torque_task_R_qp = torch.zeros(batch + (r_model,), **kw)
        if cfg.use_hqp and self._nc_levels:
            h0 = self._nc_levels[0]
            nprev = nulls[h0 - 1] if h0 > 0 else eye_r
            res = qp_level(nprev @ J_base_R_kt, force_on_nc, tg_R + torque_task_R)
            warm_out.append((res.x, res.lam))
            gap = torch.maximum(gap, res.gap)
            pres = torch.maximum(pres, res.primal_res)
            torque_task_R_qp[..., :co] = _mv(J_base_R_kt, res.f_star_delta)[..., :co]
        for th_R_nc, t_nc in nc_entries:
            torque_task_R = torque_task_R + th_R_nc
            torque_task_NC = torque_task_NC + t_nc

        # ---- recomposition (src/dwbc.cpp:3442-3443)
        torque_task = torch.zeros(batch + (model.model_dof,), **kw)
        torque_task[..., co_act] = torque_task_R[..., :co] + torque_task_R_qp[..., :co]
        torque_task[..., nc_act] = (_mv(rd.J_I_nc.transpose(-1, -2), torque_task_R[..., co:])
                                    + _mv(rd.N_I_nc, torque_task_NC))

        # ---- contact redistribution in reduced coordinates
        # (ReducedCalcContactRedistribute, src/dwbc.cpp:3758-3770)
        torque_contact = torch.zeros(batch + (model.model_dof,), **kw)
        if cfg.use_hqp and csr.NwJw.shape[-1] > 0:
            sol = solve_contact_redistribution_qp(
                tg_R + torque_task_R, csr.NwJw, csr.J_C_INV_T, P_CR, A_const, A_rot,
                self.tlim, iters=iters, tangential_weight=self.tangential_weight,
                warm=next_warm(), backend=bk, limit_rows=self._limit_rows)
            warm_out.append((sol.x, sol.lam))
            gap = torch.maximum(gap, sol.gap)
            pres = torch.maximum(pres, sol.primal_res)
            torque_contact[..., co_act] = _mv(csr.NwJw, sol.x)[..., :co]

        torque_cmd = torque_grav + torque_task + torque_contact
        result = TickResult(
            torque_grav=torque_grav,
            torque_task=torque_task,
            torque_contact=torque_contact,
            torque_cmd=torque_cmd,
            contact_force=dyn.contact_force_from_torque(torque_cmd, J_C_INV_T_full, P_C_full),
            qp_gap=gap,
            qp_primal_res=pres,
            contact_rank_health=csr.rank_health,
            qp_error=qp_error_flag(gap, pres, torque_cmd, cfg),
        )
        return (result, tuple(warm_out)) if warm is not None else result

    def forward(self, q, qdot, fstars, warm=None, qp_iters=None, servos=None):
        return self._tick_impl(q, qdot, fstars, warm=warm, qp_iters=qp_iters, servos=servos)
