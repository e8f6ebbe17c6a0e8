"""FusedTick: the whole WBC tick as two CUDA kernel launches.

Counterpart of ``libdwbc_tpu/wbc/fused.py::FusedTick``: the same
``_tick_impl`` / ``init_warm`` serving contract and the same warm-state
shapes, with batch-major inputs and results.  ``servos=`` runs the
on-device trajectory-PD servo inside the tick (inside ``tick_prestage``
under ``backend="cuda"``), fed by q̇.  ``masked=True`` is
the multi-contact-mode tick: ``cfg.contacts`` is a candidate set and each
call takes a per-scenario ``contact_mask`` (the ``MaskedTick`` signature, so
``make_control_loop`` drives either).  ``backend="cuda"`` runs
``tick_prestage`` then ``tick_qpchain`` (``ops/tick_cuda.py``);
``backend="torch"`` runs the plain element-leading program
(``ops/tick_kernel.py``) on any device.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.tick_kernel import SERVO_ELEM_SHAPES, TickProgram
from .pipeline import TickResult, qp_error_flag


class FusedTick(nn.Module):
    """One WBC tick for a fixed configuration; the model's constant tables
    are buffers on ``device``."""

    def __init__(self, model, cfg, device, dtype=torch.float32, backend="cuda",
                 masked=False):
        super().__init__()
        device = torch.device(device)
        if backend not in ("torch", "cuda"):
            raise ValueError(f"backend must be 'torch' or 'cuda', got {backend!r}")
        if backend == "cuda":
            if not torch.cuda.is_available() or device.type != "cuda":
                raise RuntimeError("FusedTick(backend='cuda') needs a CUDA device")
            if dtype != torch.float32:
                raise TypeError("the CUDA tick kernels are float32")
            # exact float32 products on the card (no TF32 rounding)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.backend = backend
        self.masked = masked
        self.prog = TickProgram(model, cfg, device, dtype, masked=masked)
        if backend == "cuda":
            from ..ops.tick_cuda import TickKernels

            self.kernels = TickKernels(self.prog)

    @property
    def device(self):
        return self.prog.axis.device

    def init_warm(self, batch=()):
        """Cold warm state: per QP (zeros (batch, n), ones (batch, m))."""
        batch = tuple(batch)
        return tuple(
            (torch.zeros(batch + (nv,), dtype=self.dtype, device=self.device),
             torch.ones(batch + (rows,), dtype=self.dtype, device=self.device))
            for nv, rows in self.prog.plan.qp_dims
        )

    # ------------------------------------------------------------ servos
    def _servo_fields(self, sp, B):
        """ServoParams → dict of batched (B, elem...) tensors; a leaf
        without the batch dim serves every lane."""
        d = {}
        for f in sp._fields:
            leaf = torch.as_tensor(getattr(sp, f), dtype=self.dtype, device=self.device)
            es = SERVO_ELEM_SHAPES[f]
            if leaf.ndim == len(es):
                leaf = leaf.expand((B,) + es)
            d[f] = leaf
        return d

    def _servos_batched(self, servos, B):
        """Nested per-level / per-spec ServoParams → per level None or a
        tuple of per-spec dict-or-None of batched tensors."""
        if servos is None:
            return None
        out = []
        for h in range(len(self.prog.plan.task_slots)):
            lvl = servos[h] if h < len(servos) else None
            out.append(None if lvl is None else tuple(
                None if sp is None else self._servo_fields(sp, B) for sp in lvl))
        return tuple(out)

    def _servos_el(self, servos, B):
        """``_servos_batched`` element-leading: (elem..., B) contiguous, as
        ``TickProgram`` and the kernels take them."""
        return tuple(None if lvl is None else tuple(
            None if d is None else {k: v.movedim(0, -1).contiguous() for k, v in d.items()}
            for d in lvl) for lvl in self._servos_batched(servos, B))

    def _tick_impl(self, q, qdot, fstars, contact_mask=None, warm=None, qp_iters=None,
                   servos=None):
        """q (B, nq) or (nq,), q̇ alike, f* per level (B, t) or (t,),
        contact_mask (B, nc) or (nc,) in masked mode (a 1-D mask serves the
        whole batch), warm per QP (x, λ) or None → TickResult, and the warm
        state out when warm was given.  servos: CompiledTick's nested per-level
        / per-spec ServoParams; q̇ feeds the servo'd task links' velocities.
        Without servos q̇ is unused: the tick compensates gravity, not
        Coriolis."""
        if (contact_mask is not None) != self.masked:
            raise ValueError("contact_mask goes with FusedTick(masked=True), and only there")
        iters = self.cfg.qp_iters if qp_iters is None else qp_iters

        def as_t(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        q = as_t(q)
        fstars = tuple(as_t(f) for f in fstars)
        batched = q.ndim == 2
        if not batched:
            q = q[None]
            fstars = tuple(f[None] for f in fstars)
            if warm is not None:
                warm = tuple((as_t(x)[None], as_t(l)[None]) for x, l in warm)
        qd_el = sv_el = None
        if servos is not None:
            qdot = as_t(qdot)
            qd_el = (qdot if batched else qdot[None]).T.contiguous()
            sv_el = self._servos_el(servos, q.shape[0])
        q_el = q.T.contiguous()
        fs_el = [f.T.contiguous() for f in fstars]
        cm_el = None
        if self.masked:
            cmask = as_t(contact_mask)
            if cmask.ndim == 1:
                cmask = cmask[:, None].expand(cmask.shape[0], q_el.shape[1])
            else:
                cmask = cmask.T
            cm_el = cmask.contiguous()
        w_el = None
        if warm is not None:
            w_el = [(as_t(x).T.contiguous(), as_t(l).T.contiguous()) for x, l in warm]
        ticker = self.kernels if self.backend == "cuda" else self.prog
        out = ticker.tick(q_el, fs_el, warm=w_el, iters=iters, cmask=cm_el, qdot=qd_el,
                          servos=sv_el)

        def bm(t):
            return t.movedim(-1, 0)

        result = TickResult(
            torque_grav=bm(out["torque_grav"]),
            torque_task=bm(out["torque_task"]),
            torque_contact=bm(out["torque_contact"]),
            torque_cmd=bm(out["torque_cmd"]),
            contact_force=bm(out["contact_force"]),
            qp_gap=out["qp_gap"],
            qp_primal_res=out["qp_primal_res"],
            contact_rank_health=out["health"],
            qp_error=qp_error_flag(out["qp_gap"], out["qp_primal_res"],
                                   bm(out["torque_cmd"]), self.cfg),
        )
        wout = tuple((bm(x), bm(l)) for x, l in out["warm_out"])
        if not batched:
            result = TickResult(*(r[0] for r in result))
            wout = tuple((x[0], l[0]) for x, l in wout)
        return (result, wout) if warm is not None else result

    def forward(self, q, qdot, fstars, contact_mask=None, warm=None, qp_iters=None,
                servos=None):
        return self._tick_impl(q, qdot, fstars, contact_mask, warm=warm, qp_iters=qp_iters,
                               servos=servos)
