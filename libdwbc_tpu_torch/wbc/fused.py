"""FusedTick: the whole WBC tick as two CUDA kernel launches.

Counterpart of ``libdwbc_tpu/wbc/fused.py::FusedTick`` in static mode (no
masked contact sets, no servo): the same ``_tick_impl`` / ``init_warm``
serving contract and the same warm-state shapes, with batch-major inputs and
results.  ``backend="cuda"`` runs ``tick_prestage`` then ``tick_qpchain``
(``ops/tick_cuda.py``); ``backend="torch"`` runs the plain element-leading
program (``ops/tick_kernel.py``) on any device.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.tick_kernel import TickProgram
from .pipeline import TickResult, qp_error_flag


class FusedTick(nn.Module):
    """One WBC tick for a fixed configuration; the model's constant tables
    are buffers on ``device``."""

    def __init__(self, model, cfg, device, dtype=torch.float32, backend="cuda"):
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
        self.prog = TickProgram(model, cfg, device, dtype)
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

    def _tick_impl(self, q, qdot, fstars, warm=None, qp_iters=None):
        """q (B, nq) or (nq,), f* per level (B, t) or (t,), warm per QP
        (x, λ) or None → TickResult, and the warm state out when warm was
        given.  qdot is accepted for interface parity; the tick compensates
        gravity, not Coriolis, and runs no servo."""
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
        q_el = q.T.contiguous()
        fs_el = [f.T.contiguous() for f in fstars]
        w_el = None
        if warm is not None:
            w_el = [(as_t(x).T.contiguous(), as_t(l).T.contiguous()) for x, l in warm]
        ticker = self.kernels if self.backend == "cuda" else self.prog
        out = ticker.tick(q_el, fs_el, warm=w_el, iters=iters)

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

    def forward(self, q, qdot, fstars, warm=None, qp_iters=None):
        return self._tick_impl(q, qdot, fstars, warm=warm, qp_iters=qp_iters)
