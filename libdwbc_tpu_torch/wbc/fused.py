"""FusedTick: the whole WBC tick as two CUDA kernel launches.

Counterpart of ``libdwbc_tpu/wbc/fused.py::FusedTick``: the same
``_tick_impl`` / ``init_warm`` serving contract and the same warm-state
shapes, with batch-major inputs and results.  ``servos=`` runs the
on-device trajectory-PD servo inside the tick (inside ``tick_prestage``
under ``backend="cuda"``), fed by q̇.  ``masked=True`` is
the multi-contact-mode tick: ``cfg.contacts`` is a candidate set and each
call takes a per-scenario ``contact_mask`` (the ``MaskedTick`` signature, so
``make_control_loop`` drives either).  ``backend="cuda"`` runs
``tick_prestage`` then ``tick_qpchain`` (``ops/tick_cuda.py``), a call
without servos from the CUDA graph of its shape (``wbc/tick_graph.py``);
``backend="torch"`` runs the plain element-leading program
(``ops/tick_kernel.py``) on any device.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import tracing
from ..ops.tick_kernel import SERVO_ELEM_SHAPES, TickProgram
from .pipeline import TickResult, card_setup, qp_error_flag


class FusedTick(nn.Module):
    """One WBC tick for a fixed configuration; the model's constant tables
    are buffers on ``device``."""

    def __init__(self, model, cfg, device, dtype=torch.float32, backend="cuda",
                 masked=False):
        super().__init__()
        device = card_setup("FusedTick", device, dtype, backend)
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.backend = backend
        self.masked = masked
        self.prog = TickProgram(model, cfg, device, dtype, masked=masked)
        # how often a call was served by a captured graph, and how often eagerly
        self.graph_counts = {"captures": 0, "replays": 0, "eager": 0}
        # calls that took the previous call's prestage; what the next may take
        # (a list: a module's attribute assignment costs microseconds a call)
        self.prestage_reuses = 0
        self._last = [None]
        self.graphs = None
        if backend == "cuda":
            from ..ops.tick_cuda import TickKernels
            from .tick_graph import TickGraphs

            self.kernels = TickKernels(self.prog)
            self.graphs = TickGraphs(self, self.graph_counts)

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
        Coriolis.

        Under ``backend="cuda"`` a call without servos is served by the CUDA
        graph of its shape (``wbc/tick_graph.py``; ``graph_counts``), any
        other eagerly.  The three stages are the spans ``dwbc.tick.prep``
        (the inputs staged, or made element-leading), ``dwbc.tick.run`` (the
        graph's replay or capture, or the launches) and ``dwbc.tick.post``
        (the graph's outputs copied; the results batch-major).

        Without servos the prestage depends on q and the mask alone.  A
        call without servos whose q, and mask, are the very tensors of the
        previous call, on the tick's device and not modified in place since
        (their ``_version``), takes that call's prestage and runs the QP
        chain alone (``prestage_reuses``, the counter
        ``dwbc.tick.prestage_reused``): the control loop's full-budget
        re-solve of a warm tick.  The held prestage is that of a graph's
        replay (not of its capture, which executes nothing) or of the plain
        path; the eager CUDA path (servos, keys past ``KEYS_MAX``) holds
        none.  An input written behind torch's back (through numpy, ``.data``
        or a raw pointer) between two calls has to be a new tensor."""
        with tracing.span("dwbc.tick.prep"):
            if (contact_mask is not None) != self.masked:
                raise ValueError("contact_mask goes with FusedTick(masked=True), and only there")
            iters = self.cfg.qp_iters if qp_iters is None else qp_iters
            held = self._held_pre(q, contact_mask, servos)
            graph = None
            if self.graphs is not None:
                if held is not None:
                    graph = self.graphs.graph(q, fstars, contact_mask, warm, iters, servos,
                                              source=held)
                    if graph is None:
                        held = None
                if graph is None:
                    graph = self.graphs.graph(q, fstars, contact_mask, warm, iters, servos)
            if held is not None:
                self.prestage_reuses += 1
                tracing.count("dwbc.tick.prestage_reused", 1)
            if graph is None:
                self.graph_counts["eager"] += 1
                batched, q_el, fs_el, kw = self._element_leading(q, qdot, fstars, contact_mask,
                                                                 warm, servos)
                kw["iters"] = iters
        with tracing.span("dwbc.tick.run"):
            left = None                 # the prestage this call leaves to take
            if graph is not None:
                if graph.run():
                    left = graph
            elif self.backend == "torch" and servos is None:
                left = held if held is not None else self.prog.prestage(q_el, kw["cmask"])
                out = self.prog.qpchain(left, fs_el, warm=kw["warm"], iters=iters)
                # the results alias these two fields of the prestage
                out.update(torque_grav=out["torque_grav"].clone(),
                           health=out["health"].clone())
            else:
                ticker = self.kernels if self.backend == "cuda" else self.prog
                out = ticker.tick(q_el, fs_el, **kw)
            if held is None:
                self._hold(q, contact_mask, left)
        with tracing.span("dwbc.tick.post"):
            if graph is None:
                return self._batch_major(out, batched, warm is not None)
            out, wout, err = graph.results()
            return self._batch_major(self.kernels.unpack_result(out, wout), graph.batched,
                                     warm is not None, err)

    def _hold(self, q, mask, pre):
        """Remember this call's q and mask, with their versions, and the
        prestage it leaves behind (None: none to take), where both inputs
        are tensors on the tick's device."""
        last = None
        if pre is not None:
            dev = self.device
            if all(x is None or (isinstance(x, torch.Tensor) and x.device == dev)
                   for x in (q, mask)):
                last = (q, q._version, mask, None if mask is None else mask._version, pre)
        self._last[0] = last

    def _held_pre(self, q, mask, servos):
        """The previous call's held prestage if this call may take it, else
        None."""
        last = self._last[0]
        if last is None or servos is not None:
            return None
        lq, qv, lm, mv, pre = last
        if q is not lq or q._version != qv or mask is not lm:
            return None
        if mask is not None and mask._version != mv:
            return None
        return pre

    def _element_leading(self, q, qdot, fstars, contact_mask, warm, servos):
        """(batched, q, f*, the other inputs by keyword) of a call,
        element-leading and contiguous, as ``TickProgram.tick`` and the
        kernels take them."""

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
        return batched, q_el, fs_el, dict(warm=w_el, cmask=cm_el, qdot=qd_el, servos=sv_el)

    def _batch_major(self, out, batched, warm_given, qp_error=None):
        """The kernels' element-leading outputs as the TickResult (and the
        warm state out when warm was given), batch-major; ``qp_error`` when
        it was computed already (B,)."""

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
            qp_error=qp_error if qp_error is not None else qp_error_flag(
                out["qp_gap"], out["qp_primal_res"], bm(out["torque_cmd"]), self.cfg),
        )
        wout = tuple((bm(x), bm(l)) for x, l in out["warm_out"])
        if not batched:
            result = TickResult(*(r[0] for r in result))
            wout = tuple((x[0], l[0]) for x, l in wout)
        return (result, wout) if warm_given else result

    def forward(self, q, qdot, fstars, contact_mask=None, warm=None, qp_iters=None,
                servos=None):
        return self._tick_impl(q, qdot, fstars, contact_mask, warm=warm, qp_iters=qp_iters,
                               servos=servos)
