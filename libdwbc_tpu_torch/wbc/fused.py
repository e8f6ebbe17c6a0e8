"""FusedTick: the whole WBC tick as two CUDA kernel launches.

Counterpart of ``libdwbc_tpu/wbc/fused.py::FusedTick``: the same
``_tick_impl`` / ``init_warm`` serving contract and the same warm-state
shapes, with batch-major inputs and results.  ``servos=`` runs the
on-device trajectory-PD servo inside the tick (inside ``tick_prestage``
under ``backend="cuda"``), fed by q̇.  ``masked=True`` is
the multi-contact-mode tick: ``cfg.contacts`` is a candidate set and each
call takes a per-scenario ``contact_mask`` (the ``MaskedTick`` signature, so
``make_control_loop`` drives either).

Every call takes one route on either backend: its key, its entry and its
staged inputs (``wbc/tick_graph.py``, the one owner of the element-leading
layout), the body on them, the results batch-major.  The backend chooses
the body's two stage functions (``backend="cuda"``: ``tick_prestage`` and
``tick_qpchain``, ``ops/tick_cuda.py``; ``backend="torch"``: the plain
element-leading program, ``ops/tick_kernel.py``, on any device and dtype)
and whether a kept key is captured into a CUDA graph (on the card).
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from .. import tracing
from ..ops.tick_cuda import TickKernels, pack_result, pack_servos, servo_mask
from ..ops.tick_kernel import SERVO_ELEM_SHAPES, TickProgram
from .pipeline import TickResult, card_setup
from .tick_graph import TickEntries


# The body's two stage functions per backend (``tick_graph._Entry._body``):
# the prestage of an entry's staged inputs (servos element-leading, or
# None), and the QP chain on a prestage → (result buffer, warm buffer).
def _kernels_prestage(k, st, servos):
    smask = servo_mask(servos, k.plan)
    if not smask:
        return k.prestage_staged(st.q, st.cmask)
    return k.prestage_staged(st.q, st.cmask, st.qdot, st.fs,
                             pack_servos(servos, k.plan, st.el.shape[1]), smask)


def _kernels_qpchain(k, pre, st, iters):
    return k.qpchain_staged(pre, None if pre.servo else st.fs, st.win, iters)


def _plain_prestage(prog, st, servos):
    if servos is None:
        return prog.prestage(st.q, st.cmask)
    return prog.prestage_servo(st.q, st.cmask, st.qdot, st.fstars, servos)


def _plain_qpchain(prog, pre, st, iters):
    res = prog.qpchain(pre, pre.get("fstars", st.fstars), warm=st.warm, iters=iters)
    return pack_result(prog.plan, res)


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
        # how often a call was served by a captured graph, and how often not
        self.graph_counts = {"captures": 0, "replays": 0, "eager": 0}
        # calls that took the previous call's prestage; what the next may take
        # (a list: a module's attribute assignment costs microseconds a call)
        self.prestage_reuses = 0
        self._last = [None]
        if backend == "cuda":
            self.kernels = TickKernels(self.prog)
            self.stages = (partial(_kernels_prestage, self.kernels),
                           partial(_kernels_qpchain, self.kernels))
        else:
            self.stages = (partial(_plain_prestage, self.prog), partial(_plain_qpchain, self.prog))
        self.entries = TickEntries(self, capture=backend == "cuda")

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
        Coriolis.  Inputs: numpy arrays, tensors or sequences, any float
        dtype, on the host or the tick's device.

        The three stages are the spans ``dwbc.tick.prep`` (the call's entry
        found or made, its inputs staged), ``dwbc.tick.run`` (the entry's
        graph replayed or captured, or its body run) and ``dwbc.tick.post``
        (the outputs copied; the results batch-major).  ``graph_counts``
        counts captures, replays and runs not captured.

        Without servos the prestage depends on q and the mask alone.  A
        call without servos whose q, and mask, are the very tensors of the
        previous call, on the tick's device and not modified in place since
        (their ``_version``), takes that call's prestage and runs the QP
        chain alone (``prestage_reuses``, the counter
        ``dwbc.tick.prestage_reused``): the control loop's full-budget
        re-solve of a warm tick.  The previous call leaves one where its
        kept entry executed (not a graph's capture); a servo'd call, one
        past ``KEYS_MAX`` and one whose inputs were converted leave none.
        An input written behind torch's back (through numpy, ``.data`` or a
        raw pointer) between two calls has to be a new tensor."""
        with tracing.span("dwbc.tick.prep"):
            if (contact_mask is not None) != self.masked:
                raise ValueError("contact_mask goes with FusedTick(masked=True), and only there")
            iters = self.cfg.qp_iters if qp_iters is None else qp_iters
            held = self._held_pre(q, contact_mask, servos)
            if held is not None:
                self.prestage_reuses += 1
                tracing.count("dwbc.tick.prestage_reused", 1)
            entry = self.entries.entry(q, qdot, fstars, contact_mask, warm, iters, servos,
                                       source=held)
        with tracing.span("dwbc.tick.run"):
            holds = entry.run()
            if held is None:
                self._hold(q, contact_mask, entry if holds else None)
        with tracing.span("dwbc.tick.post"):
            return self._batch_major(*entry.results(), entry.batched, warm is not None)

    def _hold(self, q, mask, entry):
        """Remember this call's q and mask, with their versions, and the
        entry that holds its prestage (None: none to take), where both
        inputs are tensors on the tick's device."""
        last = None
        if entry is not None:
            dev = self.device
            if all(x is None or (isinstance(x, torch.Tensor) and x.device == dev)
                   for x in (q, mask)):
                last = (q, q._version, mask, None if mask is None else mask._version, entry)
        self._last[0] = last

    def _held_pre(self, q, mask, servos):
        """The entry holding the previous call's prestage if this call may
        take it, else None."""
        last = self._last[0]
        if last is None or servos is not None:
            return None
        lq, qv, lm, mv, entry = last
        if q is not lq or q._version != qv or mask is not lm:
            return None
        if mask is not None and mask._version != mv:
            return None
        return entry

    def _batch_major(self, out, qp_error, batched, warm_given):
        """An entry's element-leading results and qp_error (B,) as the
        TickResult (and the warm state out when warm was given),
        batch-major."""

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
            qp_error=qp_error,
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
