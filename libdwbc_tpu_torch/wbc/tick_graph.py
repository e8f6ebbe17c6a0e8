"""The host path of ``FusedTick``: each call's key, its staged inputs and
the entry that runs it, on either backend.

A call is, for its key (``graph_key``: batched, B, warm given, the IPM
budget, the mask's shape, and where each input group lives), always the
same work on inputs of the same shapes.  Its entry keeps them in static
buffers (``Staged``, the one writer of the element-leading layout that the
kernels and ``TickProgram`` read) and runs the tick's body on them: the
upload of the host-resident rows, the prestage (or a held one), the QP
chain and ``qp_error_flag``.  The backend gives the body its two stage
functions (``FusedTick``): ``TickKernels``' two launches, or
``TickProgram``'s prestage and QP chain.

A tick keeps at most ``KEYS_MAX`` entries.  On the card a kept entry's
body is captured into a CUDA graph over its buffers: the key's first call
runs the body on the capture's side stream (that call's results), then
captures; each later call stages its inputs and replays.  Each graph shares
one memory pool with the tick's other graphs (they replay one at a time on
the caller's stream, each with its own outputs).  Every other call runs the
body as it is: on the plain backend, and in a transient entry made for
the call: a servo'd call (its servos go to the body unstaged), a call past
``KEYS_MAX``, and one whose inputs the key cannot place (converted to the
tick's dtype and device first).

A kept whole-tick entry holds the prestage of its last run that executed
(a replay or a direct run, not a capture); a transient entry holds none.
A call that may take a held prestage (``FusedTick`` decides: the control
loop's full-budget re-solve repeats the warm tick's q) is served by the
entry of the QP chain alone on it, keyed by the source entry's key and the
call's: its own staged f* and warm state.

``results()`` copies an entry's outputs for each call, so that no result
aliases a buffer that a later call writes: the static inputs, a graph's
outputs, a held prestage.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import torch

from .. import tracing
from ..ops.tick_cuda import unpack_result
from .pipeline import qp_error_flag

# entries kept per tick; a call of any further key runs in a transient one
KEYS_MAX = 8
# the input groups, in the order of their rows in the static buffers; q̇
# only in a servo'd call
GROUPS = ("q", "fstars", "warm", "mask", "qdot")


def tick_dims(tick):
    """What a key checks the inputs against: (nq, ndof, f* rows per level,
    (n, m) per QP, candidate contacts or None for an unmasked tick)."""
    plan = tick.prog.plan
    return (plan.nq, plan.ndof, tuple(plan.level_tdofs), tuple(plan.qp_dims),
            len(tick.cfg.contacts) if tick.masked else None)


def _leaves(q, fstars, mask, warm, qdot):
    """The call's input tensors per group (absent groups left out)."""
    groups = {"q": [q], "fstars": list(fstars)}
    if warm is not None:
        groups["warm"] = [t for xl in warm for t in xl]
    if mask is not None:
        groups["mask"] = [mask]
    if qdot is not None:
        groups["qdot"] = [qdot]
    return groups


def graph_key(q, fstars, mask, warm, iters, qdot, dims, device):
    """The key of a call, or None where the key cannot place it (an input
    that is neither a numpy array nor a tensor on the host or ``device``, a
    group in two places, a shape the tick does not take).

    qdot: a servo'd call's q̇, None in a call without servos.  dims:
    ``tick_dims``.  The key: batched, B, warm given, the IPM budget, the
    mask's shape, and per group (``GROUPS``) "host", "device" or None
    (absent)."""
    nq, ndof, tdofs, qp_dims, nc = dims
    shape = getattr(q, "shape", None)
    if (shape is None or len(shape) not in (1, 2) or shape[-1] != nq
            or len(fstars) != len(tdofs) or (mask is None) != (nc is None)):
        return None
    lead = tuple(shape[:-1])
    B = lead[0] if lead else 1
    if B < 1:
        return None

    def where(leaves, shapes):
        """"device" when every leaf is a tensor on ``device``, "host" when
        every leaf is a numpy array or a CPU tensor, each of its shape."""
        at = None
        for x, want in zip(leaves, shapes):
            if isinstance(x, torch.Tensor):
                d = x.device
                w = "device" if d == device else "host" if d.type == "cpu" else None
            else:
                w = "host" if isinstance(x, np.ndarray) else None
            if w is None or at not in (None, w) or x.shape != want:
                return None
            at = w
        return at

    key = {"q": where((q,), (lead + (nq,),)),
           "fstars": where(fstars, [lead + (t,) for t in tdofs])}
    if warm is not None:
        if len(warm) != len(qp_dims) or any(len(xl) != 2 for xl in warm):
            return None
        key["warm"] = where([t for xl in warm for t in xl],
                            [lead + (d,) for nm in qp_dims for d in nm])
    if mask is not None:
        key["mask"] = where((mask,), ((nc,) if len(getattr(mask, "shape", ())) == 1
                                      else (B, nc),))
    if qdot is not None:
        key["qdot"] = where((qdot,), (lead + (ndof,),))
    if None in key.values():
        return None
    return (bool(lead), B, warm is not None, int(iters),
            None if mask is None else tuple(mask.shape)) + tuple(key.get(g) for g in GROUPS)


class Staged:
    """The static inputs of one key, as the kernels and ``TickProgram``
    read them.

    ``el`` (rows, B) in the tick's dtype on its device holds q (nq, B), the
    f* of every level concatenated, the warm (x, λ) of every QP
    concatenated, the mask (nc, B) and q̇ (ndof, B), host-resident groups'
    rows first; a group the key places nowhere (None) has no rows.
    ``host`` (on a CUDA device pinned) holds those rows, staged by
    ``np.copyto`` and uploaded by one copy.  A device-resident group is
    staged by one op: a ``copy_`` of a single tensor into its rows
    (transposed), or a ``torch.cat`` of several into its rows (B = 1) or
    into a batch-major buffer that ``upload`` transposes into its rows.

    The kernels read ``q``, ``fs``, ``win``, ``cmask`` and ``qdot`` (each
    None where absent); the plain body ``fstars`` (per level) and ``warm``
    ((x, λ) per QP, or None): row views of ``el``."""

    def __init__(self, key, dims, device, dtype):
        nq, ndof, tdofs, qp_dims, nc = dims
        batched, B, warm_given, _, mask_shape = key[:5]
        where = dict(zip(GROUPS, key[5:]))
        wrows = [d for nm in qp_dims for d in nm] if warm_given else []
        rows = {"q": [nq], "fstars": list(tdofs), "warm": wrows,
                "mask": [nc] if mask_shape is not None else [], "qdot": [ndof]}
        order = ([g for g in GROUPS if where[g] == "host"]
                 + [g for g in GROUPS if where[g] == "device"])
        like = dict(dtype=dtype, device=device)
        self.el = torch.empty((sum(sum(rows[g]) for g in order), B), **like)
        n_host = sum(sum(rows[g]) for g in order if where[g] == "host")
        self.host = self.host_np = None
        if n_host:
            self.host = torch.empty((n_host, B), dtype=dtype, pin_memory=device.type == "cuda")
            self.host_np = self.host.numpy()
        self.uploaded = torch.cuda.Event(external=True) if device.type == "cuda" else None
        self.view, self.targets, self.transposes = {}, [], []
        off = 0
        for g in order:
            n = sum(rows[g])
            self.view[g] = self.el[off:off + n]
            if where[g] == "host":
                sub = off
                for k, r in enumerate(rows[g]):
                    self.targets.append((g, k, "np", self.host_np[sub:sub + r].T))
                    sub += r
            elif len(rows[g]) == 1:
                self.targets.append((g, 0, "copy", self.view[g].T))
            elif B == 1:
                lead = (1,) if batched else ()
                self.targets.append((g, None, "cat", self.view[g].view(lead + (n,))))
            else:
                bm = torch.empty((B, n), **like)
                self.targets.append((g, None, "cat", bm))
                self.transposes.append((self.view[g], bm))
            off += n
        self.n_host = n_host
        self.q, self.fs, self.win, self.cmask, self.qdot = (self.view.get(g) for g in GROUPS)
        self.fstars = None if self.fs is None else self.fs.split(list(tdofs))
        self.warm = None
        if self.win is not None:
            parts = self.win.split(wrows)
            self.warm = list(zip(parts[0::2], parts[1::2]))

    def stage(self, q, fstars, mask, warm, qdot):
        """Write one call's inputs into the static buffers: host groups into
        ``host`` (after the previous upload from it has run), device groups
        by one op each on the current stream."""
        groups = _leaves(q, fstars, mask, warm, qdot)
        if self.uploaded is not None and self.host is not None:
            self.uploaded.synchronize()
        for g, k, how, tgt in self.targets:
            if how == "np":
                np.copyto(tgt, np.asarray(groups[g][k]), casting="unsafe")
            elif how == "copy":
                tgt.copy_(groups[g][k])
            else:
                torch.cat(groups[g], -1, out=tgt)

    def upload(self):
        """The device side of staging (the body's first step): the host
        rows' one copy, then the batch-major groups' transposes."""
        if self.host is not None:
            self.el[:self.n_host].copy_(self.host, non_blocking=True)
            if self.uploaded is not None:
                self.uploaded.record()
        for el, bm in self.transposes:
            el.copy_(bm.T)


class _Entry:
    """One key's static inputs and the tick's body on them; a captured
    entry also its graph and the graph's static outputs.

    source None: the whole tick, whose prestage ``pre`` the entry holds.
    Otherwise the QP chain alone on ``source``'s ``pre`` (its staged inputs
    f* and the warm state only).  servos: a servo'd call's, element-leading
    (``FusedTick._servos_el``)."""

    def __init__(self, owner, key, kept, source=None, servos=None):
        self.owner = weakref.proxy(owner)       # no cycle: a tick frees its graphs
        self.key, self.kept, self.source, self.servos = key, kept, source, servos
        self.batched, _, self.warm_given, self.iters = key[:4]
        self.captured = kept and owner.capture
        if source is not None:
            key = key[:5] + (None,) + key[6:8] + (None, None)
        self.staged = Staged(key, owner.dims, owner.device, owner.dtype)
        self.graph = self.graph_outs = self.outs = self.pre = None

    def _body(self):
        """The tick on the staged inputs → (prestage, (result buffer, warm
        buffer, qp_error))."""
        own, st = self.owner, self.staged
        st.upload()
        pre = own.prestage(st, self.servos) if self.source is None else self.source.pre
        out, wout = own.qpchain(pre, st, self.iters)
        res = unpack_result(own.plan, out, wout)
        err = qp_error_flag(res["qp_gap"], res["qp_primal_res"],
                            res["torque_cmd"].movedim(-1, 0), own.cfg)
        return pre, (out, wout, err)

    def run(self) -> bool:
        """Run this call: the body, or a captured entry's graph (on its first
        call the body on the side stream, then the capture).  Whether ``pre``
        now holds this call's prestage for a later call to take."""
        own = self.owner
        if not self.captured:
            self.pre, self.outs = self._body()
            own.counts["eager"] += 1
            return self.kept and self.source is None
        if self.graph is None:
            side, cur = own.side_stream(), torch.cuda.current_stream(own.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.outs = self._body()[1]
            cur.wait_stream(side)
            for t in self.outs:
                t.record_stream(cur)
            graph = torch.cuda.CUDAGraph()
            # a collection inside the capture that frees another CUDA graph
            # destroys it there, which invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with tracing.span("dwbc.tick.capture"):
                    with torch.cuda.graph(graph, pool=own.pool, stream=side,
                                          capture_error_mode="thread_local"):
                        self.pre, self.graph_outs = self._body()
            finally:
                if collecting:
                    gc.enable()
            self.graph = graph
            own.counts["captures"] += 1
            return False                # a capture executes nothing
        with tracing.span("dwbc.tick.replay"):
            self.graph.replay()
        own.counts["replays"] += 1
        launches = own.kernels.launches
        if self.source is None:
            launches["tick_prestage"] += 1
        launches["tick_qpchain"] += 1
        self.outs = self.graph_outs
        return self.source is None

    def results(self):
        """This call's (result dict, qp_error), element-leading, in fresh
        tensors (the warm buffer only when the call gave a warm state)."""
        out, wout, err = self.outs
        return (unpack_result(self.owner.plan, out.clone(),
                              wout.clone() if self.warm_given else wout), err.clone())


class TickEntries:
    """The entries of one ``FusedTick``: ``entry(...)`` gives the call's
    entry with its inputs staged.  ``counts``: captures, replays and runs
    not captured ("eager")."""

    def __init__(self, tick, capture):
        self.tick = weakref.proxy(tick)
        self.plan, self.cfg = tick.prog.plan, tick.cfg
        self.device, self.dtype = tick.device, tick.dtype
        self.dims = tick_dims(tick)
        self.capture = capture
        self.counts = tick.graph_counts
        self.kernels = getattr(tick, "kernels", None)
        self.prestage, self.qpchain = tick.stages
        self.kept = {}
        self.pool = self._side = None

    def side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        return self._side

    def entry(self, q, qdot, fstars, mask, warm, iters, servos, source=None):
        """The call's entry, its inputs staged: kept (found, or made while
        fewer than ``KEYS_MAX`` are) for a call without servos whose inputs
        the key places, else transient.  source: a kept entry that holds
        this call's prestage; the entry is then the QP chain's alone on
        it."""
        qdot = None if servos is None else qdot
        key = graph_key(q, fstars, mask, warm, iters, qdot, self.dims, self.device)
        placed = key is not None
        if not placed:
            def conv(x):
                return None if x is None else torch.as_tensor(x, dtype=self.dtype,
                                                              device=self.device)

            q, qdot, mask = conv(q), conv(qdot), conv(mask)
            fstars = tuple(conv(f) for f in fstars)
            warm = None if warm is None else tuple((conv(x), conv(lam)) for x, lam in warm)
            key = graph_key(q, fstars, mask, warm, iters, qdot, self.dims, self.device)
            if key is None:
                raise ValueError("the call's q, q̇, f*, warm state or contact mask do not "
                                 "have the tick's shapes")
        ekey = key if source is None else (source.key, key)
        entry = self.kept.get(ekey) if placed and servos is None else None
        if entry is None:
            kept = placed and servos is None and len(self.kept) < KEYS_MAX
            entry = _Entry(self, key, kept, source,
                           None if servos is None else self.tick._servos_el(servos, key[1]))
            if kept:
                self.kept[ekey] = entry
        entry.staged.stage(q, fstars, mask, warm, qdot)
        return entry
