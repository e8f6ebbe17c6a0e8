"""``FusedTick(backend="cuda")`` served from captured CUDA graphs.

A call without servos is, for its shape, always the same device work:
the inputs to element-leading float32, ``tick_prestage``, ``tick_qpchain``
and ``qp_error_flag``.  Eagerly, each call pays the host path in front of
the launches (casts, transposes, checks, ``torch.cat``s, ``torch.empty``s)
with the card idle.  Here each call shape (``graph_key``) gets static
element-leading input buffers (``Staged``) and a CUDA graph of the whole
tick over them: the upload of the host-resident inputs as its first node,
the device-resident inputs' transposes, both kernels and the failure flag.
A call then stages its inputs into the buffers, replays the graph and
copies its three outputs (results, warm state, ``qp_error``) into fresh
tensors, so that no result is overwritten by a later replay.

A key's first call runs the tick eagerly on the capture's side stream
(that call's results), then captures; each key's graph shares one memory
pool with the tick's other keys (they replay one at a time on the caller's
stream, and each keeps its own outputs).  A tick holds at most ``KEYS_MAX`` graphs;
calls of further keys, and calls the key refuses, run the eager path.

A whole tick's graph keeps its prestage buffer as a static output.  A call
whose prestage that buffer already holds (``FusedTick`` decides: the
control loop's full-budget re-solve repeats the warm tick's q) is served
by a graph of the QP chain alone on it, keyed by the whole tick's key and
the call's: its own staged f* and warm state, ``tick_qpchain`` and the
failure flag.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import torch

from .. import tracing
from .pipeline import qp_error_flag

# graphs per tick; calls of any further key run eagerly
KEYS_MAX = 8
# the input groups, in the order of their rows in the static buffers
GROUPS = ("q", "fstars", "warm", "mask")


def _leaves(q, fstars, mask, warm):
    """The call's input tensors per group (absent groups left out)."""
    groups = {"q": [q], "fstars": list(fstars)}
    if warm is not None:
        groups["warm"] = [t for xl in warm for t in xl]
    if mask is not None:
        groups["mask"] = [mask]
    return groups


def graph_key(q, fstars, mask, warm, iters, servos, dims, device):
    """The graph key of a call, or None where the call is not one the graphs
    take (servos, an input that is neither a numpy array nor a tensor on
    the host or ``device``, a shape the eager path would refuse).

    dims: (nq, f* rows per level, (n, m) per QP, candidate contacts or None
    for an unmasked tick).  The key: batched, B, warm given, the IPM
    budget, the mask's shape, and per group (q, f*, warm, mask) "host",
    "device" or None (absent)."""
    nq, tdofs, qp_dims, nc = dims
    shape = getattr(q, "shape", None)
    if (servos is not None or shape is None or len(shape) not in (1, 2) or shape[-1] != nq
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
    if None in key.values():
        return None
    return (bool(lead), B, warm is not None, int(iters),
            None if mask is None else tuple(mask.shape)) + tuple(key.get(g) for g in GROUPS)


class Staged:
    """The static inputs of one key, as the kernels read them.

    ``el`` (rows, B) float32 on the device holds q (nq, B), the f* of every
    level concatenated, the warm (x, λ) of every QP concatenated and the
    mask (nc, B), host-resident groups' rows first; a group the key places
    nowhere (None) has no rows.  ``host`` (on a CUDA
    device pinned) holds those rows, staged by ``np.copyto`` and uploaded
    by one copy.  A device-resident group is staged by one op: a ``copy_``
    of a single tensor into its rows (transposed), or a ``torch.cat`` of
    several into its rows (B = 1) or into a batch-major buffer that
    ``upload`` transposes into its rows."""

    def __init__(self, key, dims, device):
        nq, tdofs, qp_dims, nc = dims
        batched, B, warm_given, _, mask_shape = key[:5]
        where = dict(zip(GROUPS, key[5:]))
        rows = {"q": [nq], "fstars": list(tdofs),
                "warm": [d for nm in qp_dims for d in nm] if warm_given else [],
                "mask": [nc] if mask_shape is not None else []}
        order = ([g for g in GROUPS if where[g] == "host"]
                 + [g for g in GROUPS if where[g] == "device"])
        f32 = dict(dtype=torch.float32, device=device)
        self.el = torch.empty((sum(sum(rows[g]) for g in order), B), **f32)
        n_host = sum(sum(rows[g]) for g in order if where[g] == "host")
        self.host = self.host_np = None
        if n_host:
            self.host = torch.empty((n_host, B), dtype=torch.float32,
                                    pin_memory=device.type == "cuda")
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
                bm = torch.empty((B, n), **f32)
                self.targets.append((g, None, "cat", bm))
                self.transposes.append((self.view[g], bm))
            off += n
        self.n_host = n_host
        # what the kernels read
        self.q = self.view.get("q")
        self.fs = self.view["fstars"]
        self.win = self.view.get("warm")
        self.cmask = self.view.get("mask")

    def stage(self, q, fstars, mask, warm):
        """Write one call's inputs into the static buffers: host groups into
        ``host`` (after the previous upload from it has run), device groups
        by one op each on the current stream."""
        groups = _leaves(q, fstars, mask, warm)
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
        """The device side of staging (what the graph captures first): the
        host rows' one copy, then the batch-major groups' transposes."""
        if self.host is not None:
            self.el[:self.n_host].copy_(self.host, non_blocking=True)
            if self.uploaded is not None:
                self.uploaded.record()
        for el, bm in self.transposes:
            el.copy_(bm.T)


class _Graph:
    """One key's static inputs, its graph and the graph's static outputs.

    source None: the whole tick, whose prestage buffer ``pre`` is a static
    output too.  Otherwise the QP chain alone on ``source``'s ``pre``
    (its staged inputs f* and the warm state only)."""

    def __init__(self, owner, key, source=None):
        self.owner = weakref.proxy(owner)       # no cycle: a tick frees its graphs
        self.source, self.key = source, key
        self.batched, _, self.warm_given, self.iters = key[:4]
        if source is not None:
            key = key[:5] + (None,) + key[6:8] + (None,)
        self.staged = Staged(key, owner.dims, owner.device)
        self.graph = self.outs = self.first = self.pre = None

    def _body(self):
        """The tick on the staged inputs → (prestage buffer, (results, warm
        state, qp_error))."""
        st, k = self.staged, self.owner.kernels
        st.upload()
        pre = (k.prestage_staged(st.q, st.cmask) if self.source is None
               else self.source.pre)
        out, wout = k.qpchain_staged(pre, st.fs, st.win, self.iters)
        res = k.unpack_result(out, wout)
        err = qp_error_flag(res["qp_gap"], res["qp_primal_res"],
                            res["torque_cmd"].movedim(-1, 0), self.owner.cfg)
        return pre, (out, wout, err)

    def run(self) -> bool:
        """Replay the graph; on the key's first call run the tick eagerly on
        the side stream (this call's results), then capture.  Whether
        ``pre`` now holds this call's prestage: after a replay of a whole
        tick, not after a capture, which executes nothing."""
        own = self.owner
        if self.graph is None:
            side, cur = own.side_stream(), torch.cuda.current_stream(own.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.first = self._body()[1]
            cur.wait_stream(side)
            for t in self.first:
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
                        self.pre, self.outs = self._body()
            finally:
                if collecting:
                    gc.enable()
            self.graph = graph
            own.counts["captures"] += 1
            held = False
        else:
            with tracing.span("dwbc.tick.replay"):
                self.graph.replay()
            own.counts["replays"] += 1
            held = self.source is None
        launches = own.kernels.launches
        if self.source is None:
            launches["tick_prestage"] += 1
        launches["tick_qpchain"] += 1
        return held

    def results(self):
        """This call's (results, warm state, qp_error) in fresh tensors."""
        if self.first is not None:
            out, self.first = self.first, None
            return out
        out, wout, err = self.outs
        return out.clone(), wout.clone() if self.warm_given else wout, err.clone()


class TickGraphs:
    """The graphs of one ``FusedTick(backend="cuda")``: ``graph(...)`` gives
    the call's ``_Graph`` with its inputs staged, or None for the eager
    path; with ``source`` (a whole tick's ``_Graph`` whose ``pre`` holds
    this call's prestage) the graph of the QP chain alone on it, or None.
    ``counts``: captures, replays and eager calls."""

    def __init__(self, tick, counts):
        plan = tick.prog.plan
        self.kernels, self.cfg, self.device = tick.kernels, tick.cfg, tick.device
        self.dims = (plan.nq, tuple(plan.level_tdofs), tuple(plan.qp_dims),
                     len(tick.cfg.contacts) if tick.masked else None)
        self.counts = counts
        self.graphs = {}
        self.pool = self._side = None

    def side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        return self._side

    def graph(self, q, fstars, mask, warm, iters, servos, source=None):
        key = graph_key(q, fstars, mask, warm, iters, servos, self.dims, self.device)
        if key is None:
            return None
        gkey = key if source is None else (source.key, key)
        g = self.graphs.get(gkey)
        if g is None and len(self.graphs) < KEYS_MAX:
            g = self.graphs[gkey] = _Graph(self, key, source)
        if g is not None:
            g.staged.stage(q, fstars, mask, warm)
        return g
