"""Spans inside the port's host path: where a served tick's host time goes.

A span records only while a torch profiler session is recording, or
between ``start()`` and ``stop()``.  Otherwise ``span(name)`` is one check
and a no-op context manager, cheap enough to stay on the serving path.

    import torch
    from libdwbc_tpu_torch import tracing

    with torch.profiler.profile(activities=[...]) as prof:
        loop(q, qdot, fstars)                 # the spans record
    tracing.totals()                          # per name: count, total and self ns
    prof.export_chrome_trace("tick.json")     # the spans' twins beside the kernels

    tracing.start()                           # or without a profiler
    loop(q, qdot, fstars)
    tracing.stop()

Each record holds its name, its start and end on ``time.perf_counter_ns()``,
its parent (the innermost span of the same thread open when it started) and
its request: ``(sequence number, index)``, opened by the serving layer
around what it serves (a loop call's tick, a ``TickConsumer``'s call, a
mesh solver's step), so the spans of one tick share it; a span outside
any request block (a direct ``FusedTick`` call) carries None.  While a
profiler is recording, each span also opens a profiler range of its name
(its twin), so the profiler's events and an exported Chrome trace carry the
port's spans beside the device's kernels.

A new session, of either kind, starts an empty store of ``CAPACITY``
records; spans past it are counted in ``dropped()``.  The store takes one
pair of clocks when a session starts: ``to_profiler_ns`` puts a span's
time on the profiler's timeline, which is stamped on the epoch clock.  A
profiler session is noticed by the first span or request inside it, and
its end by the first one after it, or by a read of the store: two profiler
sessions with none of these between them share one store.

The spans and what they time:

==========================  ================================================
``dwbc.loop.sync``          the control loop's host read of the tripped
                            lanes' count
``dwbc.loop.resolve``       the loop's full-budget re-solve of a warm tick
                            and its per-lane selection
``dwbc.loop.transition``    the loop's transition between ticks
``dwbc.tick.prep``          ``FusedTick``: the call's key and entry, its
                            inputs staged into the entry's static buffers
``dwbc.tick.run``           ``FusedTick``: the entry's graph replayed or
                            captured, or its body run
``dwbc.tick.replay``        inside it: a CUDA graph's replay
``dwbc.tick.capture``       inside it: a CUDA graph's capture
``dwbc.tick.post``          ``FusedTick``: the entry's outputs copied, the
                            results batch-major
``dwbc.consumer``           one ``native.TickConsumer`` call
``dwbc.consumer.read``      its reads of τ_cmd and ``qp_error``
``dwbc.mesh.step``          one ``sharded_batch_solver`` step on this rank
==========================  ================================================

Counters, summed over the session while spans record (``count``; read in
``totals()`` as a count with no time):

==============================  ============================================
``dwbc.loop.resolve_lanes``     lanes whose result the loop took from a
                                re-solve
``dwbc.tick.prestage_reused``   ``FusedTick`` calls that took the previous
                                call's prestage (the QP chain alone)
==============================  ============================================
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

# a profiler range at a tenth of record_function's cost
from torch._C._profiler import _RecordFunctionFast as _Twin

NAMES = ("dwbc.loop.sync", "dwbc.loop.transition", "dwbc.tick.prep", "dwbc.tick.run",
         "dwbc.tick.post", "dwbc.consumer", "dwbc.consumer.read", "dwbc.mesh.step",
         "dwbc.tick.replay", "dwbc.tick.capture", "dwbc.loop.resolve",
         "dwbc.loop.resolve_lanes", "dwbc.tick.prestage_reused")
# over a minute of a B = 1024 control loop, at five spans a tick
CAPACITY = 1 << 18

_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None      # None while the span is open
    parent: int             # index into spans(), -1 for none (or not kept)
    request: tuple | None


class Total(NamedTuple):
    count: int
    total_ns: int
    self_ns: int            # less the time its child spans cover


class _Store:
    """The session's records and its clock anchor.  ``kind``: the open
    session's, "operator" or "profiler", or None (the records of the last
    one are kept)."""

    def __init__(self):
        self.operator = False
        self.kind = None
        self.begin(None)

    def begin(self, kind):
        self.kind, self.capacity = kind, CAPACITY
        self.records, self.dropped, self.counts = [], 0, {}
        self.wall_ns, self.perf_ns = time.time_ns(), time.perf_counter_ns()


class _Thread(threading.local):
    def __init__(self):
        self.stack = []
        self.request = None


_store = _Store()
_thread = _Thread()
_sequence = itertools.count()


def _recording() -> bool:
    if _store.operator:
        return True
    if _profiling():
        if _store.kind is None:
            _store.begin("profiler")
        return True
    if _store.kind == "profiler":
        _store.kind = None
    return False


class _Open:
    __slots__ = ("name", "start", "end", "parent", "request", "_twin")

    def __init__(self, name):
        self.name = name
        self.end = None

    def __enter__(self):
        th = _thread
        self.parent = th.stack[-1] if th.stack else None
        self.request = th.request
        self._twin = _Twin(self.name) if _profiling() else None
        if self._twin is not None:
            self._twin.__enter__()
        self.start = time.perf_counter_ns()
        if len(_store.records) < _store.capacity:
            _store.records.append(self)
        else:
            _store.dropped += 1
        th.stack.append(self)

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _thread.stack.pop()
        if self._twin is not None:
            self._twin.__exit__(None, None, None)
        return False


class _Request:
    __slots__ = ("request", "_outer")

    def __init__(self, request):
        self.request = request

    def __enter__(self):
        self._outer, _thread.request = _thread.request, self.request

    def __exit__(self, *exc):
        _thread.request = self._outer
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records the block as span ``name`` (one of
    ``NAMES``) while spans record, and does nothing otherwise."""
    return _Open(name) if _recording() else _OFF


def count(name: str, n: int):
    """Add ``n`` to counter ``name`` (one of ``NAMES``) while spans record;
    otherwise one check."""
    if _recording():
        _store.counts[name] = _store.counts.get(name, 0) + n


def sequence() -> int:
    """A new sequence number for a serving layer's requests."""
    return next(_sequence)


def request(seq: int, index: int):
    """A context manager: the spans this thread opens inside the block
    carry the request (seq, index)."""
    return _Request((seq, index)) if _recording() else _OFF


def start():
    """Start an operator's session: spans record, with or without a
    profiler, into an empty store, until ``stop()``."""
    _store.operator = True
    _store.begin("operator")


def stop():
    """End the operator's session; its records stay until the next session
    starts.  A profiler still recording goes on filling the store."""
    _store.operator = False
    _store.kind = "profiler" if _profiling() else None


def _kept() -> list:
    _recording()
    return list(_store.records)


def spans() -> list:
    """The session's span records, in the order they started."""
    recs = _kept()
    index = {id(r): i for i, r in enumerate(recs)}
    return [Span(r.name, r.start, r.end, index.get(id(r.parent), -1), r.request)
            for r in recs]


def totals() -> dict:
    """Per span name, the closed spans' ``Total``: count, total ns and self
    ns (its time less the part its child spans cover); per counter, its sum
    as the count and no time."""
    recs = spans()
    child = [0] * len(recs)
    for s in recs:
        if s.end_ns is not None and s.parent >= 0:
            child[s.parent] += s.end_ns - s.start_ns
    out = {}
    for s, c in zip(recs, child):
        if s.end_ns is None:
            continue
        n, tot, own = out.get(s.name, (0, 0, 0))
        d = s.end_ns - s.start_ns
        out[s.name] = Total(n + 1, tot + d, own + d - c)
    for name, n in _store.counts.items():
        out[name] = Total(n, 0, 0)
    return out


def dropped() -> int:
    """Spans of the session that the full store did not keep."""
    return _store.dropped


def to_profiler_ns(t: int) -> int:
    """A ``perf_counter_ns`` time of this session on the profiler's (epoch)
    clock, through the pair of clocks taken when the session started."""
    return t - _store.perf_ns + _store.wall_ns
