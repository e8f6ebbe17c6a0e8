"""The port's host-path spans (``libdwbc_tpu_torch.tracing``) on the plain
path on the CPU: the control loop (B = 2, K = 5, the gap fallback armed),
``native.TickConsumer`` and ``sharded_batch_solver`` on one gloo rank record
their spans only while a profiler session records or between ``start()``
and ``stop()``; each span carries its request and its parent, and its
profiler twin lands where ``to_profiler_ns`` puts it."""

import statistics
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from libdwbc_tpu_torch import entry, tracing
from libdwbc_tpu_torch.native import TickConsumer
from libdwbc_tpu_torch.wbc.loop import make_control_loop

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

B, K = 2, 5
TICK = ("dwbc.tick.prep", "dwbc.tick.run", "dwbc.tick.post")


@pytest.fixture(scope="module")
def served():
    model, tick = entry._model_and_tick("cpu", torch.float64, backend="torch")
    q, qd, fs = entry._example_inputs(model, np.float64)
    batch = (np.tile(q, (B, 1)), np.tile(qd, (B, 1)), tuple(np.tile(f, (B, 1)) for f in fs))
    loop = make_control_loop(tick, K=K, warm_start=True, gap_fallback=1e-3)
    return model, tick, loop, batch


def profiled(fn, *args):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(*args)
    return prof


def empty_store():
    tracing.start()
    tracing.stop()
    assert tracing.spans() == []


def test_off_the_loop_records_nothing(served):
    _, _, loop, batch = served
    empty_store()
    loop(*batch)
    assert tracing.spans() == [] and tracing.totals() == {}


def test_profiled_loop_spans(served):
    _, _, loop, batch = served
    profiled(loop, *batch)
    sp = tracing.spans()
    n = Counter(s.name for s in sp)
    assert n == {"dwbc.loop.sync": K - 1, "dwbc.loop.transition": K, "dwbc.tick.prep": K,
                 "dwbc.tick.run": K, "dwbc.tick.post": K}
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in sp)
    assert all(s.parent == -1 for s in sp)        # the loop's spans nest in nothing
    seq = sp[0].request[0]
    for k in range(K):
        mine = [s.name for s in sp if s.request == (seq, k)]
        want = [*TICK] + (["dwbc.loop.sync"] if k else []) + ["dwbc.loop.transition"]
        assert mine == want, (k, mine)
    totals = tracing.totals()
    # the held state (no transition) hands ticks 1 … K − 1 the very q of
    # tick 0: each takes tick 0's prestage
    assert totals.pop("dwbc.tick.prestage_reused") == tracing.Total(K - 1, 0, 0)
    for name, t in totals.items():
        assert t.count == n[name] and 0 <= t.self_ns <= t.total_ns
    assert tracing.dropped() == 0


def test_consumer_spans_nest_per_thread(served):
    model, tick, _, _ = served
    cons = TickConsumer(tick)
    q, qd, fs = entry._example_inputs(model, np.float64)
    state = np.concatenate([q, qd, *fs, [0.0]])
    out = np.zeros(cons.out_dim)

    def calls(n):
        for _ in range(n):
            cons(state, out)

    profiled(calls, 2)
    sp = tracing.spans()
    assert Counter(s.name for s in sp) == {"dwbc.consumer": 2, "dwbc.consumer.read": 2,
                                           **{t: 2 for t in TICK}}
    for i, s in enumerate(sp):
        if s.name == "dwbc.consumer":
            assert s.parent == -1 and s.request[1] == len([c for c in sp[:i]
                                                           if c.name == s.name])
            inner = [c for c in sp if c.parent == i]
            assert [c.name for c in inner] == [*TICK, "dwbc.consumer.read"]
            assert all(c.request == s.request for c in inner)
    # a call served on another thread nests in none of this thread's spans
    tracing.start()
    with tracing.span("dwbc.loop.transition"):
        t = threading.Thread(target=calls, args=(1,))
        t.start()
        t.join(timeout=60)
    tracing.stop()
    assert not t.is_alive()
    sp = tracing.spans()
    assert [s.parent for s in sp if s.name == "dwbc.consumer"] == [-1]
    assert len(sp) == 1 + 2 + len(TICK)


def test_mesh_step_spans_on_one_gloo_rank(served):
    import torch.distributed as dist

    from libdwbc_tpu_torch.parallel.mesh import (free_port, init_distributed, make_mesh,
                                                 sharded_batch_solver)

    model, tick, _, (q, qd, fs) = served
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        mesh = make_mesh()
        assert mesh.device_mesh is not None
        step, _ = sharded_batch_solver(tick._tick_impl, mesh)
        grid = (torch.as_tensor(q)[None], torch.as_tensor(qd)[None],
                tuple(torch.as_tensor(f)[None] for f in fs))

        def steps(n):
            for _ in range(n):
                step(*grid)

        profiled(steps, 3)
    finally:
        dist.destroy_process_group()
    sp = tracing.spans()
    outer = [i for i, s in enumerate(sp) if s.name == "dwbc.mesh.step"]
    assert len(outer) == 3
    assert [sp[i].request[1] for i in outer] == [0, 1, 2]
    for i in outer:
        assert [s.name for s in sp if s.parent == i] == list(TICK)


def test_spans_land_on_their_twins(served):
    _, _, loop, batch = served
    prof = profiled(loop, *batch)
    twins = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in tracing.NAMES:
            twins.setdefault(e.name(), []).append(e.start_ns())
    sp = tracing.spans()
    gaps = []
    for name, starts in twins.items():
        mine = sorted(tracing.to_profiler_ns(s.start_ns) for s in sp if s.name == name)
        assert len(mine) == len(starts), name
        gaps += [abs(a - b) for a, b in zip(mine, sorted(starts))]
    assert set(twins) == {s.name for s in sp}
    assert max(gaps) <= 200_000 and statistics.median(gaps) <= 20_000, gaps


def test_sessions_start_empty_and_count_drops(served, monkeypatch):
    _, _, loop, batch = served
    profiled(loop, *batch)
    first = tracing.spans()
    profiled(loop, *batch)
    second = tracing.spans()
    assert len(second) == len(first) and second[0].request[0] > first[-1].request[0]
    tracing.start()                                   # no profiler
    loop(*batch)
    tracing.stop()
    assert len(tracing.spans()) == len(first)
    assert tracing.spans()[0].request[0] > second[-1].request[0]
    loop(*batch)                                      # stopped: kept, not added to
    assert len(tracing.spans()) == len(first)
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    tracing.start()
    loop(*batch)
    tracing.stop()
    assert len(tracing.spans()) == 4 and tracing.dropped() == len(first) - 4
    assert [s.name for s in tracing.spans()] == [*TICK, "dwbc.loop.transition"]


def test_request_holds_for_its_block_only(served):
    """A span outside the serving layers' request blocks carries none: a
    direct tick after a loop call, and a tick on a thread whose request
    block was opened before the session began."""
    _, tick, loop, (q, qd, fs) = served
    tracing.start()
    loop(q, qd, fs)
    tick._tick_impl(q, qd, fs)
    tracing.stop()
    sp = tracing.spans()
    assert all(s.request is not None for s in sp[:-len(TICK)])
    assert [(s.name, s.request) for s in sp[-len(TICK):]] == [(t, None) for t in TICK]
    with tracing.request(7, 0):                       # off: no request is set
        tracing.start()
        tick._tick_impl(q, qd, fs)
        tracing.stop()
    assert [s.request for s in tracing.spans()] == [None] * len(TICK)


class _ForcedTrip:
    """The served tick with the gap of ``lanes`` raised past the fallback on
    every warm tick at the warm budget, so that the loop re-solves those
    lanes; every call's iteration budget and result are kept."""

    def __init__(self, tick, lanes, warm_iters):
        self.tick, self.lanes, self.warm_iters = tick, lanes, warm_iters
        self.model, self.cfg, self.dtype, self.device = (tick.model, tick.cfg, tick.dtype,
                                                         tick.device)
        self.init_warm = tick.init_warm
        self.calls = []

    def _tick_impl(self, q, qdot, fstars, warm=None, qp_iters=None, servos=None):
        res, w = self.tick._tick_impl(q, qdot, fstars, warm=warm, qp_iters=qp_iters,
                                      servos=servos)
        if qp_iters == self.warm_iters:
            gap = res.qp_gap.clone()
            gap[self.lanes] = 1.0
            res = res._replace(qp_gap=gap)
        self.calls.append((qp_iters, res))
        return res, w


def test_forced_trip_counts_resolved_lanes(served):
    """With two of three lanes tripped on every warm tick, the loop re-solves
    each warm tick once, in a ``dwbc.loop.resolve`` span of its request, and
    counts the two lanes a tick in ``dwbc.loop.resolve_lanes``: the lanes
    whose served torque is the re-solve's."""
    model, tick, _, (q, qd, fs) = served
    lanes, k_ = [0, 2], 4
    forced = _ForcedTrip(tick, lanes, warm_iters=4)
    loop = make_control_loop(forced, K=k_, warm_start=True, warm_iters=4, gap_fallback=1e-3)
    batch = (np.tile(q[0], (3, 1)), np.tile(qd[0], (3, 1)), tuple(np.tile(f[0], (3, 1))
                                                                   for f in fs))
    tracing.start()
    out = loop(*batch)
    tracing.stop()
    assert out.refined_ticks == k_ - 1
    assert tracing.totals()["dwbc.loop.resolve_lanes"] == tracing.Total(len(lanes) * (k_ - 1),
                                                                         0, 0)
    sp = tracing.spans()
    resolves = [s for s in sp if s.name == "dwbc.loop.resolve"]
    assert [s.request[1] for s in resolves] == list(range(1, k_))
    # each re-solve span holds the re-solve's tick and follows the tick's sync
    for s in resolves:
        mine = [c.name for c in sp if c.request == s.request and c.parent == -1]
        assert mine == [*TICK, "dwbc.loop.sync", "dwbc.loop.resolve", "dwbc.loop.transition"]
        assert [c.name for c in sp if c.parent == sp.index(s)] == list(TICK)
    iters = [i for i, _ in forced.calls]
    assert iters == [tick.cfg.qp_iters] + [4, tick.cfg.qp_iters] * (k_ - 1)
    from_resolve = 0
    for k in range(1, k_):
        warm_res, full_res = forced.calls[2 * k - 1][1], forced.calls[2 * k][1]
        served_k = out.torques[k]
        took = (served_k == full_res.torque_cmd).all(-1) & (served_k != warm_res.torque_cmd).any(-1)
        kept = (served_k == warm_res.torque_cmd).all(-1)
        assert took.tolist() == [True, False, True] and bool(kept[1])
        from_resolve += int(took.sum())
    assert from_resolve == tracing.totals()["dwbc.loop.resolve_lanes"].count
