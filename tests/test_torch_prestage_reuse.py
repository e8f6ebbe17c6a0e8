"""``FusedTick``'s reuse of the previous call's prestage on the plain path
(``backend="torch"``) on the CPU, for the flagship, the hands-and-feet plan
and the masked flagship: a repeated call (the control loop's full-budget
re-solve repeats the warm tick's q) runs the QP chain alone on the held
prestage and gives bit for bit what the whole tick gives; a rollout with the
gap fallback gives the LoopResult of the same rollout whose every call gets
a fresh q; the guard refuses a q edited in place, an equal but distinct q,
an equal but distinct mask or one edited in place, servos and a numpy q;
the counter ``dwbc.tick.prestage_reused`` counts one per reuse; no result is
changed by a later call.  The CUDA graph of the QP chain alone runs on the
card only (``tests/test_torch_gpu.py``)."""

import pytest
import torch

from libdwbc_tpu_torch import entry, tracing
from libdwbc_tpu_torch.wbc.fused import FusedTick
from libdwbc_tpu_torch.wbc.loop import make_control_loop

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

B = 4
PLANS = ["stand", "hands", "masked"]


@pytest.fixture(scope="module")
def model():
    return entry._model_and_tick("cpu", torch.float32, backend="torch")[0]


@pytest.fixture(scope="module", params=PLANS)
def plan(request, model):
    """(tick, q, q̇, f*, mask or None) of a plan, inputs as torch tensors."""
    name = request.param
    if name == "hands":
        cfg = entry._hands_feet_config(model)
        q, qd, fs = entry._hands_feet_inputs(model, B, seed=3)
        mask = None
    else:
        cfg = entry._model_and_tick("cpu", torch.float32, backend="torch")[1].cfg
        q, qd, fs, mask = entry._masked_inputs(model, B, seed=3)
        if name == "stand":
            mask = None
    tick = FusedTick(model, cfg, "cpu", torch.float32, backend="torch",
                     masked=mask is not None)
    t = torch.as_tensor
    return (tick, t(q), t(qd), tuple(t(f) for f in fs),
            None if mask is None else t(mask))


def mask_args(mask):
    return () if mask is None else (mask,)


def bits(x):
    """A result, nested tuples of tensors, as comparable int32 bits."""
    if isinstance(x, tuple):
        return tuple(bits(t) for t in x)
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(a, b):
    a, b = bits(a), bits(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert torch.equal(a, b)


def flat(x):
    return [u for t in x for u in flat(t)] if isinstance(x, tuple) else [x]


def clone(x):
    return tuple(clone(t) for t in x) if isinstance(x, tuple) else x.clone()


def result(out):
    res, warm = out
    return tuple(res), warm


def warm_call(tick, q, qd, fs, mask):
    """A cold tick then a warm tick at 3 iterations on q: (warm tick's
    result, its warm state)."""
    _, w0 = tick._tick_impl(q.clone(), qd, fs, *mask_args(mask), warm=tick.init_warm((B,)),
                            qp_iters=tick.cfg.qp_iters)
    return tick._tick_impl(q, qd, fs, *mask_args(mask), warm=w0, qp_iters=3)


def test_repeated_full_budget_call_is_the_full_tick(plan):
    """The re-solve's call (the warm tick's q and mask, its warm output, the
    full budget) takes the warm tick's prestage and equals, bit for bit,
    the whole tick on a fresh q."""
    tick, q, qd, fs, mask = plan
    full = tick.cfg.qp_iters
    _, w1 = warm_call(tick, q, qd, fs, mask)
    n0 = tick.prestage_reuses
    got = tick._tick_impl(q, qd, fs, *mask_args(mask), warm=w1, qp_iters=full)
    assert tick.prestage_reuses == n0 + 1
    kept = clone(result(got))
    # the held prestage outlives a caller's in-place edit of the results
    got[0].torque_grav.add_(1.0)
    got[0].contact_rank_health.add_(1.0)
    again = tick._tick_impl(q, qd, fs, *mask_args(mask), warm=w1, qp_iters=full)
    assert tick.prestage_reuses == n0 + 2
    want = tick._tick_impl(q.clone(), qd, fs, *mask_args(mask), warm=w1, qp_iters=full)
    assert tick.prestage_reuses == n0 + 2
    assert_same(kept, result(want))
    assert_same(result(again), result(want))


def test_results_outlive_later_calls(plan):
    """No result aliases a buffer that a later call writes (the entry's
    staged inputs, its outputs, a held prestage): a call's results and warm
    state stay as they were after a reuse of its prestage and after a later
    call of the same key, and the reuse's after that call too."""
    tick, q, qd, fs, mask = plan
    full = tick.cfg.qp_iters
    q = q.clone()
    first = tick._tick_impl(q, qd, fs, *mask_args(mask), warm=tick.init_warm((B,)),
                            qp_iters=full)
    kept = clone(result(first))
    n0 = tick.prestage_reuses
    reuse = tick._tick_impl(q, qd, fs, *mask_args(mask), warm=first[1], qp_iters=full)
    assert tick.prestage_reuses == n0 + 1
    kept_reuse = clone(result(reuse))
    q2 = q.clone()
    q2[:, 6:39] += 1e-3
    later = tick._tick_impl(q2, qd, fs, *mask_args(mask), warm=tick.init_warm((B,)),
                            qp_iters=full)
    assert not torch.equal(later[0].torque_cmd, first[0].torque_cmd)
    assert_same(result(first), kept)
    assert_same(result(reuse), kept_reuse)
    # the rule itself: no served tensor shares storage with what an entry
    # keeps (its staged inputs, its outputs, its held prestage)
    held = set()
    for e in tick.entries.kept.values():
        pre = list(e.pre.values()) if isinstance(e.pre, dict) else []
        for t in [e.staged.el, *(e.outs or ()), *pre]:
            for x in t if isinstance(t, list) else [t]:
                if isinstance(x, torch.Tensor):
                    held.add(x.untyped_storage().data_ptr())
    for out in (first, reuse, later):
        for t in flat(result(out)):
            assert t.untyped_storage().data_ptr() not in held


class FreshQ:
    """A tick that hands every call a fresh copy of q: no call reuses."""

    def __init__(self, tick):
        self.tick = tick
        self.model, self.cfg, self.dtype = tick.model, tick.cfg, tick.dtype
        self.masked, self.device = tick.masked, tick.device

    def init_warm(self, batch=()):
        return self.tick.init_warm(batch)

    def _tick_impl(self, q, *args, **kw):
        return self.tick._tick_impl(q.clone(), *args, **kw)


def test_fallback_rollout_matches_fresh_inputs(plan):
    """A K = 6 rollout with the gap fallback at 1e-9 (every warm tick at 2
    iterations trips): the re-solves take their warm tick's prestage, and
    the LoopResult equals bit for bit the rollout whose calls all get a
    fresh q."""
    tick, q, qd, fs, mask = plan

    def transition(q, qdot, res, dt):
        q = q.clone()
        q[:, 6:39] += 1e-4 * torch.tanh(res.torque_cmd / 100.0)
        return q, qdot

    loops = [make_control_loop(t, transition, K=6, warm_start=True, warm_iters=2,
                               gap_fallback=1e-9) for t in (tick, FreshQ(tick))]
    n0 = tick.prestage_reuses
    got = loops[0](q, qd, fs, mask)
    n1 = tick.prestage_reuses
    want = loops[1](q, qd, fs, mask)
    assert got.refined_ticks == want.refined_ticks == 5
    assert n1 - n0 == got.refined_ticks and tick.prestage_reuses == n1
    assert_same(tuple(got[:5]), tuple(want[:5]))


REFUSALS = ["q edited in place", "equal q", "other mask", "mask edited in place", "servos",
            "numpy q"]


@pytest.mark.parametrize("plan,case", [(p, c) for p in PLANS for c in REFUSALS
                                       if "mask" not in c or p == "masked"], indirect=["plan"])
def test_guard_refuses(plan, model, case):
    """A call that may not take the previous call's prestage runs the whole
    tick: its result is that of a fresh q, and nothing is counted."""
    tick, q, qd, fs, mask = plan
    full = tick.cfg.qp_iters
    q = q.clone()
    mask = None if mask is None else mask.clone()
    _, w1 = warm_call(tick, q, qd, fs, mask)
    kw = dict(warm=w1, qp_iters=full)
    if case == "q edited in place":
        q[:, 6] += 1e-3
    elif case == "equal q":
        q = q.clone()
    elif case == "other mask":
        mask = mask.clone()
    elif case == "mask edited in place":
        mask.fill_(1.0)
    elif case == "servos":
        kw["servos"] = entry._servo_inputs(model, B, seed=5)[3]
    n0 = tick.prestage_reuses
    if case == "numpy q":
        qn = q.numpy().copy()
        tick._tick_impl(qn, qd, fs, *mask_args(mask), **kw)
        got = tick._tick_impl(qn, qd, fs, *mask_args(mask), **kw)
    else:
        got = tick._tick_impl(q, qd, fs, *mask_args(mask), **kw)
    assert tick.prestage_reuses == n0
    want = tick._tick_impl(q.clone(), qd, fs, *mask_args(None if mask is None else mask.clone()),
                           **kw)
    assert_same(result(got), result(want))


def test_counter_counts_one_per_reuse(plan):
    """Two calls on q after the first take its prestage, one after a call
    on another q takes that one's: three reuses, counted while spans
    record and in ``prestage_reuses`` always."""
    tick, q, qd, fs, mask = plan
    q, q2 = q.clone(), q.clone()
    args = (qd, fs, *mask_args(mask))
    n0 = tick.prestage_reuses
    tracing.start()
    for x in (q, q, q, q2, q2):
        tick._tick_impl(x, *args)
    tracing.stop()
    assert tracing.totals()["dwbc.tick.prestage_reused"] == tracing.Total(3, 0, 0)
    tick._tick_impl(q2, *args)
    assert tick.prestage_reuses == n0 + 4
    assert tracing.totals()["dwbc.tick.prestage_reused"] == tracing.Total(3, 0, 0)
