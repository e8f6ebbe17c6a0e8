"""The host path of ``FusedTick`` (``wbc/tick_graph.py``) on the CPU: its
staging writes bit for bit the element-leading inputs the kernels and the
plain program read (q, q̇ and the mask transposed, every level's f* and
every QP's warm state concatenated), its key tells the call shapes apart
and refuses what it cannot place, a tick that does not capture (the plain
backend) keeps entries and counts its calls as eager, and a tick and its
entries are freed without the collector.  The graphs themselves run on the
card only (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from libdwbc_tpu_torch import entry
from libdwbc_tpu_torch.wbc.tick_graph import Staged, graph_key, tick_dims

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ticks():
    model, tick = entry._model_and_tick("cpu", torch.float32, backend="torch")
    _, mtick = entry._model_and_tick("cpu", torch.float32, backend="torch", masked=True)
    return model, tick, mtick


def inputs(model, tick, B, rng, warm=True):
    """float64 numpy (q, f*, warm) of a call; B None: unbatched."""
    lead = () if B is None else (B,)
    q0, _, f0 = entry._example_inputs(model, np.float64)
    q = q0 + 0.02 * rng.standard_normal(lead + q0.shape)
    fs = tuple(f + 0.05 * rng.standard_normal(lead + f.shape) for f in f0)
    w = None
    if warm:
        w = tuple((rng.standard_normal(lead + (n,)), rng.uniform(0.1, 2.0, lead + (m,)))
                  for n, m in tick.prog.plan.qp_dims)
    return q, fs, w


def as_torch(x):
    if isinstance(x, (tuple, list)):
        return type(x)(as_torch(t) for t in x)
    return None if x is None else torch.as_tensor(x)


def bits(t):
    return t.contiguous().view(torch.int32)


def want_el(q, fs, mask, warm, qdot=None):
    """The element-leading float32 inputs, built here: q, q̇ and the mask
    transposed (a 1-D mask for every lane), f* and the warm state
    concatenated."""
    def el(x):
        t = torch.as_tensor(x, dtype=torch.float32)
        return (t[None] if t.ndim == 1 else t).T

    q_el = el(q)
    cm = None
    if mask is not None:
        cm = torch.as_tensor(mask, dtype=torch.float32)
        cm = cm[:, None].expand(cm.shape[0], q_el.shape[1]) if cm.ndim == 1 else cm.T
    win = None if warm is None else torch.cat([el(t) for xl in warm for t in xl], 0)
    return (q_el, torch.cat([el(f) for f in fs], 0), win, cm,
            None if qdot is None else el(qdot))


CASES = [  # (masked, B, mask: None, "1d" or "2d", warm given, q̇ staged: servo'd)
    (False, None, None, True, False), (False, None, None, False, False),
    (False, 1, None, True, False), (False, 3, None, True, False), (False, 3, None, False, False),
    (True, 3, "1d", True, False), (True, 3, "2d", True, False), (True, None, "1d", True, False),
    (True, 1, "2d", False, False), (False, 3, None, True, True), (True, None, "1d", False, True)]
# where each group lives: numpy everywhere, torch everywhere (on the tick's
# device, here the CPU), and mixed
RESIDENCE = ["numpy", "torch", "mixed"]


@pytest.mark.parametrize("residence", RESIDENCE)
@pytest.mark.parametrize("masked,B,mask_kind,warm_given,servod", CASES)
def test_staging_matches_eager_bit_for_bit(ticks, masked, B, mask_kind, warm_given, servod,
                                           residence):
    model, tick, mtick = ticks
    tick = mtick if masked else tick
    rng = np.random.default_rng([7, B or 0, masked])
    q, fs, warm = inputs(model, tick, B, rng, warm_given)
    qd = 0.1 * rng.standard_normal(q.shape[:-1] + (q.shape[-1] - 1,)) if servod else None
    mask = None
    if mask_kind == "1d":
        mask = np.array([1.0, 0.0])
    elif mask_kind == "2d":
        mask = (rng.uniform(size=(B or 1, 2)) < 0.5).astype(np.float64)
        mask[:, 0] = 1.0
    if residence == "torch":
        q, fs, warm, mask, qd = (as_torch(x) for x in (q, fs, warm, mask, qd))
    elif residence == "mixed":
        q, warm = as_torch(q), as_torch(warm)
    key = graph_key(q, fs, mask, warm, 12, qd, tick_dims(tick), CPU)
    assert key is not None
    st = Staged(key, tick_dims(tick), CPU, torch.float32)
    st.el.fill_(float("nan"))
    if st.host is not None:
        st.host.fill_(float("nan"))
    st.stage(q, fs, mask, warm, qd)
    st.upload()
    want = want_el(q, fs, mask, warm, qd)
    got = (st.q, st.fs, st.win, st.cmask, st.qdot)
    for name, g, w in zip(("q", "fstars", "warm", "mask", "qdot"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.shape == w.shape and g.dtype == torch.float32, name
            assert torch.equal(bits(g), bits(w)), name
    # the plain body's rows: per level, per QP (x, λ)
    assert torch.equal(bits(torch.cat(st.fstars, 0)), bits(want[1]))
    assert (st.warm is None) == (warm is None)
    if warm is not None:
        assert torch.equal(bits(torch.cat([t for xl in st.warm for t in xl], 0)), bits(want[2]))


def test_staging_reuses_its_buffers(ticks):
    """Two calls of one key stage into the same buffers, each call's own."""
    model, tick, _ = ticks
    rng = np.random.default_rng(3)
    calls = [inputs(model, tick, 3, rng) for _ in range(2)]
    key = graph_key(*calls[0][:2], None, calls[0][2], 7, None, tick_dims(tick), CPU)
    st = Staged(key, tick_dims(tick), CPU, torch.float32)
    ptr = st.el.data_ptr()
    for q, fs, warm in calls:
        st.stage(q, fs, None, warm, None)
        st.upload()
        assert st.el.data_ptr() == ptr
        for g, w in zip((st.q, st.fs, st.win), want_el(q, fs, None, warm)):
            assert torch.equal(bits(g), bits(w))


def test_key_separates_call_shapes(ticks):
    model, tick, mtick = ticks
    rng = np.random.default_rng(11)
    d, md = tick_dims(tick), tick_dims(mtick)
    keys = {}

    def key(name, q, fs, warm, iters=12, mask=None, dm=d, qdot=None):
        keys[name] = graph_key(q, fs, mask, warm, iters, qdot, dm, CPU)
        assert keys[name] is not None, name

    q1, f1, w1 = inputs(model, tick, None, rng)
    qb1, fb1, wb1 = inputs(model, tick, 1, rng)
    q3, f3, w3 = inputs(model, tick, 3, rng)
    q4, f4, w4 = inputs(model, tick, 4, rng)
    key("unbatched", q1, f1, w1)
    key("batched B 1", qb1, fb1, wb1)
    key("B 3", q3, f3, w3)
    key("B 4", q4, f4, w4)
    key("B 3 cold", q3, f3, None)
    key("B 3 at 7", q3, f3, w3, iters=7)
    key("B 3 q on the device", as_torch(q3), f3, w3)
    key("B 3 f* on the device", q3, as_torch(f3), w3)
    key("B 3 warm on the device", q3, f3, as_torch(w3))
    key("masked 1-D", q3, f3, w3, mask=np.ones(2), dm=md)
    key("masked 2-D", q3, f3, w3, mask=np.ones((3, 2)), dm=md)
    key("masked 2-D on the device", q3, f3, w3, mask=torch.ones((3, 2)), dm=md)
    qd3 = 0.1 * rng.standard_normal((3, 39))
    key("B 3 servo'd", q3, f3, w3, qdot=qd3)
    key("B 3 servo'd, q̇ on the device", q3, f3, w3, qdot=as_torch(qd3))
    assert len(set(keys.values())) == len(keys)
    # the same call shape, other values: the same key
    q3b, f3b, w3b = inputs(model, tick, 3, rng)
    assert graph_key(q3b, f3b, None, w3b, 12, None, d, CPU) == keys["B 3"]


def test_key_refuses_what_the_graphs_do_not_take(ticks):
    model, tick, mtick = ticks
    rng = np.random.default_rng(13)
    d, md = tick_dims(tick), tick_dims(mtick)
    q, fs, warm = inputs(model, tick, 3, rng)
    assert graph_key(q, fs, None, warm, 12, q[:, :-2], d, CPU) is None   # q̇ (3, 38)
    assert graph_key(q[:, :-1], fs, None, warm, 12, None, d, CPU) is None
    assert graph_key(q, fs[:1], None, warm, 12, None, d, CPU) is None
    assert graph_key(q, (fs[0], fs[1][:2]), None, warm, 12, None, d, CPU) is None
    assert graph_key(q, (fs[0], fs[1][0]), None, warm, 12, None, d, CPU) is None
    assert graph_key(q, fs, None, warm[:2], 12, None, d, CPU) is None
    assert graph_key(q.tolist(), fs, None, warm, 12, None, d, CPU) is None
    # a group that lives in two places, or on another device
    assert graph_key(q, (fs[0], as_torch(fs[1])), None, warm, 12, None, d, CPU) is None
    assert graph_key(torch.empty(q.shape, device="meta"), fs, None, warm, 12, None, d,
                     CPU) is None
    # a mask that the tick does not take, or one missing
    assert graph_key(q, fs, np.ones(2), warm, 12, None, d, CPU) is None
    assert graph_key(q, fs, None, warm, 12, None, md, CPU) is None
    assert graph_key(q, fs, np.ones((4, 2)), warm, 12, None, md, CPU) is None
    assert graph_key(q, fs, np.ones(3), warm, 12, None, md, CPU) is None
    # a CPU tensor is on the host for a tick on the card
    card = torch.device("cuda", 0)
    assert graph_key(as_torch(q), fs, None, warm, 12, None, d, card)[5] == "host"


def test_plain_ticks_count_eager_calls(ticks):
    """A tick on the plain backend (``backend="torch"``) keeps entries but
    captures none, and counts every call as eager: with and without servos,
    unbatched, masked."""
    model, tick, mtick = ticks
    q, qd, fs, servos = entry._servo_inputs(model, 2)
    tick.graph_counts.update(captures=0, replays=0, eager=0)
    assert not tick.entries.capture and not mtick.entries.capture
    tick._tick_impl(q, qd, fs)
    tick._tick_impl(q, qd, fs, servos=servos)
    tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs), warm=tick.init_warm(), qp_iters=7)
    assert tick.graph_counts == {"captures": 0, "replays": 0, "eager": 3}
    assert tick.entries.kept and all(e.graph is None for e in tick.entries.kept.values())
    m0 = dict(mtick.graph_counts)
    qm, qdm, fsm, masks = entry._masked_inputs(model, 2)
    mtick._tick_impl(qm, qdm, fsm, masks)
    assert mtick.graph_counts == dict(m0, eager=m0["eager"] + 1)


def test_graphs_free_without_the_collector(ticks):
    """A tick and its entries sit in no reference cycle: they are freed when
    the caller lets go of the tick, not by the cyclic collector, which may
    run inside another tick's capture and destroy a graph there (that
    invalidates the capture)."""
    import gc
    import weakref

    from libdwbc_tpu_torch.wbc.fused import FusedTick

    model, tick, _ = ticks
    q, fs, warm = inputs(model, tick, 3, np.random.default_rng(19))
    collecting = gc.isenabled()
    gc.disable()
    try:
        t = FusedTick(model, tick.cfg, "cpu", torch.float32, backend="torch")
        qt = torch.as_tensor(q)
        t._tick_impl(qt, None, fs, warm=warm, qp_iters=7)
        t._tick_impl(qt, None, fs, warm=warm, qp_iters=7)         # held: the QP chain's entry
        assert t.prestage_reuses == 1 and len(t.entries.kept) == 2
        alive = [weakref.ref(x) for x in (t, t.entries, *t.entries.kept.values())]
        del t
        assert [r() for r in alive] == [None] * len(alive)
    finally:
        if collecting:
            gc.enable()
