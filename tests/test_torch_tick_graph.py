"""The CUDA-graph path of ``FusedTick`` (``wbc/tick_graph.py``) on the CPU:
its staging writes bit for bit the element-leading inputs the eager path
hands the kernels (``FusedTick._element_leading`` and the two ``torch.cat``s
of ``TickKernels.qpchain_packed``), its key tells the call shapes apart and
refuses what the graphs do not take, and a tick that cannot capture (the
plain path, servos) counts its calls as eager.  The graphs themselves run
on the card only (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from libdwbc_tpu_torch import entry
from libdwbc_tpu_torch.wbc.tick_graph import Staged, graph_key

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ticks():
    model, tick = entry._model_and_tick("cpu", torch.float32, backend="torch")
    _, mtick = entry._model_and_tick("cpu", torch.float32, backend="torch", masked=True)
    return model, tick, mtick


def dims(tick):
    plan = tick.prog.plan
    return (plan.nq, tuple(plan.level_tdofs), tuple(plan.qp_dims),
            len(tick.cfg.contacts) if tick.masked else None)


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


def eager_el(tick, q, fs, mask, warm):
    """What the eager path hands the kernels: q, f* and the warm state
    concatenated, the mask."""
    _, q_el, fs_el, kw = tick._element_leading(q, None, fs, mask, warm, None)
    win = None if kw["warm"] is None else torch.cat([t for xl in kw["warm"] for t in xl], 0)
    return q_el, torch.cat(list(fs_el), 0), win, kw["cmask"]


CASES = [  # (masked, B, mask: None, "1d" or "2d", warm given)
    (False, None, None, True), (False, None, None, False), (False, 1, None, True),
    (False, 3, None, True), (False, 3, None, False), (True, 3, "1d", True),
    (True, 3, "2d", True), (True, None, "1d", True), (True, 1, "2d", False)]
# where each group lives: numpy everywhere, torch everywhere (on the tick's
# device, here the CPU), and mixed
RESIDENCE = ["numpy", "torch", "mixed"]


@pytest.mark.parametrize("residence", RESIDENCE)
@pytest.mark.parametrize("masked,B,mask_kind,warm_given", CASES)
def test_staging_matches_eager_bit_for_bit(ticks, masked, B, mask_kind, warm_given, residence):
    model, tick, mtick = ticks
    tick = mtick if masked else tick
    rng = np.random.default_rng([7, B or 0, masked])
    q, fs, warm = inputs(model, tick, B, rng, warm_given)
    mask = None
    if mask_kind == "1d":
        mask = np.array([1.0, 0.0])
    elif mask_kind == "2d":
        mask = (rng.uniform(size=(B or 1, 2)) < 0.5).astype(np.float64)
        mask[:, 0] = 1.0
    if residence == "torch":
        q, fs, warm, mask = as_torch(q), as_torch(fs), as_torch(warm), as_torch(mask)
    elif residence == "mixed":
        q, warm = as_torch(q), as_torch(warm)
    key = graph_key(q, fs, mask, warm, 12, None, dims(tick), CPU)
    assert key is not None
    st = Staged(key, dims(tick), CPU)
    st.el.fill_(float("nan"))
    if st.host is not None:
        st.host.fill_(float("nan"))
    st.stage(q, fs, mask, warm)
    st.upload()
    want = eager_el(tick, q, fs, mask, warm)
    got = (st.q, st.fs, st.win, st.cmask)
    for name, g, w in zip(("q", "fstars", "warm", "mask"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.shape == w.shape and g.dtype == torch.float32, name
            assert torch.equal(bits(g), bits(w)), name


def test_staging_reuses_its_buffers(ticks):
    """Two calls of one key stage into the same buffers, each call's own."""
    model, tick, _ = ticks
    rng = np.random.default_rng(3)
    calls = [inputs(model, tick, 3, rng) for _ in range(2)]
    key = graph_key(*calls[0][:2], None, calls[0][2], 7, None, dims(tick), CPU)
    st = Staged(key, dims(tick), CPU)
    ptr = st.el.data_ptr()
    for q, fs, warm in calls:
        st.stage(q, fs, None, warm)
        st.upload()
        assert st.el.data_ptr() == ptr
        for g, w in zip((st.q, st.fs, st.win), eager_el(tick, q, fs, None, warm)):
            assert torch.equal(bits(g), bits(w))


def test_key_separates_call_shapes(ticks):
    model, tick, mtick = ticks
    rng = np.random.default_rng(11)
    d, md = dims(tick), dims(mtick)
    keys = {}

    def key(name, q, fs, warm, iters=12, mask=None, dm=d):
        keys[name] = graph_key(q, fs, mask, warm, iters, None, dm, CPU)
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
    assert len(set(keys.values())) == len(keys)
    # the same call shape, other values: the same key
    q3b, f3b, w3b = inputs(model, tick, 3, rng)
    assert graph_key(q3b, f3b, None, w3b, 12, None, d, CPU) == keys["B 3"]


def test_key_refuses_what_the_graphs_do_not_take(ticks):
    model, tick, mtick = ticks
    rng = np.random.default_rng(13)
    d, md = dims(tick), dims(mtick)
    q, fs, warm = inputs(model, tick, 3, rng)
    _, _, _, servos = entry._servo_inputs(model, 3)
    assert graph_key(q, fs, None, warm, 12, servos, d, CPU) is None
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
    """A tick on the plain path (the CPU, ``backend="torch"``), with and
    without servos, has no graphs and counts every call as eager."""
    model, tick, mtick = ticks
    q, qd, fs, servos = entry._servo_inputs(model, 2)
    tick.graph_counts.update(captures=0, replays=0, eager=0)
    assert tick.graphs is None and mtick.graphs is None
    tick._tick_impl(q, qd, fs)
    tick._tick_impl(q, qd, fs, servos=servos)
    tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs), warm=tick.init_warm(), qp_iters=7)
    assert tick.graph_counts == {"captures": 0, "replays": 0, "eager": 3}
    m0 = dict(mtick.graph_counts)
    qm, qdm, fsm, masks = entry._masked_inputs(model, 2)
    mtick._tick_impl(qm, qdm, fsm, masks)
    assert mtick.graph_counts == dict(m0, eager=m0["eager"] + 1)


def test_graphs_free_without_the_collector(ticks):
    """A tick's graphs sit in no reference cycle: they are freed when the
    tick lets go of them, not by the cyclic collector, which may run inside
    another tick's capture and destroy a graph there (that invalidates the
    capture)."""
    import gc
    import weakref
    from types import SimpleNamespace

    from libdwbc_tpu_torch.wbc.tick_graph import TickGraphs

    model, tick, _ = ticks
    owner = SimpleNamespace(prog=tick.prog, kernels=None, cfg=tick.cfg, device=CPU,
                            masked=False)
    q, fs, warm = inputs(model, tick, 3, np.random.default_rng(19))
    collecting = gc.isenabled()
    gc.disable()
    try:
        graphs = TickGraphs(owner, {})
        g = graphs.graph(q, fs, None, warm, 7, None)
        assert g is not None and graphs.graph(q, fs, None, warm, 7, None) is g
        alive = (weakref.ref(graphs), weakref.ref(g))
        del graphs, g
        assert [r() for r in alive] == [None, None]
    finally:
        if collecting:
            gc.enable()
