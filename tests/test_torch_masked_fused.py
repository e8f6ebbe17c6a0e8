"""The port's masked FusedTick (plain backend) against the JAX
FusedTick(masked=True, backend="xla"), at float64 on the CPU.

One batch of B = 3 holds the three support hypotheses of the two feet
(both, left, right; inputs as in tests/test_fused_masked.py).  The JAX
program runs eagerly (``_tick_impl`` and ``prog.prestage`` without jit), each
reference once per module.  Tolerances: pre-QP fields 1e-10 and the masks
exactly; a cold 25-iteration tick 1e-8; a warm tick after a state drift by
the flat-face policy (τ_grav 1e-8, τ_task 2e-3, τ_cmd 5e-2).  The other
candidate types (POINT, LINE) run on the plain version only, against the
port's static tick.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
B = 3
MASKS = np.array([[1, 1], [1, 0], [0, 1]], np.float64)
TAUS = ("torque_grav", "torque_task", "torque_contact", "torque_cmd")
PRE_FIELDS = ("torque_grav", "P_C", "Jbar_act", "NwJw", "Ntorques", "Atemp", "bA0",
              "health", "crow_mask", "active_cdof")


def _inputs():
    f1, f2 = CASE_FSTAR[1]
    q = np.tile(full_q(CASE_Q[1]), (B, 1))
    q2 = q.copy()
    q2[:, 6:39] += 1e-3 * np.random.default_rng(0).standard_normal((B, 33))
    return q, q2, np.zeros((B, 39)), (np.tile(f1, (B, 1)), np.tile(f2, (B, 1)))


def _port_tick(cfg=None, masked=True):
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=25) if cfg is None else cfg
    return FusedTick(m, cfg, "cpu", torch.float64, backend="torch", masked=masked)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(t) for t in x]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(a, b):
    if isinstance(a, list):
        return max(_err(x, y) for x, y in zip(a, b))
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.fixture(scope="module")
def ref():
    """The JAX masked prestage, a cold 25-iteration tick from the cold warm
    state, and a warm 7-iteration tick on the drifted state."""
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    ft = FusedTick(m, standard_tocabi_config(m, qp_iters=25), dtype=jnp.float64,
                   backend="xla", masked=True)
    q, q2, qd, fs = _inputs()
    pre = ft.prog.prestage(jnp.asarray(q.T), cmask=jnp.asarray(MASKS.T))
    r0, w1 = ft._tick_impl(q, qd, fs, MASKS, warm=ft.init_warm((B,)), qp_iters=25)
    r1, _ = ft._tick_impl(q2, qd, fs, MASKS, warm=w1, qp_iters=7)
    return dict(pre={k: _np(pre[k]) for k in PRE_FIELDS},
                r0={k: _np(v) for k, v in r0._asdict().items()},
                r1={k: _np(v) for k, v in r1._asdict().items()})


@pytest.fixture(scope="module")
def out():
    tick = _port_tick()
    q, q2, qd, fs = _inputs()
    pre = tick.prog.prestage(torch.as_tensor(q.T.copy()), torch.as_tensor(MASKS.T.copy()))
    r0, w1 = tick._tick_impl(q, qd, fs, MASKS, warm=tick.init_warm((B,)), qp_iters=25)
    r1, w2 = tick._tick_impl(q2, qd, fs, MASKS, warm=w1, qp_iters=7)
    return dict(tick=tick, pre={k: _np(pre[k]) for k in PRE_FIELDS},
                r0={k: _np(v) for k, v in r0._asdict().items()},
                r1={k: _np(v) for k, v in r1._asdict().items()}, w1=w1, w2=w2)


@pytest.mark.parametrize("field", PRE_FIELDS)
def test_masked_prestage_matches_jax(ref, out, field):
    err = _err(out["pre"][field], ref["pre"][field])
    if field in ("crow_mask", "active_cdof"):
        assert err == 0.0, field
    assert err <= 1e-10, f"{field}: {err:.3e}"


@pytest.mark.parametrize("field", TAUS + ("contact_force",))
def test_masked_cold_tick_matches_jax(ref, out, field):
    assert out["r0"][field].shape == ref["r0"][field].shape == (B, 33 if field in TAUS else 12)
    err = _err(out["r0"][field], ref["r0"][field])
    assert err <= 1e-8, f"{field}: {err:.3e}"
    assert not out["r0"]["qp_error"].any()
    assert np.array_equal(out["r0"]["qp_error"], ref["r0"]["qp_error"])


@pytest.mark.parametrize("field,tol", [("torque_grav", 1e-8), ("torque_task", 2e-3),
                                       ("torque_cmd", 5e-2)])
def test_masked_warm_tick_matches_jax(ref, out, field, tol):
    err = _err(out["r1"][field], ref["r1"][field])
    assert err <= tol, f"{field}: {err:.3e}"
    assert float(out["r1"]["qp_gap"].max()) < 1e-6


def test_masked_warm_state_shapes(out):
    """init_warm keeps the static dims: the flagship's candidate set pads to
    the double-support QPs (12, 86), (9, 86), (6, 86)."""
    assert [tuple(x.shape) + tuple(lam.shape) for x, lam in out["w1"]] == [
        (B, n, B, 86) for n in (12, 9, 6)]
    assert [tuple(x.shape) for x, _ in out["tick"].init_warm()] == [(12,), (9,), (6,)]


def test_masked_unbatched_tick_and_1d_mask(out):
    """An unbatched tick with a 1-D mask is its lane of the batch; a 1-D
    mask with a batch serves every lane."""
    tick = out["tick"]
    q, _, qd, fs = _inputs()
    cold = tick._tick_impl(q, qd, fs, MASKS).torque_cmd
    for b in range(B):
        r = tick._tick_impl(q[b], qd[b], tuple(f[b] for f in fs), MASKS[b])
        assert r.torque_cmd.shape == (33,)
        assert _err(r.torque_cmd, cold[b]) <= 1e-10
    rb = tick._tick_impl(q, qd, fs, MASKS[1])
    assert _err(rb.torque_cmd, cold[1].expand(B, 33)) <= 1e-10
    with pytest.raises(ValueError):
        tick._tick_impl(q, qd, fs)


def test_masked_matches_static_tick(out):
    """Mask [1, 1] against the port's static tick: a different kernel-basis
    and padding machinery for the same problem (test_fused_masked.py:79-94)."""
    q, _, qd, fs = _inputs()
    rs = _port_tick(masked=False)._tick_impl(q[:1], qd[:1], tuple(f[:1] for f in fs))
    r = out["r0"]
    assert _err(r["torque_grav"][:1], rs.torque_grav) <= 1e-9
    assert _err(r["torque_task"][:1], rs.torque_task) <= 2e-3
    assert _err(r["torque_cmd"][:1], rs.torque_cmd) <= 5e-2


# -------------------------------------- POINT and LINE candidates, plain
def _hands_feet(hand_type, foot_type):
    """Feet on links 6, 12 and hands on links 23, 31 as candidates
    (tests/test_contacts_non6d.py:20-40)."""
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    cfg = standard_tocabi_config(RobotModel.load(MODEL), qp_iters=25)
    foot = cfg.contacts[0]
    feet = tuple(dataclasses.replace(foot, link=k, contact_type=foot_type) for k in (6, 12))
    hands = tuple(dataclasses.replace(foot, link=k, contact_type=hand_type, plane_x=0.04,
                                      plane_y=0.04) for k in (23, 31))
    return dataclasses.replace(cfg, contacts=feet + hands)


def test_point_candidates_match_static_tick():
    """Hands as POINT candidates beside 6D feet: all four active against the
    static per-type tick, hands off against the two-feet static tick, with
    test_contacts_non6d.py's cross-formulation bounds."""
    from libdwbc_tpu_torch.wbc import types as T

    cfg = _hands_feet(T.CONTACT_POINT, T.CONTACT_6D)
    mt = _port_tick(cfg)
    q, _, qd, fs = _inputs()
    mres = mt._tick_impl(q[:2], qd[:2], tuple(f[:2] for f in fs),
                         np.array([[1.0, 1, 1, 1], [1.0, 1, 0, 0]]))
    for b, sres in enumerate((
            _port_tick(cfg, masked=False)._tick_impl(q[0], qd[0], tuple(f[0] for f in fs)),
            _port_tick(masked=False)._tick_impl(q[0], qd[0], tuple(f[0] for f in fs)))):
        assert _err(mres.torque_grav[b], sres.torque_grav) <= 1e-8
        assert _err(mres.torque_task[b], sres.torque_task) <= 2e-3
        assert _err(mres.torque_cmd[b], sres.torque_cmd) <= 8e-2
        assert float(mres.qp_primal_res[b]) < 1e-6


def test_line_candidates_match_masked_tick():
    """The feet as LINE candidates (contact-local moment rows, the local-x
    moment statically dead; tests/test_contacts_non6d.py:168-208), both
    active, against the port's MaskedTick: the same masked problem in the
    batched formulation.  (Against the static LINE tick only τ_grav is
    determined: the padded and the 5-row NwJw bases pick different points
    of the contact block's flat face, here 0.18 Nm apart in τ_task.)"""
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.masked import MaskedTick

    cfg = _hands_feet(T.CONTACT_POINT, T.CONTACT_LINE)
    cfg = dataclasses.replace(cfg, contacts=tuple(dataclasses.replace(c, plane_y=0.0)
                                                  for c in cfg.contacts[:2]))
    q, _, qd, fs = _inputs()
    args = (q[0], qd[0], tuple(f[0] for f in fs))
    mres = _port_tick(cfg)._tick_impl(*args, np.ones(2))
    tres = MaskedTick(RobotModel.load(MODEL), cfg, "cpu", torch.float64,
                      backend="torch")._tick_impl(*args, np.ones(2))
    sres = _port_tick(cfg, masked=False)._tick_impl(*args)
    # τ_contact and τ_cmd ride the contact block's flat face, where the
    # polished float64 solve_qp of MaskedTick and the IPM part at ~1e-6
    for field, tol in (("torque_grav", 1e-8), ("torque_task", 1e-8),
                       ("torque_contact", 1e-5), ("torque_cmd", 1e-5)):
        assert _err(getattr(mres, field), getattr(tres, field)) <= tol, field
    assert _err(mres.torque_grav, sres.torque_grav) <= 1e-8
    assert float(mres.qp_primal_res) < 1e-6


def test_hands_candidates_match_jax():
    """The four hands-and-feet candidates (6D feet, POINT hands; entry.
    _hands_feet_config) against the JAX masked fused tick at float64, one
    lane per hypothesis (feet, feet and the left hand, feet and the right
    hand, all four), cold at 25 iterations: the tick's torques and contact
    force within 1e-8, no lane flagged.  (The JAX prestage alone would add
    a minute of eager dispatch; its fields are held through the static
    hands variant of test_torch_prestage.py and, masked, through the
    kernels' lanes against the plain prestage in test_torch_csrc_host.py.)"""
    from libdwbc_tpu.model.compile import RobotModel as JM
    from libdwbc_tpu.wbc import pipeline as jpipe
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu.wbc.fused import FusedTick as JF
    from libdwbc_tpu_torch.entry import HANDS_MASKS, _hands_feet_config
    from libdwbc_tpu_torch.model.compile import RobotModel

    m = JM.load(MODEL)
    base = jpipe.standard_tocabi_config(m, qp_iters=25)
    jcfg = dataclasses.replace(base, contacts=base.contacts + tuple(
        dataclasses.replace(base.contacts[0], link=link, contact_type=JT.CONTACT_POINT,
                            plane_x=0.04, plane_y=0.04) for link in (23, 31)))
    masks = HANDS_MASKS.astype(np.float64)
    nb = len(masks)
    f1, f2 = CASE_FSTAR[1]
    q = np.tile(full_q(CASE_Q[1]), (nb, 1))
    q[:, 6:39] += 1e-2 * np.random.default_rng(3).standard_normal((nb, 33))
    qd, fs = np.zeros((nb, 39)), (np.tile(f1, (nb, 1)), np.tile(f2, (nb, 1)))
    jt = JF(m, jcfg, dtype=jnp.float64, backend="xla", masked=True)
    jres, _ = jt._tick_impl(q, qd, fs, masks, warm=jt.init_warm((nb,)), qp_iters=25)
    pt = _port_tick(_hands_feet_config(RobotModel.load(MODEL)))
    pres, _ = pt._tick_impl(q, qd, fs, masks, warm=pt.init_warm((nb,)), qp_iters=25)
    assert pres.contact_force.shape == (nb, 24)
    for field in TAUS + ("contact_force",):
        err = _err(getattr(pres, field), np.asarray(getattr(jres, field)))
        assert err <= 1e-8, f"{field}: {err:.3e}"
    assert not pres.qp_error.any() and not np.asarray(jres.qp_error).any()


def test_float32_warm_masked_lanes_stay_near_float64():
    """The plain float32 masked QP chain on 1024 lanes of the masked sweep,
    cold at 12 iterations then warm at 7, against the float64 QP chain from
    the same prestage and warm state: every lane within 1e-3 Nm in τ_cmd
    (the IPM holds a variable whose Gram pivot was lost; a step from the
    clamped factor left 5 of these lanes up to 104 Nm away, at a gap of
    6e-7)."""
    from libdwbc_tpu_torch.entry import _masked_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=12)
    p32 = TickProgram(m, cfg, "cpu", torch.float32, masked=True)
    p64 = TickProgram(m, cfg, "cpu", torch.float64, masked=True)
    q, _, fs, masks = _masked_inputs(m, 1024, seed=0)
    fs_el = [torch.as_tensor(np.ascontiguousarray(f.T)) for f in fs]
    pre = p32.prestage(torch.as_tensor(np.ascontiguousarray(q.T)),
                       torch.as_tensor(np.ascontiguousarray(masks.T)))
    cold = p32.qpchain(pre, fs_el, None, 12)
    warm = p32.qpchain(pre, fs_el, cold["warm_out"], 7)
    ref = p64.qpchain({k: ([t.double() for t in v] if isinstance(v, list) else v.double())
                       for k, v in pre.items()}, [f.double() for f in fs_el],
                      [(x.double(), lam.double()) for x, lam in cold["warm_out"]], 7)
    err = (warm["torque_cmd"].double() - ref["torque_cmd"]).abs().amax(0)
    print(f"float32 warm masked lanes: τ_cmd from float64 max {float(err.max()):.3e}, "
          f"gap max {float(warm['qp_gap'].max()):.3e}")
    assert float(err.max()) <= 1e-3, f"{int((err > 1e-3).sum())} lanes, max {float(err.max()):.3e}"
    assert float(warm["qp_gap"].max()) <= 1e-3
