"""The port's make_control_loop against the JAX package's, on the masked
FusedTick at float64 on the CPU (B = 3 lanes, one per support hypothesis of
the two feet; K = 4 ticks; the held-state default transition).

The JAX loop runs under ``jax.disable_jit()``: jitting the fused XLA scan on
the CPU takes many minutes.  Its tick goes through a thin shim that turns
jit back on inside the tick, so the IPM's ``fori_loop`` compiles instead of
running op by op, and computes the prestage of the held state once; the
loop's own scan and cond stay eager.  Cases: no lane trips the gap fallback
(1e-3), every lane trips it at every warm tick (1e-30).  The torques, the
primal residuals and ``qp_error`` of every tick must match (1e-8: the same
recurrence at float64).  The cold loop and the contact-mask routing are
checked on the port alone.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
B, K = 3, 4
MASKS = np.array([[1, 1], [1, 0], [0, 1]], np.float64)


def _inputs():
    f1, f2 = CASE_FSTAR[1]
    q = np.tile(full_q(CASE_Q[1]), (B, 1))
    q[:, 6:39] += 1e-3 * np.random.default_rng(2).standard_normal((B, 33))
    return q, np.zeros((B, 39)), (np.tile(f1, (B, 1)), np.tile(f2, (B, 1)))


class _JaxTick:
    """The JAX masked FusedTick as make_control_loop sees it: jit on inside
    each tick, the prestage of a state computed once."""

    masked = True

    def __init__(self):
        from libdwbc_tpu.model.compile import RobotModel
        from libdwbc_tpu.wbc.fused import FusedTick
        from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

        m = RobotModel.load(MODEL)
        self.ft = FusedTick(m, standard_tocabi_config(m, qp_iters=12), dtype=jnp.float64,
                            backend="xla", masked=True)
        self.model, self.cfg, self.dtype = m, self.ft.cfg, self.ft.dtype
        prestage, seen = self.ft.prog.prestage, {}

        def memo(q, cmask=None, qdot=None, servo_req=None):
            key = (np.asarray(q).tobytes(), np.asarray(cmask).tobytes())
            if key not in seen:
                seen[key] = prestage(q, cmask=cmask, qdot=qdot, servo_req=servo_req)
            return seen[key]

        self.ft.prog.prestage = memo

    def init_warm(self, batch=()):
        return self.ft.init_warm(batch)

    def _tick_impl(self, *args, **kw):
        with jax.disable_jit(False):
            return self.ft._tick_impl(*args, **kw)


def _port_tick():
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    return FusedTick(m, standard_tocabi_config(m, qp_iters=12), "cpu", torch.float64,
                     backend="torch", masked=True)


@pytest.fixture(scope="module")
def jax_tick():
    return _JaxTick()


@pytest.mark.parametrize("gap_fallback,refined", [(1e-3, 0), (1e-30, K - 1)],
                         ids=["no_lane_trips", "every_lane_trips"])
def test_warm_loop_matches_jax(jax_tick, gap_fallback, refined):
    from libdwbc_tpu.wbc.loop import make_control_loop as jax_loop
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    q, qd, fs = _inputs()
    kw = dict(K=K, warm_start=True, warm_iters=7, gap_fallback=gap_fallback)
    with jax.disable_jit():
        want = jax_loop(jax_tick, **kw)(jnp.asarray(q), jnp.asarray(qd),
                                        tuple(map(jnp.asarray, fs)), jnp.asarray(MASKS))
    got = make_control_loop(_port_tick(), **kw)(q, qd, fs, MASKS)
    assert got.refined_ticks == refined
    assert got.torques.shape == (K, B, 33)
    for name in ("torques", "qp_primal_res", "q_final"):
        err = float(np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name))).max())
        assert err <= 1e-8, f"{name}: {err:.3e}"
    assert np.array_equal(got.qp_error.numpy(), np.asarray(want.qp_error))
    assert not got.qp_error.any()


def test_cold_loop_is_the_cold_tick_repeated():
    """warm_start=False: every tick is the cold full-budget tick of the
    held state."""
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    tick = _port_tick()
    q, qd, fs = _inputs()
    res = make_control_loop(tick, K=2)(q, qd, fs, MASKS)
    one = tick._tick_impl(q, qd, fs, MASKS)
    assert res.torques.shape == (2, B, 33) and res.refined_ticks == 0
    for k in range(2):
        assert torch.equal(res.torques[k], one.torque_cmd)
        assert torch.equal(res.qp_error[k], one.qp_error)


def test_contact_mask_routing():
    """A masked tick's loop needs the mask; a static tick's loop refuses
    one; the servo waits for its own slice."""
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import make_control_loop
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    q, qd, fs = _inputs()
    with pytest.raises(ValueError):
        make_control_loop(_port_tick(), K=2)(q, qd, fs)
    m = RobotModel.load(MODEL)
    static = FusedTick(m, standard_tocabi_config(m, qp_iters=8), "cpu", torch.float64,
                       backend="torch")
    with pytest.raises(ValueError):
        make_control_loop(static, K=2)(q, qd, fs, MASKS)
    with pytest.raises(NotImplementedError):
        make_control_loop(static, K=2)(q, qd, fs, servos=(None, None))
