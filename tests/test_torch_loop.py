"""The port's make_control_loop against the JAX package's, on the masked
FusedTick at float64 on the CPU (B = 3 lanes, one per support hypothesis of
the two feet; K = 4 ticks, K = 3 with servos; the held-state default
transition), and forward_dynamics_transition against the JAX one.

The JAX loop runs under ``jax.disable_jit()``: jitting the fused XLA scan on
the CPU takes many minutes.  Its tick goes through a thin shim that turns
jit back on inside the tick, so the IPM's ``fori_loop`` compiles instead of
running op by op, and computes the prestage of the held state once; the
loop's own scan and cond stay eager.  Cases: no lane trips the gap fallback
(1e-3), every lane trips it at every warm tick (1e-30).  The torques, the
primal residuals and ``qp_error`` of every tick must match (1e-8: the same
recurrence at float64).  The servo'd loop advances the servos' clocks by
dt per tick, the re-solve of a tripped tick included.  The cold loop, the
contact-mask routing and the closed-loop tracking of a pelvis step through
forward_dynamics_transition (tests/test_fused_servo.py:104-146, K = 150)
are checked on the port alone.
"""

import os

import jax
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
            key = (np.asarray(q).tobytes(), np.asarray(cmask).tobytes(),
                   None if qdot is None else np.asarray(qdot).tobytes(), servo_req)
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
    one; servos that servo no level give the loop without servos."""
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
    loop = make_control_loop(static, K=2, warm_start=True, gap_fallback=1e-30)
    a, b = loop(q, qd, fs, servos=(None, None)), loop(q, qd, fs)
    assert a.refined_ticks == b.refined_ticks == 1
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- servos
def _servos(q, qd, dtype=np.float64):
    """Port servos on the states q: a 2 mm pelvis step and the torso held,
    at gains 100 (tests/test_fused_servo.py's gentle servos), clock 0.05
    of a 0.2 s trajectory."""
    from libdwbc_tpu_torch.entry import _link_frames
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.pipeline import make_servo

    p0, R0, R15 = _link_frames(RobotModel.load(MODEL), q)
    dp = torch.tensor([0.002, 0.0, 0.001], dtype=torch.float64)
    pelvis = make_servo(pos_init=p0, pos_des=p0 + dp, rot_init=R0, rot_des=R0, t=0.05,
                        t0=0.0, tf=0.2, pos_p=100.0, pos_d=10.0, rot_p=100.0, rot_d=10.0,
                        dtype=torch.float64)
    torso = make_servo(rot_init=R15, rot_des=R15, t=0.05, t0=0.0, tf=0.2, rot_p=50.0,
                       rot_d=5.0, dtype=torch.float64)
    return ((pelvis,), (torso,))


def _to_jax(servos):
    from libdwbc_tpu.wbc.pipeline import ServoParams

    return tuple(tuple(ServoParams(*(jnp.asarray(v.numpy()) for v in sp)) for sp in lvl)
                 for lvl in servos)


@pytest.mark.parametrize("warm_start", [True, False], ids=["warm_every_lane_trips", "cold"])
def test_servo_loop_matches_jax(jax_tick, warm_start):
    """The servo'd loop, K = 3 on moving held states: warm with every lane
    re-solved at every warm tick (each at its tick's clock), and cold.
    Torques, primal residuals and q_final within 1e-8 of the JAX loop."""
    from libdwbc_tpu.wbc.loop import make_control_loop as jax_loop
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    q, _, fs = _inputs()
    qd = 0.05 * np.random.default_rng(9).standard_normal((B, 39))
    servos = _servos(q, qd)
    kw = dict(K=3, warm_start=warm_start, warm_iters=7,
              gap_fallback=1e-30 if warm_start else None)
    with jax.disable_jit():
        want = jax_loop(jax_tick, **kw)(jnp.asarray(q), jnp.asarray(qd),
                                        tuple(map(jnp.asarray, fs)), jnp.asarray(MASKS),
                                        servos=_to_jax(servos))
    got = make_control_loop(_port_tick(), **kw)(q, qd, fs, MASKS, servos=servos)
    assert got.refined_ticks == (2 if warm_start else 0)
    for name in ("torques", "qp_primal_res", "q_final"):
        err = float(np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name))).max())
        print(f"servo'd loop {name}: {err:.3e}")
        assert err <= 1e-8, f"{name}: {err:.3e}"
    # the clocks moved: the servo'd ticks differ from one another
    assert float((got.torques[1] - got.torques[0]).abs().max()) > 1e-6


def test_forward_dynamics_transition_matches_jax():
    """One semi-implicit step of the closed-loop simulator against the JAX
    one, on three moving, turned states and one tick's torques and contact
    forces: (q', q̇') within 1e-10."""
    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu.wbc.loop import forward_dynamics_transition as jfd
    from libdwbc_tpu.wbc.pipeline import CompiledTick as JTick
    from libdwbc_tpu.wbc.pipeline import TickResult as JResult
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config as jcfg
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.loop import forward_dynamics_transition
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, standard_tocabi_config

    rng = np.random.default_rng(17)
    q, _, fs = _inputs()
    ang = np.array([0.3, -0.2, 0.1])
    q[:, 3:6] = np.sin(ang / 2)[:, None] * np.array([0.0, 0.6, 0.8])
    q[:, 39] = np.cos(ang / 2)
    qd = 0.2 * rng.standard_normal((B, 39))
    m = RobotModel.load(MODEL)
    ct = CompiledTick(m, standard_tocabi_config(m, qp_iters=12), "cpu", torch.float64,
                      backend="torch")
    res = ct._tick_impl(q, qd, fs)
    got = forward_dynamics_transition(ct)(torch.as_tensor(q), torch.as_tensor(qd), res, 2e-3)
    jm = JModel.load(MODEL)
    jres = JResult(*(jnp.asarray(v.numpy()) for v in res))
    # jitted: one compile costs a few seconds, the eager first call ten
    want = jax.jit(jfd(JTick(jm, jcfg(jm, qp_iters=12), dtype=jnp.float64)))(
        jnp.asarray(q), jnp.asarray(qd), jres, 2e-3)
    for g, w in zip(got, want):
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        print(f"forward_dynamics_transition: {err:.3e}")
        assert err <= 1e-10
    assert float(np.abs(got[1].numpy() - qd).max()) > 1e-3      # it accelerated


def test_fused_servo_closed_loop_tracking():
    """tests/test_fused_servo.py:104-146 on the port: the plain FusedTick
    servo'd by a 1 cm pelvis step (gains 400 / 40 over 0.12 s, the torso
    held) inside make_control_loop (warm, 10 warm iterations, gap_fallback
    1e-6) through forward_dynamics_transition, K = 150 at dt = 1 ms, float64:
    every torque finite, primal residual < 1e-5, the pelvis error at the
    end below half the initial one."""
    from libdwbc_tpu_torch.entry import _link_frames
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import forward_dynamics_transition, make_control_loop
    from libdwbc_tpu_torch.wbc.pipeline import (CompiledTick, make_servo,
                                                standard_tocabi_config)

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=25)
    q, qd = full_q(CASE_Q[1]), np.zeros(39)
    p0, R0, R15 = (t[0] for t in _link_frames(m, q[None]))
    target = p0 + torch.tensor([0.01, 0.0, 0.0], dtype=torch.float64)
    K, dt = 150, 0.001
    pelvis = make_servo(pos_init=p0, pos_des=target, rot_init=R0, rot_des=R0, t0=0.0,
                        tf=K * dt * 0.8, pos_p=400.0, pos_d=40.0, rot_p=400.0, rot_d=40.0,
                        dtype=torch.float64)
    torso = make_servo(rot_init=R15, rot_des=R15, t0=0.0, tf=0.01, rot_p=100.0, rot_d=20.0,
                       dtype=torch.float64)
    ct = CompiledTick(m, cfg, "cpu", torch.float64, backend="torch")
    loop = make_control_loop(FusedTick(m, cfg, "cpu", torch.float64, backend="torch"),
                             transition=forward_dynamics_transition(ct), K=K, dt=dt,
                             warm_start=True, warm_iters=10, gap_fallback=1e-6)
    res = loop(q, qd, (np.zeros(6), np.zeros(3)), servos=((pelvis,), (torso,)))
    assert torch.isfinite(res.torques).all()
    assert float(res.qp_primal_res.max()) < 1e-5
    p_end = _link_frames(m, res.q_final[None].numpy())[0][0]
    err0 = float(torch.linalg.vector_norm(p0 - target))
    err_end = float(torch.linalg.vector_norm(p_end - target))
    print(f"closed loop: pelvis error {err0:.3e} → {err_end:.3e} m, refined ticks "
          f"{res.refined_ticks}, primal residual max {float(res.qp_primal_res.max()):.3e}")
    assert err_end < 0.5 * err0, (err0, err_end)
