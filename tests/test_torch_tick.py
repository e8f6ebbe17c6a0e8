"""The port's FusedTick (plain backend) against the JAX FusedTick(backend="xla").

Both packages load models/tocabi.npz and run standard_tocabi_config.  The
JAX tick runs eagerly (``_tick_impl`` without jit), each reference once per
module.  Tolerances follow the repository's flat-face policy: pre-QP
algebra and τ_grav tight, the unit-Hessian task torque to 2e-3, and τ_cmd
to 5e-2 where a warm solve may land elsewhere on a flat optimal face of the
zero-Hessian contact block.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
B = 4
TAUS = ("torque_grav", "torque_task", "torque_contact", "torque_cmd")


def _jax_tick(qp_iters):
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    return FusedTick(m, standard_tocabi_config(m, qp_iters=qp_iters),
                     dtype=jnp.float64, backend="xla")


def _port_tick(qp_iters, dtype=torch.float64):
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    return FusedTick(m, standard_tocabi_config(m, qp_iters=qp_iters), "cpu",
                     dtype=dtype, backend="torch")


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(t) for t in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _serving_inputs():
    """bench.py's serving batch, cut to B = 4, and a drifted second state."""
    rng = np.random.default_rng(3)
    q = np.tile(full_q(CASE_Q[1]), (B, 1))
    q[:, 6:39] += 0.02 * rng.standard_normal((B, 33))
    fs = tuple(np.tile(f, (B, 1)) + 0.05 * rng.standard_normal((B, f.shape[0]))
               for f in CASE_FSTAR[1])
    q2 = q.copy()
    q2[:, 6:39] += 1e-3 * rng.standard_normal((B, 33))
    return q, q2, fs, np.zeros((B, 39))


def _serve(tick, q, q2, fs, qd):
    """Cold-state tick at 12 iterations, then a warm tick at 7 on q2."""
    w0 = tick.init_warm((B,))
    r0, w1 = tick._tick_impl(q, qd, fs, warm=w0, qp_iters=12)
    r1, w2 = tick._tick_impl(q2, qd, fs, warm=w1, qp_iters=7)
    return dict(w0=_np(w0), r0=r0._asdict(), w1=_np(w1), r1=r1._asdict(), w2=_np(w2))


# ------------------------------------------------------------- cold tick
@pytest.fixture(scope="module")
def cold():
    q, f = full_q(CASE_Q[1]), CASE_FSTAR[1]
    ref = _jax_tick(25)._tick_impl(q, np.zeros(39), f)._asdict()
    out = _port_tick(25)._tick_impl(q, np.zeros(39), f)._asdict()
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("field", TAUS)
def test_cold_tick_matches_jax(field, cold):
    ref, out = cold
    assert out[field].shape == ref[field].shape == (33,)
    err = float(np.abs(out[field] - ref[field]).max())
    assert err <= 1e-8, f"{field}: {err:.3e}"


def test_cold_tick_diagnostics(cold):
    ref, out = cold
    assert np.abs(out["contact_force"] - ref["contact_force"]).max() <= 1e-8
    assert abs(float(out["contact_rank_health"]) - float(ref["contact_rank_health"])) <= 1e-12
    assert not out["qp_error"] and not ref["qp_error"]


# ------------------------------------------------ warm serving shape, f64
@pytest.fixture(scope="module")
def serving():
    q, q2, fs, qd = _serving_inputs()
    ref = _serve(_jax_tick(12), q, q2, fs, qd)
    out = _serve(_port_tick(12), q, q2, fs, qd)
    return ref, out


def test_warm_state_shapes_match_jax(serving):
    ref, out = serving
    for key in ("w0", "w1", "w2"):
        assert [(x.shape, l.shape) for x, l in out[key]] == \
               [(x.shape, l.shape) for x, l in ref[key]]
    assert [x.shape[1] for x, _ in out["w0"]] == [12, 9, 6]
    assert all(l.shape[1] == 86 for _, l in out["w0"])


@pytest.mark.parametrize("tick,field,tol", [
    (t, f, tol) for t in ("r0", "r1")
    for f, tol in (("torque_grav", 1e-8), ("torque_task", 2e-3), ("torque_cmd", 5e-2))
])
def test_serving_ticks_match_jax(serving, tick, field, tol):
    ref, out = serving
    a, b = out[tick][field].numpy(), np.asarray(ref[tick][field])
    assert a.shape == b.shape == (B, 33)
    err = float(np.abs(a - b).max())
    assert err <= tol, f"{tick}.{field}: {err:.3e}"


@pytest.mark.parametrize("tick", ["r0", "r1"])
def test_serving_ticks_converge(serving, tick):
    _, out = serving
    r = out[tick]
    assert float(r["qp_gap"].max()) <= 1e-6
    assert float(r["qp_primal_res"].max()) <= 1e-6
    assert not bool(r["qp_error"].any())


# ------------------------------------------------------- float32 vs f64
@pytest.fixture(scope="module")
def serving32(serving):
    q, q2, fs, qd = _serving_inputs()
    f32 = tuple(f.astype(np.float32) for f in fs)
    return _serve(_port_tick(12, torch.float32), q.astype(np.float32),
                  q2.astype(np.float32), f32, qd.astype(np.float32))


@pytest.mark.parametrize("tick", ["r0", "r1"])
def test_float32_tick_close_to_float64(serving, serving32, tick):
    _, out64 = serving
    r32, r64 = serving32[tick], out64[tick]
    assert r32["torque_cmd"].dtype == torch.float32
    assert float((r32["torque_grav"].double() - r64["torque_grav"]).abs().max()) < 0.05
    assert float(r32["qp_gap"].max()) <= 1e-3
    assert float(r32["qp_primal_res"].max()) <= 1e-3
    assert bool(torch.isfinite(r32["torque_cmd"]).all())


# ------------------------------ other static-mode configurations, cold
@pytest.mark.parametrize("variant", ["mixed", "single_foot"])
def test_variant_cold_tick_matches_jax(variant):
    """Mixed 6D/line/point contacts with a whole-body COM task (three
    levels), and a single foot (no redistribution QP)."""
    import dataclasses

    from libdwbc_tpu.model.compile import RobotModel as JM
    from libdwbc_tpu.wbc import pipeline as jpipe
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu.wbc.fused import FusedTick as JF
    from libdwbc_tpu_torch.model.compile import RobotModel as PM
    from libdwbc_tpu_torch.wbc import pipeline as ppipe
    from libdwbc_tpu_torch.wbc import types as PT
    from libdwbc_tpu_torch.wbc.fused import FusedTick as PF
    from test_torch_prestage import _variant_cfg

    jm, pm = JM.load(MODEL), PM.load(MODEL)
    jc = dataclasses.replace(_variant_cfg(JT, jpipe, jm, variant), qp_iters=25)
    pc = dataclasses.replace(_variant_cfg(PT, ppipe, pm, variant), qp_iters=25)
    rng = np.random.default_rng(1)
    fs = tuple(0.1 * rng.standard_normal(sum(6 if s[0] in (0, 1, 2) else 3 for s in lv))
               for lv in pc.task_specs)
    q = full_q(CASE_Q[1])
    ref = JF(jm, jc, dtype=jnp.float64, backend="xla")._tick_impl(q, np.zeros(39), fs)
    out = PF(pm, pc, "cpu", torch.float64, backend="torch")._tick_impl(q, np.zeros(39), fs)
    for field in TAUS + ("contact_force",):
        err = float(np.abs(getattr(out, field).numpy() - np.asarray(getattr(ref, field))).max())
        assert err <= 1e-8, f"{variant}.{field}: {err:.3e}"
    assert not bool(out.qp_error)
