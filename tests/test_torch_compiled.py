"""The port's CompiledTick (plain backend) against the JAX CompiledTick on
the flagship (``models/tocabi.npz``, ``standard_tocabi_config``), float64.

The JAX tick runs once, eagerly, in a module fixture (about a minute): the
serving shape, a batch of three perturbed standing states from the cold
warm state (x = 0, λ = 1) at 12 IPM iterations.  Tolerances follow the
repository's flat-face tolerance policy: τ_grav 1e-8, the
unit-Hessian task torque 2e-3, τ_cmd 5e-2, gap and primal residual 1e-6.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import CASE_FSTAR, CASE_Q, full_q

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
B = 3
ITERS = 12
TOL = {"torque_grav": 1e-8, "torque_task": 2e-3, "torque_cmd": 5e-2}


def _inputs():
    rng = np.random.default_rng(3)
    q = np.tile(full_q(CASE_Q[1]), (B, 1))
    q[:, 6:39] += 0.02 * rng.standard_normal((B, 33))
    fs = tuple(np.tile(f, (B, 1)) + 0.05 * rng.standard_normal((B, f.shape[0]))
               for f in CASE_FSTAR[1])
    return q, np.zeros((B, 39)), fs


def _port(cls="compiled", dtype=torch.float64):
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, standard_tocabi_config

    m = RobotModel.load(MODEL)
    tick = CompiledTick if cls == "compiled" else FusedTick
    return tick(m, standard_tocabi_config(m, qp_iters=ITERS), "cpu", dtype=dtype,
                backend="torch")


@pytest.fixture(scope="module")
def served():
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config
    from libdwbc_tpu_torch.convert import result_to_numpy, warm_to_numpy

    q, qd, fs = _inputs()
    m = RobotModel.load(MODEL)
    jt = CompiledTick(m, standard_tocabi_config(m, qp_iters=ITERS), dtype=jnp.float64)
    r_ref, w_ref = jt._tick_impl(jnp.asarray(q), jnp.asarray(qd), tuple(map(jnp.asarray, fs)),
                                 warm=jt.init_warm((B,)))
    tick = _port()
    r, w = tick._tick_impl(q, qd, fs, warm=tick.init_warm((B,)))
    return dict(ref=result_to_numpy(r_ref), got=result_to_numpy(r),
                w_ref=warm_to_numpy(w_ref), w_got=warm_to_numpy(w))


@pytest.mark.parametrize("field", sorted(TOL))
def test_torques_match_jax(served, field):
    err = float(np.abs(served["got"][field] - served["ref"][field]).max())
    print(f"{field}: {err:.3e}")
    assert err <= TOL[field]


def test_diagnostics_match_jax(served):
    got, ref = served["got"], served["ref"]
    assert np.array_equal(got["qp_error"], ref["qp_error"]) and not got["qp_error"].any()
    assert got["qp_gap"].max() <= 1e-6 and got["qp_primal_res"].max() <= 1e-6
    assert np.abs(got["contact_rank_health"] - ref["contact_rank_health"]).max() <= 1e-10
    assert np.abs(got["contact_force"] - ref["contact_force"]).max() <= 1e-6


def test_warm_state_shapes_match_jax(served):
    assert [(x.shape, lam.shape) for x, lam in served["w_got"]] == \
        [(x.shape, lam.shape) for x, lam in served["w_ref"]]
    # the task block of each level's x (δf*, unit Hessian) is well determined
    for (x, _), (xr, _), t in zip(served["w_got"], served["w_ref"], (6, 3)):
        assert np.abs(x[:, :t] - xr[:, :t]).max() <= 2e-3


def test_fused_and_compiled_take_each_others_warm_state():
    q, qd, fs = _inputs()
    comp, fused = _port("compiled"), _port("fused")
    rc, wc = comp._tick_impl(q, qd, fs, warm=comp.init_warm((B,)))
    rf, wf = fused._tick_impl(q, qd, fs, warm=fused.init_warm((B,)))
    q2 = q.copy()
    q2[:, 6:39] += 1e-3
    a, _ = fused._tick_impl(q2, qd, fs, warm=wc, qp_iters=7)
    b, _ = comp._tick_impl(q2, qd, fs, warm=wf, qp_iters=7)
    for x, y in ((rc, rf), (a, b)):
        assert float((x.torque_grav - y.torque_grav).abs().max()) <= 1e-8
        assert float((x.torque_task - y.torque_task).abs().max()) <= 2e-3
        assert float((x.torque_cmd - y.torque_cmd).abs().max()) <= 5e-2
    assert not bool(a.qp_error.any()) and not bool(b.qp_error.any())


def test_unbatched_tick_is_lane_zero():
    q, qd, fs = _inputs()
    tick = _port()
    rb = tick._tick_impl(q, qd, fs)
    r1 = tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs))
    assert r1.torque_cmd.shape == (33,) and r1.qp_gap.shape == ()
    assert float((r1.torque_cmd - rb.torque_cmd[0]).abs().max()) <= 1e-9
    r2, w2 = tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs), warm=tick.init_warm())
    assert [tuple(x.shape) for x, _ in w2] == [(12,), (9,), (6,)]


def _serving_inputs(n=8):
    """chip_smoke.py's serving batch (seed 0), cut to n lanes, float32."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel

    q, _, fstars = entry._example_inputs(RobotModel.load(MODEL))
    rng = np.random.default_rng(0)
    qs = np.tile(q, (n, 1)).astype(np.float32)
    qs[:, 6:39] += 0.02 * rng.standard_normal((n, 33)).astype(np.float32)
    fs = [np.tile(f, (n, 1)).astype(np.float32)
          + 0.05 * rng.standard_normal((n, f.shape[0])).astype(np.float32) for f in fstars]
    return qs, np.zeros((n, 39), np.float32), fs


def _against_float64(tick32, n=8):
    qs, qd, fs = _serving_inputs(n)
    t64 = _port()
    r32, w = tick32._tick_impl(qs, qd, fs, warm=tick32.init_warm((n,)))
    r64, _ = t64._tick_impl(qs.astype(np.float64), qd, [f.astype(np.float64) for f in fs],
                            warm=t64.init_warm((n,)))
    assert float((r32.torque_grav.double() - r64.torque_grav).abs().max()) <= 0.05
    assert float((r32.torque_cmd.double() - r64.torque_cmd).abs().max()) <= 0.05
    assert not bool(r32.qp_error.any())
    for _ in range(2):
        r32, w = tick32._tick_impl(qs, qd, fs, warm=w, qp_iters=7)
        assert not bool(r32.qp_error.any()) and float(r32.qp_gap.max()) <= 1e-3


def test_float32_against_float64_on_the_cpu():
    """The plain float32 tick within the truth guard's bars of float64 on
    the serving inputs (on flat-face inputs float32 τ_cmd may sit 0.3 Nm
    away; τ_grav and τ_task do not)."""
    _against_float64(_port(dtype=torch.float32))


def test_kernel_routing_with_the_plain_versions(monkeypatch):
    """The CUDA backend's routing, run on the CPU: with the routing rules
    widened to CPU tensors, the tick goes through the two wrappers, which
    take their plain versions here (no launch), and stays within the truth
    guard's bars of float64."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp, qp_cuda

    calls = {"psd_inverse": 0, "qp_solve": 0}
    inv, solve = linalg_cuda.psd_inverse, qp_cuda.qp_solve

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(linalg_cuda, "use_kernel", lambda M, backend: (
        M.dtype == torch.float32 and linalg_cuda.MIN_N <= M.shape[-1] <= linalg_cuda.MAX_N))
    monkeypatch.setattr(qp, "_use_kernel", lambda H, A, lb, Aeq, backend, mirror=0: (
        lb is None and Aeq is None and H.dtype == torch.float32
        and qp_cuda.kernel_takes(H.shape[-1], A.shape[-2], mirror)))
    monkeypatch.setattr(linalg_cuda, "psd_inverse", count("psd_inverse", inv))
    monkeypatch.setattr(qp_cuda, "qp_solve", count("qp_solve", solve))
    n0 = dict(linalg_cuda.launches, **qp_cuda.launches)
    _against_float64(_port(dtype=torch.float32))
    assert calls == {"psd_inverse": 2 * 3, "qp_solve": 3 * 3}
    assert dict(linalg_cuda.launches, **qp_cuda.launches) == n0


def test_entry_returns_compiled_tick_and_refuses_cuda_on_cpu():
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick

    model, tick = entry._model_and_tick("cpu", dtype=torch.float64, backend="torch",
                                        fused=False)
    assert isinstance(tick, CompiledTick) and tick.backend == "torch"
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledTick(model, tick.cfg, "cpu", backend="cuda")
    q, qd, fs = entry._example_inputs(model, np.float64)
    a, b = tick._tick_impl(q, qd, fs, servos=(None, None)), tick._tick_impl(q, qd, fs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
