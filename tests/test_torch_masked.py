"""The port's MaskedTick and masked_contact_space against the JAX
package's, at float64 on the CPU.

Three lanes hold the support hypotheses of the two feet (both, left, right).
The JAX functions run eagerly (``_tick_impl`` without jit), each reference
once per module.  Tolerances: the contact-space factorization 1e-10
(relative to each field's largest entry), a cold 25-iteration tick 1e-8,
and the warm chain of tests/test_masked_warm.py:31-71 at that test's
bounds: each warm 7-iteration tick against a cold 25-iteration solve at the
same state (primal residual 1e-8, gap 1e-5, τ_grav 1e-10, τ_task 2e-3, the
τ_cmd spread inside span(NwJw) to 2e-3), and its first warm tick against the
JAX one by the flat-face policy (τ_grav 1e-8, τ_task 2e-3, τ_cmd 5e-2).
"""

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
WARM_ITERS = 7


def _inputs():
    f1, f2 = CASE_FSTAR[1]
    q = np.tile(full_q(CASE_Q[1]), (B, 1))
    q2 = q.copy()
    q2[:, 6:39] += 1e-3 * np.random.default_rng(11).standard_normal((B, 33))
    return q, q2, np.zeros((B, 39)), (np.tile(f1, (B, 1)), np.tile(f2, (B, 1)))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def port():
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.masked import MaskedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    return MaskedTick(m, standard_tocabi_config(m, qp_iters=25), "cpu", torch.float64,
                      backend="torch")


@pytest.fixture(scope="module")
def jax_tick():
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.wbc.masked import MaskedTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    return MaskedTick(m, standard_tocabi_config(m, qp_iters=25), dtype=jnp.float64)


def test_masked_contact_space_matches_jax(port):
    """The padded contact jacobian and A⁻¹ of the three hypotheses (the
    port's kinematics) through both masked_contact_space functions."""
    from libdwbc_tpu.wbc.masked import masked_contact_space as jmcs
    from libdwbc_tpu_torch.wbc.masked import masked_contact_space

    q, _, qd, _ = _inputs()
    st = port.kin.update(torch.as_tensor(q), torch.as_tensor(qd), points=port._points)
    J_C = torch.cat([st.J_pts[:, i] for i in range(2)], 1)
    row_mask = torch.as_tensor(np.repeat(MASKS, 6, axis=1))
    got = masked_contact_space(J_C, st.A_inv, row_mask)
    want = jmcs(jnp.asarray(J_C.numpy()), jnp.asarray(st.A_inv.numpy()),
                jnp.asarray(row_mask.numpy()))
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(_np(g) - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= 1e-10, f"{name}: {err:.3e}"
    assert not got.NwJw[1:].any() and not got.V2[1:].any()


@pytest.fixture(scope="module")
def ticks(port, jax_tick):
    """Cold 25-iteration ticks from the cold warm state, then warm
    7-iteration ticks on the drifted state, for both packages."""
    q, q2, qd, fs = _inputs()
    out = {}
    for name, t in (("port", port), ("jax", jax_tick)):
        r0, w1 = t._tick_impl(q, qd, fs, MASKS, warm=t.init_warm((B,)), qp_iters=25)
        r1, _ = t._tick_impl(q2, qd, fs, MASKS, warm=w1, qp_iters=WARM_ITERS)
        out[name] = ({k: _np(v) for k, v in r0._asdict().items()},
                     {k: _np(v) for k, v in r1._asdict().items()})
    return out


@pytest.mark.parametrize("field", TAUS + ("contact_force",))
def test_masked_cold_tick_matches_jax(ticks, field):
    got, want = ticks["port"][0][field], ticks["jax"][0][field]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 1e-8, f"{field}: {err:.3e}"
    assert np.array_equal(ticks["port"][0]["qp_error"], ticks["jax"][0]["qp_error"])


@pytest.mark.parametrize("field,tol", [("torque_grav", 1e-8), ("torque_task", 2e-3),
                                       ("torque_cmd", 5e-2)])
def test_masked_warm_tick_matches_jax(ticks, field, tol):
    err = float(np.abs(ticks["port"][1][field] - ticks["jax"][1][field]).max())
    assert err <= tol, f"{field}: {err:.3e}"


def test_masked_warm_chain_matches_cold_solves(port):
    """tests/test_masked_warm.py:31-71 on the port: four warm ticks over
    drifting states against cold full-budget solves at the same states."""
    from libdwbc_tpu_torch.wbc.masked import masked_contact_space

    q, _, qd, fs = _inputs()
    rng = np.random.default_rng(11)
    res, warm = port._tick_impl(q, qd, fs, MASKS, warm=port.init_warm((B,)), qp_iters=25)
    worst_task = 0.0
    for _ in range(4):
        q = q.copy()
        q[:, 6:39] += 1e-3 * rng.standard_normal((B, 33))
        res_w, warm = port._tick_impl(q, qd, fs, MASKS, warm=warm, qp_iters=WARM_ITERS)
        res_c = port._tick_impl(q, qd, fs, MASKS)
        assert float(res_w.qp_primal_res.max()) < 1e-8
        assert float(res_w.qp_gap.max()) < 1e-5
        assert float((res_w.torque_grav - res_c.torque_grav).abs().max()) <= 1e-10
        worst_task = max(worst_task, float((res_w.torque_task - res_c.torque_task).abs().max()))
        st = port.kin.update(torch.as_tensor(q), torch.as_tensor(qd), points=port._points)
        J_C = torch.cat([st.J_pts[:, i] for i in range(2)], 1)
        NwJw = masked_contact_space(J_C, st.A_inv,
                                    torch.as_tensor(np.repeat(MASKS, 6, axis=1))).NwJw
        for b in range(B):
            d_cmd = (res_w.torque_cmd[b] - res_c.torque_cmd[b]).numpy()
            z, *_ = np.linalg.lstsq(NwJw[b].numpy(), d_cmd, rcond=None)
            assert np.abs(NwJw[b].numpy() @ z - d_cmd).max() < 2e-3
    assert worst_task < 2e-3, worst_task


def test_masked_tick_refuses_servos_and_a_cuda_backend_without_a_card(port):
    from libdwbc_tpu_torch.wbc.masked import MaskedTick

    q, _, qd, fs = _inputs()
    a, b = port._tick_impl(q, qd, fs, MASKS, servos=(None, None)), port._tick_impl(q, qd, fs,
                                                                                   MASKS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MaskedTick(port.model, port.cfg, "cpu", backend="cuda")
