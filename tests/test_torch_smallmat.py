"""The port's rotations, small-matrix factorizations and PSD pseudo-inverse
against the JAX package, float64, inputs from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

TOL = 1e-11


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    err = float(np.abs(got.numpy() - ref).max() / max(1.0, np.abs(ref).max()))
    assert err <= tol, err


@pytest.mark.parametrize("fn", ["skew", "quat_to_matrix", "axis_angle_matrix"])
def test_rotations_match_jax(fn):
    from libdwbc_tpu.kin import rotations as jr
    from libdwbc_tpu_torch.kin import rotations as tr

    rng = np.random.default_rng(0)
    if fn == "axis_angle_matrix":
        a = rng.standard_normal((5, 3))
        a /= np.linalg.norm(a, axis=-1, keepdims=True)
        ang = rng.standard_normal(5)
        args = (a, ang)
    else:
        args = (rng.standard_normal((5, 3 if fn == "skew" else 4)),)
    ref = getattr(jr, fn)(*map(jnp.asarray, args))
    _close(getattr(tr, fn)(*map(torch.as_tensor, args)), ref)


def _spd(rng, B, n):
    M = rng.standard_normal((B, n, n))
    return M @ np.swapaxes(M, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("fn", ["chol", "psd_solve", "cho_solve", "solve_lower",
                                "solve_upper", "qr_thin", "qr_thin_drop", "complete_basis",
                                "qr_pinv", "qr_pinv_rank_deficient"])
def test_smallmat_matches_jax(fn):
    from libdwbc_tpu.ops import smallmat as jsm
    from libdwbc_tpu_torch.ops import smallmat as sm

    rng = np.random.default_rng(1)
    A = _spd(rng, 3, 7)
    b = rng.standard_normal((3, 7, 4))
    if fn in ("chol", "psd_solve"):
        args = (A,) if fn == "chol" else (A, b)
    elif fn == "cho_solve":
        args = (np.linalg.cholesky(A), b)
    elif fn == "solve_lower":
        args = (np.linalg.cholesky(A), b[..., 0])
    elif fn == "solve_upper":
        args = (np.swapaxes(np.linalg.cholesky(A), -1, -2), b)
    elif fn.startswith("qr_thin"):
        T = rng.standard_normal((3, 9, 4))
        if fn == "qr_thin_drop":
            T[..., 3] = T[..., 0] - 2.0 * T[..., 1]       # a dependent column
            ref = jsm.qr_thin(jnp.asarray(T), drop_tol=1e-7)
            got = sm.qr_thin(torch.as_tensor(T), drop_tol=1e-7)
            _close(got, ref)
            assert float(got[..., 3].abs().max()) == 0.0
            return
        args = (T,)
    elif fn == "complete_basis":
        args = (rng.standard_normal((3, 12, 6)),)
    else:
        M = rng.standard_normal((3, 6, 6))
        if fn == "qr_pinv_rank_deficient":
            M[..., 5] = M[..., 0] + M[..., 1]
            fn = "qr_pinv"
        args = (M,)
    ref = getattr(jsm, fn)(*map(jnp.asarray, args))
    _close(getattr(sm, fn)(*map(torch.as_tensor, args)), ref)


def test_complete_basis_first_max_tie_break():
    """Ties in the residual norms pick the first column, as jnp.argmax."""
    from libdwbc_tpu.ops import smallmat as jsm
    from libdwbc_tpu_torch.ops import smallmat as sm

    A = np.zeros((2, 12, 6))
    A[:, :6, :] = np.eye(6)                  # every residual norm ties at 1
    _close(sm.complete_basis(torch.as_tensor(A)), jsm.complete_basis(jnp.asarray(A)), 0.0)


def test_chol_clamps_singular_pivots():
    """A Gram of rank n−1: the last pivot is clamped, the factor stays
    finite, and the contact rank probe (dynamics._chol_health) reads what
    the JAX one reads."""
    from libdwbc_tpu.ops import smallmat as jsm
    from libdwbc_tpu.wbc.dynamics import _chol_health as jax_health
    from libdwbc_tpu_torch.ops import smallmat as sm
    from libdwbc_tpu_torch.wbc.dynamics import _chol_health

    v = np.random.default_rng(2).standard_normal((2, 6, 5))
    G = v @ np.swapaxes(v, -1, -2)
    got = sm.chol(torch.as_tensor(G))
    assert torch.isfinite(got).all()
    _close(got, jsm.chol(jnp.asarray(G)), 1e-9)
    _close(_chol_health(torch.as_tensor(G)), jax_health(jnp.asarray(G)), 1e-9)


def test_pinv_psd_matches_jax():
    from libdwbc_tpu.ops.linalg import pinv_psd as jpinv
    from libdwbc_tpu_torch.ops.linalg import pinv_psd

    v = np.random.default_rng(3).standard_normal((3, 6, 4))
    M = v @ np.swapaxes(v, -1, -2)           # rank 4 of 6
    _close(pinv_psd(torch.as_tensor(M)), jpinv(jnp.asarray(M)), 1e-10)
