"""libdwbc_tpu_torch.ops.elemlin against libdwbc_tpu.ops.elemlin at float64.

Both run on the same seeded element-leading inputs (batch trailing, bt = (5,));
every ported function must agree to 1e-12 relative to the largest entry of
the JAX result.  Differences come only from summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdwbc_tpu.ops import elemlin as jel
from libdwbc_tpu_torch.ops import elemlin as tel

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

RTOL = 1e-12
NB = 5


def _el(a):
    """batch-leading (B, ...) -> element-leading (..., B)."""
    return np.ascontiguousarray(np.moveaxis(a, 0, -1))


def _inputs():
    rng = np.random.default_rng(0)

    def spd(n):
        M = rng.standard_normal((NB, n, n))
        return M @ np.swapaxes(M, 1, 2) + n * np.eye(n)

    S12 = spd(12)
    L12 = np.linalg.cholesky(S12)
    R85 = rng.standard_normal((NB, 8, 5))
    R85[:, :, 3] = R85[:, :, 0] + R85[:, :, 1]          # dependent column
    P6 = rng.standard_normal((NB, 6, 6))
    D6 = P6.copy()
    D6[:, :, 4] = D6[:, :, 0] - 2.0 * D6[:, :, 2]        # rank 5
    Z85 = R85.copy()
    Z85[:, :, 1] = 0.0                                  # an exact zero column too
    Z85[:, :, 3] = Z85[:, :, 0]                         # and a dependent one
    return dict(
        A64=_el(rng.standard_normal((NB, 6, 4))),
        B45=_el(rng.standard_normal((NB, 4, 5))),
        B54=_el(rng.standard_normal((NB, 5, 4))),
        A46=_el(rng.standard_normal((NB, 4, 6))),
        x4=_el(rng.standard_normal((NB, 4))),
        y6=_el(rng.standard_normal((NB, 6))),
        a3=_el(rng.standard_normal((NB, 3))),
        b3=_el(rng.standard_normal((NB, 3))),
        s=_el(rng.standard_normal((NB,))),
        S12=_el(S12),
        S6=_el(spd(6)),
        L12=_el(L12),
        idg12=_el(1.0 / np.diagonal(L12, axis1=1, axis2=2)),
        B12=_el(rng.standard_normal((NB, 12, 3))),
        R85=_el(R85),
        C126=_el(rng.standard_normal((NB, 12, 6))),
        P6=_el(P6),
        D6=_el(D6),
        Z85=_el(Z85),
    )


X = _inputs()
# static operands, with structural zeros and ones
SV = np.array([0.5, 0.0, 1.0, -2.0])
SM43 = np.array([[1.0, 0.0, 0.3], [0.0, 0.0, 0.0], [-1.5, 2.0, 1.0], [0.0, 1.0, 0.0]])
SM54 = np.array([[0.0, 1.0, 0.0, 0.2], [1.0, 0.0, 0.0, 0.0], [0.3, -0.7, 0.0, 1.0],
                 [0.0, 0.0, 0.0, 0.0], [2.0, 0.0, 1.0, -1.0]])

CASES = {
    "mm": lambda el, t: [el.mm(t("A64"), t("B45"))],
    "mmT": lambda el, t: [el.mmT(t("A64"), t("B54"))],
    "mTm": lambda el, t: [el.mTm(t("A46"), t("B45"))],
    "mv": lambda el, t: [el.mv(t("A64"), t("x4"))],
    "mTv": lambda el, t: [el.mTv(t("A64"), t("y6"))],
    "dot": lambda el, t: [el.dot(t("y6"), t("y6"))],
    "outer": lambda el, t: [el.outer(t("y6"), t("x4"))],
    "transpose": lambda el, t: [el.transpose(t("A64"))],
    "cross": lambda el, t: [el.cross(t("a3"), t("b3"))],
    "eye": lambda el, t: [el.eye(4, t("s"))],
    "mv_ds": lambda el, t: [el.mv_ds(t("A64"), SV)],
    "mm_ds": lambda el, t: [el.mm_ds(t("A64"), SM43)],
    "vec_sd": lambda el, t: [el.vec_sd(SV, [t("x4")[i] for i in range(4)])],
    "mv_sd": lambda el, t: [el.mv_sd(SM54, t("x4"))],
    "mm_sd": lambda el, t: [el.mm_sd(SM54, t("B45"))],
    "svec": lambda el, t: [el.svec(SV, t("s") * 0.0)],
    "smat": lambda el, t: [el.smat(SM43, t("s") * 0.0)],
    "diag_add": lambda el, t: [el.diag_add(t("S6"), [t("s"), 1.5, 0.0, t("s") * 2.0, -1.0, 3.0])],
    "chol_factor": lambda el, t: _chol_factor(el, t),
    "chol": lambda el, t: [el.chol(t("S12"))],
    "solve_lower": lambda el, t: [el.solve_lower(t("L12"), t("B12"))],
    "solve_lower_inv": lambda el, t: [el.solve_lower_inv(t("L12"), t("idg12"), t("B12"))],
    "solve_upperT_inv": lambda el, t: [el.solve_upperT_inv(t("L12"), t("idg12"), t("B12"))],
    "cho_solve_mat": lambda el, t: [el.cho_solve_mat(t("L12"), t("idg12"), t("B12"))],
    "tri_inv_lower": lambda el, t: [el.tri_inv_lower(t("L12"), t("idg12"))],
    "ltl_sym": lambda el, t: [el.ltl_sym(t("L12"))],
    "mmT_sym": lambda el, t: [el.mmT_sym(t("A64"), t("C126")[0:6, 0:4])],
    "mTm_sym": lambda el, t: [el.mTm_sym(t("A64"), t("C126")[0:6, 0:4])],
    "mm_sym": lambda el, t: [el.mm_sym(t("A64"), t("A46"))],
    "psd_inverse": lambda el, t: [el.psd_inverse(t("S12"))],
    "chol_health": lambda el, t: [el.chol_health(t("S12"))],
    "qr_thin": lambda el, t: [el.qr_thin(t("C126"))],
    "qr_thin_drop": lambda el, t: [el.qr_thin(t("R85"), drop_tol=1e-7)],
    "complete_basis": lambda el, t: [el.complete_basis(t("C126"))],
    "qr_pinv": lambda el, t: [el.qr_pinv(t("P6"))],
    "qr_pinv_rank_deficient": lambda el, t: [el.qr_pinv(t("D6"))],
    "orthonormalize_drop": lambda el, t: [el.orthonormalize_drop(t("C126"))],
    "orthonormalize_drop_rank_deficient": lambda el, t: [el.orthonormalize_drop(t("Z85"))],
    "compact_columns": lambda el, t: list(el.compact_columns(t("Z85"))),
    "compact_columns_dropped": lambda el, t: list(
        el.compact_columns(el.orthonormalize_drop(t("Z85")))),
}


def _chol_factor(el, t):
    L, idg = el.chol_factor(t("S12"))
    if isinstance(idg, list):
        idg = jnp.stack(idg, axis=0)
    return [L, idg]


@pytest.mark.parametrize("name", sorted(CASES))
def test_elemlin_matches_jax(name):
    ref = CASES[name](jel, lambda k: jnp.asarray(X[k]))
    out = CASES[name](tel, lambda k: torch.as_tensor(X[k]))
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        r = np.asarray(r)
        o = o.numpy()
        assert o.shape == r.shape, (name, o.shape, r.shape)
        scale = max(float(np.abs(r).max()), 1e-300)
        err = float(np.abs(o - r).max()) / scale
        assert err <= RTOL, f"{name}: relative error {err:.3e}"


def test_qr_pinv_dead_pivot_is_zero_row():
    """The rank-deficient case really exercises the dead-pivot rule."""
    X_ = tel.qr_pinv(torch.as_tensor(X["D6"]))
    assert (X_.abs().amax(dim=(1, 2)) == 0).sum() == 1


def test_dropped_columns_are_exact_zeros():
    """orthonormalize_drop returns the zero and the dependent column of Z85
    as exact zeros, and compact_columns moves the three live columns left in
    order and leaves an exactly zero tail."""
    V = tel.orthonormalize_drop(torch.as_tensor(X["Z85"]))
    assert not V[:, 1].any() and not V[:, 3].any()
    assert (V[:, [0, 2, 4]].square().sum(0) - 1.0).abs().max() <= 1e-12
    C, count = tel.compact_columns(V)
    assert torch.equal(count, torch.full((NB,), 3.0, dtype=torch.float64))
    assert torch.equal(C[:, 0:3], V[:, [0, 2, 4]]) and not C[:, 3:].any()
