"""Element-leading linear algebra in torch: the math core of the reference
tick (a frozen copy of the port's ``ops/elemlin.py``).

Layout ("batch in lanes", as in ``libdwbc_tpu/ops/elemlin.py``): element
indices lead and the batch dimensions trail —

    matrix: (m, n, *bt)     vector: (n, *bt)     scalar: (*bt)

The algorithms and pivot clamps (1e-30) are those of the JAX module, so the
plain tick here and the CUDA kernels in ``csrc/elemlin.cuh`` compute the same
recurrences.  Contractions over a whole axis are one ``einsum`` instead of
the JAX module's unrolled loops; recurrences (Cholesky, substitutions,
Gram-Schmidt) keep their loops, vectorised over whole rows or columns.
Results agree with the JAX module up to summation order.
"""

from __future__ import annotations

import numpy as np
import torch


def _bt(x, ndim):
    """Reshape a leading-only tensor to broadcast against ndim trailing
    batch dims."""
    return x.reshape(tuple(x.shape) + (1,) * ndim)


# ------------------------------------------------------------- products
def mm(A, B):
    """(m,k)+bt @ (k,n)+bt -> (m,n)+bt."""
    return torch.einsum("ik...,kj...->ij...", A, B)


def mmT(A, B):
    """A @ Bᵀ: (m,k)+bt, (n,k)+bt -> (m,n)+bt."""
    return torch.einsum("ik...,jk...->ij...", A, B)


def mTm(A, B):
    """Aᵀ @ B: (k,m)+bt, (k,n)+bt -> (m,n)+bt."""
    return torch.einsum("ki...,kj...->ij...", A, B)


def mv(A, x):
    """(m,n)+bt @ (n,)+bt -> (m,)+bt."""
    return (A * x[None]).sum(1)


def mTv(A, x):
    """Aᵀ x: (m,n)+bt, (m,)+bt -> (n,)+bt."""
    return (A * x[:, None]).sum(0)


def dot(a, b):
    """(n,)+bt · (n,)+bt -> (*bt)."""
    return (a * b).sum(0)


def outer(a, b):
    """(m,)+bt ⊗ (n,)+bt -> (m,n)+bt."""
    return a[:, None] * b[None]


def transpose(A):
    """(m,n)+bt -> (n,m)+bt (swap the two leading dims)."""
    return A.transpose(0, 1)


def cross(a, b):
    """3-vector cross product on (3,)+bt operands."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ], dim=0)


def eye(n, ref):
    """(n,n)+bt identity whose batch dims match a reference (*bt) scalar."""
    e = torch.eye(n, dtype=ref.dtype, device=ref.device)
    return _bt(e, ref.ndim).expand((n, n) + tuple(ref.shape)).contiguous()


# ------------------------------------------------- static-operand products
# One operand is a host-side numpy constant (joint axes, joint transforms,
# inertia tensors, constraint blocks).

def _const(x_np, like):
    return torch.as_tensor(np.asarray(x_np, np.float64), dtype=like.dtype,
                           device=like.device)


def mv_ds(A, b_np):
    """dynamic (m,n)+bt @ static (n,) -> (m,)+bt."""
    b = _const(b_np, A)
    return (A * _bt(b, A.ndim - 2)[None]).sum(1)


def mm_ds(A, B_np):
    """dynamic (m,k)+bt @ static (k,n) -> (m,n)+bt."""
    B = _const(B_np, A)
    return torch.einsum("ik...,kj->ij...", A, B)


def vec_sd(A_np_row, xs):
    """static row (k,) · list of k (*bt) scalars -> (*bt)."""
    a = _const(A_np_row, xs[0])
    return (_bt(a, xs[0].ndim) * torch.stack(list(xs), 0)).sum(0)


def mv_sd(A_np, x):
    """static (m,n) @ dynamic (n,)+bt -> (m,)+bt."""
    A = _const(A_np, x)
    return torch.einsum("ik,k...->i...", A, x)


def mm_sd(A_np, B):
    """static (m,k) @ dynamic (k,n)+bt -> (m,n)+bt."""
    A = _const(A_np, B)
    return torch.einsum("ik,kj...->ij...", A, B)


def svec(vals, zero):
    """static 1-D values -> (n,)+bt broadcast against a (*bt) zero."""
    v = _const(vals, zero)
    return _bt(v, zero.ndim) + zero


def smat(M_np, zero):
    """static 2-D values -> (m,n)+bt broadcast against a (*bt) zero."""
    M = _const(M_np, zero)
    return _bt(M, zero.ndim) + zero


def diag_add(M, vals):
    """M + diag(vals): vals is a list of (*bt) scalars or floats."""
    out = M.clone()
    for i in range(M.shape[0]):
        out[i, i] = out[i, i] + vals[i]
    return out


def _mirror_lower(E):
    """Keep the lower triangle (i ≥ j) of (n,n)+bt and mirror it, so the
    result is exactly symmetric."""
    n = E.shape[0]
    low = torch.ones(n, n, dtype=torch.bool, device=E.device).tril()
    return torch.where(_bt(low, E.ndim - 2), E, E.transpose(0, 1))


# ------------------------------------------------------ factorizations
def chol_factor(M):
    """Lower Cholesky factor of (n,n)+bt SPD plus its reciprocal diagonal
    (n,)+bt: right-looking, one rsqrt per column, pivots clamped at 1e-30.
    The stored diagonal is S_jj·rsqrt(max(S_jj, 1e-30))."""
    n = M.shape[0]
    S = M
    L = torch.zeros_like(M)
    inv_diag = []
    for j in range(n):
        inv_d = torch.rsqrt(torch.clamp_min(S[0, 0], 1e-30))
        col = S[:, 0] * inv_d[None]
        L[j:, j] = col
        if j < n - 1:
            ctail = col[1:]
            S = S[1:, 1:] - ctail[:, None] * ctail[None]
        inv_diag.append(inv_d)
    return L, torch.stack(inv_diag, 0)


def chol(M):
    """Lower Cholesky factor of (n,n)+bt SPD; see chol_factor."""
    return chol_factor(M)[0]


def solve_lower(L, B):
    """L X = B, B (n,m)+bt (forward substitution)."""
    X = torch.empty_like(B)
    for i in range(L.shape[0]):
        acc = B[i]
        if i:
            acc = acc - (L[i, :i, None] * X[:i]).sum(0)
        X[i] = acc / L[i, i][None]
    return X


def solve_lower_inv(L, inv_diag, B):
    """L X = B with a precomputed reciprocal diagonal (no divides)."""
    X = torch.empty_like(B)
    for i in range(L.shape[0]):
        acc = B[i]
        if i:
            acc = acc - (L[i, :i, None] * X[:i]).sum(0)
        X[i] = acc * inv_diag[i][None]
    return X


def solve_upperT_inv(L, inv_diag, Y):
    """Lᵀ X = Y (back substitution on the transposed factor), reciprocal
    diagonal, matrix RHS."""
    n = L.shape[0]
    X = torch.empty_like(Y)
    for i in reversed(range(n)):
        acc = Y[i]
        if i < n - 1:
            acc = acc - (L[i + 1:, i, None] * X[i + 1:]).sum(0)
        X[i] = acc * inv_diag[i][None]
    return X


def cho_solve_mat(L, inv_diag, B):
    """Solve L Lᵀ X = B for a matrix RHS (n,m)+bt."""
    return solve_upperT_inv(L, inv_diag, solve_lower_inv(L, inv_diag, B))


def tri_inv_lower(L, inv_diag):
    """Inverse of a lower-triangular (n,n)+bt factor, row by row:
    X[i,i] = 1/L[i,i];  X[i,j] = −(Σ_{k=j..i−1} L[i,k]·X[k,j]) / L[i,i].
    Entries above the diagonal are exact zeros."""
    n = L.shape[0]
    X = torch.zeros_like(L)
    for i in range(n):
        X[i, i] = inv_diag[i]
        if i:
            X[i, :i] = -(L[i, :i, None] * X[:i, :i]).sum(0) * inv_diag[i][None]
    return X


def ltl_sym(X):
    """XᵀX for a lower-triangular (n,n)+bt X; exactly symmetric."""
    return _mirror_lower(mTm(X, X))


def mmT_sym(A, B):
    """A @ Bᵀ for operands known to give a symmetric result; the lower
    triangle is mirrored, so the result is exactly symmetric."""
    return _mirror_lower(mmT(A, B))


def mTm_sym(A, B):
    """Aᵀ @ B with a symmetric result (lower triangle mirrored)."""
    return _mirror_lower(mTm(A, B))


def mm_sym(A, B):
    """A @ B with a symmetric result (lower triangle mirrored)."""
    return _mirror_lower(mm(A, B))


def psd_inverse(M):
    """(n,n)+bt SPD inverse: A⁻¹ = L⁻ᵀL⁻¹ through the triangular inverse."""
    L, inv_diag = chol_factor(M)
    return ltl_sym(tri_inv_lower(L, inv_diag))


def chol_health(M):
    """min(diag L)/max(diag L) ≈ sqrt(λmin/λmax): the rank-health
    indicator."""
    L = chol(M)
    d = torch.stack([L[i, i] for i in range(M.shape[0])], 0).abs()
    return d.amin(0) / torch.clamp_min(d.amax(0), 1e-30)


# -------------------------------------------------------- orthogonal ops
def qr_thin(A, drop_tol=None):
    """Thin QR factor Q of (m,k)+bt by double-pass modified Gram-Schmidt.
    With drop_tol, a column whose residual falls below drop_tol times its
    original norm comes back as zeros."""
    cols = []
    for j in range(A.shape[1]):
        v = A[:, j]
        nrm0 = torch.sqrt(dot(v, v))[None]
        for _ in range(2):
            for q in cols:
                v = v - dot(q, v)[None] * q
        nrm = torch.sqrt(torch.clamp_min(dot(v, v), 1e-30))[None]
        if drop_tol is None:
            cols.append(v / nrm)
        else:
            keep = nrm > drop_tol * torch.clamp_min(nrm0, 1e-30)
            cols.append(torch.where(keep, v / nrm, torch.zeros_like(v)))
    return torch.stack(cols, 1)


def complete_basis(A):
    """Orthonormal completion of col(A), A (m,k)+bt → (m,m)+bt whose first
    k columns span col(A): the unit vectors' residuals against col(A), then
    m−k greedy picks of the FIRST residual of largest norm."""
    m, k = A.shape[0], A.shape[1]
    Q = qr_thin(A)
    R = eye(m, A[0, 0])
    for j in range(k):
        q = Q[:, j]
        R = R - q[:, None] * (q[:, None] * R).sum(0)[None]
    chosen = []
    for _ in range(m - k):
        nrm = (R * R).sum(0)                             # (m,)+bt
        hit = nrm >= nrm.amax(0)[None]
        onehot = (hit & (torch.cumsum(hit.to(torch.int32), 0) == 1)).to(A.dtype)
        v = (R * onehot[None]).sum(1)
        v = v / torch.sqrt(torch.clamp_min(dot(v, v), 1e-30))[None]
        chosen.append(v)
        R = R - v[:, None] * (v[:, None] * R).sum(0)[None]
    return torch.cat([Q, torch.stack(chosen, 1)], 1)


def orthonormalize_drop(V, tol=1e-8):
    """Single-pass modified Gram-Schmidt over the columns of (n,k)+bt with
    rank dropout: a column whose residual norm is at most ``tol`` comes back
    as exact zeros (a rank-deficient masked kernel basis gives zeros, not
    normalised noise)."""
    out = []
    for j in range(V.shape[1]):
        v = V[:, j]
        for u in out:
            v = v - dot(u, v)[None] * u
        nrm = torch.sqrt(dot(v, v))[None]
        keep = nrm > tol
        out.append(torch.where(keep, v / torch.where(keep, nrm, 1.0), 0.0))
    return torch.stack(out, 1)


def compact_columns(V, tol=1e-10):
    """Shift the nonzero columns of (n,k)+bt to the left, in order, through a
    0/1 selection built from prefix sums (no gather); the tail is exact
    zeros.  Returns (V_compacted, number of nonzero columns (*bt))."""
    k = V.shape[1]
    nz = (torch.sqrt((V * V).sum(0)) > tol).to(V.dtype)      # (k,)+bt
    pos = torch.cumsum(nz, 0) - 1.0                            # target slot of column j
    t = _bt(torch.arange(k, dtype=V.dtype, device=V.device), V.ndim - 2)
    sel = nz[:, None] * ((pos[:, None] - t[None]).abs() < 0.5).to(V.dtype)
    return torch.einsum("ij...,jt...->it...", V, sel), nz.sum(0)


def qr_pinv(M, rcond=1e-6):
    """Thresholded pseudo-inverse of a small square (n,n)+bt matrix: MGS QR
    (drop_tol 1e-7), rows whose |R_ii| ≤ rcond·max|R_ii| become identity
    rows with a zero right-hand side."""
    n = M.shape[0]
    Q = qr_thin(M, drop_tol=1e-7)
    R = mTm(Q, M)
    d = torch.stack([R[i, i] for i in range(n)], 0).abs()
    live = (d > rcond * d.amax(0)[None])[:, None]
    Rm = torch.where(live, R, eye(n, M[0, 0]))
    B = torch.where(live, transpose(Q), torch.zeros_like(R))
    X = torch.empty_like(B)
    for i in reversed(range(n)):
        acc = B[i]
        if i < n - 1:
            acc = acc - (Rm[i, i + 1:, None] * X[i + 1:]).sum(0)
        X[i] = acc / Rm[i, i][None]
    return X
