"""Batched small-matrix factorizations in torch, batch-major (counterpart of
``libdwbc_tpu/ops/smallmat.py``).

All functions take (..., n, n) / (..., n, m) tensors with leading batch
dims.  The recurrences, pivot clamps and thresholds are the JAX module's:

* ``chol`` clamps each pivot at 1e-30, so a singular Gram gives a tiny
  pivot instead of raising (``torch.linalg.cholesky``) or NaN — the rank
  probe ``wbc/dynamics.py::_chol_health`` relies on it;
* ``complete_basis`` picks the FIRST residual of largest norm
  (``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does);
* ``qr_pinv`` keeps ``drop_tol=1e-7`` and the relative ``rcond``.

Loops run over one matrix index and are vectorised over the other and the
batch; sums over a whole axis are one reduction, so results agree with the
JAX module up to summation order.
"""

from __future__ import annotations

import torch


def chol(A):
    """Lower Cholesky factor of a PSD matrix, right-looking over columns,
    pivots clamped at 1e-30."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    S = A
    for j in range(n):
        d = torch.sqrt(torch.clamp_min(S[..., 0, 0], 1e-30))
        col = S[..., :, 0] / d[..., None]
        L[..., j:, j] = col
        S = S[..., 1:, 1:] - col[..., 1:, None] * col[..., None, 1:]
    return L


def _rhs(L, B):
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    batch = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    X = torch.empty(batch + B.shape[-2:], dtype=B.dtype, device=B.device)
    return vec, B, X


def solve_lower(L, B):
    """Solve L X = B (L lower-triangular) by forward substitution.
    B: (..., n, m) or (..., n)."""
    vec, B, X = _rhs(L, B)
    for i in range(L.shape[-1]):
        acc = B[..., i, :] - (L[..., i, :i, None] * X[..., :i, :]).sum(-2)
        X[..., i, :] = acc / L[..., i, i, None]
    return X[..., 0] if vec else X


def solve_upper(U, B):
    """Solve U X = B (U upper-triangular) by back substitution."""
    vec, B, X = _rhs(U, B)
    n = U.shape[-1]
    for i in reversed(range(n)):
        acc = B[..., i, :] - (U[..., i, i + 1:, None] * X[..., i + 1:, :]).sum(-2)
        X[..., i, :] = acc / U[..., i, i, None]
    return X[..., 0] if vec else X


def cho_solve(L, B):
    """Solve A X = B given the Cholesky factor L of A."""
    return solve_upper(L.transpose(-1, -2), solve_lower(L, B))


def psd_solve(A, B):
    """Solve A X = B for symmetric positive definite A."""
    return cho_solve(chol(A), B)


def psd_inverse(A):
    """Inverse of a symmetric PD matrix: A⁻¹ = L⁻ᵀ L⁻¹."""
    L = chol(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    Linv = solve_lower(L, eye)
    return Linv.transpose(-1, -2) @ Linv


def qr_thin(A, drop_tol=None):
    """Orthonormal Q (..., m, k) of a tall A by two-pass modified
    Gram-Schmidt.  With drop_tol, a column whose residual is at most
    drop_tol·‖original column‖ becomes zeros instead of normalized noise."""
    cols = []
    for j in range(A.shape[-1]):
        v = A[..., :, j]
        nrm0 = torch.sqrt((v * v).sum(-1, keepdim=True))
        for _ in range(2):
            for q in cols:
                v = v - (q * v).sum(-1, keepdim=True) * q
        nrm = torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-30))
        if drop_tol is None:
            cols.append(v / nrm)
        else:
            keep = nrm > drop_tol * torch.clamp_min(nrm0, 1e-30)
            cols.append(torch.where(keep, v / nrm, torch.zeros_like(v)))
    return torch.stack(cols, dim=-1)


def complete_basis(A):
    """Orthonormal basis (..., m, m) whose first k columns span col(A)
    (A: (..., m, k)): the unit vectors' residuals against col(A), then m−k
    greedy picks of the first residual of largest norm."""
    m, k = A.shape[-2], A.shape[-1]
    Q = qr_thin(A)
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (m, m))
    # R[:, c] = e_c − Q Qᵀ e_c, one projection per column of Q in turn
    R = eye
    for j in range(k):
        q = Q[..., :, j]
        R = R - q[..., :, None] * (q[..., :, None] * R).sum(-2)[..., None, :]
    chosen = []
    for _ in range(m - k):
        nrm = (R * R).sum(-2)
        jbest = torch.argmax(nrm, dim=-1)
        v = torch.take_along_dim(R, jbest[..., None, None], dim=-1)[..., 0]
        v = v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-30))
        chosen.append(v)
        R = R - v[..., :, None] * (v[..., :, None] * R).sum(-2)[..., None, :]
    return torch.cat([Q, torch.stack(chosen, dim=-1)], dim=-1)


def qr_pinv(M, rcond=1e-6):
    """Thresholded pseudo-inverse of a small square matrix via MGS QR:
    directions whose R pivot is at most rcond·max|R_ii| are zeroed instead
    of inverted (the reference's COD pinv with threshold 1e-6)."""
    n = M.shape[-1]
    Q = qr_thin(M, drop_tol=1e-7)
    QT = Q.transpose(-1, -2)
    R = QT @ M
    d = torch.diagonal(R, dim1=-2, dim2=-1).abs()
    live = (d > rcond * d.max(dim=-1, keepdim=True).values)[..., :, None]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    R = torch.where(live, R, eye)          # dead row j ← e_j (solves to 0)
    B = torch.where(live, QT, torch.zeros_like(QT))
    return solve_upper(R, B)


def qr_inv(M):
    """Inverse of a small square matrix by MGS QR: M⁻¹ = R⁻¹Qᵀ.  Unlike
    ``inv_via_normal`` it does not square the condition number (qr_thin's
    second pass keeps Q orthonormal to working precision)."""
    Q = qr_thin(M)
    QT = Q.transpose(-1, -2)
    return solve_upper(QT @ M, QT)


def inv_via_normal(M):
    """Inverse of a small square matrix by the normal equations:
    M⁻¹ = (MᵀM)⁻¹Mᵀ, with a ridge of 1e-12·tr(MᵀM).  Squares the condition
    number: for well-conditioned matrices."""
    MT = M.transpose(-1, -2)
    G = MT @ M
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    G = G + 1e-12 * tr[..., None, None] * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return psd_solve(G, MT)
