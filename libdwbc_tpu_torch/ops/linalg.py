"""Dense linear algebra of the pipeline in torch (counterpart of
``libdwbc_tpu/ops/linalg.py``).

The reference pseudo-inverts with Eigen's rank-revealing complete
orthogonal decomposition (``PinvCOD``/``PinvCODWB``, src/math.cpp:23-53,
src/wbd.cpp:5-53) at a 1e-6 threshold.  Here every matrix it
pseudo-inverts is symmetric PSD, so one symmetric eigendecomposition gives
the pseudo-inverse and an orthonormal null basis, and where the rank is
known statically (the reduced path, src/dwbc.cpp:3119) no data-dependent
rank decision is made.  The pseudo-inverse is basis-independent; a null
basis differs from Eigen's by an orthogonal transform.
"""

from __future__ import annotations

import torch


def pinv_psd_fixed_rank(M, rank: int):
    """Pseudo-inverse and orthonormal null basis of a symmetric PSD matrix
    of statically known rank: (M⁺, V2) with V2 (n−rank, n) spanning ker(M)
    by rows (``PinvCODWB(W, Winv, V2, ...)``, src/wbd.cpp:32-53)."""
    n = M.shape[-1]
    s, U = torch.linalg.eigh(M)                  # ascending eigenvalues
    null_dim = n - rank
    keep = torch.arange(n, device=M.device) >= null_dim
    inv_s = torch.where(keep, 1.0 / torch.where(s.abs() > 0, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    M_pinv = torch.einsum("...ik,...k,...jk->...ij", U, inv_s, U)
    return M_pinv, U[..., :, :null_dim].transpose(-1, -2)


def pinv_psd(M, rel_threshold: float = 1.0e-6):
    """Pseudo-inverse of a symmetric PSD matrix: eigenvalues at most
    ``rel_threshold · max|eig|`` count as zero (Eigen COD threshold
    semantics, the reference's ``PinvCODWB(QW⁻¹Qᵀ)``)."""
    s, U = torch.linalg.eigh(M)
    cutoff = rel_threshold * s.abs().max(dim=-1, keepdim=True).values
    keep = s.abs() > cutoff
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return torch.einsum("...ik,...k,...jk->...ij", U, inv_s, U)


def pinv_svd(M, rel_threshold: float = 1.0e-6):
    """Pseudo-inverse V·Σ⁺·Uᵀ of a general matrix by SVD, singular values at
    most ``rel_threshold · max σ`` counted as zero.  (The JAX module's
    contracts Vᵀ in V's place; nothing there calls it.)"""
    U, s, Vh = torch.linalg.svd(M, full_matrices=False)
    keep = s > rel_threshold * s.max(dim=-1, keepdim=True).values
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return torch.einsum("...ij,...i,...ki->...jk", Vh, inv_s, U)


def null_space_basis(A, rank: int):
    """Orthonormal basis Z (n, n−rank) of ker(A) for A (m, n) of statically
    known rank, A·Z ≈ 0 (``getNullSpace``, src/math.cpp:349-360)."""
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    return Vh.transpose(-1, -2)[..., :, rank:]


def solve_psd(M, b):
    """Cholesky solve of M x = b for a symmetric positive definite M
    (b: (..., n, k))."""
    return torch.cholesky_solve(b, torch.linalg.cholesky(M))
