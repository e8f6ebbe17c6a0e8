"""Dense linear algebra of the pipeline (counterpart of the part of
``libdwbc_tpu/ops/linalg.py`` the tick needs): the thresholded PSD
pseudo-inverse that ``task_jkt(exact_pinv=True)`` uses."""

from __future__ import annotations

import torch


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
