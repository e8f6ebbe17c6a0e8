"""The batched SPD inverse: CUDA kernel ``psd_inverse`` (``csrc/
psd_inverse.cu``) and its plain version (counterpart of
``libdwbc_tpu/ops/pallas_linalg.py``).

``psd_inverse(A)`` follows the wrappers' rule: a CPU tensor goes to the
plain version; a CUDA tensor goes to the kernel, or the call raises (dtype
other than float32, n outside [16, 64], a wrong shape or layout, a failed
build, a refused launch).  Nothing falls back.  ``use_kernel`` is the
routing rule of the callers (``kin/engine.py``, ``wbc/dynamics.py``): a
CUDA float32 matrix with 16 ≤ n ≤ 64 under ``backend="cuda"``, at any batch
size.  Each launch adds one to ``launches["psd_inverse"]``.
"""

from __future__ import annotations

import torch

from . import _build

MIN_N, MAX_N = 16, 64
launches = {"psd_inverse": 0}

# Max relative error (max abs error / max |A⁻¹|) of the kernel against the
# plain version in float64 on the serving inputs of chip_smoke.py (batch
# 1024), by n: about ten times the plain float32 version's own error there
# (6.6e-7 for A at n = 39, 7.7e-6 for W + V2ᵀV2 at n = 33; the kernel showed
# 6.3e-7 and 6.8e-6 on an H100).  ReducedTick's: A_R at n = 24 and the
# reduced W + V2ᵀV2 at n = 18 on the flagship (plain float32 8.4e-7 and
# 8.9e-7; the kernel 7.5e-7 and 8.9e-7), A_R at n = 18 on config 3.  The
# kernel's rsqrt pivot and the plain version's sqrt-then-reciprocal differ
# by float32 rounding only.
PSD_INV_RTOL = {39: 7e-6, 33: 8e-5, 24: 9e-6, 18: 9e-6}


def psd_inverse_flops(n: int) -> int:
    """Floating-point operations of one n×n inverse as the kernel does it
    (an FMA counts 2; a multiply, rsqrt or reciprocal 1): Cholesky, L⁻¹,
    then the lower triangle of L⁻ᵀL⁻¹ — about n³ in all."""
    tri = sum((n - j - 1) * (n - j) // 2 for j in range(n))    # FMAs of chol, and of L⁻¹
    ltl = sum((j + 1) * (n - j) for j in range(n))              # FMAs of L⁻ᵀL⁻¹
    other = sum(n - j + 1 for j in range(n)) + n * (n - 1) // 2  # scalings, rsqrt
    return 2 * (2 * tri + ltl) + other


def use_kernel(M, backend) -> bool:
    """Whether a PSD inverse of M runs the CUDA kernel."""
    return (backend == "cuda" and M.is_cuda and M.dtype == torch.float32
            and MIN_N <= M.shape[-1] <= MAX_N)


def chol_inv_diag(K):
    """Lower Cholesky factor of K and its reciprocal diagonal, column by
    column as the Pallas kernels do: pivot sqrt(max(S_jj, 1e-30)), then the
    column times 1/pivot.  Only the lower triangle of K is read."""
    n = K.shape[-1]
    S = K.clone()
    L = torch.zeros_like(K)
    inv_diag = torch.empty(K.shape[:-1], dtype=K.dtype, device=K.device)
    for j in range(n):
        dj = torch.sqrt(torch.clamp_min(S[..., j, j], 1e-30))
        inv_d = 1.0 / dj
        inv_diag[..., j] = inv_d
        L[..., j, j] = dj
        col = S[..., j + 1:, j] * inv_d[..., None]
        L[..., j + 1:, j] = col
        S[..., j + 1:, j + 1:] -= col[..., :, None] * col[..., None, :]
    return L, inv_diag


def psd_inverse_plain(A):
    """The Pallas kernel's recurrence, vectorised over the batch: Cholesky
    (``chol_inv_diag``), L⁻¹ by forward substitution with reciprocal
    diagonal multiplies, L⁻ᵀL⁻¹ with the lower triangle mirrored so the
    result is exactly symmetric."""
    n = A.shape[-1]
    L, inv_diag = chol_inv_diag(A)
    X = torch.zeros_like(A)                      # L⁻¹, row by row
    for i in range(n):
        X[..., i, :i] = -(L[..., i, None, :i] @ X[..., :i, :i])[..., 0, :] \
            * inv_diag[..., i, None]
        X[..., i, i] = inv_diag[..., i]
    low = torch.tril(X.transpose(-1, -2) @ X)
    return low + torch.tril(low, -1).transpose(-1, -2)


def psd_inverse(A):
    """A⁻¹ for a batch of SPD matrices A (..., n, n); the lower triangle is
    read.  CPU → plain version; CUDA → the kernel or raise."""
    if A.device.type == "cpu":
        return psd_inverse_plain(A)
    if A.dtype != torch.float32:
        raise TypeError(f"psd_inverse kernel takes float32, got {A.dtype}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"psd_inverse kernel takes (..., n, n), got {tuple(A.shape)}")
    n = A.shape[-1]
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"psd_inverse kernel takes {MIN_N} <= n <= {MAX_N}, got {n}")
    if not A.is_contiguous():
        raise ValueError("psd_inverse kernel takes a contiguous A")
    B = A.numel() // (n * n)
    lib = _build.library()
    out = torch.empty_like(A)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.dwbc_psd_inverse(A.data_ptr(), out.data_ptr(), B, n, stream)
    if rc != 0:
        raise RuntimeError(f"psd_inverse launch failed: CUDA error {rc}")
    launches["psd_inverse"] += 1
    return out
