"""The batched one-sided QP solver: CUDA kernel ``qp_solve`` (``csrc/
qp_solve.cu``) and its plain version (counterpart of
``libdwbc_tpu/ops/pallas_qp.py``).

Both solve B problems  min ½xᵀHx + gᵀx  s.t.  Cx ≤ d  by a fixed number of
Mehrotra predictor-corrector iterations, with ``pallas_qp_solve``'s
semantics: warm floors 1e-4 whatever the dtype, the ridge added in the H
mat-vec and on the Gram diagonal, a step skipped when dx is not finite,
constants by dtype, and ``mirror`` rows folded (C[mirror:2·mirror] ==
−C[:mirror], the ± torque-limit pairs; the caller guarantees it).  In
float32 they depart from it where the Gram's Cholesky loses a pivot, as
the fused tick's IPM does (``csrc/ipm.cuh``, ``TickProgram._ipm``): the
pivot's variable is held for the step, or a lane already within
``LOST_PIVOT_NEAR`` in μ and max |r_p| skips it.  On the masked sweep,
``pallas_qp_solve``'s float32 step from the clamped factor put warm
single-support lanes of MaskedTick up to 0.036 Nm (the kernel, H100) and
0.47 Nm (this plain version, CPU) from a float64 solve of the same QP.
Float64 is the Pallas recurrence unchanged.

``qp_solve`` follows the wrappers' rule: CPU tensors go to the plain
version; CUDA tensors go to the kernel, or the call raises (dtype other
than float32, a wrong shape or layout, a shape that ``kernel_takes``
refuses, a failed build, a refused launch).  Nothing falls back.  Each
launch adds one to ``launches["qp_solve"]``.  ``kernel_takes`` is the one
rule of which shapes the kernel takes; ``ops/qp.py`` routes by it.
"""

from __future__ import annotations

import torch

from . import _build
from .linalg_cuda import chol_inv_diag
from .tick_kernel import LOST_PIVOT_NEAR

launches = {"qp_solve": 0}

# Max abs error of the kernel against the plain float32 version on the
# CPU, same inputs (the tick's three QPs on the serving inputs of
# chip_smoke.py, batch 1024, cold at 12 and warm at 7 iterations), λ
# relative to 1 + |λ| entry by entry: about ten times what an H100 showed
# (x 2.1e-9, λ 1.8e-15, gap 1.3e-13).  The primal residual was 0 on both
# sides; its limit is float32 roundoff of a unit-scale row.
QP_SOLVE_TOL = {"x": 2e-8, "lam": 2e-14, "gap": 2e-12, "pres": 1e-7}

# pallas_qp_solve's routing limits (libdwbc_tpu/ops/qp.py:76)
MAX_N, MAX_M = 24, 512
# shared bytes a block may opt into on the H100 (csrc/qp_solve.cu::kSmemOptin)
SMEM_OPTIN_BYTES = 232448


def smem_elems(n: int, m: int, mirror: int) -> int:
    """Shared floats of one problem's working set, as ``csrc/qp_solve.cu::
    qp_solve_smem_elems``: H and the Cholesky factor (n² each), g, the
    stored rows [B; D] of C padded to an odd length, d and nine more
    m-vectors, five n-vectors, x and λ."""
    return 2 * n * n + n + (m - mirror) * (n | 1) + 11 * m + 6 * n


def kernel_takes(n: int, m: int, mirror: int) -> bool:
    """Whether the kernel takes a problem of n variables, m rows and
    ``mirror`` mirrored row pairs: n ≤ 24 and m ≤ 512 (the JAX router's
    limits), 0 ≤ 2·mirror ≤ m, and one problem's working set fits a block's
    shared memory."""
    return (1 <= n <= MAX_N and 1 <= m <= MAX_M and 0 <= 2 * mirror <= m
            and 4 * smem_elems(n, m, mirror) <= SMEM_OPTIN_BYTES)


def qp_solve_flops(n: int, m: int, mr: int, iters: int) -> int:
    """Floating-point operations of one problem (an FMA counts 2; a
    compare, divide or square root 1), the analytic count of
    ``benchmarks/sol_qp.py::kernel_flops`` for the same recurrence."""
    me = m - mr
    fma = n * (n + 1) + 2 * me * n + me * n * (n + 1) // 2 + n ** 3 // 6
    other = (2 * mr + 2 * n + 2 * m + 4 * m + me * n + mr + n
             + n * (n - 1) // 2 + 2 * n)
    for _ in range(2):                          # predictor, corrector
        fma += 2 * me * n + n * (n - 1)
        other += 2 * m + 3 * m + mr + n + 2 * n + mr + 2 * m + 3 * m
    fma += 3 * m + n + 2 * m
    other += 16 * m + 4 * m + 2 * (n + 2 * m)
    return (2 * fma + other) * iters


def _consts(dtype):
    f32 = dtype == torch.float32
    return (1e-10 if f32 else 1e-14), (1e8 if f32 else 1e12), (5e-8 if f32 else 1e-13)


def _cho_solve(L, inv_diag, b):
    """L Lᵀ x = b for (B, n) b, reciprocal-diagonal multiplies."""
    n = b.shape[-1]
    y = torch.empty_like(b)
    for i in range(n):
        y[:, i] = (b[:, i] - (L[:, i, :i] * y[:, :i]).sum(-1)) * inv_diag[:, i]
    x = torch.empty_like(b)
    for i in reversed(range(n)):
        x[:, i] = (y[:, i] - (L[:, i + 1:, i] * x[:, i + 1:]).sum(-1)) * inv_diag[:, i]
    return x


def _chol_held(K):
    """``chol_inv_diag`` with the float32 rule for a lost pivot (one that
    fell to the 1e-30 clamp or below 1e-6 of its diagonal entry before
    elimination): its reciprocal is 0 and its column leaves the
    elimination, so a step holds that variable.  Also returns, per problem,
    whether a pivot was lost."""
    n = K.shape[-1]
    S = K.clone()
    L = torch.zeros_like(K)
    inv_diag = torch.empty(K.shape[:-1], dtype=K.dtype, device=K.device)
    diag0 = torch.diagonal(K, dim1=-2, dim2=-1)
    collapsed = torch.zeros(K.shape[:-2], dtype=torch.bool, device=K.device)
    for j in range(n):
        ljj = S[..., j, j]
        lost = ~(ljj >= 1e-30) | (ljj < 1e-6 * diag0[..., j])
        collapsed = collapsed | lost
        dj = torch.sqrt(torch.clamp_min(ljj, 1e-30))
        inv_d = torch.where(lost, torch.zeros_like(dj), 1.0 / dj)
        inv_diag[..., j] = inv_d
        L[..., j, j] = dj
        col = S[..., j + 1:, j] * inv_d[..., None]
        L[..., j + 1:, j] = col
        S[..., j + 1:, j + 1:] -= col[..., :, None] * col[..., None, :]
    return L, inv_diag, collapsed


def _alpha_max(v, dv):
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, 1e20))
    return torch.clamp_max(0.995 * ratio.min(dim=-1).values, 1.0)


def qp_solve_plain(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6, mirror=0):
    """``pallas_qp_solve``'s loop on batch-major tensors: H (B,n,n), g
    (B,n), C (B,m,n), d (B,m), optional x0 (B,n) and λ0 (B,m) → (x, s, λ)."""
    B, m, n = C.shape
    mr = mirror
    f32 = C.dtype == torch.float32
    s_floor, w_cap, mu_tol = _consts(C.dtype)
    H = H.expand(B, n, n)
    g = g.expand(B, n)
    d = d.expand(B, m)
    Cs = torch.cat([C[:, :mr], C[:, 2 * mr:]], 1) if mr else C   # stored [B; D]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)

    def fold(v, sign):
        if mr == 0:
            return v
        return torch.cat([v[:, :mr] + sign * v[:, mr:2 * mr], v[:, 2 * mr:]], 1)

    def matvec_C(x):
        acc = (Cs @ x[..., None])[..., 0]
        if mr == 0:
            return acc
        return torch.cat([acc[:, :mr], -acc[:, :mr], acc[:, mr:]], 1)

    def matvec_CT(v):
        return (Cs.transpose(1, 2) @ fold(v, -1.0)[..., None])[..., 0]

    def newton(fac, s, lam, sigma_mu):
        inv_s, r_d, r_p, w, L, inv_diag = fac
        r_c = s * lam - sigma_mu
        rhs = -r_d - matvec_CT(w * r_p - r_c * inv_s)
        dx = _cho_solve(L, inv_diag, rhs)
        ds = -(r_p + matvec_C(dx))
        dlam = -(r_c + lam * ds) * inv_s
        return dx, ds, dlam

    warm = x0 is not None
    if warm:
        x = x0.expand(B, n).clone()
        s = torch.clamp_min(d - matvec_C(x), 1e-4)
        lam = torch.clamp(lam0.expand(B, m), 1e-4, w_cap)
    else:
        x = torch.zeros_like(g)
        s = torch.clamp_min(d - matvec_C(x), 1.0)
        lam = torch.ones_like(s)
    for _ in range(iters):
        mu = (s * lam).sum(-1) / m
        live = (mu > mu_tol).to(C.dtype)[:, None]
        inv_s = 1.0 / torch.clamp_min(s, s_floor)
        r_d = (H @ x[..., None])[..., 0] + ridge * x + g + matvec_CT(lam)
        r_p = matvec_C(x) + s - d
        w = torch.clamp(lam * inv_s, 0.0, w_cap)
        K = H + Cs.transpose(1, 2) @ (fold(w, 1.0)[..., None] * Cs) + ridge * eye
        if f32:
            L, inv_diag, collapsed = _chol_held(K)
        else:
            L, inv_diag = chol_inv_diag(K)
        fac = (inv_s, r_d, r_p, w, L, inv_diag)
        dx_a, ds_a, dlam_a = newton(fac, s, lam, torch.zeros_like(s))
        a_p = _alpha_max(s, ds_a)[:, None]
        a_d = _alpha_max(lam, dlam_a)[:, None]
        mu_aff = ((s + a_p * ds_a) * (lam + a_d * dlam_a)).sum(-1) / m
        sigma = (mu_aff / torch.clamp_min(mu, 1e-30)) ** 3
        dx, ds, dlam = newton(fac, s, lam, (sigma * mu)[:, None] - ds_a * dlam_a)
        if warm:
            a_pc = live * _alpha_max(s, ds)[:, None]
            a_dc = live * _alpha_max(lam, dlam)[:, None]
        else:
            a_pc = live * torch.minimum(_alpha_max(s, ds), _alpha_max(lam, dlam))[:, None]
            a_dc = a_pc
        ok = torch.isfinite(dx).all(-1, keepdim=True)
        if f32:      # a lane within the bars does not step on a lost pivot
            near = (mu <= LOST_PIVOT_NEAR) & (r_p.abs().amax(-1) <= LOST_PIVOT_NEAR)
            ok = ok & ~(collapsed & near)[:, None]
        x = torch.where(ok, x + a_pc * dx, x)
        s = torch.where(ok, s + a_pc * ds, s)
        lam = torch.where(ok, torch.clamp_max(lam + a_dc * dlam, w_cap), lam)
    return x, s, lam


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"qp_solve kernel: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"qp_solve kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"qp_solve kernel: {name} must be contiguous")


def qp_solve(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6, mirror=0):
    """B one-sided QPs → (x (B,n), s (B,m), λ (B,m)).  CPU → plain version;
    CUDA → the kernel or raise."""
    if C.device.type == "cpu":
        return qp_solve_plain(H, g, C, d, x0, lam0, iters, ridge, mirror)
    if C.ndim != 3:
        raise ValueError(f"qp_solve kernel: C must be (B, m, n), got {tuple(C.shape)}")
    B, m, n = C.shape
    if not kernel_takes(n, m, mirror):
        raise ValueError(f"qp_solve kernel: does not take n {n}, m {m}, mirror {mirror}")
    if (x0 is None) != (lam0 is None):
        raise ValueError("qp_solve kernel: give both x0 and lam0, or neither")
    args = [("H", H, (B, n, n)), ("g", g, (B, n)), ("C", C, (B, m, n)), ("d", d, (B, m))]
    if x0 is not None:
        args += [("x0", x0, (B, n)), ("lam0", lam0, (B, m))]
    for name, t, shape in args:
        if t.device != C.device:
            raise ValueError(f"qp_solve kernel: {name} is on {t.device}, C on {C.device}")
        _check(name, t, shape)
    lib = _build.library()
    x = torch.empty((B, n), dtype=C.dtype, device=C.device)
    s = torch.empty((B, m), dtype=C.dtype, device=C.device)
    lam = torch.empty((B, m), dtype=C.dtype, device=C.device)
    stream = torch.cuda.current_stream(C.device).cuda_stream
    rc = lib.dwbc_qp_solve(
        H.data_ptr(), g.data_ptr(), C.data_ptr(), d.data_ptr(),
        None if x0 is None else x0.data_ptr(), None if lam0 is None else lam0.data_ptr(),
        x.data_ptr(), s.data_ptr(), lam.data_ptr(), B, n, m, mirror,
        int(iters), float(ridge), stream)
    if rc != 0:
        raise RuntimeError(f"qp_solve launch failed: CUDA error {rc}")
    launches["qp_solve"] += 1
    return x, s, lam
