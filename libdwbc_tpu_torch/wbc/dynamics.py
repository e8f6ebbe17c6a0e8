"""Operational-space WBC functions in torch, batch-major (counterpart of
``libdwbc_tpu/wbc/dynamics.py``): contact-consistent dynamics, gravity
compensation, the task-to-torque map J_kt, task null-space chaining, the
contact force observation, the per-contact-type jacobian rows,
constraint blocks and rotation blocks, and the closed-form two-contact
redistribution (``contact_redistribute_two``, ``yaw_rotation``).

``backend="cuda"`` routes the SPD inverses of CUDA float32 matrices with
16 ≤ n ≤ 64 (the flagship's W + V2ᵀV2 at n = 33) to the ``psd_inverse``
kernel (``ops/linalg_cuda.py``); everything else is torch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import linalg_cuda
from ..ops import smallmat as sm
from ..ops.linalg import pinv_psd
from . import types as _T

# Above this size the loop factorizations give way to torch.linalg (the
# same threshold as ops/qp.py).
_UNROLL_LIMIT = 48


class ContactSpace(NamedTuple):
    """Outputs of the contact-space factorization (``CalculateContactConstraint``,
    src/wbd.cpp:108-143): Λ_c, J̄_cᵀ, N_C, A⁻¹N_C, W, W⁻¹, V2, NwJw."""

    Lambda_c: torch.Tensor   # (c,c)
    J_C_INV_T: torch.Tensor  # (c,n)
    N_C: torch.Tensor        # (n,n)
    A_inv_N_C: torch.Tensor  # (n,n)
    W: torch.Tensor          # (n-6,n-6)
    W_inv: torch.Tensor      # (n-6,n-6)
    V2: torch.Tensor         # (c-6,n-6) orthonormal null rows of W
    NwJw: torch.Tensor       # (n-6,c-6) contact-force redistribution directions
    rank_health: torch.Tensor  # () numeric rank indicator, ~[0,1]; tiny = degenerate


def _chol_health(M):
    """min(diag L) / max(diag L) of the Cholesky factor of a PSD Gram,
    ≈ sqrt(λ_min/λ_max); NaN-free on singular input (pivots clamped)."""
    if M.shape[-1] <= _UNROLL_LIMIT:
        L = sm.chol(M)
    else:
        n = M.shape[-1]
        eye = torch.eye(n, dtype=M.dtype, device=M.device)
        L = torch.nan_to_num(torch.linalg.cholesky_ex(M + 1e-30 * eye).L)
    d = torch.diagonal(L, dim1=-2, dim2=-1).abs()
    return d.min(dim=-1).values / torch.clamp_min(d.max(dim=-1).values, 1e-30)


def _psd_inv(M, backend="torch"):
    """Inverse of a symmetric positive definite matrix via Cholesky."""
    if linalg_cuda.use_kernel(M, backend):
        return linalg_cuda.psd_inverse(M.contiguous())
    if M.shape[-1] <= _UNROLL_LIMIT:
        return sm.psd_inverse(M)
    L = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


def _psd_inv_reg(M, backend="torch"):
    """κ-bounded SPD inverse for the task-space operators (Λ_t, QW⁻¹Qᵀ): at
    float32 a relative Tikhonov ridge of 1e-4·max|diag| first (the JAX
    module's guard against near-singular tasks, which float32 cannot
    survive); float64 stays exact."""
    if M.dtype == torch.float32:
        dmax = torch.diagonal(M, dim1=-2, dim2=-1).abs().max(dim=-1).values
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        M = M + (1e-4 * dmax)[..., None, None] * eye
    return _psd_inv(M, backend)


def contact_space(J_C, A_inv, backend="torch") -> ContactSpace:
    """Contact-consistent dynamics factorization.  J_C (...,c,n) stacked
    contact jacobians, A_inv (...,n,n).  The null space of W comes from two
    small QR factorizations and W⁺ = (W + V2ᵀV2)⁻¹ − V2ᵀV2 from one
    Cholesky (exact because V2 is an orthonormal kernel basis)."""
    c, n = J_C.shape[-2], J_C.shape[-1]
    JCT = J_C.transpose(-1, -2)
    JAinv = J_C @ A_inv
    Mc = JAinv @ JCT
    Mc = 0.5 * (Mc + Mc.transpose(-1, -2))
    # rank health: a singular contact Gram, or a rank-deficient base block
    Jb = J_C[..., :, 0:6]
    health = torch.minimum(_chol_health(Mc), _chol_health(Jb.transpose(-1, -2) @ Jb))
    Lambda_c = _psd_inv(Mc, backend)
    J_C_INV_T = Lambda_c @ JAinv
    N_C = torch.eye(n, dtype=J_C.dtype, device=J_C.device) - JCT @ J_C_INV_T
    A_inv_N_C = A_inv @ N_C
    W = A_inv_N_C[..., 6:, 6:]
    W = 0.5 * (W + W.transpose(-1, -2))

    if c > 6:
        Ny = sm.complete_basis(Jb)[..., :, 6:]                       # (...,c,c-6)
        V2T = sm.qr_thin(J_C[..., :, 6:].transpose(-1, -2) @ Ny)      # (...,n-6,c-6)
        VV = V2T @ V2T.transpose(-1, -2)
        W_inv = _psd_inv(W + VV, backend) - VV
        V2 = V2T.transpose(-1, -2)
        # NwJw = V2ᵀ (J̄_cᵀ[0:c-6, 6:] V2ᵀ)⁻¹   (src/wbd.cpp:128)
        NwJw = V2T @ sm.qr_pinv(J_C_INV_T[..., 0 : c - 6, 6:] @ V2T)
    else:
        W_inv = _psd_inv(W, backend)
        V2 = W.new_zeros(W.shape[:-2] + (0, n - 6))
        NwJw = W.new_zeros(W.shape[:-2] + (n - 6, 0))
    return ContactSpace(Lambda_c, J_C_INV_T, N_C, A_inv_N_C, W, W_inv, V2, NwJw, health)


def gravity_compensation(A_inv, W_inv, N_C, J_C_INV_T, G):
    """τ_grav = W⁻¹ · (A⁻¹ bottom rows · N_C G);  P_C = J̄_cᵀ G
    (``CalculateGravityCompensation``, src/wbd.cpp:186-192)."""
    m = W_inv.shape[-1]
    NCG = (N_C @ G[..., None])[..., 0]
    torque_grav = (W_inv @ (A_inv[..., -m:, :] @ NCG[..., None]))[..., 0]
    P_C = (J_C_INV_T @ G[..., None])[..., 0]
    return torque_grav, P_C


class TaskSpaceFactors(NamedTuple):
    Lambda_task: torch.Tensor  # (t,t)
    J_kt: torch.Tensor         # (n-6,t)
    Q: torch.Tensor            # (t,n-6)


def task_jkt(J_task, A_inv, N_C, W_inv, exact_pinv: bool = False,
             backend="torch") -> TaskSpaceFactors:
    """Λ_t = (J A⁻¹N_C Jᵀ)⁻¹; Q = (Λ_t J A⁻¹N_C) right cols;
    J_ktᵀ = W⁻¹Qᵀ(QW⁻¹Qᵀ)⁺ (``CalculateJKT``, src/wbd.cpp:207-213).
    exact_pinv takes the thresholded eigendecomposition for QW⁻¹Qᵀ."""
    JAN = J_task @ A_inv @ N_C
    M = JAN @ J_task.transpose(-1, -2)
    Lambda_task = _psd_inv_reg(0.5 * (M + M.transpose(-1, -2)), backend)
    Q = (Lambda_task @ JAN)[..., :, 6:]
    QT = Q.transpose(-1, -2)
    QWQ = Q @ W_inv @ QT
    QWQ = 0.5 * (QWQ + QWQ.transpose(-1, -2))
    inv_mid = pinv_psd(QWQ) if exact_pinv else _psd_inv_reg(QWQ, backend)
    J_kt = W_inv @ QT @ inv_mid
    return TaskSpaceFactors(Lambda_task, J_kt, Q)


def task_null_space(J_kt, Lambda_task, J_task, A_inv_N_C, prev_null):
    """prev_null (I − J_kt Λ_t J_t A⁻¹N_C right cols)
    (``CalculateTaskNullSpace``, src/wbd.cpp:257-261)."""
    m = J_task.shape[-1] - 6
    eye = torch.eye(m, dtype=J_task.dtype, device=J_task.device)
    term = J_kt @ Lambda_task @ J_task @ A_inv_N_C[..., :, -m:]
    return prev_null @ (eye - term)


def contact_force_from_torque(command_torque, J_C_INV_T, P_C):
    """f_c = J̄_cᵀ actuated cols · τ − P_C (``CalculateContactForce``)."""
    m = command_torque.shape[-1]
    return (J_C_INV_T[..., :, -m:] @ command_torque[..., None])[..., 0] - P_C


# ---------------------------------------------------------------------------
# Contact constraint blocks (src/wbd.cpp:59-97) and per-type rows
# ---------------------------------------------------------------------------

def zmp_const_matrix(lx, ly, dtype=torch.float64, device="cpu"):
    """4×6 CoP box block for one 6D contact with half-sizes lx, ly."""
    Z = np.zeros((4, 6))
    Z[0, 2], Z[0, 4] = -lx, -1.0
    Z[1, 2], Z[1, 4] = -lx, 1.0
    Z[2, 2], Z[2, 3] = -ly, -1.0
    Z[3, 2], Z[3, 3] = -ly, 1.0
    return torch.as_tensor(Z, dtype=dtype, device=device)


def force_const_matrix(mu, mu_z, dtype=torch.float64, device="cpu"):
    """6×6 friction-cone block: |fx|,|fy| ≤ µ fz, |Mz| ≤ µ_z fz."""
    F = np.zeros((6, 6))
    F[0, 0], F[0, 2] = 1.0, -mu
    F[1, 0], F[1, 2] = -1.0, -mu
    F[2, 1], F[2, 2] = 1.0, -mu
    F[3, 1], F[3, 2] = -1.0, -mu
    F[4, 5], F[4, 2] = 1.0, -mu_z
    F[5, 5], F[5, 2] = -1.0, -mu_z
    return torch.as_tensor(F, dtype=dtype, device=device)


def contact_jacobian_rows(J6, R, contact_type):
    """Per-type contact jacobian rows from the pos-first point jacobian J6
    (…,6,n) and the contact body rotation R (…,3,3)."""
    if contact_type == _T.CONTACT_6D:
        return J6
    if contact_type == _T.CONTACT_POINT:
        return J6[..., 0:3, :]
    if contact_type == _T.CONTACT_LINE:
        Jrot_local = R.transpose(-1, -2) @ J6[..., 3:6, :]
        return torch.cat([J6[..., 0:3, :], Jrot_local[..., 1:3, :]], dim=-2)
    raise ValueError(f"unknown contact type {contact_type}")


def contact_constraint_block(contact_type, lx, ly, mu, mu_z, dtype=torch.float64,
                             device="cpu"):
    """(k, d) inequality block on the contact-local wrench:
    6D → (10,6); POINT → (6,3); LINE → (8,5) over [fx fy fz my mz]."""
    Z = zmp_const_matrix(lx, ly, dtype, device)
    F = force_const_matrix(mu, mu_z, dtype, device)
    if contact_type == _T.CONTACT_6D:
        return torch.cat([Z, F], dim=0)
    if contact_type == _T.CONTACT_POINT:
        return F[:, 0:3]
    if contact_type == _T.CONTACT_LINE:
        cols = [0, 1, 2, 4, 5]
        return torch.cat([Z[0:2][:, cols], F[:, cols]], dim=0)
    raise ValueError(f"unknown contact type {contact_type}")


def contact_rotation_block(contact_type, R):
    """(…, d, d) world→contact-local rotation for the per-type wrench:
    6D → Rᵀ⊕Rᵀ; POINT → Rᵀ; LINE → Rᵀ⊕I₂."""
    RT = R.transpose(-1, -2)
    if contact_type == _T.CONTACT_6D:
        out = R.new_zeros(R.shape[:-2] + (6, 6))
        out[..., 0:3, 0:3] = RT
        out[..., 3:6, 3:6] = RT
        return out
    if contact_type == _T.CONTACT_POINT:
        return RT
    if contact_type == _T.CONTACT_LINE:
        out = R.new_zeros(R.shape[:-2] + (5, 5))
        out[..., 0:3, 0:3] = RT
        out[..., 3, 3] = 1.0
        out[..., 4, 4] = 1.0
        return out
    raise ValueError(f"unknown contact type {contact_type}")


# ---------------------------------------------------------------------------
# Closed-form two-contact force redistribution (src/wbd.cpp:273-404)
# ---------------------------------------------------------------------------

def _eta_interval_update(A, B, C, eta_lb, eta_ub):
    """Intersect the eta interval with the roots of (A²−C²)η² + 2ABη + B² ≤ 0."""
    a = A * A
    b = 2.0 * A * B
    c = B * B - C * C
    disc = torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, 0.0))
    valid = a.abs() > 1e-30
    safe_a = torch.where(valid, a, torch.ones_like(a))
    sol1 = (-b + disc) / (2.0 * safe_a)
    sol2 = (-b - disc) / (2.0 * safe_a)
    eta_ub = torch.where(valid, torch.minimum(eta_ub, torch.maximum(sol1, sol2)), eta_ub)
    eta_lb = torch.where(valid, torch.maximum(eta_lb, torch.minimum(sol1, sol2)), eta_lb)
    return eta_lb, eta_ub


def contact_redistribute_two(eta_cust, footlength, footwidth, mu_static, ratio_x, ratio_y,
                             P1, P2, F12):
    """Closed-form two-foot redistribution (``ContactRedistributetwomod``).

    F12: (...,12) stacked [f1(3) m1(3) f2(3) m2(3)] in a yaw-aligned frame;
    P1, P2: (...,3) foot positions relative to the COM (same frame).
    Returns (resultant wrench (6), redistributed F12 (12), eta)."""
    f1, m1 = F12[..., 0:3], F12[..., 3:6]
    f2, m2 = F12[..., 6:9], F12[..., 9:12]
    cross = torch.linalg.cross
    Fr = f1 + f2
    Mr = m1 + m2 + cross(P1, f1, dim=-1) + cross(P2, f2, dim=-1)
    R = torch.cat([Fr, Mr], dim=-1)

    ones = torch.ones_like(R[..., 0])
    eta_lb = (1.0 - eta_cust) * ones
    eta_ub = eta_cust * ones

    dP = P1 - P2
    # Mx bound
    A = dP[..., 2] * R[..., 1] - dP[..., 1] * R[..., 2]
    B = R[..., 3] + P2[..., 2] * R[..., 1] - P2[..., 1] * R[..., 2]
    C = ratio_y * footwidth / 2.0 * R[..., 2].abs()
    eta_lb, eta_ub = _eta_interval_update(A, B, C, eta_lb, eta_ub)
    # My bound
    A2 = -dP[..., 2] * R[..., 0] + dP[..., 0] * R[..., 2]
    B2 = R[..., 4] - P2[..., 2] * R[..., 0] + P2[..., 0] * R[..., 2]
    C2 = ratio_x * footlength / 2.0 * R[..., 2].abs()
    eta_lb, eta_ub = _eta_interval_update(A2, B2, C2, eta_lb, eta_ub)
    # Mz bound
    A3 = -dP[..., 0] * R[..., 1] + dP[..., 1] * R[..., 0]
    B3 = R[..., 5] + P2[..., 1] * R[..., 0] - P2[..., 0] * R[..., 1]
    C3 = mu_static * R[..., 2].abs()
    eta_lb, eta_ub = _eta_interval_update(A3, B3, C3, eta_lb, eta_ub)

    eta_s = (-R[..., 3] - P2[..., 2] * R[..., 1] + P2[..., 1] * R[..., 2]) / A
    eta = torch.minimum(torch.maximum(eta_s, eta_lb), eta_ub)
    eta = torch.where((eta > eta_cust) | (eta < 1.0 - eta_cust), torch.full_like(eta, 0.5), eta)

    M_lin = torch.stack([A * eta * eta + B * eta, A2 * eta * eta + B2 * eta,
                         A3 * eta * eta + B3 * eta], dim=-1)
    out1 = torch.cat([eta[..., None] * R[..., 0:3], M_lin], dim=-1)
    one_m = (1.0 - eta)[..., None]
    M_b = torch.stack([A * eta + B, A2 * eta + B2, A3 * eta + B3], dim=-1)
    out2 = torch.cat([one_m * R[..., 0:3], one_m * M_b], dim=-1)
    return R, torch.cat([out1, out2], dim=-1), eta


def yaw_rotation(yaw):
    """Rz(yaw) (rotateWithZ, src/math.cpp:55-72)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero], dim=-1),
                        torch.stack([s, c, zero], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)
