"""Batched fixed-iteration QP solver in torch (counterpart of
``libdwbc_tpu/ops/qp.py``): a Mehrotra predictor-corrector interior-point
method with a static iteration count, then an active-set polish with an
objective gate.

Problem form (qpOASES convention, two-sided linear constraints):

    min ½ xᵀHx + gᵀx   s.t.  lb ≤ A x ≤ ub,  (optional) Aeq x = beq

Infinite bounds are handled by row masking; H may be positive
semidefinite.  All arguments broadcast on leading batch dims.

Routing: with ``backend="cuda"``, a CUDA float32 problem that is one-sided
(``lb`` None), has no equality rows and a shape that
``qp_cuda.kernel_takes`` accepts (n ≤ 24, m ≤ 512, as the JAX router) goes
to the ``qp_solve`` kernel (``ops/qp_cuda.py``), with that kernel's
semantics; gap and primal residual are computed here from the unmirrored
C, as the JAX module does.  Everything else takes the loop below.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import qp_cuda
from . import smallmat as sm

_BIG = 1.0e20
# Above this size the loop factorizations give way to torch.linalg.
_UNROLL_LIMIT = 48


class QPSolution(NamedTuple):
    x: torch.Tensor          # (n,) primal solution
    lam: torch.Tensor        # (m,) multipliers of the one-sided rows
    gap: torch.Tensor        # () normalized complementarity gap
    primal_res: torch.Tensor  # () max primal violation
    polished: torch.Tensor   # () bool: polish step accepted


def _chol(K):
    if K.shape[-1] <= _UNROLL_LIMIT:
        return sm.chol(K)
    # a factorization that fails is NaN, as jnp.linalg.cholesky gives it:
    # the step guard skips such a step and the polish's finite check
    # rejects such a polish
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _cho_solve(L, b):
    if L.shape[-1] <= _UNROLL_LIMIT:
        return sm.cho_solve(L, b)
    vec = b.ndim == L.ndim - 1
    out = torch.cholesky_solve(b[..., None] if vec else b, L)
    return out[..., 0] if vec else out


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _comp_gap(slack, lam, m):
    """Normalized complementarity Σ|slack_i|·λ_i/(1+λ_i) / m: a divergent
    dual on an ε-infeasible row contributes ≈|slack|, healthy rows keep
    their slack·λ scale."""
    lam = torch.clamp_min(lam, 0.0)
    return (slack.abs() * (lam / (1.0 + lam))).sum(-1) / m


def _one_sided(A, lb, ub):
    """lb ≤ Ax ≤ ub → Cx ≤ d; rows with an infinite bound become 0·x ≤ 1."""
    ub_f = torch.isfinite(ub) & (ub.abs() < _BIG)
    lb_f = torch.isfinite(lb) & (lb.abs() < _BIG)
    C = torch.cat([A * ub_f[..., :, None], -A * lb_f[..., :, None]], dim=-2)
    one = torch.ones_like(ub)
    d = torch.cat([torch.where(ub_f, ub, one), torch.where(lb_f, -lb, one)], dim=-1)
    return C, d


def _use_kernel(H, A, lb, Aeq, backend, mirror=0):
    return (backend == "cuda" and lb is None and Aeq is None and A.is_cuda
            and H.dtype == torch.float32
            and qp_cuda.kernel_takes(H.shape[-1], A.shape[-2], mirror))


def _solve_kernel(H, g, A, ub, iters, ridge, warm, mirror):
    """The qp_solve kernel on the flattened batch; gap and primal residual
    from the unmirrored C (as ops/qp.py does around pallas_qp_solve)."""
    n, m = H.shape[-1], A.shape[-2]
    bshape = torch.broadcast_shapes(H.shape[:-2], g.shape[:-1], A.shape[:-2], ub.shape[:-1])
    ub_f = torch.isfinite(ub) & (ub.abs() < _BIG)
    C = A * ub_f[..., :, None]
    d = torch.where(ub_f, ub, torch.ones_like(ub))

    def flat(t, tail):
        return t.expand(bshape + tail).reshape((-1,) + tail).contiguous()

    x0 = lam0 = None
    if warm is not None:
        x0, lam0 = flat(warm[0], (n,)), flat(warm[1], (m,))
    x, _, lam = qp_cuda.qp_solve(flat(H, (n, n)), flat(g, (n,)), flat(C, (m, n)),
                                 flat(d, (m,)), x0, lam0, iters=iters,
                                 ridge=max(ridge, 1e-6), mirror=mirror)
    x = x.reshape(bshape + (n,))
    lam = lam.reshape(bshape + (m,))
    slack = d - _mv(C, x)
    pres = torch.clamp_min(-slack, 0.0).max(dim=-1).values
    gap = _comp_gap(slack, lam, m)
    return QPSolution(x=x, lam=lam, gap=gap, primal_res=pres,
                      polished=torch.zeros_like(pres, dtype=torch.bool))


def solve_qp(H, g, A, lb, ub, Aeq=None, beq=None, iters: int = 30,
             ridge: float = 1.0e-9, backend: str = "torch", warm=None,
             mirror: int = 0) -> QPSolution:
    """Solve one (or a batch of) dense QPs.

    iters: static IPM iteration count.  warm: optional (x, λ) of a previous
    solve.  mirror: row count k with A[k:2k] == −A[:k] and finite ub on both
    (the ± torque-limit pairs); only the kernel uses it, the caller
    guarantees the structure.  backend: "torch" (this loop) or "cuda"
    (route eligible problems to the qp_solve kernel)."""
    if _use_kernel(H, A, lb, Aeq, backend, mirror):
        return _solve_kernel(H, g, A, ub, iters, ridge, warm, mirror)
    n = H.shape[-1]
    dtype, dev = H.dtype, H.device
    f32 = dtype == torch.float32
    ridge = max(ridge, 1e-6) if f32 else ridge
    if lb is None:
        ub_f = torch.isfinite(ub) & (ub.abs() < _BIG)
        C = A * ub_f[..., :, None]
        d = torch.where(ub_f, ub, torch.ones_like(ub))
    else:
        C, d = _one_sided(A, lb, ub)
    m = C.shape[-2]
    p = Aeq.shape[-2] if Aeq is not None else 0

    eye_n = torch.eye(n, dtype=dtype, device=dev)
    Hr = H + ridge * eye_n
    s_floor = 1e-10 if f32 else 1e-14
    w_cap = 1e8 if f32 else 1e12
    mu_tol = 5e-8 if f32 else 1e-13

    xshape = torch.broadcast_shapes(H.shape[:-2], A.shape[:-2]) + (n,)
    if warm is not None:
        x0 = warm[0] * torch.ones(xshape, dtype=dtype, device=dev)
        s_floor_w = 1e-4 if f32 else 1e-6
        s0 = torch.clamp_min(d - _mv(C, x0), s_floor_w)
        lam0 = torch.clamp(warm[1], s_floor_w, w_cap)
    else:
        x0 = torch.zeros(xshape, dtype=dtype, device=dev)
        s0 = torch.clamp_min(d - _mv(C, x0), 1.0)
        lam0 = torch.ones_like(s0)
    bshape = torch.broadcast_shapes(x0.shape[:-1], s0.shape[:-1], lam0.shape[:-1])
    x0 = x0.expand(bshape + (n,))
    s0 = s0.expand(bshape + (m,))
    lam0 = lam0.expand(bshape + (m,))
    nu0 = torch.zeros(bshape + (p,), dtype=dtype, device=dev)

    def factor_step(x, s, lam, nu):
        """Residuals, scaling w, the reduced-KKT Cholesky and, with
        equalities, the Schur complement factor: once per iteration."""
        s_safe = torch.clamp_min(s, s_floor)
        r_d = _mv(Hr, x) + g + _mtv(C, lam)
        if Aeq is not None:
            r_d = r_d + _mtv(Aeq, nu)
        r_p = _mv(C, x) + s - d
        w = torch.clamp(lam / s_safe, 0.0, w_cap)
        K = Hr + C.transpose(-1, -2) @ (w[..., :, None] * C)
        L = _chol(K)
        if Aeq is not None:
            r_e = _mv(Aeq, x) - beq
            Kinv_At = _cho_solve(L, Aeq.transpose(-1, -2).expand(K.shape[:-2] + (n, p)))
            S = Aeq @ Kinv_At + ridge * torch.eye(p, dtype=dtype, device=dev)
            L_S = _chol(0.5 * (S + S.transpose(-1, -2)))
        else:
            r_e = Kinv_At = L_S = None
        return s_safe, r_d, r_p, w, L, r_e, Kinv_At, L_S

    def newton_step(fac, s, lam, nu, sigma_mu):
        s_safe, r_d, r_p, w, L, r_e, Kinv_At, L_S = fac
        r_c = s * lam - sigma_mu
        rhs = -r_d - _mtv(C, w * r_p - r_c / s_safe)
        if Aeq is not None:
            Kinv_rhs = _cho_solve(L, rhs)
            dnu = _cho_solve(L_S, _mv(Aeq, Kinv_rhs) + r_e)
            dx = Kinv_rhs - _mv(Kinv_At, dnu)
        else:
            dx = _cho_solve(L, rhs)
            dnu = nu
        ds = -(r_p + _mv(C, dx))
        dlam = -(r_c + lam * ds) / s_safe
        return dx, ds, dlam, dnu

    def alpha_max(v, dv, tau=0.995):
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                            torch.full_like(v, _BIG))
        return torch.clamp_max(tau * ratio.min(dim=-1).values, 1.0)

    def finite_all(t):
        return (t * 0.0).sum(-1) == 0.0

    x, s, lam, nu = x0, s0, lam0, nu0
    for _ in range(iters):
        mu = (s * lam).sum(-1) / m
        # freeze converged lanes: a zero step once μ is tiny
        live = (mu > mu_tol).to(dtype)
        fac = factor_step(x, s, lam, nu)
        dx_a, ds_a, dlam_a, _ = newton_step(fac, s, lam, nu, torch.zeros_like(s))
        a_p = alpha_max(s, ds_a)
        a_d = alpha_max(lam, dlam_a)
        mu_aff = ((s + a_p[..., None] * ds_a) * (lam + a_d[..., None] * dlam_a)).sum(-1) / m
        sigma = (mu_aff / torch.clamp_min(mu, 1e-300)) ** 3
        target = (sigma * mu)[..., None] - ds_a * dlam_a
        dx, ds, dlam, dnu = newton_step(fac, s, lam, nu, target)
        # non-finite guard, stricter than the kernel's: skip a step that is
        # not finite or would overflow the next iterate
        step_mag = torch.nan_to_num(dx, nan=float("inf")).abs().max(dim=-1).values
        x_mag = x.abs().max(dim=-1).values
        ok = ((step_mag < 1.0e15 * (1.0 + x_mag)) & finite_all(ds) & finite_all(dlam)
              & finite_all(dnu))
        okc = ok[..., None]
        dx = torch.where(okc, torch.nan_to_num(dx), 0.0)
        ds = torch.where(okc, torch.nan_to_num(ds), 0.0)
        dlam = torch.where(okc, torch.nan_to_num(dlam), 0.0)
        dnu = torch.where(okc, torch.nan_to_num(dnu), 0.0)
        live = live * ok.to(dtype)
        if warm is not None:
            # split primal/dual steps on warm solves only
            a_pc = (live * alpha_max(s, ds))[..., None]
            a_dc = (live * alpha_max(lam, dlam))[..., None]
        else:
            a_pc = (live * torch.minimum(alpha_max(s, ds), alpha_max(lam, dlam)))[..., None]
            a_dc = a_pc
        x, s = x + a_pc * dx, s + a_pc * ds
        lam, nu = torch.clamp_max(lam + a_dc * dlam, w_cap), nu + a_dc * dnu

    # ------------------------------------------------------------- polish
    # active set from the central path (λ > s); the saddle KKT reduces to
    # the n×n penalty system (H + CᵀDC/ρ [+ AeqᵀAeq/ρ]) x = −g + CᵀDd/ρ [...]
    act = (lam > s).to(dtype)
    pen = 1.0e4 if f32 else 1.0 / ridge
    K_p = Hr + pen * C.transpose(-1, -2) @ (act[..., :, None] * C)
    rhs_p = -g + pen * _mtv(C, act * d)
    if Aeq is not None:
        K_p = K_p + pen * Aeq.transpose(-1, -2) @ Aeq
        rhs_p = rhs_p + pen * _mtv(Aeq, beq)
    rhs_p = rhs_p * torch.ones_like(x)
    x_p = _cho_solve(_chol(0.5 * (K_p + K_p.transpose(-1, -2))), rhs_p)
    lam_p = pen * act * (_mv(C, x_p) - d)

    def metrics(xv, lv):
        slack = d - _mv(C, xv)
        pres = torch.clamp_min(-slack, 0.0).max(dim=-1).values
        if Aeq is not None:
            pres = torch.maximum(pres, (_mv(Aeq, xv) - beq).abs().max(dim=-1).values)
        return pres, _comp_gap(slack, lv, m)

    pres_i, gap_i = metrics(x, lam)
    pres_p, gap_p = metrics(x_p, torch.clamp_min(lam_p, 0.0))

    def objective(xv):
        return 0.5 * (xv * _mv(Hr, xv)).sum(-1) + (g * xv).sum(-1)

    obj_i, obj_p = objective(x), objective(x_p)
    ok = (torch.isfinite(x_p).all(dim=-1)
          & (pres_p + gap_p <= pres_i + gap_i + 1e-9)
          & (lam_p.min(dim=-1).values >= -1e-7)
          # a feasible vertex with sign-correct multipliers can still be the
          # wrong vertex: accept polish only when it loses no objective
          & (obj_p <= obj_i + 1e-9 * (1.0 + obj_i.abs())))
    if f32:
        # penalty-polish multipliers are too noisy at float32
        ok = torch.zeros_like(ok)
    x_fin = torch.where(ok[..., None], x_p, x)
    lam_fin = torch.where(ok[..., None], torch.clamp_min(lam_p, 0.0), lam)
    pres = torch.where(ok, pres_p, pres_i)
    gap = torch.where(ok, gap_p, gap_i)
    return QPSolution(x=x_fin, lam=lam_fin, gap=gap, primal_res=pres, polished=ok)
