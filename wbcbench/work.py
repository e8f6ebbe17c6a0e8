"""The work of one served tick, counted from a configuration's shapes, and
the card's published peaks: the yardstick of the kernels' roofline share.

The operation counts are frozen copies of the port's own analytic counts
(``chip_smoke.py::tick_flops`` and ``masked_extra_flops``,
``ops/qp_cuda.py::qp_solve_flops``, ``ops/linalg_cuda.py::psd_inverse_flops``)
at the commit this benchmark was written against: a later change to the
kernels does not change what a tick's work is.  They take a plan of the
reference tick (``reference/tick.py::TickPlan``), so they count the same
work whichever kernels carry it.

The bytes of a solve are its inputs read once and its outputs written once
(float32): q, f*, the contact mask, the warm (x, λ) of every QP in and out,
the four torques, the contact force and the three per-lane diagnostics.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit:
# float32 outside the tensor cores, and the HBM3 bandwidth
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAKS_SOURCE = "NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 (no tensor cores), 3.35 TB/s"


def psd_inverse_flops(n: int) -> int:
    """Floating-point operations of one n×n SPD inverse (an FMA counts 2; a
    multiply, rsqrt or reciprocal 1): Cholesky, L⁻¹, then the lower
    triangle of L⁻ᵀL⁻¹."""
    tri = sum((n - j - 1) * (n - j) // 2 for j in range(n))
    ltl = sum((j + 1) * (n - j) for j in range(n))
    other = sum(n - j + 1 for j in range(n)) + n * (n - 1) // 2
    return 2 * (2 * tri + ltl) + other


def qp_solve_flops(n: int, m: int, mr: int, iters: int) -> int:
    """Floating-point operations of one one-sided IPM problem with n
    variables, m rows of which mr mirrored (an FMA counts 2; a compare,
    divide or square root 1)."""
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


def masked_extra_flops(plan) -> tuple[int, int]:
    """Operations per solve that the masked branches add to the static
    counts: (prestage, qpchain)."""
    nd, md, cd, cf, kr = plan.ndof, plan.mdof, plan.cdof, plan.cfree, plan.k_rows
    pre = (cd * nd
           + 2 * cd
           + 2 * cd * cd
           - 2 * md * cf * cf
           + 2 * md * cf
           + 2 * cd * md * cf - 2 * cf * md * cf
           + 2 * cd + 3 * cf * cf
           + md * cf)
    qp = kr * sum(nv for nv, _ in plan.qp_dims) + 2
    return pre, qp


def tick_flops(plan, iters: int) -> tuple[int, int]:
    """Operations per solve of a tick on a plan at ``iters`` IPM iterations
    (a multiply-add is 2): (prestage, qpchain)."""
    inv = psd_inverse_flops
    nb, nd, md, cd, cf, kr = (plan.nbody, plan.ndof, plan.mdof, plan.cdof, plan.cfree,
                              plan.k_rows)

    def chol(n):
        return sum(2 * (n - j - 1) * (n - j) // 2 + (n - j) for j in range(n))

    def w_apply(r):
        return 2 * md * md * r + (4 * md * cf * r if cf else 0)

    pre = 40 + (nb - 1) * 180
    pre += len(plan.points) * nd * 12
    pre += nb * 140 + (nb - 1) * 36
    pre += nd * 72 + 12 * int(plan.anc_pairs.sum()) + 6 * nd
    if plan.uses_tot:
        pre += 250 + nd * 50
    pre += inv(nd)
    pre += (2 * cd * nd * nd + cd * (cd + 1) * nd + 42 * cd + chol(cd) + chol(6) + inv(cd)
            + 2 * cd * cd * nd + 4 * cd * nd + md * (md + 1) * cd)
    if cf:
        pre += (4 * cd ** 3 + 2 * cd * md * cf + 2 * (3 * md * cf + 2 * md * cf * (cf - 1))
                + md * (md + 1) * cf + 2 * cf * cf * md + 4 * cf ** 3 + 2 * md * cf * cf)
    pre += chol(md) + 2 * md * nd + w_apply(1)
    nlev = len(plan.level_tdofs)
    for h, t in enumerate(plan.level_tdofs):
        pre += (2 * t * nd * nd + 4 * t * nd * cd + t * (t + 1) * nd + 2 * inv(t)
                + 2 * t * t * md + w_apply(t) + t * (t + 1) * md + 4 * md * t * t)
        pre += 2 * md * md * t if h else 0
        if h + 1 < nlev:
            pre += 2 * md * md * t * (2 if h else 1)
    pre += kr * (36 + 12 * md)
    pre += sum(5 * (c.contact_dof - 3 if not plan.masked else 3) * nd
               for c in plan.cfg.contacts if c.contact_type == 2)
    qp = 2 * cd * md
    mirror = md if plan.tlim is not None else 0
    for nv, m in plan.qp_dims:
        qp += (qp_solve_flops(nv, m, mirror, iters) + 2 * kr * md * nv + 2 * kr * md
               + 4 * md * nv)
    if plan.masked:
        x_pre, x_qp = masked_extra_flops(plan)
        pre, qp = pre + x_pre, qp + x_qp
    return pre, qp


def tick_bytes(plan) -> int:
    """Bytes one solve reads and writes once (float32)."""
    ntask = sum(plan.level_tdofs)
    warm = sum(n + m for n, m in plan.qp_dims)
    nmask = len(plan.cfg.contacts) if plan.masked else 0
    reads = plan.nq + ntask + nmask + warm
    writes = 4 * plan.mdof + plan.cdof + 3 + warm
    return 4 * (reads + writes)


def least_seconds(plan, solves_by_iters: dict) -> tuple[float, str]:
    """The least time the card could take for the solves {iters: count}:
    the larger of their operations over the float32 peak and their bytes
    over the memory peak, and which of the two bounds it."""
    flops = sum(sum(tick_flops(plan, it)) * n for it, n in solves_by_iters.items())
    nbytes = tick_bytes(plan) * sum(solves_by_iters.values())
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
