// The one-sided Mehrotra predictor-corrector IPM of one lane, shared by the
// tick's QP chain (tick_qpchain.cu) and the standalone batched QP solver
// (qp_solve.cu):
//
//   min ½xᵀHx + gᵀx  s.t.  Cx ≤ d,   C = [B; −B; D] with only [B; D] stored.
//
// The mirrored −B rows (the ± torque-limit pairs, mr of them) are folded
// into every reduction over the m rows, while slacks and duals keep all m.
// H is either diagonal (1 on the first nt variables, 0 on the rest, g = 0:
// the tick's QPs) or dense with a linear term g (qp_solve).  Warm solves
// start from (x, λ) with floors 1e-4 and take split primal/dual steps,
// cold solves start from (0, 1) with a common step; an iteration freezes
// once μ ≤ μ_tol, a step with a non-finite dx is skipped, λ is capped at
// w_cap.  The same recurrence as libdwbc_tpu/ops/pallas_qp.py::_make_kernel
// and libdwbc_tpu/ops/tick_kernel.py::TickProgram._ipm, with one change, for
// a pivot of the Gram's Cholesky that is lost (fell to the 1e-30 clamp or,
// in float32, below 1e-6 of its diagonal entry before elimination): in the
// tick's diagonal-H form at any precision, in the dense form (qp_solve) at
// float32 only, so that float64 keeps pallas_qp_solve's recurrence.  In
// float32 near convergence the Gram's entries reach λ/s ~ 1e6 and a pivot
// that should be ~1 cancels to noise or ≤ 0; a step from the clamped factor
// then moves x far from the optimum at a small gap (warm single-support
// lanes of the masked tick, in both forms: on the masked sweep MaskedTick's
// float32 qp_solve put such lanes up to 0.036 Nm (H100) and its plain
// recurrence 0.47 Nm (CPU) from a float64 solve of the same QP).  So in
// float32 a lane whose μ and largest |r_p| are both within kLostPivotNear
// skips that step; any other lane, and every lane in float64, takes the
// step with the lost pivot's reciprocal 0 and its column out of the
// elimination, i.e. holds that variable (dx = 0) and moves the others
// (Wright's modified Cholesky for IPMs): on active constraints far from
// convergence (the servo'd loop) the Gram is as ill-conditioned, and a
// skipped step would stall the lane.  Float64 has no float32 noise to
// guard against, and there a pivot that is the ridge alone (a direction
// with no Hessian and no constraint: the hands plan's singular NwJw
// direction, 1e-9 at a diagonal of ~1e8) falls below 1e-30 or not by
// rounding, so a skip would stop a lane at an iteration its rounding
// picks; the held step leaves that direction, which nothing reads, alone.
// (The plain tick, TickProgram._ipm, also skips in float64; the two part
// only on a float64 lane that loses a pivot within the bars.)
//
// The nl lanes of a Lanes (warp_linalg.cuh) share one problem: tick_qpchain
// runs a warp per scenario and qp_solve a warp per problem, each on shared
// memory.  Every value is taken in a fixed order set by the problem (n, m),
// the same for any nl.  The lanes split outputs: the stored rows of C·x,
// the n outputs of Cᵀv, the n(n+1)/2 entries of the Gram, the m rows of
// every elementwise update, the trailing triangle of each Cholesky column.
// The two triangular solves go column by column, each lane holding its
// rows' running sums (solve_lower_vec in the row order's bits,
// solve_upperT_vec with each row's terms from the last column down).  μ,
// μ_aff and the gap are fixed_sum's 32 partials and tree.  The step
// lengths, max |r_p|, the primal residual and the finite-dx test are exact
// min / max reductions.
#pragma once

#include "warp_linalg.cuh"

namespace dwbc {

// μ and max |r_p| at or below which a float32 lane stops on a lost pivot: the
// tick's failure bars (PipelineConfig.qp_fail_gap / qp_fail_pres),
// ops/tick_kernel.py::LOST_PIVOT_NEAR.
constexpr double kLostPivotNear = 1e-3;

// Workspace of one IPM: the stored rows C (srows × nv, rows padded to an
// odd length against bank conflicts when the lanes split them), the
// Cholesky factor L (nv × nv) and its reciprocal diagonal, and the
// m-vectors.
template <typename T>
struct IPMWS {
  V<T> d, s, inv_s, r_p, wv, ds_a, dlam_a, ds, dlam, tmp, r_d, rhs, dx_a, dx, idg;
  M<T> C, L;

  DWBC_HD IPMWS(Arena<T>& a, int nv, int srows, int m) {
    C = a.mat(srows, nv, nv | 1);
    L = a.mat(nv, nv);
    d = a.vec(m);
    s = a.vec(m);
    inv_s = a.vec(m);
    r_p = a.vec(m);
    wv = a.vec(m);
    ds_a = a.vec(m);
    dlam_a = a.vec(m);
    ds = a.vec(m);
    dlam = a.vec(m);
    tmp = a.vec(m);
    r_d = a.vec(nv);
    rhs = a.vec(nv);
    dx_a = a.vec(nv);
    dx = a.vec(nv);
    idg = a.vec(nv);
  }
};

// out (m rows) = C·x with the mirrored block unfolded: [Bx; −Bx; Dx].
template <typename T>
DWBC_HD void cx_full(const IPMWS<T>& w, V<T> x, V<T> out, int n, int me, int mr, Lanes wp) {
  for (int r = wp.lane; r < me; r += wp.nl) {
    T acc = w.C(r, 0) * x[0];
    for (int i = 1; i < n; ++i) acc += w.C(r, i) * x[i];
    if (r < mr) {
      out[r] = acc;
      out[mr + r] = -acc;
    } else {
      out[mr + r] = acc;
    }
  }
  wp.sync();
}

// out (n) = Cᵀ·v over all m rows, the mirrored rows folded: v_r − v_{mr+r}.
// w.tmp holds the folded vector.
template <typename T>
DWBC_HD void ctv_full(const IPMWS<T>& w, V<T> v, V<T> out, int n, int me, int mr, Lanes wp) {
  for (int r = wp.lane; r < me; r += wp.nl) w.tmp[r] = r < mr ? v[r] - v[mr + r] : v[mr + r];
  wp.sync();
  for (int i = wp.lane; i < n; i += wp.nl) {
    T acc = w.C(0, i) * w.tmp[0];
    for (int r = 1; r < me; ++r) acc += w.C(r, i) * w.tmp[r];
    out[i] = acc;
  }
  wp.sync();
}

template <typename T>
DWBC_HD T alpha_max(V<T> v, V<T> dv, int m, Lanes wp) {
  T mn = (T)1e20;
  for (int r = wp.lane; r < m; r += wp.nl) {
    T ratio = dv[r] < (T)0 ? -v[r] / dv[r] : (T)1e20;
    mn = vmin(mn, ratio);
  }
  return clamp_max((T)0.995 * wp.reduce(mn, MinOp{}), (T)1);
}

// One Newton solve on the factored system.  Complementarity residual
// r_c = s∘λ − σμ·1 + ds_a∘dλ_a (corrector) or s∘λ (predictor).
template <typename T>
DWBC_HD void newton(const IPMWS<T>& w, V<T> lam, V<T> dxo, V<T> dso, V<T> dlo,
                    bool corrector, T sigma_mu, int n, int me, int mr, Lanes wp) {
  const int m = me + mr;
  V<T> v = dso;                                   // scratch before ds lands
  for (int r = wp.lane; r < m; r += wp.nl) {
    T rc = w.s[r] * lam[r] - (corrector ? sigma_mu - w.ds_a[r] * w.dlam_a[r] : (T)0);
    v[r] = w.wv[r] * w.r_p[r] - rc * w.inv_s[r];
  }
  wp.sync();
  ctv_full(w, v, w.rhs, n, me, mr, wp);
  for (int i = wp.lane; i < n; i += wp.nl) w.rhs[i] = -w.r_d[i] - w.rhs[i];
  wp.sync();
  solve_lower_vec(w.L, w.idg, w.rhs, dxo, n, wp);
  solve_upperT_vec(w.L, w.idg, dxo, n, wp);
  cx_full(w, dxo, dso, n, me, mr, wp);
  for (int r = wp.lane; r < m; r += wp.nl) {
    T rc = w.s[r] * lam[r] - (corrector ? sigma_mu - w.ds_a[r] * w.dlam_a[r] : (T)0);
    T dsr = -(w.r_p[r] + dso[r]);
    dso[r] = dsr;
    dlo[r] = -(rc + lam[r] * dsr) * w.inv_s[r];
  }
  wp.sync();
}

// The iterations.  H.p == nullptr: H = diag(1 on the first nt variables, 0
// on the rest) and g = 0; else H (n × n) dense and g (n).  w.C and w.d hold
// the problem; x and lam are the warm state in (when warm) and the solution
// out; w.s holds the slacks out.  The caller has synced the lanes since it
// wrote them; the lanes are synced on return.
template <typename T>
DWBC_HD void ipm_iterate(const IPMWS<T>& w, M<T> H, V<T> g, V<T> x, V<T> lam,
                         int n, int nt, int me, int mr, int iters, bool warm,
                         T ridge, Lanes wp) {
  const bool f32 = sizeof(T) == 4;
  const bool dense = H.p != nullptr;
  const T s_floor = f32 ? (T)1e-10 : (T)1e-14;
  const T w_cap = f32 ? (T)1e8 : (T)1e12;
  const T mu_tol = f32 ? (T)5e-8 : (T)1e-13;
  const int m = me + mr;

  if (warm) {
    cx_full(w, x, w.tmp, n, me, mr, wp);
    for (int r = wp.lane; r < m; r += wp.nl) {
      w.s[r] = clamp_min(w.d[r] - w.tmp[r], (T)1e-4);
      lam[r] = clamp_max(clamp_min(lam[r], (T)1e-4), w_cap);
    }
  } else {
    for (int i = wp.lane; i < n; i += wp.nl) x[i] = (T)0;
    for (int r = wp.lane; r < m; r += wp.nl) {
      w.s[r] = clamp_min(w.d[r], (T)1);
      lam[r] = (T)1;
    }
  }
  wp.sync();

  for (int it = 0; it < iters; ++it) {
    const T mu = fixed_sum<T>([&](int r) { return w.s[r] * lam[r]; }, m, wp) / (T)m;
    const T live = mu > mu_tol ? (T)1 : (T)0;

    // factor: residuals, scaling w = λ/s, Gram Cᵀdiag(w)C + H + ridge
    cx_full(w, x, w.r_p, n, me, mr, wp);
    T rp_max = 0;                                 // NaN-propagating, as torch's amax
    for (int r = wp.lane; r < m; r += wp.nl) {
      w.inv_s[r] = (T)1 / clamp_min(w.s[r], s_floor);
      w.r_p[r] = w.r_p[r] + w.s[r] - w.d[r];
      rp_max = NanMaxOp{}(rp_max, (T)fabs(w.r_p[r]));
      w.wv[r] = clamp_max(clamp_min(lam[r] * w.inv_s[r], (T)0), w_cap);
    }
    rp_max = wp.reduce(rp_max, NanMaxOp{});
    wp.sync();
    ctv_full(w, lam, w.r_d, n, me, mr, wp);
    for (int i = wp.lane; i < n; i += wp.nl) {
      if (dense) {
        T hx = H(i, 0) * x[0] + ridge * x[i];
        for (int j = 1; j < n; ++j) hx += H(i, j) * x[j];
        w.r_d[i] = (hx + g[i]) + w.r_d[i];
      } else {
        w.r_d[i] = ((i < nt ? (T)1 : (T)0) + ridge) * x[i] + w.r_d[i];
      }
    }
    for (int r = wp.lane; r < me; r += wp.nl)
      w.tmp[r] = r < mr ? w.wv[r] + w.wv[mr + r] : w.wv[mr + r];
    wp.sync();
    {
      int i = 0, j = 0;
      for (walk_lower(i, j, wp.lane); i < n; walk_lower(i, j, wp.nl)) {
        T acc = (w.C(0, i) * w.tmp[0]) * w.C(0, j);
        for (int r = 1; r < me; ++r) acc += (w.C(r, i) * w.tmp[r]) * w.C(r, j);
        if (dense) {
          acc = H(i, j) + acc;
          if (i == j) acc = acc + ridge;
        } else if (i == j) {
          acc = acc + ((i < nt ? (T)1 : (T)0) + ridge);
        }
        w.L(i, j) = acc;
        if (i == j) w.idg[i] = acc;               // the diagonal before elimination
      }
    }
    wp.sync();
    // right-looking, sqrt pivots: every lane takes the pivot, the lanes
    // scale the column and split the trailing triangle, lane 0 writes the
    // pivot's diagonal and reciprocal (read by no lane in that phase)
    bool collapsed = false;
    for (int j = 0; j < n; ++j) {
      const T ljj = w.L(j, j);
      const bool lost = (!dense || f32) &&
                        (!(ljj >= (T)1e-30) || (f32 && ljj < (T)1e-6 * w.idg[j]));
      collapsed = collapsed || lost;
      const T dj = sqrt(clamp_min(ljj, (T)1e-30));
      const T inv_d = lost ? (T)0 : (T)1 / dj;
      for (int i = j + 1 + wp.lane; i < n; i += wp.nl) w.L(i, j) = w.L(i, j) * inv_d;
      wp.sync();
      if (wp.lane == 0) {
        w.idg[j] = inv_d;
        w.L(j, j) = dj;
      }
      chol_trailing(w.L, j, n, wp);
      wp.sync();
    }

    // predictor
    newton(w, lam, w.dx_a, w.ds_a, w.dlam_a, false, (T)0, n, me, mr, wp);
    const T a_p = alpha_max(w.s, w.ds_a, m, wp);
    const T a_d = alpha_max(lam, w.dlam_a, m, wp);
    const T mu_aff = fixed_sum<T>([&](int r) {
                       return (w.s[r] + a_p * w.ds_a[r]) * (lam[r] + a_d * w.dlam_a[r]);
                     }, m, wp) / (T)m;
    T ratio = mu_aff / clamp_min(mu, (T)1e-30);
    const T sigma = ratio * ratio * ratio;

    // corrector
    newton(w, lam, w.dx, w.ds, w.dlam, true, sigma * mu, n, me, mr, wp);
    T a_pc, a_dc;
    if (warm) {
      a_pc = live * alpha_max(w.s, w.ds, m, wp);
      a_dc = live * alpha_max(lam, w.dlam, m, wp);
    } else {
      a_pc = live * vmin(alpha_max(w.s, w.ds, m, wp), alpha_max(lam, w.dlam, m, wp));
      a_dc = a_pc;
    }
    T finite = 1;
    for (int i = wp.lane; i < n; i += wp.nl) finite = isfinite(w.dx[i]) ? finite : (T)0;
    const bool ok = wp.reduce(finite, MinOp{}) != (T)0 && !(f32 && collapsed && mu <= (T)kLostPivotNear &&
                                        rp_max <= (T)kLostPivotNear);
    if (ok) {
      for (int i = wp.lane; i < n; i += wp.nl) x[i] = x[i] + a_pc * w.dx[i];
      for (int r = wp.lane; r < m; r += wp.nl) {
        w.s[r] = w.s[r] + a_pc * w.ds[r];
        lam[r] = clamp_max(lam[r] + a_dc * w.dlam[r], w_cap);
      }
    }
    wp.sync();
  }
}

}  // namespace dwbc
