// tick_qpchain: the prestage outputs, f* and the warm state → the tick's
// torques, diagnostics and warm state out, one thread per scenario.
//
// Replaces the second stage of the TPU kernel wbc/fused.py::FusedTick.
// _run_pallas, i.e. libdwbc_tpu/ops/tick_kernel.py::TickProgram.qpchain and
// TickProgram._ipm in static mode: per task level a one-sided Mehrotra
// predictor-corrector IPM for min ½xᵀdiag(H)x s.t. Cx ≤ d (H = 1 on the task
// block, 0 on the contact block; float32 ridge 1e-6), then the contact
// redistribution QP.  Only [B; D] is stored: the mirrored −B torque-limit
// rows are folded into every reduction over the m rows, while slacks and
// duals keep all m.  Warm solves take split primal/dual steps, cold solves a
// common step; iterations freeze once μ ≤ μ_tol, a non-finite step is
// skipped, λ is capped at w_cap.
//
// What bounds it on the H100: per IPM iteration one Gram matrix (n²/2·m
// FMAs, n ≤ 12, m = 86) and one n×n Cholesky, plus passes over the 53×n
// stored rows: about 108k FLOP per scenario at 7 iterations, serial within
// the thread, with the constraint rows and the m-vectors streamed from the
// [elem][B] workspace (coalesced across the warp, L1/L2 resident at
// B = 1024).  Blocks are one warp (32 blocks at B = 1024); filling all
// 132 SMs is later work.
#include "elemlin.cuh"

namespace dwbc {

template <typename T>
struct QPWS {
  V<T> tau_task, tau_contact, tau_base, d, s, inv_s, r_p, wv, ds_a, dlam_a, ds,
      dlam, tmp, r_d, rhs, dx_a, dx, idg;
  M<T> C, L;

  DWBC_HD QPWS(Arena<T>& a, const Tab<T>& tb) {
    const int nv = tb.tmax() + tb.cfree, m = tb.mrows();
    tau_task = a.vec(tb.mdof);
    tau_contact = a.vec(tb.mdof);
    tau_base = a.vec(tb.mdof);
    C = a.mat(tb.srows(), nv);
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
DWBC_HD void cx_full(const QPWS<T>& w, V<T> x, V<T> out, int n, int me, int mr) {
  for (int r = 0; r < me; ++r) {
    T acc = w.C(r, 0) * x[0];
    for (int i = 1; i < n; ++i) acc += w.C(r, i) * x[i];
    if (r < mr) {
      out[r] = acc;
      out[mr + r] = -acc;
    } else {
      out[mr + r] = acc;
    }
  }
}

// out (n) = Cᵀ·v over all m rows, the mirrored rows folded: v_r − v_{mr+r}.
// w.tmp holds the folded vector.
template <typename T>
DWBC_HD void ctv_full(const QPWS<T>& w, V<T> v, V<T> out, int n, int me, int mr) {
  for (int r = 0; r < me; ++r) w.tmp[r] = r < mr ? v[r] - v[mr + r] : v[mr + r];
  for (int i = 0; i < n; ++i) {
    T acc = w.C(0, i) * w.tmp[0];
    for (int r = 1; r < me; ++r) acc += w.C(r, i) * w.tmp[r];
    out[i] = acc;
  }
}

template <typename T>
DWBC_HD T alpha_max(V<T> v, V<T> dv, int m) {
  T mn = (T)1e20;
  for (int r = 0; r < m; ++r) {
    T ratio = dv[r] < (T)0 ? -v[r] / dv[r] : (T)1e20;
    mn = vmin(mn, ratio);
  }
  return clamp_max((T)0.995 * mn, (T)1);
}

// One Newton solve on the factored system.  Complementarity residual
// r_c = s∘λ − σμ·1 + ds_a∘dλ_a (corrector) or s∘λ (predictor).
template <typename T>
DWBC_HD void newton(const QPWS<T>& w, V<T> lam, V<T> dxo, V<T> dso, V<T> dlo,
                    bool corrector, T sigma_mu, int n, int me, int mr) {
  const int m = me + mr;
  V<T> v = dso;                                   // scratch before ds lands
  for (int r = 0; r < m; ++r) {
    T rc = w.s[r] * lam[r] - (corrector ? sigma_mu - w.ds_a[r] * w.dlam_a[r] : (T)0);
    v[r] = w.wv[r] * w.r_p[r] - rc * w.inv_s[r];
  }
  ctv_full(w, v, w.rhs, n, me, mr);
  for (int i = 0; i < n; ++i) w.rhs[i] = -w.r_d[i] - w.rhs[i];
  for (int i = 0; i < n; ++i) {                   // L y = rhs
    T acc = w.rhs[i];
    for (int k = 0; k < i; ++k) acc -= w.L(i, k) * dxo[k];
    dxo[i] = acc * w.idg[i];
  }
  for (int i = n - 1; i >= 0; --i) {              // Lᵀ dx = y
    T acc = dxo[i];
    for (int k = i + 1; k < n; ++k) acc -= w.L(k, i) * dxo[k];
    dxo[i] = acc * w.idg[i];
  }
  cx_full(w, dxo, dso, n, me, mr);
  for (int r = 0; r < m; ++r) {
    T rc = w.s[r] * lam[r] - (corrector ? sigma_mu - w.ds_a[r] * w.dlam_a[r] : (T)0);
    T dsr = -(w.r_p[r] + dso[r]);
    dso[r] = dsr;
    dlo[r] = -(rc + lam[r] * dsr) * w.inv_s[r];
  }
}

// min ½xᵀdiag(H)x s.t. Cx ≤ d, H = 1 on the first nt variables and 0 on
// the rest.  x and lam are the warm state in and the solution out.
template <typename T>
DWBC_HD void ipm(const QPWS<T>& w, V<T> x, V<T> lam, int n, int nt, int me,
                 int mr, int iters, bool warm, T& gap, T& pres) {
  const bool f32 = sizeof(T) == 4;
  const T ridge = f32 ? (T)1e-6 : (T)1e-9;
  const T s_floor = f32 ? (T)1e-10 : (T)1e-14;
  const T w_cap = f32 ? (T)1e8 : (T)1e12;
  const T mu_tol = f32 ? (T)5e-8 : (T)1e-13;
  const int m = me + mr;

  if (warm) {
    cx_full(w, x, w.tmp, n, me, mr);
    for (int r = 0; r < m; ++r) {
      w.s[r] = clamp_min(w.d[r] - w.tmp[r], (T)1e-4);
      lam[r] = clamp_max(clamp_min(lam[r], (T)1e-4), w_cap);
    }
  } else {
    for (int i = 0; i < n; ++i) x[i] = (T)0;
    for (int r = 0; r < m; ++r) {
      w.s[r] = clamp_min(w.d[r], (T)1);
      lam[r] = (T)1;
    }
  }

  for (int it = 0; it < iters; ++it) {
    T mu = 0;
    for (int r = 0; r < m; ++r) mu += w.s[r] * lam[r];
    mu = mu / (T)m;
    const T live = mu > mu_tol ? (T)1 : (T)0;

    // factor: residuals, scaling w = λ/s, Gram Cᵀdiag(w)C + H + ridge
    cx_full(w, x, w.r_p, n, me, mr);
    for (int r = 0; r < m; ++r) {
      w.inv_s[r] = (T)1 / clamp_min(w.s[r], s_floor);
      w.r_p[r] = w.r_p[r] + w.s[r] - w.d[r];
      w.wv[r] = clamp_max(clamp_min(lam[r] * w.inv_s[r], (T)0), w_cap);
    }
    ctv_full(w, lam, w.r_d, n, me, mr);
    for (int i = 0; i < n; ++i)
      w.r_d[i] = ((i < nt ? (T)1 : (T)0) + ridge) * x[i] + w.r_d[i];
    for (int r = 0; r < me; ++r) w.tmp[r] = r < mr ? w.wv[r] + w.wv[mr + r] : w.wv[mr + r];
    for (int i = 0; i < n; ++i)
      for (int j = 0; j <= i; ++j) {
        T acc = (w.C(0, i) * w.tmp[0]) * w.C(0, j);
        for (int r = 1; r < me; ++r) acc += (w.C(r, i) * w.tmp[r]) * w.C(r, j);
        if (i == j) acc = acc + ((i < nt ? (T)1 : (T)0) + ridge);
        w.L(i, j) = acc;
      }
    for (int j = 0; j < n; ++j) {                 // right-looking, sqrt pivots
      T dj = sqrt(clamp_min(w.L(j, j), (T)1e-30));
      T inv_d = (T)1 / dj;
      w.idg[j] = inv_d;
      w.L(j, j) = dj;
      for (int i = j + 1; i < n; ++i) w.L(i, j) = w.L(i, j) * inv_d;
      for (int i = j + 1; i < n; ++i)
        for (int k = j + 1; k <= i; ++k) w.L(i, k) = w.L(i, k) - w.L(i, j) * w.L(k, j);
    }

    // predictor
    newton(w, lam, w.dx_a, w.ds_a, w.dlam_a, false, (T)0, n, me, mr);
    const T a_p = alpha_max(w.s, w.ds_a, m);
    const T a_d = alpha_max(lam, w.dlam_a, m);
    T mu_aff = 0;
    for (int r = 0; r < m; ++r)
      mu_aff += (w.s[r] + a_p * w.ds_a[r]) * (lam[r] + a_d * w.dlam_a[r]);
    mu_aff = mu_aff / (T)m;
    T ratio = mu_aff / clamp_min(mu, (T)1e-30);
    const T sigma = ratio * ratio * ratio;

    // corrector
    newton(w, lam, w.dx, w.ds, w.dlam, true, sigma * mu, n, me, mr);
    T a_pc, a_dc;
    if (warm) {
      a_pc = live * alpha_max(w.s, w.ds, m);
      a_dc = live * alpha_max(lam, w.dlam, m);
    } else {
      a_pc = live * vmin(alpha_max(w.s, w.ds, m), alpha_max(lam, w.dlam, m));
      a_dc = a_pc;
    }
    bool ok = true;
    for (int i = 0; i < n; ++i) ok = ok && isfinite(w.dx[i]);
    if (ok) {
      for (int i = 0; i < n; ++i) x[i] = x[i] + a_pc * w.dx[i];
      for (int r = 0; r < m; ++r) {
        w.s[r] = w.s[r] + a_pc * w.ds[r];
        lam[r] = clamp_max(lam[r] + a_dc * w.dlam[r], w_cap);
      }
    }
  }

  cx_full(w, x, w.tmp, n, me, mr);
  T p = 0, g = 0;
  for (int r = 0; r < m; ++r) {
    T slack = w.d[r] - w.tmp[r];
    p = vmax(p, clamp_min(-slack, (T)0));
    g += fabs(slack) * (lam[r] / ((T)1 + lam[r]));
  }
  pres = p;
  gap = g / (T)m;
}

// Constraint rows of one QP: C = [blk; −Atemp·blk], d = [τlim − τ;
// τlim + τ; Atemp·τ − bA0] with τ = w.tau_base.
template <typename T>
DWBC_HD void build_rows(const Tab<T>& tb, const QPWS<T>& w, const Pre<T>& pre,
                        int nv) {
  const int md = tb.mdof;
  for (int r = 0; r < tb.krows; ++r) {
    for (int c = 0; c < nv; ++c) {
      T acc = pre.Atemp(r, 0) * w.C(0, c);
      for (int i = 1; i < md; ++i) acc += pre.Atemp(r, i) * w.C(i, c);
      w.C(md + r, c) = -acc;
    }
    T acc = pre.Atemp(r, 0) * w.tau_base[0];
    for (int i = 1; i < md; ++i) acc += pre.Atemp(r, i) * w.tau_base[i];
    w.d[2 * md + r] = acc - pre.bA0[r];
  }
  for (int i = 0; i < md; ++i) {
    w.d[i] = tb.tlim[i] - w.tau_base[i];
    w.d[md + i] = tb.tlim[i] + w.tau_base[i];
  }
}

template <typename T>
DWBC_HD void qpchain_lane(const T* table, const T* prep, const T* fsp,
                          const T* warm_in, T* outp, T* warm_out, T* wsp,
                          long long B, int iters) {
  const Tab<T> tb(table);
  const int md = tb.mdof, cf = tb.cfree, me = tb.srows();
  Arena<T> pa{const_cast<T*>(prep), B, 0};
  const Pre<T> pre(pa, tb);
  Arena<T> oa{outp, B, 0};
  Out<T> out(oa, tb);
  Arena<T> woa{warm_out, B, 0};
  Warm<T> wo(woa, tb);
  Arena<T> wa{wsp, B, 0};
  QPWS<T> w(wa, tb);
  const bool warm = warm_in != nullptr;
  if (warm) {                                    // x, λ evolve in warm_out
    Arena<T> wia{const_cast<T*>(warm_in), B, 0};
    Warm<T> wi(wia, tb);
    for (int h = 0; h <= tb.nlev; ++h) {
      const int n = h < tb.nlev ? tb.lev_t[h] + cf : cf;
      for (int i = 0; i < n; ++i) wo.x[h][i] = wi.x[h][i];
      for (int r = 0; r < tb.mrows(); ++r) wo.lam[h][r] = wi.lam[h][r];
    }
  }
  V<T> fs{const_cast<T*>(fsp), B};

  for (int i = 0; i < md; ++i) {
    w.tau_task[i] = (T)0;
    w.tau_contact[i] = (T)0;
  }
  T gap = 0, pres = 0;
  int foff = 0;
  for (int h = 0; h < tb.nlev; ++h) {
    const int t = tb.lev_t[h], nv = t + cf;
    const M<T> Nt = pre.Nt[h];
    V<T> f = fs.at(foff);
    for (int i = 0; i < md; ++i) {
      T acc = Nt(i, 0) * f[0];
      for (int c = 1; c < t; ++c) acc += Nt(i, c) * f[c];
      w.tau_base[i] = (pre.tg[i] + w.tau_task[i]) + acc;
      for (int c = 0; c < nv; ++c) w.C(i, c) = c < t ? Nt(i, c) : pre.NwJw(i, c - t);
    }
    build_rows(tb, w, pre, nv);
    T g, p;
    ipm(w, wo.x[h], wo.lam[h], nv, t, me, md, iters, warm, g, p);
    for (int i = 0; i < md; ++i) {
      T acc = Nt(i, 0) * (f[0] + wo.x[h][0]);
      for (int c = 1; c < t; ++c) acc += Nt(i, c) * (f[c] + wo.x[h][c]);
      w.tau_task[i] = w.tau_task[i] + acc;
      T tc = pre.NwJw(i, 0) * wo.x[h][t];
      for (int c = 1; c < cf; ++c) tc += pre.NwJw(i, c) * wo.x[h][t + c];
      w.tau_contact[i] = tc;
    }
    gap = vmax(gap, g);
    pres = vmax(pres, p);
    foff += t;
  }

  // contact redistribution QP
  {
    const int h = tb.nlev;
    for (int i = 0; i < md; ++i) {
      w.tau_base[i] = (pre.tg[i] + w.tau_task[i]) + w.tau_contact[i];
      for (int c = 0; c < cf; ++c) w.C(i, c) = pre.NwJw(i, c);
    }
    build_rows(tb, w, pre, cf);
    T g, p;
    ipm(w, wo.x[h], wo.lam[h], cf, cf, me, md, iters, warm, g, p);
    for (int i = 0; i < md; ++i) {
      T acc = pre.NwJw(i, 0) * wo.x[h][0];
      for (int c = 1; c < cf; ++c) acc += pre.NwJw(i, c) * wo.x[h][c];
      w.tau_contact[i] = w.tau_contact[i] + acc;
    }
    gap = vmax(gap, g);
    pres = vmax(pres, p);
  }

  for (int i = 0; i < md; ++i) {
    out.tg[i] = pre.tg[i];
    out.tt[i] = w.tau_task[i];
    out.tc[i] = w.tau_contact[i];
    out.tcmd[i] = (pre.tg[i] + w.tau_task[i]) + w.tau_contact[i];
  }
  for (int r = 0; r < tb.cdof; ++r) {
    T acc = pre.Jbar_act(r, 0) * out.tcmd[0];
    for (int i = 1; i < md; ++i) acc += pre.Jbar_act(r, i) * out.tcmd[i];
    out.cforce[r] = acc - pre.PC[r];
  }
  out.gap[0] = gap;
  out.pres[0] = pres;
  out.health[0] = pre.health[0];
}

template <typename T>
long long qpchain_ws_elems(const T* table) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0};
  QPWS<T> w(a, tb);
  return a.off;
}

template <typename T>
long long out_elems(const T* table) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0};
  Out<T> o(a, tb);
  return a.off;
}

template <typename T>
long long warm_elems(const T* table) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0};
  Warm<T> o(a, tb);
  return a.off;
}

}  // namespace dwbc

extern "C" long long dwbc_qpchain_ws_elems(const float* table_host) {
  return dwbc::qpchain_ws_elems(table_host);
}

extern "C" long long dwbc_out_elems(const float* table_host) {
  return dwbc::out_elems(table_host);
}

extern "C" long long dwbc_warm_elems(const float* table_host) {
  return dwbc::warm_elems(table_host);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
    tick_qpchain_kernel(const float* table, const float* pre, const float* fs,
                        const float* warm_in, float* out, float* warm_out,
                        float* ws, int B, int iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  dwbc::qpchain_lane<float>(table, pre + b, fs + b,
                            warm_in ? warm_in + b : nullptr, out + b,
                            warm_out + b, ws + b, (long long)B, iters);
}

// pre (pre_elems, B), fs (Σ task dofs, B), warm_in (warm_elems, B) or null
// for a cold tick, out (out_elems, B), warm_out (warm_elems, B), ws
// (qpchain_ws_elems, B): float32, contiguous, on the device; launched on
// `stream`, no synchronisation.
extern "C" int dwbc_tick_qpchain(const float* table, const float* pre,
                                 const float* fs, const float* warm_in,
                                 float* out, float* warm_out, float* ws, int B,
                                 int iters, void* stream) {
  const int threads = 32;               // one warp per block: spread lanes over SMs
  const int blocks = (B + threads - 1) / threads;
  tick_qpchain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, pre, fs, warm_in, out, warm_out, ws, B, iters);
  return (int)cudaGetLastError();
}
#endif
