// tick_qpchain: the prestage outputs, f* and the warm state → the tick's
// torques, diagnostics and warm state out, one thread per scenario.
//
// Replaces the second stage of the TPU kernel wbc/fused.py::FusedTick.
// _run_pallas, i.e. libdwbc_tpu/ops/tick_kernel.py::TickProgram.qpchain and
// TickProgram._ipm in static and masked mode: per task level a one-sided Mehrotra
// predictor-corrector IPM for min ½xᵀdiag(H)x s.t. Cx ≤ d (H = 1 on the task
// block, 0 on the contact block; float32 ridge 1e-6), then the contact
// redistribution QP.  The IPM itself is csrc/ipm.cuh, shared with the
// standalone solver csrc/qp_solve.cu.  Masked mode: the cone/ZMP rows of an
// inactive candidate become 0·x ≤ 1, and a lane with at most 6 active
// contact dof keeps the redistribution QP out of its gap and residual.
//
// What bounds it on the H100: per IPM iteration one Gram matrix (n²/2·m
// FMAs, n ≤ 12, m = 86) and one n×n Cholesky, plus passes over the 53×n
// stored rows: about 108k FLOP per scenario at 7 iterations, serial within
// the thread, with the constraint rows and the m-vectors streamed from the
// [elem][B] workspace (coalesced across the warp, L1/L2 resident at
// B = 1024).  Blocks are one warp (32 blocks at B = 1024); filling all
// 132 SMs is later work.
#include "elemlin.cuh"
#include "ipm.cuh"

namespace dwbc {

template <typename T>
struct QPWS : IPMWS<T> {
  V<T> tau_task, tau_contact, tau_base;

  DWBC_HD QPWS(Arena<T>& a, const Tab<T>& tb)
      : IPMWS<T>(a, tb.tmax() + tb.cfree, tb.srows(), tb.mrows()) {
    tau_task = a.vec(tb.mdof);
    tau_contact = a.vec(tb.mdof);
    tau_base = a.vec(tb.mdof);
  }
};

// min ½xᵀdiag(H)x s.t. Cx ≤ d, H = 1 on the first nt variables and 0 on
// the rest (ipm.cuh), then the primal residual and the normalized
// complementarity gap.  x and lam are the warm state in and the solution out.
template <typename T>
DWBC_HD void ipm(const QPWS<T>& w, V<T> x, V<T> lam, int n, int nt, int me,
                 int mr, int iters, bool warm, T& gap, T& pres) {
  const T ridge = sizeof(T) == 4 ? (T)1e-6 : (T)1e-9;
  const int m = me + mr;
  ipm_iterate<T>(w, M<T>{nullptr, 0, 0}, V<T>{nullptr, 0}, x, lam, n, nt, me,
                 mr, iters, warm, ridge);
  cx_full<T>(w, x, w.tmp, n, me, mr);
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
// τlim + τ; Atemp·τ − bA0] with τ = w.tau_base; masked: a row whose
// crow_mask is 0 becomes 0·x ≤ 1.
template <typename T>
DWBC_HD void build_rows(const Tab<T>& tb, const QPWS<T>& w, const Pre<T>& pre,
                        int nv) {
  const int md = tb.mdof;
  for (int r = 0; r < tb.krows; ++r) {
    const T cr = tb.masked ? pre.crow[r] : (T)1;
    for (int c = 0; c < nv; ++c) {
      T acc = pre.Atemp(r, 0) * w.C(0, c);
      for (int i = 1; i < md; ++i) acc += pre.Atemp(r, i) * w.C(i, c);
      w.C(md + r, c) = tb.masked ? -acc * cr : -acc;
    }
    T acc = pre.Atemp(r, 0) * w.tau_base[0];
    for (int i = 1; i < md; ++i) acc += pre.Atemp(r, i) * w.tau_base[i];
    w.d[2 * md + r] = cr > (T)0.5 ? acc - pre.bA0[r] : (T)1;
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
  const bool servo = fsp == nullptr;   // as ops/tick_cuda.py::PackedPre.servo
  Arena<T> pa{const_cast<T*>(prep), B, 0};
  const Pre<T> pre(pa, tb, servo);
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
  const V<T> fs = servo ? pre.fstar : V<T>{const_cast<T*>(fsp), B};

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
    if (tb.masked) {        // no redistribution problem unless active_cdof > 6
      const T live = pre.acdof[0] > (T)6.5 ? (T)1 : (T)0;
      g = g * live;
      p = p * live;
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
  dwbc::qpchain_lane<float>(table, pre + b, fs ? fs + b : nullptr,
                            warm_in ? warm_in + b : nullptr, out + b,
                            warm_out + b, ws + b, (long long)B, iters);
}

// pre (pre_elems, B), fs (Σ task dofs, B), or fs null and pre (pre_elems
// with the servo section, B) for a servo'd tick, warm_in (warm_elems, B) or
// null for a cold tick, out (out_elems, B), warm_out (warm_elems, B), ws
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
