// tick_qpchain: the prestage outputs, f* and the warm state → the tick's
// torques, diagnostics and warm state out, one warp per scenario.
//
// Replaces the second stage of the TPU kernel wbc/fused.py::FusedTick.
// _run_pallas, i.e. libdwbc_tpu/ops/tick_kernel.py::TickProgram.qpchain and
// TickProgram._ipm in static, masked and servo'd mode: per task level a
// one-sided Mehrotra predictor-corrector IPM for min ½xᵀdiag(H)x s.t. Cx ≤ d
// (H = 1 on the task block, 0 on the contact block; float32 ridge 1e-6;
// with a torque limit the mirrored ±τ rows, without one the constraint
// rows alone), then the contact redistribution QP (none with one contact
// of 6 dof or fewer: cfree = 0, τ_contact stays zero).  The IPM itself is csrc/ipm.cuh,
// shared with the standalone solver csrc/qp_solve.cu.  Masked mode: the
// cone/ZMP rows of an inactive candidate become 0·x ≤ 1, and a lane with at
// most 6 active contact dof keeps the redistribution QP out of its gap and
// residual.  Servo'd: f* is read from the prestage buffer's servo section.
//
// Mapping: kQPWarps scenarios per block, a warp each.  The block copies its
// scenarios' inputs (the constraint blocks Atemp, NwJw and Nt, τ_grav, bA0,
// the masks, f*, the warm (x, λ)) from the element-leading [elem][B]
// buffers into shared memory (for one element the block's scenarios are
// neighbouring words), the warp runs the chain there (ipm.cuh: the lanes
// split the constraint rows, the Gram's entries and the m-vectors), and
// the block writes the results and the warm state out the same way.  J̄ᵀ
// is read once from device memory at the end.  About 3,500 floats
// (~14 KB) per scenario.  The three QPs share one loop, so the IPM is
// compiled once, and no view is indexed by a run-time level: the compiler
// then keeps the views in registers, knows their stride is 1 and that they
// point at shared memory (shared loads, 32-bit offsets), and the kernel
// stays small enough for the instruction cache.
//
// What bounds it on the H100: per IPM iteration one Gram matrix (n²/2·m
// FMAs; flagship n ≤ 12, m = 86; hands and feet n ≤ 18, m = 98) and one
// n×n Cholesky, plus passes over the 53×n (hands 65×n) stored rows: about
// 108k FLOP per scenario at 7 iterations, on shared memory, in a chain of
// warp phases whose latency sets the time at any batch (B = 1 takes ~90%
// of B = 1024's): not the bytes (~8 KB per scenario) nor the card's FLOP
// rate.  So every chain is kept short: each value is taken in a fixed
// order set by the problem, the same for any nl (ipm.cuh), the two
// triangular solves as n shuffle-linked column steps each rather than
// n(n−1)/2 dependent steps on one lane, μ, μ_aff and the gap as 32
// partials and a five-level tree rather than m-long sums.  The Cholesky's
// n pivot steps, each two barriers apart, are the longest chain (27-31%
// of the kernel's time on the flagship and hands plans).
#include "ipm.cuh"

namespace dwbc {

constexpr int kQPWarps = 4;   // scenarios per block

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

template <typename T>
DWBC_HD long long out_elems(const Tab<T>& tb) {
  Arena<T> a{nullptr, 0, 0};
  Out<T> o(a, tb);
  return a.off;
}

// The prestage fields the QP chain reads more than once, as rows of the
// prestage buffer (NwJw, the levels' Nt blocks, Atemp and bA0 in the
// buffer's order), and the f* of every level.
template <typename T>
struct QPIn {
  V<T> tg, Nt, bA0, crow, acdof, fstar;
  M<T> NwJw, Atemp;

  DWBC_HD QPIn(Arena<T>& a, const Tab<T>& tb) {
    tg = a.vec(tb.mdof);
    NwJw = a.mat(tb.mdof, tb.cfree);
    Nt = a.vec(tb.mdof * tb.tsum());              // level h: mdof × lev_t(h), in turn
    Atemp = a.mat(tb.krows, tb.mdof);
    bA0 = a.vec(tb.krows);
    crow = tb.masked ? a.vec(tb.krows) : V<T>{nullptr, 0};
    acdof = tb.masked ? a.vec(1) : V<T>{nullptr, 0};
    fstar = a.vec(tb.tsum());
  }
};

// One scenario's working set in shared memory: inputs, IPM workspace, the
// warm state (tick_common.cuh's layout, evolved in place) and the results.  No view is indexed by a run-time level, so that the compiler
// keeps every view in registers and sees that it points at shared memory.
template <typename T>
struct QPShared {
  QPIn<T> in;
  QPWS<T> w;
  V<T> warm;
  Out<T> out;
  DWBC_HD QPShared(Arena<T>& a, const Tab<T>& tb)
      : in(a, tb), w(a, tb), warm(a.vec((int)warm_elems(tb))), out(a, tb) {}
};

// Elements per scenario of the shared working set.
template <typename T>
DWBC_HD long long qpchain_smem_elems(const Tab<T>& tb) {
  Arena<T> a{nullptr, 0, 0};
  QPShared<T> sh(a, tb);
  return a.off;
}

// Copy cnt elements of nw scenarios between an [elem][B] buffer (g, at
// the block's first scenario) and their shared copies (scenario w at
// sh + w·S), in or out.  Threads tid of nthr split the (element, scenario)
// pairs, neighbouring threads on neighbouring scenarios.
template <typename T>
DWBC_HD void stage(T* sh, T* g, int cnt, bool in, long long S, long long B, int nw, int W,
                   int tid, int nthr) {
  for (int e = tid; e < cnt * W; e += nthr) {
    const int el = e / W, w = e % W;
    if (w >= nw) continue;
    if (in)
      sh[w * S + el] = g[el * B + w];
    else
      g[el * B + w] = sh[w * S + el];
  }
}

// The block's scenarios b0 .. b0 + nw − 1 into shared memory (sm, S
// elements each).
template <typename T>
DWBC_HD void qpchain_stage_in(const Tab<T>& tb, const T* prep, const T* fsp, const T* warm_in,
                              T* sm, long long S, long long B, long long b0, int nw, int W,
                              int tid, int nthr) {
  const bool servo = fsp == nullptr;   // as ops/tick_cuda.py::PackedPre.servo
  Arena<T> pa{const_cast<T*>(prep) + b0, B, 0};
  const Pre<T> pre(pa, tb, servo);
  Arena<T> sa{sm, 1, 0};
  const QPShared<T> sh(sa, tb);
  const int md = tb.mdof, kr = tb.krows;
  const QPIn<T>& d = sh.in;
  T* const src[] = {pre.tg.p, pre.NwJw.p, pre.crow.p,
                    servo ? pre.fstar.p : const_cast<T*>(fsp) + b0,
                    warm_in != nullptr ? const_cast<T*>(warm_in) + b0 : nullptr};
  T* const dst[] = {d.tg.p, d.NwJw.p, d.crow.p, d.fstar.p, sh.warm.p};
  const int cnt[] = {md, md * (tb.cfree + tb.tsum()) + kr * md + kr,   // NwJw … bA0
                     tb.masked ? kr + 1 : 0,                           // crow, acdof
                     tb.tsum(), warm_in != nullptr ? (int)warm_elems(tb) : 0};
  for (int f = 0; f < 5; ++f)
    if (cnt[f] > 0) stage(dst[f], src[f], cnt[f], true, S, B, nw, W, tid, nthr);
}

// The block's results and warm state out of shared memory.
template <typename T>
DWBC_HD void qpchain_stage_out(const Tab<T>& tb, T* outp, T* warm_out, T* sm, long long S,
                               long long B, long long b0, int nw, int W, int tid, int nthr) {
  Arena<T> sa{sm, 1, 0};
  const QPShared<T> sh(sa, tb);
  stage(sh.out.tg.p, outp + b0, (int)out_elems(tb), false, S, B, nw, W, tid, nthr);
  stage(sh.warm.p, warm_out + b0, (int)warm_elems(tb), false, S, B, nw, W, tid, nthr);
}

// min ½xᵀdiag(H)x s.t. Cx ≤ d, H = 1 on the first nt variables and 0 on
// the rest (ipm.cuh), then the primal residual (an exact max over the
// lanes) and the normalized complementarity gap (fixed_sum), the same on
// every lane.  x and lam are the warm state in and the solution out.
template <typename T>
DWBC_HD void ipm(const QPWS<T>& w, V<T> x, V<T> lam, int n, int nt, int me,
                 int mr, int iters, bool warm, T& gap, T& pres, Lanes wp) {
  const T ridge = sizeof(T) == 4 ? (T)1e-6 : (T)1e-9;
  const int m = me + mr;
  ipm_iterate<T>(w, M<T>{nullptr, 0, 0}, V<T>{nullptr, 0}, x, lam, n, nt, me,
                 mr, iters, warm, ridge, wp);
  cx_full<T>(w, x, w.tmp, n, me, mr, wp);
  T p = 0;
  for (int r = wp.lane; r < m; r += wp.nl) p = vmax(p, clamp_min(w.tmp[r] - w.d[r], (T)0));
  pres = wp.reduce(p, MaxOp{});
  gap = fixed_sum<T>([&](int r) {
          return fabs(w.d[r] - w.tmp[r]) * (lam[r] / ((T)1 + lam[r]));
        }, m, wp) / (T)m;
  wp.sync();
}

// Constraint rows of one QP: C = [blk; −Atemp·blk], d = [τlim − τ;
// τlim + τ; Atemp·τ − bA0] with τ = w.tau_base; without a torque limit
// (Lim false) C = −Atemp·blk, d = Atemp·τ − bA0, with blk stored below
// those rows (the IPM reads C's first krows rows); masked: a row whose
// crow_mask is 0 becomes 0·x ≤ 1.  The lanes split the entries.  blk sits
// at row blk_row<Lim>.
template <bool Lim, typename T>
DWBC_HDI int blk_row(const Tab<T>& tb) { return Lim ? 0 : tb.krows; }

template <bool Lim, typename T>
DWBC_HD void build_rows(const Tab<T>& tb, const QPWS<T>& w, const QPIn<T>& in, int nv,
                        Lanes wp) {
  const int md = tb.mdof, mr = Lim ? md : 0, b0 = blk_row<Lim>(tb), d0 = Lim ? md : 0;
  for (int e = wp.lane; e < tb.krows * nv; e += wp.nl) {
    const int r = e / nv, c = e % nv;
    const T cr = tb.masked ? in.crow[r] : (T)1;
    T acc = in.Atemp(r, 0) * w.C(b0, c);
    for (int i = 1; i < md; ++i) acc += in.Atemp(r, i) * w.C(b0 + i, c);
    w.C(d0 + r, c) = tb.masked ? -acc * cr : -acc;
  }
  for (int r = wp.lane; r < tb.krows; r += wp.nl) {
    const T cr = tb.masked ? in.crow[r] : (T)1;
    T acc = in.Atemp(r, 0) * w.tau_base[0];
    for (int i = 1; i < md; ++i) acc += in.Atemp(r, i) * w.tau_base[i];
    w.d[2 * mr + r] = cr > (T)0.5 ? acc - in.bA0[r] : (T)1;
  }
  for (int i = wp.lane; i < mr; i += wp.nl) {
    w.d[i] = tb.tlim[i] - w.tau_base[i];
    w.d[md + i] = tb.tlim[i] + w.tau_base[i];
  }
  wp.sync();
}

// The chain of one scenario on its shared working set sh; pg is the
// scenario's view of the prestage buffer in device memory (J̄ᵀ, P_C, the
// health), read once.  QP h < nlev is task level h (n = lev_t(h) + cfree,
// H = 1 on the task block), QP nlev the contact redistribution (n = cfree,
// H = 1; only where cfree > 0): one loop, so the IPM is compiled once for
// each of Lim (a torque limit: mirrored ±τ rows) true and false, and the
// row offsets of a plan with a limit are what they were before plans
// without one were taken.
template <bool Lim, typename T>
DWBC_HD void qpchain_warp_lim(const Tab<T>& tb, const QPShared<T>& sh, const Pre<T>& pg,
                              int iters, bool warm, Lanes wp) {
  const int md = tb.mdof, cf = tb.cfree, mr = Lim ? md : 0, me = mr + tb.krows,
            m = 2 * mr + tb.krows, b0 = blk_row<Lim>(tb);
  const QPIn<T>& in = sh.in;
  const QPWS<T>& w = sh.w;
  const Out<T>& out = sh.out;

  for (int i = wp.lane; i < md; i += wp.nl) {
    w.tau_task[i] = (T)0;
    w.tau_contact[i] = (T)0;
  }
  T gap = 0, pres = 0;
  int foff = 0, woff = 0;
  for (int h = 0; h < tb.nqp(); ++h) {
    const bool redis = h == tb.nlev;
    const int t = redis ? 0 : tb.lev_t(h), nv = t + cf;
    const M<T> Nt{in.Nt.p + (long long)md * foff, 1, t};
    const V<T> f = in.fstar.at(foff);
    for (int i = wp.lane; i < md; i += wp.nl) {
      if (redis) {
        w.tau_base[i] = (in.tg[i] + w.tau_task[i]) + w.tau_contact[i];
      } else {
        T acc = Nt(i, 0) * f[0];
        for (int c = 1; c < t; ++c) acc += Nt(i, c) * f[c];
        w.tau_base[i] = (in.tg[i] + w.tau_task[i]) + acc;
      }
      for (int c = 0; c < nv; ++c) w.C(b0 + i, c) = c < t ? Nt(i, c) : in.NwJw(i, c - t);
    }
    wp.sync();
    build_rows<Lim>(tb, w, in, nv, wp);
    const V<T> x = sh.warm.at(woff), lam = sh.warm.at(woff + nv);
    T g, p;
    ipm(w, x, lam, nv, redis ? cf : t, me, mr, iters, warm, g, p, wp);
    for (int i = wp.lane; i < md; i += wp.nl) {
      if (!redis) {
        T acc = Nt(i, 0) * (f[0] + x[0]);
        for (int c = 1; c < t; ++c) acc += Nt(i, c) * (f[c] + x[c]);
        w.tau_task[i] = w.tau_task[i] + acc;
      }
      if (cf > 0) {
        T tc = in.NwJw(i, 0) * x[t];
        for (int c = 1; c < cf; ++c) tc += in.NwJw(i, c) * x[t + c];
        w.tau_contact[i] = redis ? w.tau_contact[i] + tc : tc;
      }
    }
    if (redis && tb.masked) {  // no redistribution problem unless active_cdof > 6
      const T live = in.acdof[0] > (T)6.5 ? (T)1 : (T)0;
      g = g * live;
      p = p * live;
    }
    gap = vmax(gap, g);
    pres = vmax(pres, p);
    foff += t;
    woff += nv + m;
    wp.sync();
  }

  for (int i = wp.lane; i < md; i += wp.nl) {
    out.tg[i] = in.tg[i];
    out.tt[i] = w.tau_task[i];
    out.tc[i] = w.tau_contact[i];
    out.tcmd[i] = (in.tg[i] + w.tau_task[i]) + w.tau_contact[i];
  }
  wp.sync();
  for (int r = wp.lane; r < tb.cdof; r += wp.nl) {
    T acc = pg.Jbar_act(r, 0) * out.tcmd[0];
    for (int i = 1; i < md; ++i) acc += pg.Jbar_act(r, i) * out.tcmd[i];
    out.cforce[r] = acc - pg.PC[r];
  }
  if (wp.lane == 0) {
    out.gap[0] = gap;
    out.pres[0] = pres;
    out.health[0] = pg.health[0];
  }
  wp.sync();
}

template <typename T>
DWBC_HD void qpchain_warp(const Tab<T>& tb, const QPShared<T>& sh, const Pre<T>& pg, int iters,
                          bool warm, Lanes wp) {
  if (tb.lim)
    qpchain_warp_lim<true>(tb, sh, pg, iters, warm, wp);
  else
    qpchain_warp_lim<false>(tb, sh, pg, iters, warm, wp);
}

}  // namespace dwbc

extern "C" long long dwbc_qpchain_smem_elems(const float* table_host) {
  return dwbc::qpchain_smem_elems(dwbc::Tab<float>(table_host));
}

extern "C" long long dwbc_out_elems(const float* table_host) {
  return dwbc::out_elems(dwbc::Tab<float>(table_host));
}

extern "C" long long dwbc_warm_elems(const float* table_host) {
  return dwbc::warm_elems(dwbc::Tab<float>(table_host));
}

#ifdef __CUDACC__
// Four blocks per SM: ptxas then keeps the kernel within 128 registers
// without spills.  Left free it took 168 and three blocks, 2-5% faster on
// the flagship at B = 1024 and B = 1 but 27% slower on the masked sweep at
// B = 4096 (bit for bit the same results either way; NVIDIA H100 80GB
// HBM3, 700 W).  One kernel per Lim (a torque limit or none): one kernel
// holding both chains spilled at that bound and ran the flagship 21%
// slower.  A table whose limit flag is not Lim is left alone (the wrapper
// picks the kernel by the plan).
template <bool Lim>
__global__ void __launch_bounds__(32 * dwbc::kQPWarps, 4)
    tick_qpchain_kernel(const float* table, const float* pre, const float* fs,
                        const float* warm_in, float* out, float* warm_out, int B, int iters,
                        int S) {
  extern __shared__ float sm[];
  constexpr int W = dwbc::kQPWarps;
  const dwbc::Tab<float> tb(table);
  if (tb.lim != Lim) return;
  const long long b0 = (long long)blockIdx.x * W;
  const int nw = B - b0 < W ? (int)(B - b0) : W;
  dwbc::qpchain_stage_in(tb, pre, fs, warm_in, sm, S, B, b0, nw, W, threadIdx.x, blockDim.x);
  __syncthreads();
  const int w = threadIdx.x / 32;
  if (w < nw) {
    dwbc::Arena<float> pa{const_cast<float*>(pre) + b0 + w, B, 0};
    const dwbc::Pre<float> pg(pa, tb, fs == nullptr);
    dwbc::Arena<float> sa{sm + (long long)w * S, 1, 0};
    const dwbc::QPShared<float> sh(sa, tb);
    dwbc::qpchain_warp_lim<Lim>(tb, sh, pg, iters, warm_in != nullptr,
                                dwbc::Lanes{(int)threadIdx.x % 32, 32, nullptr});
  }
  __syncthreads();
  dwbc::qpchain_stage_out(tb, out, warm_out, sm, S, B, b0, nw, W, threadIdx.x, blockDim.x);
}

static size_t qpchain_smem_bytes(int S) { return sizeof(float) * dwbc::kQPWarps * (size_t)S; }

// Allow the dynamic shared memory of S elements per scenario (once per
// size the process has seen grow, per kernel).
template <bool Lim>
static cudaError_t qpchain_allow_smem(int S) {
  static size_t allowed = 48 * 1024;
  const size_t bytes = qpchain_smem_bytes(S);
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(tick_qpchain_kernel<Lim>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess) allowed = bytes;
  return rc;
}

template <bool Lim>
static int qpchain_launch(const float* table, const float* pre, const float* fs,
                          const float* warm_in, float* out, float* warm_out, int S, int B,
                          int iters, void* stream) {
  if (cudaError_t rc = qpchain_allow_smem<Lim>(S)) return (int)rc;
  const int blocks = (B + dwbc::kQPWarps - 1) / dwbc::kQPWarps;
  tick_qpchain_kernel<Lim><<<blocks, 32 * dwbc::kQPWarps, qpchain_smem_bytes(S),
                             (cudaStream_t)stream>>>(table, pre, fs, warm_in, out, warm_out, B,
                                                     iters, S);
  return (int)cudaGetLastError();
}

// pre (pre_elems, B), fs (Σ task dofs, B), or fs null and pre (pre_elems
// with the servo section, B) for a servo'd tick, warm_in (warm_elems, B) or
// null for a cold tick, out (out_elems, B), warm_out (warm_elems, B):
// float32, contiguous, on the device; S = dwbc_qpchain_smem_elems of the
// table; launched on `stream`, no synchronisation.  A plan with a torque
// limit; dwbc_tick_qpchain_nolim takes the same arguments for a plan
// without one.
extern "C" int dwbc_tick_qpchain(const float* table, const float* pre,
                                 const float* fs, const float* warm_in,
                                 float* out, float* warm_out, int S, int B,
                                 int iters, void* stream) {
  return qpchain_launch<true>(table, pre, fs, warm_in, out, warm_out, S, B, iters, stream);
}

extern "C" int dwbc_tick_qpchain_nolim(const float* table, const float* pre,
                                       const float* fs, const float* warm_in,
                                       float* out, float* warm_out, int S, int B,
                                       int iters, void* stream) {
  return qpchain_launch<false>(table, pre, fs, warm_in, out, warm_out, S, B, iters, stream);
}

// The kernel's resources at S elements per scenario (dwbc::kernel_info),
// with a torque limit and without.
extern "C" int dwbc_tick_qpchain_info(int S, int* out) {
  if (cudaError_t rc = qpchain_allow_smem<true>(S)) return (int)rc;
  return dwbc::kernel_info(tick_qpchain_kernel<true>, 32 * dwbc::kQPWarps,
                           qpchain_smem_bytes(S), out);
}

extern "C" int dwbc_tick_qpchain_nolim_info(int S, int* out) {
  if (cudaError_t rc = qpchain_allow_smem<false>(S)) return (int)rc;
  return dwbc::kernel_info(tick_qpchain_kernel<false>, 32 * dwbc::kQPWarps,
                           qpchain_smem_bytes(S), out);
}
#endif
