// qp_solve: B one-sided QPs  min ½xᵀHx + gᵀx  s.t.  Cx ≤ d, one warp per
// problem.
//
// Replaces the TPU kernel libdwbc_tpu/ops/pallas_qp.py::pallas_qp_solve
// (_make_kernel): a fixed-iteration Mehrotra predictor-corrector IPM with
// dense H, a linear term g, an optional warm (x0, λ0) and the mirror fold
// (C = [B; −B; D], the first `mirror` rows mirrored; only [B; D] is read).
// Its semantics are the Pallas kernel's, not ops/qp.py's XLA loop: warm
// floors 1e-4 whatever the dtype, the ridge added in the H mat-vec and on
// the Gram diagonal, a step skipped when dx is not finite, constants by
// dtype; in float32, the tick IPM's rule for a lost Gram pivot (ipm.cuh).
// The iterations are csrc/ipm.cuh, shared with tick_qpchain.
//
// Mapping: W problems per block, a warp each, W = min(4, the problems whose
// working set fits the block's 227 KB of shared memory): 4 at every shape
// the port's ticks route, 2 or 3 at the largest taken (n = 24, m = 512,
// without or with 33 mirrored pairs).  A warp
// copies its problem from the batch-major inputs, as torch holds them (H
// (B,n,n), g (B,n), C (B,m,n), d (B,m), x0 (B,n), λ0 (B,m)), into shared
// memory with coalesced loads (the stored rows [B; D] of C are two
// contiguous runs), runs the IPM there (ipm.cuh: the lanes split the
// stored rows, the Gram's entries and the m-vectors; every value is the
// one lane's of any lane count), and writes x (B,n), s (B,m), λ (B,m) back
// batch-major.  The working set, 2n² + n + me·(n|1) + 11m + 6n floats (7.8
// KB at the tick's n = 12, m = 86, 33 mirrored rows), is all a problem
// touches after the copy.
//
// What bounds it on the H100: per iteration one Gram matrix (n²/2·me FMAs)
// and one n×n Cholesky, in a chain of warp phases on shared memory (about
// 40 barriers per iteration; the triangular solves column by column across
// the lanes and μ as 32 partials and a tree, ipm.cuh): the latency of that
// chain at small batches, the SM's instruction throughput once every SM
// holds its blocks; not the bytes (a few KB per problem) nor the card's
// FLOP rate.
#include "ipm.cuh"

namespace dwbc {

constexpr int kQPSolveWarps = 4;              // problems per block at most
constexpr long long kSmemOptin = 232448;      // shared bytes a block may opt into (sm_90)

// One problem's working set: the IPM's (C's stored rows, L, the m- and
// n-vectors), H, g and the iterate (x, λ).
template <typename T>
struct QPSolveSM : IPMWS<T> {
  M<T> H;
  V<T> g, x, lam;
  DWBC_HD QPSolveSM(Arena<T>& a, int n, int m, int mr) : IPMWS<T>(a, n, m - mr, m) {
    H = a.mat(n, n);
    g = a.vec(n);
    x = a.vec(n);
    lam = a.vec(m);
  }
};

// Shared elements of one problem.
template <typename T>
DWBC_HD long long qp_solve_smem_elems(int n, int m, int mr) {
  Arena<T> a{nullptr, 1, 0};
  QPSolveSM<T> w(a, n, m, mr);
  return a.off;
}

// Problems per block of the float kernel: 0 where one does not fit.
inline int qp_solve_warps(int n, int m, int mr) {
  const long long fit =
      kSmemOptin / (long long)(sizeof(float) * qp_solve_smem_elems<float>(n, m, mr));
  return fit < kQPSolveWarps ? (int)fit : kQPSolveWarps;
}

// One problem by the lanes of wp: inputs and outputs point at its rows of
// the batch-major tensors (x0p, lam0p null for a cold solve), sm at its
// qp_solve_smem_elems of scratch.
template <typename T>
DWBC_HD void qp_solve_warp(const T* Hp, const T* gp, const T* Cp, const T* dp, const T* x0p,
                           const T* lam0p, T* xp, T* sp, T* lamp, T* sm, int n, int m, int mr,
                           int iters, T ridge, Lanes wp) {
  Arena<T> a{sm, 1, 0};
  const QPSolveSM<T> w(a, n, m, mr);
  const int me = m - mr;
  for (int e = wp.lane; e < n * n; e += wp.nl) w.H.p[e] = Hp[e];
  for (int i = wp.lane; i < n; i += wp.nl) w.g[i] = gp[i];
  for (int e = wp.lane; e < me * n; e += wp.nl) {   // stored rows [B; D]: skip −B
    const int r = e / n;
    w.C(r, e - r * n) = Cp[r < mr ? e : e + mr * n];
  }
  for (int r = wp.lane; r < m; r += wp.nl) w.d[r] = dp[r];
  const bool warm = x0p != nullptr;
  if (warm) {
    for (int i = wp.lane; i < n; i += wp.nl) w.x[i] = x0p[i];
    for (int r = wp.lane; r < m; r += wp.nl) w.lam[r] = lam0p[r];
  }
  wp.sync();
  ipm_iterate<T>(w, w.H, w.g, w.x, w.lam, n, n, me, mr, iters, warm, ridge, wp);
  for (int i = wp.lane; i < n; i += wp.nl) xp[i] = w.x[i];
  for (int r = wp.lane; r < m; r += wp.nl) {
    sp[r] = w.s[r];
    lamp[r] = w.lam[r];
  }
}

}  // namespace dwbc

extern "C" long long dwbc_qp_solve_smem_elems(int n, int m, int mr) {
  return dwbc::qp_solve_smem_elems<float>(n, m, mr);
}

#ifdef __CUDACC__
// Four blocks of 128 threads per SM: at most 128 registers a thread.
__global__ void __launch_bounds__(32 * dwbc::kQPSolveWarps, 4)
    qp_solve_kernel(const float* H, const float* g, const float* C, const float* d,
                    const float* x0, const float* lam0, float* x, float* s, float* lam, int B,
                    int n, int m, int mr, int iters, float ridge, int S) {
  extern __shared__ float sm[];
  const int w = threadIdx.x / 32;
  const long long b = (long long)blockIdx.x * (blockDim.x / 32) + w;
  if (b >= B) return;                              // whole warps only
  const long long bn = b * n, bm = b * m;
  dwbc::qp_solve_warp<float>(H + bn * n, g + bn, C + bm * n, d + bm, x0 ? x0 + bn : nullptr,
                             lam0 ? lam0 + bm : nullptr, x + bn, s + bm, lam + bm,
                             sm + (long long)w * S, n, m, mr, iters, ridge,
                             dwbc::Lanes{(int)threadIdx.x % 32, 32, nullptr});
}

// Dynamic shared memory up to what a block may opt into.
static cudaError_t qp_allow_smem() {
  static cudaError_t rc = cudaFuncSetAttribute(
      qp_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dwbc::kSmemOptin);
  return rc;
}

// H (B,n,n), g (B,n), C (B,m,n), d (B,m), x0 (B,n) and lam0 (B,m) or both
// null for a cold solve, x (B,n), s (B,m), lam (B,m): float32, contiguous,
// on the device; the shapes that ops/qp_cuda.py::kernel_takes accepts;
// launched on `stream`, no synchronisation.
extern "C" int dwbc_qp_solve(const float* H, const float* g, const float* C,
                             const float* d, const float* x0, const float* lam0,
                             float* x, float* s, float* lam, int B, int n, int m, int mr,
                             int iters, float ridge, void* stream) {
  const int W = dwbc::qp_solve_warps(n, m, mr);
  if (W < 1) return (int)cudaErrorInvalidValue;
  if (cudaError_t rc = qp_allow_smem()) return (int)rc;
  const int S = (int)dwbc::qp_solve_smem_elems<float>(n, m, mr);
  const int blocks = (B + W - 1) / W;
  qp_solve_kernel<<<blocks, 32 * W, sizeof(float) * W * S, (cudaStream_t)stream>>>(
      H, g, C, d, x0, lam0, x, s, lam, B, n, m, mr, iters, ridge, S);
  return (int)cudaGetLastError();
}

// The kernel's resources at the launch shape of (n, m, mr)
// (dwbc::kernel_info; threads per block = 32 × the problems per block).
extern "C" int dwbc_qp_solve_info(int n, int m, int mr, int* out) {
  const int W = dwbc::qp_solve_warps(n, m, mr);
  if (W < 1) return (int)cudaErrorInvalidValue;
  if (cudaError_t rc = qp_allow_smem()) return (int)rc;
  return dwbc::kernel_info(qp_solve_kernel, 32 * W,
                           sizeof(float) * W * dwbc::qp_solve_smem_elems<float>(n, m, mr), out);
}
#endif
