// qp_solve: B one-sided QPs  min ½xᵀHx + gᵀx  s.t.  Cx ≤ d, one thread per
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
// Layout: the inputs are batch-major, as torch holds them (H (B,n,n), g
// (B,n), C (B,m,n), d (B,m), x0 (B,n), λ0 (B,m)); each thread copies its
// problem once into an element-leading [elem][B] workspace, so that the
// iterations' loads are coalesced across the warp, and writes x (B,n),
// s (B,m), λ (B,m) batch-major.
//
// What bounds it on the H100: per iteration one Gram matrix (n²/2·me FMAs)
// and one n×n Cholesky, serial within the thread: at the tick's shapes
// (n ≤ 12, m = 86, 7-12 iterations) the latency of one thread's chain of
// dependent loads and FMAs, not the bytes (a few KB per problem) nor the
// card's FLOP rate.  Blocks are one warp; the IPM runs with one lane per
// problem (tick_qpchain runs the same code with a warp per problem).
#include "ipm.cuh"

namespace dwbc {

template <typename T>
struct QPSolveWS : IPMWS<T> {
  M<T> H;
  V<T> g;
  DWBC_HD QPSolveWS(Arena<T>& a, int n, int m, int mr)
      : IPMWS<T>(a, n, m - mr, m) {
    H = a.mat(n, n);
    g = a.vec(n);
  }
};

template <typename T>
DWBC_HD void qp_solve_lane(const T* Hp, const T* gp, const T* Cp, const T* dp,
                           const T* x0p, const T* lam0p, T* xp, T* sp, T* lamp,
                           T* wsp, long long B, int n, int m, int mr, int iters,
                           T ridge) {
  Arena<T> a{wsp, B, 0};
  QPSolveWS<T> w(a, n, m, mr);
  const int me = m - mr;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) w.H(i, j) = Hp[i * n + j];
    w.g[i] = gp[i];
  }
  for (int r = 0; r < me; ++r) {                  // stored rows [B; D]
    const T* row = Cp + (long long)(r < mr ? r : r + mr) * n;
    for (int i = 0; i < n; ++i) w.C(r, i) = row[i];
  }
  for (int r = 0; r < m; ++r) w.d[r] = dp[r];
  const bool warm = x0p != nullptr;
  V<T> x{xp, 1}, lam{lamp, 1};
  if (warm) {
    for (int i = 0; i < n; ++i) x[i] = x0p[i];
    for (int r = 0; r < m; ++r) lam[r] = lam0p[r];
  }
  ipm_iterate<T>(w, w.H, w.g, x, lam, n, n, me, mr, iters, warm, ridge, one_lane());
  for (int r = 0; r < m; ++r) sp[r] = w.s[r];
}

template <typename T>
long long qp_solve_ws_elems(int n, int m, int mr) {
  Arena<T> a{nullptr, 0, 0};
  QPSolveWS<T> w(a, n, m, mr);
  return a.off;
}

}  // namespace dwbc

extern "C" long long dwbc_qp_solve_ws_elems(int n, int m, int mr) {
  return dwbc::qp_solve_ws_elems<float>(n, m, mr);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
    qp_solve_kernel(const float* H, const float* g, const float* C, const float* d,
                    const float* x0, const float* lam0, float* x, float* s,
                    float* lam, float* ws, int B, int n, int m, int mr, int iters,
                    float ridge) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long bn = (long long)b * n, bm = (long long)b * m;
  dwbc::qp_solve_lane<float>(H + bn * n, g + bn, C + bm * n, d + bm,
                             x0 ? x0 + bn : nullptr, lam0 ? lam0 + bm : nullptr,
                             x + bn, s + bm, lam + bm, ws + b, (long long)B, n, m,
                             mr, iters, ridge);
}

// H (B,n,n), g (B,n), C (B,m,n), d (B,m), x0 (B,n) and lam0 (B,m) or both
// null for a cold solve, x (B,n), s (B,m), lam (B,m), ws
// (qp_solve_ws_elems, B): float32, contiguous, on the device; launched on
// `stream`, no synchronisation.
extern "C" int dwbc_qp_solve(const float* H, const float* g, const float* C,
                             const float* d, const float* x0, const float* lam0,
                             float* x, float* s, float* lam, float* ws, int B,
                             int n, int m, int mr, int iters, float ridge,
                             void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  qp_solve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      H, g, C, d, x0, lam0, x, s, lam, ws, B, n, m, mr, iters, ridge);
  return (int)cudaGetLastError();
}

// The kernel's resources (dwbc::kernel_info).
extern "C" int dwbc_qp_solve_info(int* out) {
  return dwbc::kernel_info(qp_solve_kernel, 32, 0, out);
}
#endif
