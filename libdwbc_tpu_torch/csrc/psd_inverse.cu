// psd_inverse: the inverses of B symmetric positive-definite n×n matrices,
// one thread per matrix.
//
// Replaces the TPU kernel libdwbc_tpu/ops/pallas_linalg.py::
// pallas_psd_inverse (_make_kernel): Cholesky of the lower triangle with
// pivots clamped at 1e-30 → L⁻¹ by forward substitution → L⁻ᵀL⁻¹, the lower
// triangle computed once and mirrored, so the output is exactly symmetric.
// The lane code is csrc/elemlin.cuh's (chol_factor, tri_inv_lower, ltl_sym,
// the same routines tick_prestage runs for A⁻¹); its pivot is one rsqrt,
// where the Pallas kernel takes sqrt and then 1/d — the two differ by
// float32 rounding only.
//
// Layout: A and the output are batch-major (B,n,n), as torch holds them;
// only the lower triangle of A is read.  L and L⁻¹ live in an
// element-leading [elem][B] workspace (2n² + n floats per matrix), so the
// factorisation's loads are coalesced across the warp.
//
// What bounds it on the H100: about n³ FLOP per matrix (n³/3 each for the
// Cholesky, L⁻¹ and L⁻ᵀL⁻¹), serial within the thread: at n = 33-39 the
// latency of that dependent chain, not the bytes moved (n(n+1)/2 read and n²
// written per matrix) nor the FLOP rate.  Blocks are one warp.
#include "elemlin.cuh"

namespace dwbc {

template <typename T>
DWBC_HD void psd_inverse_lane(const T* Ap, T* outp, T* wsp, long long B, int n) {
  Arena<T> a{wsp, B, 0};
  M<T> L = a.mat(n, n), X = a.mat(n, n);
  V<T> idg = a.vec(n);
  const M<T> A{const_cast<T*>(Ap), 1, n};
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j) L(i, j) = A(i, j);
  chol_factor(L, idg, n);
  tri_inv_lower(X, L, idg, n);
  ltl_sym(M<T>{outp, 1, n}, X, n);
}

}  // namespace dwbc

// Workspace elements per matrix: L, L⁻¹ and the reciprocal diagonal.
extern "C" long long dwbc_psd_inverse_ws_elems(int n) { return 2LL * n * n + n; }

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
    psd_inverse_kernel(const float* A, float* out, float* ws, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long off = (long long)b * n * n;
  dwbc::psd_inverse_lane<float>(A + off, out + off, ws + b, (long long)B, n);
}

// A (B,n,n), out (B,n,n), ws (psd_inverse_ws_elems, B): float32,
// contiguous, on the device; launched on `stream`, no synchronisation.
extern "C" int dwbc_psd_inverse(const float* A, float* out, float* ws, int B,
                                int n, void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  psd_inverse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(A, out, ws, B, n);
  return (int)cudaGetLastError();
}
#endif
