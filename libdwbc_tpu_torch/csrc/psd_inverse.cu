// psd_inverse: the inverses of B symmetric positive-definite n×n matrices,
// one warp per matrix.
//
// Replaces the TPU kernel libdwbc_tpu/ops/pallas_linalg.py::
// pallas_psd_inverse (_make_kernel): Cholesky of the lower triangle with
// pivots clamped at 1e-30 → L⁻¹ by forward substitution → L⁻ᵀL⁻¹, the lower
// triangle computed once and mirrored, so the output is exactly symmetric.
// The routines are csrc/warp_linalg.cuh's (chol_factor, tri_inv_lower,
// ltl_sym, which tick_prestage runs per thread for A⁻¹); its pivot is one
// rsqrt, where the Pallas kernel takes sqrt and then 1/d — the two differ
// by float32 rounding only.
//
// Layout: A and the output are batch-major (B,n,n), as torch holds them.
// A warp reads its matrix's n² contiguous floats (coalesced) and keeps the
// lower triangle as L in shared memory; L, L⁻¹ (rows padded to n + 1 words
// against bank conflicts) and the reciprocal diagonal are the whole working
// set, 2n(n+1) + n floats (12.6 KB at n = 39).  The result is formed in L's
// place and written back as n² contiguous floats.  kPsdWarps matrices share
// a block, so B = 1 launches one block and B = 4096 some thousand.
//
// What bounds it on the H100: about n³ FLOP per matrix, but in a chain of
// n dependent columns (the Cholesky's two warp barriers per column) and,
// for L⁻¹, one lane's column of up to n²/2 dependent FMAs on shared memory;
// not the bytes (n² read and n² written per matrix) nor the FLOP rate.
#include "warp_linalg.cuh"

namespace dwbc {

constexpr int kPsdWarps = 4;   // matrices per block

// Shared-memory floats of one matrix: L and L⁻¹ with rows of n + 1, and
// the reciprocal diagonal.
DWBC_HDI long long psd_inverse_smem_elems(int n) { return 2LL * n * (n + 1) + n; }

// out = A⁻¹ for one matrix; A and out point at its n² floats, sm at its
// psd_inverse_smem_elems(n) of scratch; the lanes of wp share it.
template <typename T>
DWBC_HD void psd_inverse_warp(const T* A, T* out, T* sm, int n, Lanes wp) {
  const M<T> L{sm, 1, n + 1}, X{sm + (long long)n * (n + 1), 1, n + 1};
  const V<T> idg{sm + 2LL * n * (n + 1), 1};
  for (int e = wp.lane; e < n * n; e += wp.nl) {
    const int i = e / n, j = e % n;
    if (j <= i) L(i, j) = A[e];
  }
  wp.sync();
  chol_factor(L, idg, n, wp);
  tri_inv_lower(X, L, idg, n, wp);
  ltl_sym(L, X, n, wp);                            // L is dead: the result
  for (int e = wp.lane; e < n * n; e += wp.nl) out[e] = L(e / n, e % n);
}

}  // namespace dwbc

#ifdef __CUDACC__
__global__ void __launch_bounds__(32 * dwbc::kPsdWarps)
    psd_inverse_kernel(const float* A, float* out, int B, int n) {
  extern __shared__ float sm[];
  const int w = threadIdx.x / 32;
  const long long b = (long long)blockIdx.x * dwbc::kPsdWarps + w;
  if (b >= B) return;                              // whole warps only
  const long long off = b * n * n;
  dwbc::psd_inverse_warp<float>(A + off, out + off, sm + w * dwbc::psd_inverse_smem_elems(n), n,
                                dwbc::Lanes{(int)threadIdx.x % 32, 32, nullptr});
}

static size_t psd_smem_bytes(int n) {
  return sizeof(float) * dwbc::kPsdWarps * dwbc::psd_inverse_smem_elems(n);
}

// Dynamic shared memory up to the largest n taken (~134 KB at n = 64).
static cudaError_t psd_allow_smem() {
  static cudaError_t rc = cudaFuncSetAttribute(
      psd_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)psd_smem_bytes(64));
  return rc;
}

// A (B,n,n), out (B,n,n): float32, contiguous, on the device, 16 <= n <=
// 64; launched on `stream`, no synchronisation.
extern "C" int dwbc_psd_inverse(const float* A, float* out, int B, int n, void* stream) {
  if (n > 64) return (int)cudaErrorInvalidValue;
  if (cudaError_t rc = psd_allow_smem()) return (int)rc;
  const int blocks = (B + dwbc::kPsdWarps - 1) / dwbc::kPsdWarps;
  psd_inverse_kernel<<<blocks, 32 * dwbc::kPsdWarps, psd_smem_bytes(n), (cudaStream_t)stream>>>(
      A, out, B, n);
  return (int)cudaGetLastError();
}

// The kernel's resources at this n (dwbc::kernel_info).
extern "C" int dwbc_psd_inverse_info(int n, int* out) {
  if (cudaError_t rc = psd_allow_smem()) return (int)rc;
  return dwbc::kernel_info(psd_inverse_kernel, 32 * dwbc::kPsdWarps, psd_smem_bytes(n), out);
}
#endif
