// The lanes that cooperate on one problem, and the dense factorisations
// they share: the right-looking Cholesky, the lower-triangular inverse and
// L⁻ᵀL⁻¹ (psd_inverse, and tick_prestage's per-thread A⁻¹).
//
// A problem is processed by nl lanes.  Every parallel loop is
// `for (e = lane; e < count; e += nl)`, a phase ends with sync(), and a
// reduction goes through reduce().  On the device nl is 32 (a warp: sync is
// __syncwarp, reduce a __shfl_xor_sync butterfly) or 1 (one thread: both do
// nothing).  On the host nl is 1, or any count up to kHostLanes when a test
// runs the lanes as threads of a HostWarp (a barrier and an exchange slot
// per lane).  With nl = 1 the code is the per-thread code, so one source
// serves the warp kernels, the per-thread ones and the host compiler.
//
// Work is split over *outputs*, never over a sum: every element receives the
// same operations in the same order whatever nl is, so the results do not
// depend on it.
#pragma once

#include "tick_common.cuh"

namespace dwbc {

constexpr int kHostLanes = 64;

// Host emulation of nl > 1 lanes (tests): `barrier` returns once all nl
// lanes have called it; `slot` carries one value per lane in reduce().
struct HostWarp {
  void (*barrier)(HostWarp*);
  double slot[kHostLanes];
};

struct Lanes {
  int lane, nl;
  HostWarp* host;   // nl > 1 on the host only; unused on the device

  DWBC_HDI void sync() const {
#ifdef __CUDA_ARCH__
    if (nl > 1) __syncwarp();
#else
    if (nl > 1) host->barrier(host);
#endif
  }

  // op over the lanes' values, the same result on every lane.  For the
  // exact, order-free ops below (min, NaN-sticky max) only.
  template <typename T, typename Op>
  DWBC_HDI T reduce(T v, Op op) const {
    if (nl == 1) return v;
#ifdef __CUDA_ARCH__
    for (int o = 16; o >= 1; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
#else
    host->slot[lane] = (double)v;
    sync();
    T r = (T)host->slot[0];
    for (int l = 1; l < nl; ++l) r = op(r, (T)host->slot[l]);
    sync();
    return r;
#endif
  }
};

DWBC_HDI Lanes one_lane() { return Lanes{0, 1, nullptr}; }

struct MinOp {       // as vmin: a NaN second operand is dropped
  template <typename T> DWBC_HDI T operator()(T a, T b) const { return vmin(a, b); }
};
struct NanMaxOp {    // max that keeps a NaN once one is seen (torch's amax)
  template <typename T> DWBC_HDI T operator()(T a, T b) const {
    if (isnan(a)) return a;
    if (isnan(b)) return b;
    return b > a ? b : a;
  }
};

// Row-major walks over a triangle, for lanes that split its entries: the
// entry `step` places after (i, k), within rows of the given shapes.
// Lower triangle below column j: row i holds k = j+1..i.
DWBC_HDI void walk_trailing(int& i, int& k, int j, int step) {
  k += step;
  while (k > i) {
    k -= i - j;
    ++i;
  }
}

// Upper triangle of an n×n matrix: row i holds j = i..n−1.
DWBC_HDI void walk_upper(int& i, int& j, int n, int step) {
  j += step;
  while (j >= n && i < n) {
    j -= n - i - 1;
    ++i;
  }
}
// Lower triangle: row i holds j = 0..i.
DWBC_HDI void walk_lower(int& i, int& j, int step) {
  j += step;
  while (j > i) {
    j -= i + 1;
    ++i;
  }
}

// The trailing update of a right-looking Cholesky at column j:
// L[i,k] −= L[i,j]·L[k,j] for j < k ≤ i < n, the lanes splitting the
// entries row-major (walk_trailing), L[i,j] read once per row and lane.
template <typename T>
DWBC_HDI void chol_trailing(M<T> L, int j, int n, Lanes wp) {
  int i = j + 1, k = j + 1;
  walk_trailing(i, k, j, wp.lane);
  while (i < n) {
    const T li = L(i, j);
    for (; k <= i; k += wp.nl) L(i, k) = L(i, k) - li * L(k, j);
    walk_trailing(i, k, j, 0);
  }
}

// In-place right-looking Cholesky of the lower triangle of L (n×n), one
// rsqrt per column, pivots clamped at 1e-30; idg gets the reciprocal
// diagonal and the stored diagonal is S_jj·rsqrt(max(S_jj, 1e-30)).  The
// strict upper triangle is zeroed.  Per column: every lane takes the pivot;
// the lanes scale the rows below it; then they split the trailing lower
// triangle while lane 0 writes the diagonal (read by no lane of that phase)
// and zeroes the column above it.
template <typename T>
DWBC_HD void chol_factor(M<T> L, V<T> idg, int n, Lanes wp = one_lane()) {
  for (int j = 0; j < n; ++j) {
    const T inv_d = rsqrt_(clamp_min(L(j, j), (T)1e-30));
    for (int i = j + 1 + wp.lane; i < n; i += wp.nl) L(i, j) = L(i, j) * inv_d;
    wp.sync();
    if (wp.lane == 0) {
      L(j, j) = L(j, j) * inv_d;
      idg[j] = inv_d;
      for (int i = 0; i < j; ++i) L(i, j) = (T)0;
    }
    chol_trailing(L, j, n, wp);
    wp.sync();
  }
}

// X = L⁻¹ for lower-triangular L with reciprocal diagonal idg (n³/6 FMAs):
// X[j,j] = idg[j];  X[i,j] = −(Σ_{k=j..i−1} L[i,k]·X[k,j])·idg[i].
// Columns are independent: each lane takes whole columns.
template <typename T>
DWBC_HD void tri_inv_lower(M<T> X, M<T> L, V<T> idg, int n, Lanes wp = one_lane()) {
  for (int j = wp.lane; j < n; j += wp.nl) {
    for (int i = 0; i < j; ++i) X(i, j) = (T)0;
    X(j, j) = idg[j];
    for (int i = j + 1; i < n; ++i) {
      T acc = L(i, j) * X(j, j);
      for (int k = j + 1; k < i; ++k) acc += L(i, k) * X(k, j);
      X(i, j) = -acc * idg[i];
    }
  }
  wp.sync();
}

// C = XᵀX for lower-triangular X; C[i,j] = Σ_{k ≥ max(i,j)} X[k,i]·X[k,j].
// The lanes split the n(n+1)/2 entries i ≤ j; each sum stays in order.
template <typename T>
DWBC_HD void ltl_sym(M<T> C, M<T> X, int n, Lanes wp = one_lane()) {
  int i = 0, j = 0;
  for (walk_upper(i, j, n, wp.lane); i < n; walk_upper(i, j, n, wp.nl)) {
    T acc = X(j, i) * X(j, j);
    for (int k = j + 1; k < n; ++k) acc += X(k, i) * X(k, j);
    C(i, j) = acc;
    C(j, i) = acc;
  }
  wp.sync();
}

}  // namespace dwbc
