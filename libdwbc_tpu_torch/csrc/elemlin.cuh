// Small dense linear algebra on one scenario's views: the device
// counterparts of ops/elemlin.py (same recurrences, same 1e-30 pivot
// clamps), run by the nl lanes of a Lanes (warp_linalg.cuh): one warp per
// scenario in tick_prestage, one lane or host threads in the tests.
//
// Every routine splits its outputs over the lanes and never a sum, so every
// element receives the same operations in the same order whatever nl is:
// products by entries (row-major, e = lane, lane + nl, ...), the symmetric
// forms by lower-triangle entries (walk_lower), the triangular solves and
// the pseudo-inverse's back substitution by right-hand-side columns.  A
// scalar that is a sequential sum (a Gram-Schmidt column's norm, a dot
// product against it, max |R_ii|) is computed alike by every lane; no
// routine shuffles.  The caller has synced the lanes since it wrote a
// routine's inputs; every routine returns with the lanes synced.  The
// Cholesky, the triangular inverse and L⁻ᵀL⁻¹ are warp_linalg.cuh's.
#pragma once

#include "warp_linalg.cuh"

namespace dwbc {

// C = A·B; A (m×k), B (k×n).  C must not alias A or B.
template <typename T>
DWBC_HD void mm(M<T> C, M<T> A, M<T> B, int m, int k, int n, Lanes wp = one_lane()) {
  for (int e = wp.lane; e < m * n; e += wp.nl) {
    const int i = e / n, j = e - i * n;
    T acc = A(i, 0) * B(0, j);
    for (int t = 1; t < k; ++t) acc += A(i, t) * B(t, j);
    C(i, j) = acc;
  }
  wp.sync();
}

// C = A·Bᵀ; A (m×k), B (n×k).
template <typename T>
DWBC_HD void mmT(M<T> C, M<T> A, M<T> B, int m, int k, int n, Lanes wp = one_lane()) {
  for (int e = wp.lane; e < m * n; e += wp.nl) {
    const int i = e / n, j = e - i * n;
    T acc = A(i, 0) * B(j, 0);
    for (int t = 1; t < k; ++t) acc += A(i, t) * B(j, t);
    C(i, j) = acc;
  }
  wp.sync();
}

// C = Aᵀ·B; A (k×m), B (k×n).
template <typename T>
DWBC_HD void mTm(M<T> C, M<T> A, M<T> B, int k, int m, int n, Lanes wp = one_lane()) {
  for (int e = wp.lane; e < m * n; e += wp.nl) {
    const int i = e / n, j = e - i * n;
    T acc = A(0, i) * B(0, j);
    for (int t = 1; t < k; ++t) acc += A(t, i) * B(t, j);
    C(i, j) = acc;
  }
  wp.sync();
}

// Symmetric results: the lower triangle is computed and mirrored.
// C = A·Bᵀ (m×m); A, B (m×k).
template <typename T>
DWBC_HD void mmT_sym(M<T> C, M<T> A, M<T> B, int m, int k, Lanes wp = one_lane()) {
  int i = 0, j = 0;
  for (walk_lower(i, j, wp.lane); i < m; walk_lower(i, j, wp.nl)) {
    T acc = A(i, 0) * B(j, 0);
    for (int t = 1; t < k; ++t) acc += A(i, t) * B(j, t);
    C(i, j) = acc;
    C(j, i) = acc;
  }
  wp.sync();
}

// C = Aᵀ·B (m×m); A, B (k×m).
template <typename T>
DWBC_HD void mTm_sym(M<T> C, M<T> A, M<T> B, int k, int m, Lanes wp = one_lane()) {
  int i = 0, j = 0;
  for (walk_lower(i, j, wp.lane); i < m; walk_lower(i, j, wp.nl)) {
    T acc = A(0, i) * B(0, j);
    for (int t = 1; t < k; ++t) acc += A(t, i) * B(t, j);
    C(i, j) = acc;
    C(j, i) = acc;
  }
  wp.sync();
}

// C = A·B (m×m); A (m×k), B (k×m).
template <typename T>
DWBC_HD void mm_sym(M<T> C, M<T> A, M<T> B, int m, int k, Lanes wp = one_lane()) {
  int i = 0, j = 0;
  for (walk_lower(i, j, wp.lane); i < m; walk_lower(i, j, wp.nl)) {
    T acc = A(i, 0) * B(0, j);
    for (int t = 1; t < k; ++t) acc += A(i, t) * B(t, j);
    C(i, j) = acc;
    C(j, i) = acc;
  }
  wp.sync();
}

template <typename T>
DWBC_HD void copy_mat(M<T> D, M<T> S, int m, int n, Lanes wp = one_lane()) {
  for (int e = wp.lane; e < m * n; e += wp.nl) {
    const int i = e / n, j = e - i * n;
    D(i, j) = S(i, j);
  }
  wp.sync();
}

// Out = Min⁻¹ for SPD Min (n×n): Cholesky → L⁻¹ → L⁻ᵀL⁻¹.  L and X are
// scratch; Out may alias Min, and L may be Min (factored in place) or Out.
template <typename T>
DWBC_HD void psd_inverse(M<T> Out, M<T> Min, M<T> L, M<T> X, V<T> idg, int n,
                         Lanes wp = one_lane()) {
  if (L.p != Min.p) copy_mat(L, Min, n, n, wp);
  chol_factor(L, idg, n, wp);
  tri_inv_lower(X, L, idg, n, wp);
  ltl_sym(Out, X, n, wp);
}

// min|L_ii| / max(max|L_ii|, 1e-30) of the Cholesky factor of Min, on
// every lane.
template <typename T>
DWBC_HD T chol_health(M<T> Min, M<T> L, V<T> idg, int n, Lanes wp = one_lane()) {
  copy_mat(L, Min, n, n, wp);
  chol_factor(L, idg, n, wp);
  T dmin = fabs(L(0, 0)), dmax = dmin;
  for (int i = 1; i < n; ++i) {
    T d = fabs(L(i, i));
    dmin = vmin(dmin, d);
    dmax = vmax(dmax, d);
  }
  wp.sync();                     // every lane has read L before it is reused
  return dmin / clamp_min(dmax, (T)1e-30);
}

// L X = B with reciprocal diagonal; B (n×r).  X may alias B.  A lane takes
// whole columns.
template <typename T>
DWBC_HD void solve_lower_inv(M<T> X, M<T> L, V<T> idg, M<T> B, int n, int r,
                             Lanes wp = one_lane()) {
  for (int c = wp.lane; c < r; c += wp.nl)
    for (int i = 0; i < n; ++i) {
      T acc = B(i, c);
      for (int k = 0; k < i; ++k) acc -= L(i, k) * X(k, c);
      X(i, c) = acc * idg[i];
    }
  wp.sync();
}

// Lᵀ X = Y with reciprocal diagonal; Y (n×r).  X may alias Y.
template <typename T>
DWBC_HD void solve_upperT_inv(M<T> X, M<T> L, V<T> idg, M<T> Y, int n, int r,
                              Lanes wp = one_lane()) {
  for (int c = wp.lane; c < r; c += wp.nl)
    for (int i = n - 1; i >= 0; --i) {
      T acc = Y(i, c);
      for (int k = i + 1; k < n; ++k) acc -= L(k, i) * X(k, c);
      X(i, c) = acc * idg[i];
    }
  wp.sync();
}

// L Lᵀ X = B; X may alias B.
template <typename T>
DWBC_HD void cho_solve(M<T> X, M<T> L, V<T> idg, M<T> B, int n, int r, Lanes wp = one_lane()) {
  solve_lower_inv(X, L, idg, B, n, r, wp);
  solve_upperT_inv(X, L, idg, X, n, r, wp);
}

// Thin QR factor Q of A (m×k) by double-pass modified Gram-Schmidt, in
// place (Q may alias A).  drop_tol > 0: a column whose residual norm is at
// most drop_tol times its original norm becomes zeros.  The lanes split a
// column's rows; its norms and dot products are every lane's.
template <typename T>
DWBC_HD void qr_thin(M<T> Q, M<T> A, int m, int k, T drop_tol, Lanes wp = one_lane()) {
  for (int j = 0; j < k; ++j) {
    T n0 = 0;
    for (int i = 0; i < m; ++i) {
      T v = A(i, j);
      n0 += v * v;
    }
    n0 = sqrt(n0);
    if (Q.p != A.p)
      for (int i = wp.lane; i < m; i += wp.nl) Q(i, j) = A(i, j);
    wp.sync();
    for (int pass = 0; pass < 2; ++pass)
      for (int c = 0; c < j; ++c) {
        T d = 0;
        for (int i = 0; i < m; ++i) d += Q(i, c) * Q(i, j);
        wp.sync();
        for (int i = wp.lane; i < m; i += wp.nl) Q(i, j) = Q(i, j) - d * Q(i, c);
        wp.sync();
      }
    T nn = 0;
    for (int i = 0; i < m; ++i) nn += Q(i, j) * Q(i, j);
    T nrm = sqrt(clamp_min(nn, (T)1e-30));
    bool keep = drop_tol <= (T)0 || nrm > drop_tol * clamp_min(n0, (T)1e-30);
    wp.sync();
    for (int i = wp.lane; i < m; i += wp.nl) Q(i, j) = keep ? Q(i, j) / nrm : (T)0;
    wp.sync();
  }
}

// The last m−k columns of the orthonormal completion of col(A), A (m×k):
// residuals of the unit vectors against col(A), then m−k greedy picks of
// the FIRST residual of largest norm.  Q (m×k) and R (m×m) are scratch.  A
// lane takes whole columns of R; the picks are every lane's.
template <typename T>
DWBC_HD void complete_basis_tail(M<T> Ny, M<T> A, M<T> Q, M<T> R, int m, int k,
                                 Lanes wp = one_lane()) {
  qr_thin(Q, A, m, k, (T)0, wp);
  for (int c = wp.lane; c < m; c += wp.nl) {
    for (int i = 0; i < m; ++i) R(i, c) = i == c ? (T)1 : (T)0;
    for (int j = 0; j < k; ++j) {
      T d = 0;
      for (int i = 0; i < m; ++i) d += Q(i, j) * R(i, c);
      for (int i = 0; i < m; ++i) R(i, c) = R(i, c) - d * Q(i, j);
    }
  }
  wp.sync();
  for (int t = 0; t < m - k; ++t) {
    int sel = 0;
    T best = 0;
    for (int c = 0; c < m; ++c) {
      T nn = 0;
      for (int i = 0; i < m; ++i) nn += R(i, c) * R(i, c);
      if (c == 0 || nn > best) {
        best = nn;
        sel = c;
      }
    }
    T vv = 0;
    for (int i = 0; i < m; ++i) vv += R(i, sel) * R(i, sel);
    T inv = (T)1 / sqrt(clamp_min(vv, (T)1e-30));
    for (int i = wp.lane; i < m; i += wp.nl) Ny(i, t) = R(i, sel) * inv;
    wp.sync();
    for (int c = wp.lane; c < m; c += wp.nl) {
      T d = 0;
      for (int i = 0; i < m; ++i) d += Ny(i, t) * R(i, c);
      for (int i = 0; i < m; ++i) R(i, c) = R(i, c) - d * Ny(i, t);
    }
    wp.sync();
  }
}

// Single-pass modified Gram-Schmidt over the columns of V (m×k), in place,
// with rank dropout: a column whose residual norm is at most tol becomes
// exact zeros (ops/elemlin.py::orthonormalize_drop).  A column that is
// exactly zero stays exactly zero.
template <typename T>
DWBC_HD void orthonormalize_drop(M<T> V, int m, int k, T tol, Lanes wp = one_lane()) {
  for (int j = 0; j < k; ++j) {
    for (int c = 0; c < j; ++c) {
      T d = 0;
      for (int i = 0; i < m; ++i) d += V(i, c) * V(i, j);
      wp.sync();
      for (int i = wp.lane; i < m; i += wp.nl) V(i, j) = V(i, j) - d * V(i, c);
      wp.sync();
    }
    T nn = 0;
    for (int i = 0; i < m; ++i) nn += V(i, j) * V(i, j);
    const T nrm = sqrt(nn);
    const bool keep = nrm > tol;
    wp.sync();
    for (int i = wp.lane; i < m; i += wp.nl) V(i, j) = keep ? V(i, j) / nrm : (T)0;
    wp.sync();
  }
}

// Shift the columns of V (m×k) whose norm exceeds tol to the left, in order
// and in place (a column moves only into a slot already read); the tail
// becomes exact zeros (ops/elemlin.py::compact_columns).  Returns their
// count, on every lane.
template <typename T>
DWBC_HD int compact_columns(M<T> V, int m, int k, T tol, Lanes wp = one_lane()) {
  int cnt = 0;
  for (int j = 0; j < k; ++j) {
    T nn = 0;
    for (int i = 0; i < m; ++i) nn += V(i, j) * V(i, j);
    const bool keep = sqrt(nn) > tol;
    if (keep && cnt != j)
      for (int i = wp.lane; i < m; i += wp.nl) V(i, cnt) = V(i, j);
    if (keep) ++cnt;
    wp.sync();
  }
  for (int e = wp.lane; e < m * (k - cnt); e += wp.nl) {
    const int j = cnt + e / m;
    V(e % m, j) = (T)0;
  }
  wp.sync();
  return cnt;
}

// Thresholded pseudo-inverse X of a square Mm (n×n): MGS QR with drop_tol
// 1e-7; rows with |R_ii| ≤ rcond·max|R_ii| become identity rows with a zero
// right-hand side (a dead pivot gives a zero row of X).  Q, R scratch.  A
// lane takes whole columns of X.
template <typename T>
DWBC_HD void qr_pinv(M<T> X, M<T> Mm, M<T> Q, M<T> R, int n, T rcond, Lanes wp = one_lane()) {
  qr_thin(Q, Mm, n, n, (T)1e-7, wp);
  mTm(R, Q, Mm, n, n, n, wp);
  T dmax = fabs(R(0, 0));
  for (int i = 1; i < n; ++i) dmax = vmax(dmax, (T)fabs(R(i, i)));
  for (int c = wp.lane; c < n; c += wp.nl)
    for (int i = n - 1; i >= 0; --i) {
      if (!(fabs(R(i, i)) > rcond * dmax)) {
        X(i, c) = (T)0;
        continue;
      }
      T acc = Q(c, i);
      for (int k = i + 1; k < n; ++k) acc -= R(i, k) * X(k, c);
      X(i, c) = acc / R(i, i);
    }
  wp.sync();
}

}  // namespace dwbc
