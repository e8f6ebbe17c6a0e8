// Small dense linear algebra on one lane's strided views: the device
// counterparts of ops/elemlin.py (same recurrences, same 1e-30 pivot
// clamps).  Every routine is a serial loop nest run by one thread; matrices
// live in the global element-leading workspace, never in per-thread arrays.
#pragma once

#include "tick_common.cuh"

namespace dwbc {

// C = A·B; A (m×k), B (k×n).  C must not alias A or B.
template <typename T>
DWBC_HD void mm(M<T> C, M<T> A, M<T> B, int m, int k, int n) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      T acc = A(i, 0) * B(0, j);
      for (int t = 1; t < k; ++t) acc += A(i, t) * B(t, j);
      C(i, j) = acc;
    }
}

// C = A·Bᵀ; A (m×k), B (n×k).
template <typename T>
DWBC_HD void mmT(M<T> C, M<T> A, M<T> B, int m, int k, int n) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      T acc = A(i, 0) * B(j, 0);
      for (int t = 1; t < k; ++t) acc += A(i, t) * B(j, t);
      C(i, j) = acc;
    }
}

// C = Aᵀ·B; A (k×m), B (k×n).
template <typename T>
DWBC_HD void mTm(M<T> C, M<T> A, M<T> B, int k, int m, int n) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      T acc = A(0, i) * B(0, j);
      for (int t = 1; t < k; ++t) acc += A(t, i) * B(t, j);
      C(i, j) = acc;
    }
}

// Symmetric results: the lower triangle is computed and mirrored.
// C = A·Bᵀ (m×m); A, B (m×k).
template <typename T>
DWBC_HD void mmT_sym(M<T> C, M<T> A, M<T> B, int m, int k) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j <= i; ++j) {
      T acc = A(i, 0) * B(j, 0);
      for (int t = 1; t < k; ++t) acc += A(i, t) * B(j, t);
      C(i, j) = acc;
      C(j, i) = acc;
    }
}

// C = Aᵀ·B (m×m); A, B (k×m).
template <typename T>
DWBC_HD void mTm_sym(M<T> C, M<T> A, M<T> B, int k, int m) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j <= i; ++j) {
      T acc = A(0, i) * B(0, j);
      for (int t = 1; t < k; ++t) acc += A(t, i) * B(t, j);
      C(i, j) = acc;
      C(j, i) = acc;
    }
}

// C = A·B (m×m); A (m×k), B (k×m).
template <typename T>
DWBC_HD void mm_sym(M<T> C, M<T> A, M<T> B, int m, int k) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j <= i; ++j) {
      T acc = A(i, 0) * B(0, j);
      for (int t = 1; t < k; ++t) acc += A(i, t) * B(t, j);
      C(i, j) = acc;
      C(j, i) = acc;
    }
}

template <typename T>
DWBC_HD void copy_mat(M<T> D, M<T> S, int m, int n) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) D(i, j) = S(i, j);
}

// In-place right-looking Cholesky of the lower triangle of L (n×n), one
// rsqrt per column, pivots clamped at 1e-30; idg gets the reciprocal
// diagonal and the stored diagonal is S_jj·rsqrt(max(S_jj, 1e-30)).  The
// strict upper triangle is zeroed.
template <typename T>
DWBC_HD void chol_factor(M<T> L, V<T> idg, int n) {
  for (int j = 0; j < n; ++j) {
    T inv_d = rsqrt_(clamp_min(L(j, j), (T)1e-30));
    idg[j] = inv_d;
    for (int i = j; i < n; ++i) L(i, j) = L(i, j) * inv_d;
    for (int i = j + 1; i < n; ++i) {
      T li = L(i, j);
      for (int k = j + 1; k <= i; ++k) L(i, k) = L(i, k) - li * L(k, j);
    }
    for (int i = 0; i < j; ++i) L(i, j) = (T)0;
  }
}

// X = L⁻¹ for lower-triangular L with reciprocal diagonal idg (n³/6 FMAs):
// X[j,j] = idg[j];  X[i,j] = −(Σ_{k=j..i−1} L[i,k]·X[k,j])·idg[i].
template <typename T>
DWBC_HD void tri_inv_lower(M<T> X, M<T> L, V<T> idg, int n) {
  for (int j = 0; j < n; ++j) {
    for (int i = 0; i < j; ++i) X(i, j) = (T)0;
    X(j, j) = idg[j];
    for (int i = j + 1; i < n; ++i) {
      T acc = L(i, j) * X(j, j);
      for (int k = j + 1; k < i; ++k) acc += L(i, k) * X(k, j);
      X(i, j) = -acc * idg[i];
    }
  }
}

// C = XᵀX for lower-triangular X; C[i,j] = Σ_{k ≥ max(i,j)} X[k,i]·X[k,j].
template <typename T>
DWBC_HD void ltl_sym(M<T> C, M<T> X, int n) {
  for (int i = 0; i < n; ++i)
    for (int j = i; j < n; ++j) {
      T acc = X(j, i) * X(j, j);
      for (int k = j + 1; k < n; ++k) acc += X(k, i) * X(k, j);
      C(i, j) = acc;
      C(j, i) = acc;
    }
}

// Out = Min⁻¹ for SPD Min (n×n): Cholesky → L⁻¹ → L⁻ᵀL⁻¹.  L and X are
// scratch; Out may alias Min.
template <typename T>
DWBC_HD void psd_inverse(M<T> Out, M<T> Min, M<T> L, M<T> X, V<T> idg, int n) {
  copy_mat(L, Min, n, n);
  chol_factor(L, idg, n);
  tri_inv_lower(X, L, idg, n);
  ltl_sym(Out, X, n);
}

// min|L_ii| / max(max|L_ii|, 1e-30) of the Cholesky factor of Min.
template <typename T>
DWBC_HD T chol_health(M<T> Min, M<T> L, V<T> idg, int n) {
  copy_mat(L, Min, n, n);
  chol_factor(L, idg, n);
  T dmin = fabs(L(0, 0)), dmax = dmin;
  for (int i = 1; i < n; ++i) {
    T d = fabs(L(i, i));
    dmin = vmin(dmin, d);
    dmax = vmax(dmax, d);
  }
  return dmin / clamp_min(dmax, (T)1e-30);
}

// L X = B with reciprocal diagonal; B (n×r).  X may alias B.
template <typename T>
DWBC_HD void solve_lower_inv(M<T> X, M<T> L, V<T> idg, M<T> B, int n, int r) {
  for (int i = 0; i < n; ++i)
    for (int c = 0; c < r; ++c) {
      T acc = B(i, c);
      for (int k = 0; k < i; ++k) acc -= L(i, k) * X(k, c);
      X(i, c) = acc * idg[i];
    }
}

// Lᵀ X = Y with reciprocal diagonal; Y (n×r).  X may alias Y.
template <typename T>
DWBC_HD void solve_upperT_inv(M<T> X, M<T> L, V<T> idg, M<T> Y, int n, int r) {
  for (int i = n - 1; i >= 0; --i)
    for (int c = 0; c < r; ++c) {
      T acc = Y(i, c);
      for (int k = i + 1; k < n; ++k) acc -= L(k, i) * X(k, c);
      X(i, c) = acc * idg[i];
    }
}

// L Lᵀ X = B; X may alias B.
template <typename T>
DWBC_HD void cho_solve(M<T> X, M<T> L, V<T> idg, M<T> B, int n, int r) {
  solve_lower_inv(X, L, idg, B, n, r);
  solve_upperT_inv(X, L, idg, X, n, r);
}

// Thin QR factor Q of A (m×k) by double-pass modified Gram-Schmidt, in
// place (Q may alias A).  drop_tol > 0: a column whose residual norm is at
// most drop_tol times its original norm becomes zeros.
template <typename T>
DWBC_HD void qr_thin(M<T> Q, M<T> A, int m, int k, T drop_tol) {
  for (int j = 0; j < k; ++j) {
    T n0 = 0;
    for (int i = 0; i < m; ++i) {
      T v = A(i, j);
      Q(i, j) = v;
      n0 += v * v;
    }
    n0 = sqrt(n0);
    for (int pass = 0; pass < 2; ++pass)
      for (int c = 0; c < j; ++c) {
        T d = 0;
        for (int i = 0; i < m; ++i) d += Q(i, c) * Q(i, j);
        for (int i = 0; i < m; ++i) Q(i, j) = Q(i, j) - d * Q(i, c);
      }
    T nn = 0;
    for (int i = 0; i < m; ++i) nn += Q(i, j) * Q(i, j);
    T nrm = sqrt(clamp_min(nn, (T)1e-30));
    bool keep = drop_tol <= (T)0 || nrm > drop_tol * clamp_min(n0, (T)1e-30);
    for (int i = 0; i < m; ++i) Q(i, j) = keep ? Q(i, j) / nrm : (T)0;
  }
}

// The last m−k columns of the orthonormal completion of col(A), A (m×k):
// residuals of the unit vectors against col(A), then m−k greedy picks of
// the FIRST residual of largest norm.  Q (m×k) and R (m×m) are scratch.
template <typename T>
DWBC_HD void complete_basis_tail(M<T> Ny, M<T> A, M<T> Q, M<T> R, int m, int k) {
  qr_thin(Q, A, m, k, (T)0);
  for (int i = 0; i < m; ++i)
    for (int c = 0; c < m; ++c) R(i, c) = i == c ? (T)1 : (T)0;
  for (int j = 0; j < k; ++j)
    for (int c = 0; c < m; ++c) {
      T d = 0;
      for (int i = 0; i < m; ++i) d += Q(i, j) * R(i, c);
      for (int i = 0; i < m; ++i) R(i, c) = R(i, c) - d * Q(i, j);
    }
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
    for (int i = 0; i < m; ++i) Ny(i, t) = R(i, sel) * inv;
    for (int c = 0; c < m; ++c) {
      T d = 0;
      for (int i = 0; i < m; ++i) d += Ny(i, t) * R(i, c);
      for (int i = 0; i < m; ++i) R(i, c) = R(i, c) - d * Ny(i, t);
    }
  }
}

// Thresholded pseudo-inverse X of a square Mm (n×n): MGS QR with drop_tol
// 1e-7; rows with |R_ii| ≤ rcond·max|R_ii| become identity rows with a zero
// right-hand side (a dead pivot gives a zero row of X).  Q, R scratch.
template <typename T>
DWBC_HD void qr_pinv(M<T> X, M<T> Mm, M<T> Q, M<T> R, int n, T rcond) {
  qr_thin(Q, Mm, n, n, (T)1e-7);
  mTm(R, Q, Mm, n, n, n);
  T dmax = fabs(R(0, 0));
  for (int i = 1; i < n; ++i) dmax = vmax(dmax, (T)fabs(R(i, i)));
  for (int i = n - 1; i >= 0; --i) {
    bool live = fabs(R(i, i)) > rcond * dmax;
    for (int c = 0; c < n; ++c) {
      if (!live) {
        X(i, c) = (T)0;
        continue;
      }
      T acc = Q(c, i);
      for (int k = i + 1; k < n; ++k) acc -= R(i, k) * X(k, c);
      X(i, c) = acc / R(i, i);
    }
  }
}

}  // namespace dwbc
