// tick_prestage: q → everything the QP chain needs, one thread per scenario.
//
// Replaces the first stage of the TPU kernel wbc/fused.py::FusedTick.
// _run_pallas, i.e. libdwbc_tpu/ops/tick_kernel.py::TickProgram.prestage in
// static mode: FK with a quaternion base (x, y, z at q[3:6], w at q[ndof]),
// dof frames, point jacobians, the world-origin composite-rigid-body mass
// matrix (filled only for ancestor dof pairs), G = −A[0:3]ᵀg, A⁻¹, the
// contact space (Mc, Λc, J̄c, P_C, rank health), the kernel basis V2
// (complete_basis + qr_thin), the factored W-apply (Cholesky of Wfree+V2V2ᵀ
// with a rank-cfree correction: W⁻¹ is never formed), NwJw (qr_pinv), τ_grav,
// per-level JKT and Ntorque with the f32 relative ridge, and Atemp, bA0.
//
// What bounds it on the H100: about 337k FLOP per scenario of serial small
// dense factorisations, and the traffic of its intermediates (about 18k
// floats per scenario, several 39×39 matrices) through L2 and device
// memory.  The design keeps the TPU's batch-in-lanes mapping: one thread
// per scenario, every intermediate in a global workspace laid out [elem][B]
// so a warp's loads coalesce, nothing in per-thread arrays beyond a few 3×3
// and 6-vectors.  Blocks are one warp, so B = 1024 spreads over 32 SMs
// (more L1 per lane) instead of 8; it still leaves 100 SMs idle and every
// thread latency-bound on its own serial chain.  Warp-per-scenario or
// shared-memory tiles are the later work.
#include "elemlin.cuh"

namespace dwbc {

template <typename T>
struct PreWS {
  M<T> Rb, pb, axw, comw, ax, og, J, IC, S, A, Ainv, L, X, JC, JAinv, Mc,
      Lamc, Jbar, H6, Wf, Qb, Rres, Ny, V2T, M6, Qp, Rp, Pinv, v1, Jt, JtA,
      JtAJc, JAN, Mt, Lam, Q, QT, WQt, VtB, QWQ, Jkt, JktLam, Pn, NN, Tmp;
  V<T> idg, idgW, G, NCG;

  DWBC_HD PreWS(Arena<T>& a, const Tab<T>& tb) {
    const int nb = tb.nbody, nd = tb.ndof, md = tb.mdof, cd = tb.cdof,
              cf = tb.cfree, tm = tb.tmax();
    Rb = a.mat(nb, 9);
    pb = a.mat(nb, 3);
    axw = a.mat(nb, 3);
    comw = a.mat(nb, 3);
    ax = a.mat(3, nd);
    og = a.mat(3, nd);
    J = a.mat(6 * tb.npts, nd);
    IC = a.mat(nb, 36);
    S = a.mat(6, nd);
    A = a.mat(nd, nd);
    Ainv = a.mat(nd, nd);
    L = a.mat(nd, nd);
    X = a.mat(nd, nd);
    idg = a.vec(nd);
    G = a.vec(nd);
    NCG = a.vec(nd);
    JC = a.mat(cd, nd);
    JAinv = a.mat(cd, nd);
    Mc = a.mat(cd, cd);
    Lamc = a.mat(cd, cd);
    Jbar = a.mat(cd, nd);
    H6 = a.mat(6, 6);
    Wf = a.mat(md, md);
    idgW = a.vec(md);
    Qb = a.mat(cd, 6);
    Rres = a.mat(cd, cd);
    Ny = a.mat(cd, cf);
    V2T = a.mat(md, cf);
    M6 = a.mat(cf, cf);
    Qp = a.mat(cf, cf);
    Rp = a.mat(cf, cf);
    Pinv = a.mat(cf, cf);
    v1 = a.mat(md, 1);
    Jt = a.mat(tm, nd);
    JtA = a.mat(tm, nd);
    JtAJc = a.mat(tm, cd);
    JAN = a.mat(tm, nd);
    Mt = a.mat(tm, tm);
    Lam = a.mat(tm, tm);
    Q = a.mat(tm, md);
    QT = a.mat(md, tm);
    WQt = a.mat(md, tm);
    VtB = a.mat(cf, tm);
    QWQ = a.mat(tm, tm);
    Jkt = a.mat(md, tm);
    JktLam = a.mat(md, tm);
    Pn = a.mat(md, md);
    NN = a.mat(md, md);
    Tmp = a.mat(md, md);
  }
};

// Y = W⁻¹·Bm for Bm (mdof × r): Cholesky solve against Wfree + V2V2ᵀ, then
// the rank-cfree correction −V2(V2ᵀBm).  Y may alias Bm.
template <typename T>
DWBC_HD void w_apply(const Tab<T>& tb, PreWS<T>& w, M<T> Y, M<T> Bm, int r) {
  mTm(w.VtB, w.V2T, Bm, tb.mdof, tb.cfree, r);
  cho_solve(Y, w.Wf, w.idgW, Bm, tb.mdof, r);
  for (int i = 0; i < tb.mdof; ++i)
    for (int c = 0; c < r; ++c) {
      T acc = w.V2T(i, 0) * w.VtB(0, c);
      for (int k = 1; k < tb.cfree; ++k) acc += w.V2T(i, k) * w.VtB(k, c);
      Y(i, c) = Y(i, c) - acc;
    }
}

// κ-bounding relative ridge 1e-4·max|diag| on a task-space operator, at
// float32 only (the plain version applies it exactly where JAX does).
template <typename T>
DWBC_HD void f32_ridge(M<T> Ms, int n) {
  if (sizeof(T) != 4) return;
  T dmax = 0;
  for (int i = 0; i < n; ++i) dmax = vmax(dmax, (T)fabs(Ms(i, i)));
  for (int i = 0; i < n; ++i) Ms(i, i) = Ms(i, i) + (T)1e-4 * dmax;
}

template <typename T>
DWBC_HD void prestage_lane(const T* table, const T* qp, T* prep, T* wsp,
                           long long B) {
  const Tab<T> tb(table);
  const int nb = tb.nbody, nd = tb.ndof, md = tb.mdof, cd = tb.cdof,
            cf = tb.cfree;
  V<T> q{const_cast<T*>(qp), B};
  Arena<T> pa{prep, B, 0};
  Pre<T> pre(pa, tb);
  Arena<T> wa{wsp, B, 0};
  PreWS<T> w(wa, tb);

  // ---------------- FK
  {
    T x = q[3], y = q[4], z = q[5], qw = q[nd];
    T n2 = x * x + y * y + z * z + qw * qw;
    T s = n2 > (T)0 ? (T)2 / n2 : (T)0;
    T xs = x * s, ys = y * s, zs = z * s;
    T wx = qw * xs, wy = qw * ys, wz = qw * zs;
    T xx = x * xs, xy = x * ys, xz = x * zs;
    T yy = y * ys, yz = y * zs, zz = z * zs;
    M<T> R0 = w.Rb;
    R0(0, 0) = (T)1 - (yy + zz); R0(0, 1) = xy - wz; R0(0, 2) = xz + wy;
    R0(0, 3) = xy + wz; R0(0, 4) = (T)1 - (xx + zz); R0(0, 5) = yz - wx;
    R0(0, 6) = xz - wy; R0(0, 7) = yz + wx; R0(0, 8) = (T)1 - (xx + yy);
    for (int r = 0; r < 3; ++r) {
      w.pb(0, r) = q[r];
      w.axw(0, r) = (T)0;
    }
    for (int r = 0; r < 3; ++r) {
      T acc = w.Rb(0, 3 * r) * tb.com[0];
      for (int k = 1; k < 3; ++k) acc += w.Rb(0, 3 * r + k) * tb.com[k];
      w.comw(0, r) = w.pb(0, r) + acc;
    }
  }
  for (int i = 1; i < nb; ++i) {
    const int par = (int)tb.parent[i];
    const T qi = q[(int)tb.qidx[i]];
    const T c = cos(qi), sn = sin(qi), omc = (T)1 - c;
    const T* a = tb.axis + 3 * i;
    const T K[9] = {0, -a[2], a[1], a[2], 0, -a[0], -a[1], a[0], 0};
    T Rj[9], XR[9];
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc) {
        T v = r == cc ? c : (T)0;
        v += sn * K[3 * r + cc];
        v += omc * (a[r] * a[cc]);
        Rj[3 * r + cc] = v;
      }
    const T* xr = tb.xrot + 9 * i;
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc) {
        T acc = xr[3 * r] * Rj[cc];
        for (int k = 1; k < 3; ++k) acc += xr[3 * r + k] * Rj[3 * k + cc];
        XR[3 * r + cc] = acc;
      }
    for (int r = 0; r < 3; ++r) {
      for (int cc = 0; cc < 3; ++cc) {
        T acc = w.Rb(par, 3 * r) * XR[cc];
        for (int k = 1; k < 3; ++k) acc += w.Rb(par, 3 * r + k) * XR[3 * k + cc];
        w.Rb(i, 3 * r + cc) = acc;
      }
      T acc = w.Rb(par, 3 * r) * tb.xtrans[3 * i];
      for (int k = 1; k < 3; ++k) acc += w.Rb(par, 3 * r + k) * tb.xtrans[3 * i + k];
      w.pb(i, r) = w.pb(par, r) + acc;
    }
    for (int r = 0; r < 3; ++r) {
      T aw = w.Rb(i, 3 * r) * a[0], cw = w.Rb(i, 3 * r) * tb.com[3 * i];
      for (int k = 1; k < 3; ++k) {
        aw += w.Rb(i, 3 * r + k) * a[k];
        cw += w.Rb(i, 3 * r + k) * tb.com[3 * i + k];
      }
      w.axw(i, r) = aw;
      w.comw(i, r) = w.pb(i, r) + cw;
    }
  }

  // ---------------- dof frames: base translation, base rotation about
  // R0's columns, one revolute axis per joint
  for (int j = 0; j < nd; ++j) {
    const int o = (int)tb.owner[j];
    for (int r = 0; r < 3; ++r) {
      T axv;
      if (j < 3) axv = r == j ? (T)1 : (T)0;
      else if (j < 6) axv = w.Rb(0, 3 * r + (j - 3));
      else axv = w.axw(o, r);
      w.ax(r, j) = axv;
      w.og(r, j) = j < 6 ? w.pb(0, r) : w.pb(o, r);
    }
  }

  // ---------------- point jacobians: rows 6k..6k+5 for point k
  for (int k = 0; k < tb.npts; ++k) {
    const int link = (int)tb.pt_link[k];
    const T* off = tb.pt_off + 3 * k;
    T pw[3];
    for (int r = 0; r < 3; ++r) {
      T acc = w.Rb(link, 3 * r) * off[0];
      for (int c = 1; c < 3; ++c) acc += w.Rb(link, 3 * r + c) * off[c];
      pw[r] = w.pb(link, r) + acc;
    }
    M<T> Jk = w.J.sub(6 * k, 0);
    for (int j = 0; j < nd; ++j) {
      const T mask = tb.amask[link * nd + j];
      T a0 = w.ax(0, j), a1 = w.ax(1, j), a2 = w.ax(2, j);
      T r0 = pw[0] - w.og(0, j), r1 = pw[1] - w.og(1, j), r2 = pw[2] - w.og(2, j);
      if (j < 3) {
        Jk(0, j) = a0 * mask; Jk(1, j) = a1 * mask; Jk(2, j) = a2 * mask;
        Jk(3, j) = (T)0 * mask; Jk(4, j) = (T)0 * mask; Jk(5, j) = (T)0 * mask;
      } else {
        Jk(0, j) = (a1 * r2 - a2 * r1) * mask;
        Jk(1, j) = (a2 * r0 - a0 * r2) * mask;
        Jk(2, j) = (a0 * r1 - a1 * r0) * mask;
        Jk(3, j) = a0 * mask; Jk(4, j) = a1 * mask; Jk(5, j) = a2 * mask;
      }
    }
  }

  // ---------------- mass matrix: world-origin composite rigid body
  for (int i = 0; i < nb; ++i) {
    const T mi = tb.mass[i];
    const T* In = tb.inertia + 9 * i;
    T RI[9], c3[3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        T acc = w.Rb(i, 3 * r) * In[c];
        for (int k = 1; k < 3; ++k) acc += w.Rb(i, 3 * r + k) * In[3 * k + c];
        RI[3 * r + c] = acc;
      }
    for (int r = 0; r < 3; ++r) c3[r] = w.comw(i, r);
    const T cc = c3[0] * c3[0] + c3[1] * c3[1] + c3[2] * c3[2];
    const T chat[9] = {0, -c3[2], c3[1], c3[2], 0, -c3[0], -c3[1], c3[0], 0};
    M<T> IC = w.IC.sub(i, 0);                     // row-major 6×6 in 36 slots
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        T icm = RI[3 * r] * w.Rb(i, 3 * c);
        for (int k = 1; k < 3; ++k) icm += RI[3 * r + k] * w.Rb(i, 3 * c + k);
        T v = icm - mi * (c3[r] * c3[c]);
        if (r == c) v = v + mi * cc;
        IC(0, 6 * r + c) = v;
        IC(0, 6 * r + 3 + c) = mi * chat[3 * r + c];
        IC(0, 6 * (3 + r) + c) = -mi * chat[3 * r + c];
        IC(0, 6 * (3 + r) + 3 + c) = r == c ? mi : (T)0;
      }
  }
  for (int i = nb - 1; i > 0; --i) {
    const int par = (int)tb.parent[i];
    for (int e = 0; e < 36; ++e) w.IC(par, e) = w.IC(par, e) + w.IC(i, e);
  }
  for (int j = 0; j < nd; ++j) {
    if (j < 3) {
      for (int r = 0; r < 6; ++r) w.S(r, j) = r == 3 + j ? (T)1 : (T)0;
    } else {
      T a0 = w.ax(0, j), a1 = w.ax(1, j), a2 = w.ax(2, j);
      T o0 = w.og(0, j), o1 = w.og(1, j), o2 = w.og(2, j);
      w.S(0, j) = a0; w.S(1, j) = a1; w.S(2, j) = a2;
      w.S(3, j) = o1 * a2 - o2 * a1;
      w.S(4, j) = o2 * a0 - o0 * a2;
      w.S(5, j) = o0 * a1 - o1 * a0;
    }
  }
  for (int i = 0; i < nd; ++i)
    for (int j = 0; j < nd; ++j) w.A(i, j) = (T)0;
  for (int j = 0; j < nd; ++j) {
    const int o = (int)tb.owner[j];
    T f[6];
    for (int r = 0; r < 6; ++r) {
      T acc = w.IC(o, 6 * r) * w.S(0, j);
      for (int c = 1; c < 6; ++c) acc += w.IC(o, 6 * r + c) * w.S(c, j);
      f[r] = acc;
    }
    for (int i = 0; i <= j; ++i) {
      if (!(tb.amask[o * nd + i] > (T)0.5)) continue;
      T acc = w.S(0, i) * f[0];
      for (int r = 1; r < 6; ++r) acc += w.S(r, i) * f[r];
      w.A(i, j) = acc;
      w.A(j, i) = acc;
    }
  }

  // gravity vector: G = −A[0:3,:]ᵀ g (zero components of g skipped)
  for (int k = 0; k < nd; ++k) {
    T acc = 0;
    bool any = false;
    for (int i = 0; i < 3; ++i) {
      const T gi = tb.gravity[i];
      if (gi == (T)0) continue;
      T t = w.A(i, k) * (-gi);
      acc = any ? acc + t : t;
      any = true;
    }
    w.G[k] = acc;
  }

  psd_inverse(w.Ainv, w.A, w.L, w.X, w.idg, nd);

  // ---------------- contact jacobian rows (6D contacts: all six rows)
  for (int c = 0; c < tb.nc; ++c) {
    const int slot = (int)tb.c_slot[c];
    for (int r = 0; r < 6; ++r)
      for (int j = 0; j < nd; ++j) w.JC(6 * c + r, j) = w.J(6 * slot + r, j);
  }

  // ---------------- contact space
  mm(w.JAinv, w.JC, w.Ainv, cd, nd, nd);
  mmT_sym(w.Mc, w.JAinv, w.JC, cd, nd);
  mTm_sym(w.H6, w.JC, w.JC, cd, 6);
  {
    T h1 = chol_health(w.Mc, w.L, w.idg, cd);
    T h2 = chol_health(w.H6, w.L, w.idg, 6);
    pre.health[0] = vmin(h1, h2);
  }
  psd_inverse(w.Lamc, w.Mc, w.L, w.X, w.idg, cd);
  mm(w.Jbar, w.Lamc, w.JAinv, cd, cd, nd);
  for (int r = 0; r < cd; ++r) {
    T acc = w.Jbar(r, 0) * w.G[0];
    for (int k = 1; k < nd; ++k) acc += w.Jbar(r, k) * w.G[k];
    pre.PC[r] = acc;
  }
  for (int k = 0; k < nd; ++k) {
    T acc = w.JC(0, k) * pre.PC[0];
    for (int r = 1; r < cd; ++r) acc += w.JC(r, k) * pre.PC[r];
    w.NCG[k] = w.G[k] - acc;
  }
  for (int i = 0; i < md; ++i)
    for (int j = 0; j <= i; ++j) {
      T acc = w.JAinv(0, 6 + i) * w.Jbar(0, 6 + j);
      for (int r = 1; r < cd; ++r) acc += w.JAinv(r, 6 + i) * w.Jbar(r, 6 + j);
      w.Wf(i, j) = w.Ainv(6 + i, 6 + j) - acc;
      w.Wf(j, i) = w.Wf(i, j);
    }

  // kernel basis V2 of the contact space and the factored W-apply
  complete_basis_tail(w.Ny, w.JC, w.Qb, w.Rres, cd, 6);
  mTm(w.V2T, w.JC.sub(0, 6), w.Ny, cd, md, cf);
  qr_thin(w.V2T, w.V2T, md, cf, (T)0);
  for (int i = 0; i < md; ++i)
    for (int j = 0; j <= i; ++j) {
      T acc = w.V2T(i, 0) * w.V2T(j, 0);
      for (int k = 1; k < cf; ++k) acc += w.V2T(i, k) * w.V2T(j, k);
      w.Wf(i, j) = w.Wf(i, j) + acc;
    }
  chol_factor(w.Wf, w.idgW, md);
  mm(w.M6, w.Jbar.sub(0, 6), w.V2T, cf, md, cf);
  qr_pinv(w.Pinv, w.M6, w.Qp, w.Rp, cf, (T)1e-6);
  mm(pre.NwJw, w.V2T, w.Pinv, md, cf, cf);

  // τ_grav = W⁻¹·(A⁻¹[6:]·NCG)
  for (int i = 0; i < md; ++i) {
    T acc = w.Ainv(6 + i, 0) * w.NCG[0];
    for (int k = 1; k < nd; ++k) acc += w.Ainv(6 + i, k) * w.NCG[k];
    w.v1(i, 0) = acc;
  }
  w_apply(tb, w, w.v1, w.v1, 1);
  for (int i = 0; i < md; ++i) pre.tg[i] = w.v1(i, 0);

  // ---------------- per-level JKT + Ntorque
  for (int h = 0; h < tb.nlev; ++h) {
    const int t = tb.lev_t[h];                 // 6 (6D task) or 3 (rotation)
    const int slot = (int)tb.spec_slot[h];
    const int r0 = (int)tb.spec_mode[h] == SPEC_ROT ? 3 : 0;
    for (int r = 0; r < t; ++r)
      for (int j = 0; j < nd; ++j) w.Jt(r, j) = w.J(6 * slot + r0 + r, j);
    mm(w.JtA, w.Jt, w.Ainv, t, nd, nd);
    mmT(w.JtAJc, w.JtA, w.JC, t, nd, cd);
    for (int i = 0; i < t; ++i)
      for (int j = 0; j < nd; ++j) {
        T acc = w.JtAJc(i, 0) * w.Jbar(0, j);
        for (int r = 1; r < cd; ++r) acc += w.JtAJc(i, r) * w.Jbar(r, j);
        w.JAN(i, j) = w.JtA(i, j) - acc;
      }
    mmT_sym(w.Mt, w.JAN, w.Jt, t, nd);
    f32_ridge(w.Mt, t);
    psd_inverse(w.Lam, w.Mt, w.L, w.X, w.idg, t);
    mm(w.Q, w.Lam, w.JAN.sub(0, 6), t, t, md);
    for (int i = 0; i < md; ++i)
      for (int c = 0; c < t; ++c) w.QT(i, c) = w.Q(c, i);
    w_apply(tb, w, w.WQt, w.QT, t);
    mm_sym(w.QWQ, w.Q, w.WQt, t, md);
    f32_ridge(w.QWQ, t);
    psd_inverse(w.QWQ, w.QWQ, w.L, w.X, w.idg, t);     // inv_mid
    mm(w.Jkt, w.WQt, w.QWQ, md, t, t);
    mm(w.JktLam, w.Jkt, w.Lam, md, t, t);
    if (h == 0) copy_mat(pre.Nt[h], w.JktLam, md, t);
    else mm(pre.Nt[h], w.Pn, w.JktLam, md, md, t);
    if (h < tb.nlev - 1) {
      mm(w.NN, w.Jkt, w.Q, md, t, md);
      for (int i = 0; i < md; ++i)
        for (int j = 0; j < md; ++j) w.NN(i, j) = (i == j ? (T)1 : (T)0) - w.NN(i, j);
      if (h == 0) {
        copy_mat(w.Pn, w.NN, md, md);
      } else {
        mm(w.Tmp, w.Pn, w.NN, md, md, md);
        copy_mat(w.Pn, w.Tmp, md, md);
      }
    }
  }

  // ---------------- constraint rows: CM_c = blk_c·(Rᵀ ⊕ Rᵀ), Atemp, bA0
  for (int c = 0; c < tb.nc; ++c) {
    const int link = (int)tb.c_link[c];
    const T* blk = tb.c_blk + c * CROWS * 6;
    for (int r = 0; r < CROWS; ++r) {
      T cm[6];
      for (int cc = 0; cc < 6; ++cc) {
        const int h0 = cc < 3 ? 0 : 3, col = cc < 3 ? cc : cc - 3;
        T acc = blk[6 * r + h0] * w.Rb(link, 3 * col);
        for (int k = 1; k < 3; ++k) acc += blk[6 * r + h0 + k] * w.Rb(link, 3 * col + k);
        cm[cc] = acc;
      }
      const int orow = CROWS * c + r;
      for (int j = 0; j < md; ++j) {
        T acc = cm[0] * w.Jbar(6 * c, 6 + j);
        for (int cc = 1; cc < 6; ++cc) acc += cm[cc] * w.Jbar(6 * c + cc, 6 + j);
        pre.Atemp(orow, j) = acc;
      }
      T acc = cm[0] * pre.PC[6 * c];
      for (int cc = 1; cc < 6; ++cc) acc += cm[cc] * pre.PC[6 * c + cc];
      pre.bA0[orow] = acc;
    }
  }
  for (int r = 0; r < cd; ++r)
    for (int j = 0; j < md; ++j) pre.Jbar_act(r, j) = w.Jbar(r, 6 + j);
}

template <typename T>
long long prestage_ws_elems(const T* table) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0};
  PreWS<T> w(a, tb);
  return a.off;
}

template <typename T>
long long pre_elems(const T* table) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0};
  Pre<T> p(a, tb);
  return a.off;
}

}  // namespace dwbc

extern "C" long long dwbc_prestage_ws_elems(const float* table_host) {
  return dwbc::prestage_ws_elems(table_host);
}

extern "C" long long dwbc_pre_elems(const float* table_host) {
  return dwbc::pre_elems(table_host);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
    tick_prestage_kernel(const float* table, const float* q, float* pre,
                         float* ws, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;          // no padded lanes: a zero q would give NaNs
  dwbc::prestage_lane<float>(table, q + b, pre + b, ws + b, (long long)B);
}

// q (nq, B), pre (pre_elems, B), ws (prestage_ws_elems, B): float32,
// contiguous, on the device; launched on `stream`, no synchronisation.
extern "C" int dwbc_tick_prestage(const float* table, const float* q,
                                  float* pre, float* ws, int B, void* stream) {
  const int threads = 32;               // one warp per block: spread lanes over SMs
  const int blocks = (B + threads - 1) / threads;
  tick_prestage_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, q, pre, ws, B);
  return (int)cudaGetLastError();
}
#endif
