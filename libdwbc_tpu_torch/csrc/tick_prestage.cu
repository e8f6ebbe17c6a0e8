// tick_prestage: q → everything the QP chain needs, one warp per scenario.
//
// Replaces the first stage of the TPU kernel wbc/fused.py::FusedTick.
// _run_pallas, i.e. libdwbc_tpu/ops/tick_kernel.py::TickProgram.prestage in
// static and masked mode: FK with a quaternion base (x, y, z at q[3:6], w at q[ndof]),
// dof frames, point jacobians, the world-origin composite-rigid-body mass
// matrix (filled only for ancestor dof pairs), G = −A[0:3]ᵀg, A⁻¹, the
// contact space (Mc, Λc, J̄c, P_C, rank health), the kernel basis V2
// (complete_basis + qr_thin), the factored W-apply (Cholesky of Wfree+V2V2ᵀ
// with a rank-cfree correction: W⁻¹ is never formed), NwJw (qr_pinv), τ_grav,
// per-level JKT and Ntorque with the f32 relative ridge, and Atemp, bA0.
// General plans (kernel_unsupported in ops/tick_cuda.py): one to NC_MAX
// contacts of any type (POINT: the translation rows and blk·Rᵀ; LINE: the
// translation rows, the moment rows in the contact's frame (Rᵀ·J_rot)[1:3]
// and blk·(Rᵀ ⊕ I); one contact of 6 dof or fewer: cfree = 0, no kernel
// basis, W = Wfree factored alone), up to NLEV_MAX levels, each a list of 6D, position or rotation tasks on a
// point (link origin, COM-frame or custom-frame) or on the whole-body COM,
// whose jacobian Jcom_total (linear rows A[0:3]/M, angular rows the
// centroidal inertia's solve against the COM momentum map) is formed from
// A before A⁻¹ overwrites it; each level after the first in the null space
// of those above, Pn ← Pn·(I − Jkt·Q).
// Masked mode (a per-scenario 0/1 mask over up to NC_MAX candidates, each
// padded to 6 jacobian and 10 constraint rows, its type's dead rows masked
// by the table's live-row masks): J_C rows × the masks, +1 on the inactive
// diagonal of Mc and Λc re-masked, the kernel
// basis by orthonormalize_drop + compact_columns (exact zero columns for a
// single-support lane), NwJw through the first (c_act − 6) active rows, and
// the per-lane constraint-row mask and active contact dof as outputs.
// Servo'd calls (a nonzero task mask smask): the per-body velocities from
// q̇, each task's point state (the whole-body COM's: its position from
// A[3:6, 0:3], its velocity Jcom_total[0:3]·q̇), and on every servo'd task
// the trajectory-PD f* (csrc/servo.cuh) blended into the caller's f*, written
// to the prestage buffer's servo section for tick_qpchain; the servo branch
// of libdwbc_tpu/ops/tick_kernel.py (prestage with servo_req,
// _apply_servos_el).
//
// Mapping: kPreWarps scenarios per block, a warp each.  The 32 lanes of a
// warp split every phase's outputs, never a sum (elemlin.cuh,
// warp_linalg.cuh): the FK's rows of each body's frame, the dof frames and
// jacobian columns, the bodies' composite inertias and each of their 36
// entries' backward accumulation, the columns of A, the entries of every
// product, the triangular solves' right-hand sides.  The chains stay in
// order (FK parent → child, the CRBA's accumulation, each Cholesky's
// columns); a sequential sum (a Gram-Schmidt norm, the active-dof count)
// is every lane's or lane 0's before a sync; the servo runs on lane 0.  So
// every element gets the same operations in the same order as with one
// lane, and the results do not depend on the lane count.  A partial last
// block returns whole warps: a lane past B would run on a zero q (NaNs).
//
// Where the working set lives (flagship: nbody 34, ndof 39, mdof 33, cdof
// 12, cfree 6; 18,423 floats per scenario if nothing shared a place).  The
// live set by phase:
//   FK, dof frames, jacobians: Rb pb axw comw (612; Rb, pb, axw to the
//     end), ax og (234, to S), J (936, to the JKT loop);
//   CRBA and A⁻¹: IC (1,224), S (234), A (1,521), dead once A⁻¹ is formed
//     in A's place (the factor in place, then X = L⁻¹, 1,521);
//   contact space: JC JAinv Mc Lamc Jbar H6 rm G NCG (~2,100; Jbar, JC to
//     the end);
//   kernel basis and W: Qb Rres Ny V2T Wf idgW M6 Qp Rp Pinv JbV live
//     (~2,100; V2T, Wf, idgW to the end);
//   JKT loop: Jt JtA JtAJc JAN Mt Lam Q QT WQt VtB QWQ Jkt JktLam (~1,950)
//     per level, Pn (1,089) from level 0 to level 1.
// The peak is ~10k floats (40 KB), past the 28 KB that a warp can have at
// two blocks of four per SM.  Held
// whole in shared memory (flagship), a scenario would leave five warps per SM and
// B = 1024 would run the whole chain in two waves.  So the split: 6,996
// floats (27,984 bytes, PreWS::smem) in shared memory with the dead
// buffers overlaid (PreWS), everything that a chain of dependent phases
// reads back — the factorisations (A⁻¹ at n = 39, W at 33, the small
// inverses and healths), the FK's frames and the CRBA, the Gram-Schmidt
// of the kernel basis, the W-apply's solves, the JKT loop's small
// products; and 2,571 floats (J, G, NCG, J̄, Pn: written once, read in a
// few passes) in a device-memory workspace laid out scenario-major
// ([B][elem], stride 1), where a warp's row-split loads are neighbouring
// words and its broadcast reads one word.  B = 1024 runs in one wave of
// eight warps per SM.  A plan whose shared part exceeds 7,232 floats (three
// or four contacts: the hands-and-feet plan 9,105, its four candidates
// masked 12,303; or a wide level, whose rows X's buffer then holds past
// nd²) runs one block per SM with the shared part it needs
// (dwbc_prestage_stride), up to kPreSmemMax.  The prestage output stays
// element-leading ([elem][B]), as tick_qpchain and the wrappers read it.
//
// What bounds it on the H100: about 337k FLOP per scenario of small dense
// factorisations, which the warp runs as a chain of some hundreds of
// synced phases (39 Cholesky columns of two barriers each, the FK's 33
// bodies, the Gram-Schmidt columns, the triangular solves' rows): the
// latency of that chain, at small batches and at large ones alike (eight
// warps per SM share an SM's instruction throughput); not the card's FLOP
// rate nor the bytes in and out.
#include "elemlin.cuh"
#include "servo.cuh"

// Phase markers, for libdwbc_tpu_torch/profile_prestage.py: a build with
// -DDWBC_PRE_STOP=k returns at marker k, leaving the later outputs unwritten,
// so the kernel's time up to each marker can be read off.
#ifdef DWBC_PRE_STOP
#define DWBC_PRE_PHASE(k) \
  if ((k) >= DWBC_PRE_STOP) return
#else
#define DWBC_PRE_PHASE(k)
#endif

namespace dwbc {

constexpr int kPreWarps = 4;    // scenarios per block
// Shared floats of one scenario: two blocks of kPreWarps warps per SM,
// (228 KB − 2 × 1 KB reserved) / 2 / kPreWarps / 4 bytes.  A scenario that
// needs more (three or four contacts, a wide level) gets what it needs, up
// to kPreSmemMax, one block per SM.
constexpr long long kPreSmemElems = 7232;
constexpr long long kPreSmemMax = 2 * kPreSmemElems;

// The floats of X's buffer: nd², or what it is given once A⁻¹ is formed if
// that is more — the small inverses' L and X (order max(cd, 6, tmax)), J_C,
// then J_C·A⁻¹ (contact space) or a level's Jt, JtA, JAN (JKT loop).
template <typename T>
DWBC_HD long long prestage_x_elems(const Tab<T>& tb) {
  const long long nd = tb.ndof, cd = tb.cdof, tm = tb.tmax();
  const long long ls = vmax(vmax(cd, 6LL), tm);
  return vmax(nd * nd, 2 * ls * ls + cd * nd + vmax(cd * nd, 3 * tm * nd));
}

// One scenario's working set: views into its shared part (sh) and into its
// slice of the scenario-major workspace in device memory (a), stride 1
// both.  In shared memory, for the whole kernel: A (its Cholesky factor in
// place, then A⁻¹ in its place), X (the factor's inverse), idg, and the
// bodies' frames Rb, pb, axw.  Once A⁻¹ is formed, X's buffer holds the
// small inverses' L and X, JC, and in one place JAinv (contact space), then
// Jt, JtA, JAN (JKT loop).  Then one region, overlaid in time: the CRBA's
// comw, ax, og, IC, S until A⁻¹; from the contact space on, W and its
// factor, the kernel basis' Gram-Schmidt buffers, the small matrices and
// the JKT loop's products; after them the servo's body velocities wb, vb.
// The device-memory part: J, G, NCG, Jbar, the null space Pn of the levels
// above the current one, and with a whole-body COM task Jcom_total and the
// COM's offset from the base, cfb.
template <typename T>
struct PreWS {
  M<T> A, Ainv, X, Ls, Xs, Rb, pb, axw, comw, ax, og, IC, S, J, JC, JAinv, Mc, Lamc, Jbar,
      H6, Wf, Qb, Rres, Ny, V2T, M6, Qp, Rp, Pinv, v1, Jt, JtA, JtAJc, JAN, Mt, Lam, Q, QT,
      WQt, VtB, QWQ, Jkt, JktLam, Pn, JbV, wb, vb, Jcom;
  V<T> idg, G, NCG, idgW, rm, live, cfb;
  long long smem;                // shared elements, the overlays' largest extent

  DWBC_HD PreWS(Arena<T>& a, Arena<T>& sh, const Tab<T>& tb) {
    const int nb = tb.nbody, nd = tb.ndof, md = tb.mdof, cd = tb.cdof,
              cf = tb.cfree, tm = tb.tmax();
    // the small inverses' order: Mc (cd), the health's 6×6 and the levels' t
    const int ls = vmax(vmax(cd, 6), tm);
    A = sh.mat(nd, nd);
    Ainv = A;
    X = sh.mat(nd, nd);
    // X's buffer grows past nd² where what it is given needs more (many
    // contacts, a wide level): prestage_x_elems
    sh.vec((int)(prestage_x_elems(tb) - (long long)nd * nd));
    idg = sh.vec(nd);
    Arena<T> xa{X.p, 1, 0};
    Ls = xa.mat(ls, ls);
    Xs = xa.mat(ls, ls);
    JC = xa.mat(cd, nd);
    Arena<T> jkt = xa;
    JAinv = xa.mat(cd, nd);
    Jt = jkt.mat(tm, nd);
    JtA = jkt.mat(tm, nd);
    JAN = jkt.mat(tm, nd);
    Rb = sh.mat(nb, 9);
    pb = sh.mat(nb, 3);
    axw = sh.mat(nb, 3);
    Arena<T> crba = sh, servo = sh;         // the region's overlays
    comw = crba.mat(nb, 3);
    ax = crba.mat(3, nd);
    og = crba.mat(3, nd);
    IC = crba.mat(nb, 36);
    S = crba.mat(6, nd);
    wb = servo.mat(nb, 3);
    vb = servo.mat(nb, 3);
    Wf = sh.mat(md, md);
    idgW = sh.vec(md);
    Qb = sh.mat(cd, 6);
    Rres = sh.mat(cd, cd);
    Ny = sh.mat(cd, cf);
    V2T = sh.mat(md, cf);
    M6 = sh.mat(cf, cf);
    Qp = sh.mat(cf, cf);
    Rp = sh.mat(cf, cf);
    Pinv = sh.mat(cf, cf);
    JbV = sh.mat(cd, cf);
    live = sh.vec(cf);
    rm = sh.vec(cd);
    v1 = sh.mat(md, 1);
    VtB = sh.mat(cf, tm);
    Mc = sh.mat(cd, cd);
    Lamc = sh.mat(cd, cd);
    H6 = sh.mat(6, 6);
    Mt = sh.mat(tm, tm);
    Lam = sh.mat(tm, tm);
    QWQ = sh.mat(tm, tm);
    Q = sh.mat(tm, md);
    QT = sh.mat(md, tm);
    WQt = sh.mat(md, tm);
    Jkt = sh.mat(md, tm);
    JktLam = sh.mat(md, tm);
    JtAJc = sh.mat(tm, cd);
    smem = vmax(sh.off, vmax(crba.off, servo.off));
    J = a.mat(6 * tb.npts, nd);
    G = a.vec(nd);
    NCG = a.vec(nd);
    Jbar = a.mat(cd, nd);
    Pn = a.mat(md, md);
    Jcom = a.mat(tb.tot ? 6 : 0, nd);
    cfb = a.vec(tb.tot ? 3 : 0);
  }
};

// Y = W⁻¹·Bm for Bm (mdof × r): Cholesky solve against Wfree + V2V2ᵀ, then
// the rank-cfree correction −V2(V2ᵀBm); with cfree = 0 the solve against
// Wfree alone.  Y may alias Bm.
template <typename T>
DWBC_HD void w_apply(const Tab<T>& tb, const PreWS<T>& w, M<T> Y, M<T> Bm, int r,
                     Lanes wp = one_lane()) {
  if (tb.cfree == 0) {
    cho_solve(Y, w.Wf, w.idgW, Bm, tb.mdof, r, wp);
    return;
  }
  mTm(w.VtB, w.V2T, Bm, tb.mdof, tb.cfree, r, wp);
  cho_solve(Y, w.Wf, w.idgW, Bm, tb.mdof, r, wp);
  for (int e = wp.lane; e < tb.mdof * r; e += wp.nl) {
    const int i = e / r, c = e - i * r;
    T acc = w.V2T(i, 0) * w.VtB(0, c);
    for (int k = 1; k < tb.cfree; ++k) acc += w.V2T(i, k) * w.VtB(k, c);
    Y(i, c) = Y(i, c) - acc;
  }
  wp.sync();
}

// κ-bounding relative ridge 1e-4·max|diag| on a task-space operator, at
// float32 only (the plain version applies it exactly where JAX does).
template <typename T>
DWBC_HD void f32_ridge(M<T> Ms, int n, Lanes wp = one_lane()) {
  if (sizeof(T) != 4) return;
  T dmax = 0;
  for (int i = 0; i < n; ++i) dmax = vmax(dmax, (T)fabs(Ms(i, i)));
  wp.sync();
  for (int i = wp.lane; i < n; i += wp.nl) Ms(i, i) = Ms(i, i) + (T)1e-4 * dmax;
  wp.sync();
}

// The servo branch, one lane: per-body velocities, every task's point
// state, and the f* of every level into the prestage buffer's servo
// section.  smask bit k: task k is servo'd, its ServoIn the next block of
// the servo buffer.
template <typename T>
DWBC_HD void servo_lane(const Tab<T>& tb, const PreWS<T>& w, const Pre<T>& pre, V<T> q,
                        V<T> qd, V<T> fs, const T* svp, int smask, long long B) {
  for (int r = 0; r < 3; ++r) {
    T acc = w.Rb(0, 3 * r) * qd[3];
    for (int k = 1; k < 3; ++k) acc += w.Rb(0, 3 * r + k) * qd[3 + k];
    w.wb(0, r) = acc;
    w.vb(0, r) = qd[r];
  }
  for (int i = 1; i < tb.nbody; ++i) {
    const int par = (int)tb.parent[i];
    const T qdi = qd[(int)tb.qidx[i]];
    T d[3];
    for (int r = 0; r < 3; ++r) {
      w.wb(i, r) = w.wb(par, r) + w.axw(i, r) * qdi;
      d[r] = w.pb(i, r) - w.pb(par, r);
    }
    w.vb(i, 0) = w.vb(par, 0) + (w.wb(par, 1) * d[2] - w.wb(par, 2) * d[1]);
    w.vb(i, 1) = w.vb(par, 1) + (w.wb(par, 2) * d[0] - w.wb(par, 0) * d[2]);
    w.vb(i, 2) = w.vb(par, 2) + (w.wb(par, 0) * d[1] - w.wb(par, 1) * d[0]);
  }
  Arena<T> sa{const_cast<T*>(svp), B, 0};
  int foff = 0;
  for (int k = 0; k < tb.ntask; ++k) {
    const int slot = tb.task_slot(k), r0 = tb.task_r0(k), nr = tb.task_nr(k);
    T pos[3], vel[3], rot[9], wv[3];
    if (slot == TASK_TOT) {
      // the whole-body COM: base position + cfb, velocity Jcom_total[0:3]·q̇,
      // identity rotation, zero angular velocity
      for (int r = 0; r < 3; ++r) {
        T acc = w.Jcom(r, 0) * qd[0];
        for (int j = 1; j < tb.ndof; ++j) acc += w.Jcom(r, j) * qd[j];
        pos[r] = w.cfb[r] + q[r];
        vel[r] = acc;
        wv[r] = (T)0;
      }
      for (int r = 0; r < 9; ++r) rot[r] = r % 4 == 0 ? (T)1 : (T)0;
    } else {
      // the task link's point (origin or offset) and its velocity
      const int link = (int)tb.pt_link[slot];
      const T* off = tb.pt_off + 3 * slot;
      T rr[3];
      for (int r = 0; r < 9; ++r) rot[r] = w.Rb(link, r);
      for (int r = 0; r < 3; ++r) {
        T acc = rot[3 * r] * off[0];
        for (int c = 1; c < 3; ++c) acc += rot[3 * r + c] * off[c];
        rr[r] = acc;
        wv[r] = w.wb(link, r);
        pos[r] = w.pb(link, r) + rr[r];
      }
      vel[0] = w.vb(link, 0) + (wv[1] * rr[2] - wv[2] * rr[1]);
      vel[1] = w.vb(link, 1) + (wv[2] * rr[0] - wv[0] * rr[2]);
      vel[2] = w.vb(link, 2) + (wv[0] * rr[1] - wv[1] * rr[0]);
    }
    const V<T> ts = pre.tstate(k);
    for (int r = 0; r < 3; ++r) {
      ts[r] = pos[r];
      ts[3 + r] = vel[r];
      ts[15 + r] = wv[r];
    }
    for (int r = 0; r < 9; ++r) ts[6 + r] = rot[r];

    if (!((smask >> k) & 1)) {
      for (int r = 0; r < nr; ++r) pre.fstar[foff + r] = fs[foff + r];
    } else {
      // the f6 rows r0 .. r0 + nr − 1, blended by use_pos (rows 0-2) and
      // use_rot (rows 3-5)
      const ServoIn<T> sp(sa);
      T f6[6];
      servo_fstar(sp, pos, vel, rot, wv, f6);
      const T up = sp.use_pos[0], ur = sp.use_rot[0];
      for (int r = 0; r < nr; ++r) {
        const T u = r0 + r < 3 ? up : ur;
        pre.fstar[foff + r] = u * f6[r0 + r] + ((T)1 - u) * fs[foff + r];
      }
    }
    foff += nr;
  }
}

// The contact whose rows hold row i: of J_C (k0 false) or of the
// constraint rows (k0 true).
template <typename T>
DWBC_HDI int contact_of(const Tab<T>& tb, int i, bool k0) {
  int c = 0;
  while (c + 1 < tb.nc && i >= (k0 ? tb.c_k0(c + 1) : tb.c_j0(c + 1))) ++c;
  return c;
}

// One scenario, run by the lanes of wp.  cmp is the scenario's contact mask
// (nc, strided by B), read in masked mode only; qdp (ndof), fsp (Σ task
// dofs) and svp (SERVO_ELEMS per servo'd level), strided by B, are read
// only when smask is nonzero.  prep is the scenario's column of the
// element-leading prestage buffer, wsp its slice of the scenario-major
// workspace (prestage_ws_elems), smp its shared part (prestage_smem_elems).
template <typename T>
DWBC_HD void prestage_lane(const T* table, const T* qp, const T* cmp, const T* qdp,
                           const T* fsp, const T* svp, int smask, T* prep, T* wsp, T* smp,
                           long long B, Lanes wp = one_lane()) {
  const Tab<T> tb(table);
  const int nb = tb.nbody, nd = tb.ndof, md = tb.mdof, cd = tb.cdof,
            cf = tb.cfree;
  const V<T> q{const_cast<T*>(qp), B};
  Arena<T> pa{prep, B, 0};
  const Pre<T> pre(pa, tb, smask != 0);
  Arena<T> wa{wsp, 1, 0}, sa{smp, 1, 0};
  const PreWS<T> w(wa, sa, tb);

  // ---------------- FK: lane 0 the base; then body by body, parent before
  // child, lane r < 3 the row r of the body's rotation, origin, axis and COM
  if (wp.lane == 0) {
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
  wp.sync();
  for (int i = 1; i < nb; ++i) {
    if (wp.lane < 3) {
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
      for (int r = wp.lane; r < 3; r += wp.nl) {
        for (int cc = 0; cc < 3; ++cc) {
          T acc = w.Rb(par, 3 * r) * XR[cc];
          for (int k = 1; k < 3; ++k) acc += w.Rb(par, 3 * r + k) * XR[3 * k + cc];
          w.Rb(i, 3 * r + cc) = acc;
        }
        T acc = w.Rb(par, 3 * r) * tb.xtrans[3 * i];
        for (int k = 1; k < 3; ++k) acc += w.Rb(par, 3 * r + k) * tb.xtrans[3 * i + k];
        w.pb(i, r) = w.pb(par, r) + acc;
        T aw = w.Rb(i, 3 * r) * a[0], cw = w.Rb(i, 3 * r) * tb.com[3 * i];
        for (int k = 1; k < 3; ++k) {
          aw += w.Rb(i, 3 * r + k) * a[k];
          cw += w.Rb(i, 3 * r + k) * tb.com[3 * i + k];
        }
        w.axw(i, r) = aw;
        w.comw(i, r) = w.pb(i, r) + cw;
      }
    }
    wp.sync();
  }
  DWBC_PRE_PHASE(1);

  // ---------------- dof frames: base translation, base rotation about
  // R0's columns, one revolute axis per joint
  for (int j = wp.lane; j < nd; j += wp.nl) {
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
  wp.sync();

  // ---------------- point jacobians: rows 6k..6k+5 for point k, a lane
  // per column
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
    for (int j = wp.lane; j < nd; j += wp.nl) {
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
  wp.sync();
  DWBC_PRE_PHASE(2);

  // ---------------- mass matrix: world-origin composite rigid body; a lane
  // per body, then per entry of the 36 its accumulation child → parent
  for (int i = wp.lane; i < nb; i += wp.nl) {
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
  wp.sync();
  for (int e = wp.lane; e < 36; e += wp.nl)
    for (int i = nb - 1; i > 0; --i) {
      const int par = (int)tb.parent[i];
      w.IC(par, e) = w.IC(par, e) + w.IC(i, e);
    }
  for (int j = wp.lane; j < nd; j += wp.nl) {
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
  for (int e = wp.lane; e < nd * nd; e += wp.nl) w.A(e / nd, e % nd) = (T)0;
  wp.sync();
  for (int j = wp.lane; j < nd; j += wp.nl) {      // a lane per column of A
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
  wp.sync();

  // gravity vector: G = −A[0:3,:]ᵀ g (zero components of g skipped)
  for (int k = wp.lane; k < nd; k += wp.nl) {
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
  wp.sync();

  // whole-body COM jacobian (a "tot" task): from A before A⁻¹ overwrites
  // it.  Every lane forms the 3×3 quantities alike (skm = R0·A[3:6, 0:3]/M,
  // the COM offset cfb, the centroidal inertia and its Cholesky factor);
  // the lanes split the columns of the linear rows A[0:3]/M and of the
  // angular rows, the inertia's solve against the momentum map's column
  // cfb̂ᵀ·A[0:3] + R0·A[3:6]
  if (tb.tot) {
    const T Mt = tb.mtot;
    T R0[9], skm[9], RA[9], Ic[9];
    for (int r = 0; r < 9; ++r) R0[r] = w.Rb(0, r);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        T acc = R0[3 * i] * w.A(3, j), ra = R0[3 * i] * w.A(3, 3 + j);
        for (int k = 1; k < 3; ++k) {
          acc += R0[3 * i + k] * w.A(3 + k, j);
          ra += R0[3 * i + k] * w.A(3 + k, 3 + j);
        }
        skm[3 * i + j] = acc / Mt;
        RA[3 * i + j] = ra;
      }
    const T c0 = skm[7], c1 = skm[2], c2 = skm[3];
    const T ch[9] = {0, -c2, c1, c2, 0, -c0, -c1, c0, 0};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        T acc = RA[3 * i] * R0[3 * j], cc = ch[3 * i] * ch[3 * j];
        for (int k = 1; k < 3; ++k) {
          acc += RA[3 * i + k] * R0[3 * j + k];
          cc += ch[3 * i + k] * ch[3 * j + k];
        }
        Ic[3 * i + j] = acc - Mt * cc;
      }
    // lower Cholesky factor of Ic, pivots clamped at 1e-30 (elemlin.py's chol)
    T L[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    {
      T s00 = Ic[0], s10 = Ic[3], s20 = Ic[6];
      const T i0 = rsqrt_(clamp_min(s00, (T)1e-30));
      L[0] = s00 * i0; L[3] = s10 * i0; L[6] = s20 * i0;
      const T s11 = Ic[4] - L[3] * L[3], s21 = Ic[7] - L[6] * L[3];
      const T i1 = rsqrt_(clamp_min(s11, (T)1e-30));
      L[4] = s11 * i1; L[7] = s21 * i1;
      const T s22 = (Ic[8] - L[6] * L[6]) - L[7] * L[7];
      L[8] = s22 * rsqrt_(clamp_min(s22, (T)1e-30));
    }
    for (int j = wp.lane; j < nd; j += wp.nl) {
      T y[3];
      for (int i = 0; i < 3; ++i) {
        T acc = ch[i] * w.A(0, j);
        for (int k = 1; k < 3; ++k) acc += ch[3 * k + i] * w.A(k, j);
        T acc2 = R0[3 * i] * w.A(3, j);
        for (int k = 1; k < 3; ++k) acc2 += R0[3 * i + k] * w.A(3 + k, j);
        y[i] = acc + acc2;
        w.Jcom(i, j) = w.A(i, j) / Mt;
      }
      y[0] = y[0] / L[0];                              // L y = b
      y[1] = (y[1] - L[3] * y[0]) / L[4];
      y[2] = (y[2] - (L[6] * y[0] + L[7] * y[1])) / L[8];
      y[2] = y[2] / L[8];                              // Lᵀ x = y
      y[1] = (y[1] - L[7] * y[2]) / L[4];
      y[0] = (y[0] - (L[3] * y[1] + L[6] * y[2])) / L[0];
      for (int i = 0; i < 3; ++i) w.Jcom(3 + i, j) = y[i];
    }
    if (wp.lane == 0) {
      w.cfb[0] = c0; w.cfb[1] = c1; w.cfb[2] = c2;
    }
    wp.sync();
  }

  DWBC_PRE_PHASE(3);
  psd_inverse(w.Ainv, w.A, w.A, w.X, w.idg, nd, wp);      // A⁻¹ in A's place
  DWBC_PRE_PHASE(4);

  // ---------------- contact jacobian rows per contact: 6D all six rows,
  // POINT the translation rows, LINE the translation rows and the moment
  // rows in the contact's frame, (Rᵀ·J_rot)[1:3] (masked: all three, the
  // local-x one statically dead); masked: each candidate's six rows times
  // its live-row mask and the candidate's 0/1 mask, so dead rows are exact
  // zeros
  for (int e = wp.lane; e < cd * nd; e += wp.nl) {
    const int row = e / nd, j = e - row * nd, c = contact_of(tb, row, false),
              r = row - tb.c_j0(c);
    const int slot = tb.c_slot(c);
    T v;
    if (tb.c_line(c) && r >= 3) {         // local moment row rl: Σ_k R(k, rl)·J_rot(k)
      const int link = tb.c_link(c), rl = r - (tb.c_dof(c) - 3);
      v = w.Rb(link, rl) * w.J(6 * slot + 3, j);
      for (int k = 1; k < 3; ++k) v += w.Rb(link, 3 * k + rl) * w.J(6 * slot + 3 + k, j);
    } else {
      v = w.J(6 * slot + r, j);
    }
    if (tb.masked) {
      const T live = cmp[(long long)c * B] * tb.c_rmask[6 * c + r];
      if (j == 0) w.rm[row] = live;
      v = v * live;
    }
    w.JC(row, j) = v;
  }
  wp.sync();
  if (tb.masked && wp.lane == 0) {         // the lane's active contact dof
    T cact = 0;
    for (int i = 0; i < cd; ++i) cact += w.rm[i];
    pre.acdof[0] = cact;
  }

  // ---------------- contact space
  mm(w.JAinv, w.JC, w.Ainv, cd, nd, nd, wp);
  mmT_sym(w.Mc, w.JAinv, w.JC, cd, nd, wp);
  if (tb.masked) {          // +1 on the inactive diagonal: the active block inverts exactly
    for (int i = wp.lane; i < cd; i += wp.nl) w.Mc(i, i) = w.Mc(i, i) + ((T)1 - w.rm[i]);
    wp.sync();
  }
  mTm_sym(w.H6, w.JC, w.JC, cd, 6, wp);
  {
    T h1 = chol_health(w.Mc, w.Ls, w.idg, cd, wp);
    T h2 = chol_health(w.H6, w.Ls, w.idg, 6, wp);
    if (wp.lane == 0) pre.health[0] = vmin(h1, h2);
  }
  psd_inverse(w.Lamc, w.Mc, w.Ls, w.Xs, w.idg, cd, wp);
  if (tb.masked) {
    for (int e = wp.lane; e < cd * cd; e += wp.nl) {
      const int i = e / cd, j = e - i * cd;
      w.Lamc(i, j) = w.Lamc(i, j) * w.rm[i] * w.rm[j];
    }
    wp.sync();
  }
  mm(w.Jbar, w.Lamc, w.JAinv, cd, cd, nd, wp);
  for (int r = wp.lane; r < cd; r += wp.nl) {
    T acc = w.Jbar(r, 0) * w.G[0];
    for (int k = 1; k < nd; ++k) acc += w.Jbar(r, k) * w.G[k];
    pre.PC[r] = acc;
  }
  wp.sync();
  for (int k = wp.lane; k < nd; k += wp.nl) {
    T acc = w.JC(0, k) * pre.PC[0];
    for (int r = 1; r < cd; ++r) acc += w.JC(r, k) * pre.PC[r];
    w.NCG[k] = w.G[k] - acc;
  }
  {
    int i = 0, j = 0;
    for (walk_lower(i, j, wp.lane); i < md; walk_lower(i, j, wp.nl)) {
      T acc = w.JAinv(0, 6 + i) * w.Jbar(0, 6 + j);
      for (int r = 1; r < cd; ++r) acc += w.JAinv(r, 6 + i) * w.Jbar(r, 6 + j);
      w.Wf(i, j) = w.Ainv(6 + i, 6 + j) - acc;
      w.Wf(j, i) = w.Wf(i, j);
    }
  }
  wp.sync();
  DWBC_PRE_PHASE(5);

  // kernel basis V2 of the contact space and the factored W-apply.  In a
  // single-support lane the dead rows of J_C are exact zeros, so Q stays
  // exactly zero there, Ny picks exact unit vectors on them, and the raw
  // basis is exactly zero: orthonormalize_drop drops it to zero columns.
  // One contact (cfree = 0): no kernel basis, Wfree factored alone, no NwJw
  if (cf > 0) {
    complete_basis_tail(w.Ny, w.JC, w.Qb, w.Rres, cd, 6, wp);
    mTm(w.V2T, w.JC.sub(0, 6), w.Ny, cd, md, cf, wp);
    if (tb.masked) {
      orthonormalize_drop(w.V2T, md, cf, (T)1e-8, wp);
      compact_columns(w.V2T, md, cf, (T)1e-10, wp);
    } else {
      qr_thin(w.V2T, w.V2T, md, cf, (T)0, wp);
    }
    int i = 0, j = 0;
    for (walk_lower(i, j, wp.lane); i < md; walk_lower(i, j, wp.nl)) {
      T acc = w.V2T(i, 0) * w.V2T(j, 0);
      for (int k = 1; k < cf; ++k) acc += w.V2T(i, k) * w.V2T(j, k);
      w.Wf(i, j) = w.Wf(i, j) + acc;
    }
    wp.sync();
  }
  chol_factor(w.Wf, w.idgW, md, wp);
  if (cf > 0) {
    if (!tb.masked) {
      mm(w.M6, w.Jbar.sub(0, 6), w.V2T, cf, md, cf, wp);
    } else {
      // the inner system against the first (c_act − 6) ACTIVE rows of J̄ᵀ: an
      // integer prefix count gives row i_t of the t-th active row (the same
      // selection as the plain version's |idx − t| < 0.5); rows and columns
      // t ≥ c_act − 6 are dead and padded with identity.  Every lane counts;
      // the lanes split a picked row's columns
      const T lim = pre.acdof[0] - (T)6;
      for (int t = wp.lane; t < cf; t += wp.nl) w.live[t] = (T)t < lim ? (T)1 : (T)0;
      for (int e = wp.lane; e < cf * cf; e += wp.nl) w.M6(e / cf, e % cf) = (T)0;
      mm(w.JbV, w.Jbar.sub(0, 6), w.V2T, cd, md, cf, wp);
      int cnt = 0;
      for (int i = 0; i < cd; ++i) {
        if (!(w.rm[i] > (T)0.5)) continue;
        const int t = cnt++;
        if (t < cf && w.live[t] != (T)0)
          for (int c = wp.lane; c < cf; c += wp.nl) w.M6(t, c) = w.JbV(i, c) * w.rm[i];
      }
      wp.sync();
      for (int e = wp.lane; e < cf * cf; e += wp.nl) {
        const int t = e / cf, c = e - t * cf;
        w.M6(t, c) = w.M6(t, c) * w.live[t] * w.live[c] + (t == c ? (T)1 - w.live[t] : (T)0);
      }
      wp.sync();
    }
    qr_pinv(w.Pinv, w.M6, w.Qp, w.Rp, cf, (T)1e-6, wp);
    mm(pre.NwJw, w.V2T, w.Pinv, md, cf, cf, wp);
    if (tb.masked) {
      for (int e = wp.lane; e < md * cf; e += wp.nl) {
        const int i = e / cf, c = e - i * cf;
        pre.NwJw(i, c) = pre.NwJw(i, c) * w.live[c];
      }
      wp.sync();
    }
  }

  DWBC_PRE_PHASE(6);

  // τ_grav = W⁻¹·(A⁻¹[6:]·NCG)
  for (int i = wp.lane; i < md; i += wp.nl) {
    T acc = w.Ainv(6 + i, 0) * w.NCG[0];
    for (int k = 1; k < nd; ++k) acc += w.Ainv(6 + i, k) * w.NCG[k];
    w.v1(i, 0) = acc;
  }
  wp.sync();
  w_apply(tb, w, w.v1, w.v1, 1, wp);
  for (int i = wp.lane; i < md; i += wp.nl) pre.tg[i] = w.v1(i, 0);
  DWBC_PRE_PHASE(7);

  // ---------------- per-level JKT + Ntorque: level h's task rows gathered
  // from its task list (t = Σ of its tasks' rows), its Nt block in the
  // prestage buffer at its first task dof toff
  for (int h = 0, k = 0, toff = 0; h < tb.nlev; ++h) {
    const int t = tb.lev_t(h);
    const M<T> Nt = pre.Nt(md, toff, t);
    for (int row = 0; k < tb.ntask && tb.task_lev(k) == h; ++k) {
      const int slot = tb.task_slot(k), r0 = tb.task_r0(k), nr = tb.task_nr(k);
      const M<T> src = slot == TASK_TOT ? w.Jcom : w.J.sub(6 * slot, 0);
      for (int e = wp.lane; e < nr * nd; e += wp.nl) {
        const int r = e / nd, j = e - r * nd;
        w.Jt(row + r, j) = src(r0 + r, j);
      }
      row += nr;
    }
    wp.sync();
    mm(w.JtA, w.Jt, w.Ainv, t, nd, nd, wp);
    mmT(w.JtAJc, w.JtA, w.JC, t, nd, cd, wp);
    for (int e = wp.lane; e < t * nd; e += wp.nl) {
      const int i = e / nd, j = e - i * nd;
      T acc = w.JtAJc(i, 0) * w.Jbar(0, j);
      for (int r = 1; r < cd; ++r) acc += w.JtAJc(i, r) * w.Jbar(r, j);
      w.JAN(i, j) = w.JtA(i, j) - acc;
    }
    wp.sync();
    mmT_sym(w.Mt, w.JAN, w.Jt, t, nd, wp);
    f32_ridge(w.Mt, t, wp);
    psd_inverse(w.Lam, w.Mt, w.Ls, w.Xs, w.idg, t, wp);
    mm(w.Q, w.Lam, w.JAN.sub(0, 6), t, t, md, wp);
    for (int e = wp.lane; e < md * t; e += wp.nl) {
      const int i = e / t, c = e - i * t;
      w.QT(i, c) = w.Q(c, i);
    }
    wp.sync();
    w_apply(tb, w, w.WQt, w.QT, t, wp);
    mm_sym(w.QWQ, w.Q, w.WQt, t, md, wp);
    f32_ridge(w.QWQ, t, wp);
    psd_inverse(w.QWQ, w.QWQ, w.Ls, w.Xs, w.idg, t, wp);   // inv_mid
    mm(w.Jkt, w.WQt, w.QWQ, md, t, t, wp);
    mm(w.JktLam, w.Jkt, w.Lam, md, t, t, wp);
    if (h == 0) copy_mat(Nt, w.JktLam, md, t, wp);
    else mm(Nt, w.Pn, w.JktLam, md, md, t, wp);
    if (h + 1 < tb.nlev) {
      if (h == 0) {             // level 0's null space I − Jkt·Q
        for (int e = wp.lane; e < md * md; e += wp.nl) {
          const int i = e / md, j = e - i * md;
          T acc = w.Jkt(i, 0) * w.Q(0, j);
          for (int c = 1; c < t; ++c) acc += w.Jkt(i, c) * w.Q(c, j);
          w.Pn(i, j) = (i == j ? (T)1 : (T)0) - acc;
        }
      } else {
        // Pn ← Pn·(I − Jkt·Q) = Pn − (Pn·Jkt)·Q: Pn·Jkt (mdof × t) in
        // JktLam's place, which Nt has been read from; each entry of Pn
        // then reads only its own old value
        mm(w.JktLam, w.Pn, w.Jkt, md, md, t, wp);
        for (int e = wp.lane; e < md * md; e += wp.nl) {
          const int i = e / md, j = e - i * md;
          T acc = w.JktLam(i, 0) * w.Q(0, j);
          for (int c = 1; c < t; ++c) acc += w.JktLam(i, c) * w.Q(c, j);
          w.Pn(i, j) = w.Pn(i, j) - acc;
        }
      }
      wp.sync();
    }
    toff += t;
  }

  DWBC_PRE_PHASE(8);

  // ---------------- constraint rows: CM_c = blk_c·(Rᵀ ⊕ Rᵀ) (6D; masked:
  // POINT too), blk_c·Rᵀ (POINT), blk_c·(Rᵀ ⊕ I) (LINE: its moment rows of
  // J_C are contact-local already), Atemp, bA0; a lane per row
  for (int o = wp.lane; o < tb.krows; o += wp.nl) {
    const int c = contact_of(tb, o, true), r = o - tb.c_k0(c), link = tb.c_link(c), j0 = tb.c_j0(c), dof = tb.c_dof(c);
    const bool line = tb.c_line(c);
    const T* blk = tb.c_blk + c * CROWS * 6;
    // all six formed (a fixed index keeps cm in registers); a 6D contact's
    // sums run as one chain of fused multiply-adds, a shorter contact's
    // stop at its rows
    T cm[6];
    for (int cc = 0; cc < 6; ++cc) {
      const int h0 = cc < 3 ? 0 : 3, col = cc < 3 ? cc : cc - 3;
      T acc = blk[6 * r + h0] * w.Rb(link, 3 * col);
      for (int k = 1; k < 3; ++k) acc += blk[6 * r + h0 + k] * w.Rb(link, 3 * col + k);
      cm[cc] = line && cc >= 3 ? blk[6 * r + cc] : acc;
    }
    if (dof == 6) {
      for (int j = 0; j < md; ++j) {
        T acc = cm[0] * w.Jbar(j0, 6 + j);
        for (int cc = 1; cc < 6; ++cc) acc += cm[cc] * w.Jbar(j0 + cc, 6 + j);
        pre.Atemp(o, j) = acc;
      }
      T acc = cm[0] * pre.PC[j0];
      for (int cc = 1; cc < 6; ++cc) acc += cm[cc] * pre.PC[j0 + cc];
      pre.bA0[o] = acc;
    } else {
      for (int j = 0; j < md; ++j) {
        T acc = cm[0] * w.Jbar(j0, 6 + j);
        for (int cc = 1; cc < 6; ++cc)
          if (cc < dof) acc += cm[cc] * w.Jbar(j0 + cc, 6 + j);
        pre.Atemp(o, j) = acc;
      }
      T acc = cm[0] * pre.PC[j0];
      for (int cc = 1; cc < 6; ++cc)
        if (cc < dof) acc += cm[cc] * pre.PC[j0 + cc];
      pre.bA0[o] = acc;
    }
  }
  for (int e = wp.lane; e < cd * md; e += wp.nl) {
    const int r = e / md, j = e - r * md;
    pre.Jbar_act(r, j) = w.Jbar(r, 6 + j);
  }
  if (tb.masked)            // a candidate's live constraint rows follow its mask
    for (int o = wp.lane; o < tb.nc * CROWS; o += wp.nl)
      pre.crow[o] = cmp[(long long)(o / CROWS) * B] * tb.c_cmask[o];
  if (smask != 0 && wp.lane == 0)
    servo_lane(tb, w, pre, q, V<T>{const_cast<T*>(qdp), B}, V<T>{const_cast<T*>(fsp), B},
               svp, smask, B);
  wp.sync();
}

// Elements per scenario of the workspace in device memory and of the
// shared part.
template <typename T>
DWBC_HD long long prestage_ws_elems(const T* table) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0}, sh{nullptr, 0, 0};
  PreWS<T> w(a, sh, tb);
  return a.off;
}

template <typename T>
DWBC_HD long long prestage_smem_elems(const T* table) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0}, sh{nullptr, 0, 0};
  return PreWS<T>(a, sh, tb).smem;
}

template <typename T>
long long pre_elems(const T* table, bool servo) {
  const Tab<T> tb(table);
  Arena<T> a{nullptr, 0, 0};
  Pre<T> p(a, tb, servo);
  return a.off;
}

}  // namespace dwbc

extern "C" long long dwbc_prestage_ws_elems(const float* table_host) {
  return dwbc::prestage_ws_elems(table_host);
}

extern "C" long long dwbc_pre_elems(const float* table_host, int servo) {
  return dwbc::pre_elems(table_host, servo != 0);
}

// The shared floats a scenario of this table needs; the kernel takes the
// table if they are at most dwbc_prestage_smem_cap().
extern "C" long long dwbc_prestage_smem_elems(const float* table_host) {
  return dwbc::prestage_smem_elems(table_host);
}

extern "C" long long dwbc_prestage_smem_cap() { return dwbc::kPreSmemMax; }

// The shared floats the kernel gives each scenario of this table (its
// launch shape): kPreSmemElems, two blocks per SM, where the table's need
// fits; else the need itself, one block per SM.
extern "C" long long dwbc_prestage_stride(const float* table_host) {
  const long long need = dwbc::prestage_smem_elems(table_host);
  return need <= dwbc::kPreSmemElems ? dwbc::kPreSmemElems : need;
}

#ifdef __CUDACC__
// Two blocks per SM, as the shared part allows (S = kPreSmemElems); the
// bound also lets ptxas use 220 registers without spills, where without it
// it chose 128 and spilled.  S is the shared floats per scenario.
__global__ void __launch_bounds__(32 * dwbc::kPreWarps, 2)
    tick_prestage_kernel(const float* table, const float* q, const float* cmask,
                         const float* qdot, const float* fs, const float* servo,
                         int smask, float* pre, float* ws, int B, int S) {
  extern __shared__ float sm[];
  const int w = threadIdx.x / 32;
  const long long b = (long long)blockIdx.x * dwbc::kPreWarps + w;
  if (b >= B) return;          // whole warps only: a zero q would give NaNs
  // beyond the shared part: refused by the wrapper
  if (dwbc::prestage_smem_elems(table) > S) return;
  const long long wse = dwbc::prestage_ws_elems(table);
  dwbc::prestage_lane<float>(table, q + b, cmask ? cmask + b : nullptr,
                             smask ? qdot + b : nullptr, smask ? fs + b : nullptr,
                             smask ? servo + b : nullptr, smask, pre + b, ws + b * wse,
                             sm + (long long)w * S, (long long)B,
                             dwbc::Lanes{(int)threadIdx.x % 32, 32, nullptr});
}

static size_t prestage_smem_bytes(int S) { return sizeof(float) * dwbc::kPreWarps * (size_t)S; }

// Allow the dynamic shared memory of S elements per scenario (once per
// size the process has seen grow).
static cudaError_t prestage_allow_smem(int S) {
  static size_t allowed = 48 * 1024;
  const size_t bytes = prestage_smem_bytes(S);
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(tick_prestage_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess) allowed = bytes;
  return rc;
}

// q (nq, B), cmask (nc, B) in masked mode or null, pre (pre_elems(servo =
// smask != 0), B), ws (B × prestage_ws_elems, scenario-major); with a
// nonzero level mask smask also qdot (ndof, B), fs (Σ task dofs, B) and
// servo (SERVO_ELEMS × servo'd levels, B): float32, contiguous, on the
// device; S = dwbc_prestage_stride of the table, at most
// dwbc_prestage_smem_cap; launched on `stream`, no synchronisation.
extern "C" int dwbc_tick_prestage(const float* table, const float* q,
                                  const float* cmask, const float* qdot,
                                  const float* fs, const float* servo, int smask,
                                  float* pre, float* ws, int S, int B, void* stream) {
  if (cudaError_t rc = prestage_allow_smem(S)) return (int)rc;
  const int blocks = (B + dwbc::kPreWarps - 1) / dwbc::kPreWarps;
  tick_prestage_kernel<<<blocks, 32 * dwbc::kPreWarps, prestage_smem_bytes(S),
                         (cudaStream_t)stream>>>(table, q, cmask, qdot, fs, servo, smask, pre,
                                                 ws, B, S);
  return (int)cudaGetLastError();
}

// The kernel's resources at S shared floats per scenario (dwbc::kernel_info).
extern "C" int dwbc_tick_prestage_info(int S, int* out) {
  if (cudaError_t rc = prestage_allow_smem(S)) return (int)rc;
  return dwbc::kernel_info(tick_prestage_kernel, 32 * dwbc::kPreWarps, prestage_smem_bytes(S),
                           out);
}
#endif
