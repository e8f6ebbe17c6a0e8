// Shared definitions of the WBC tick kernels: strided lane views, the
// packed model/config table, and the per-lane layouts of the buffers the
// wrappers in ops/tick_cuda.py allocate.
//
// Layout: every buffer between the kernels is element-leading, [elem][B]
// with the batch contiguous, so element e of scenario b lives at
// base[e * B + b].  Both tick kernels compute one scenario per warp on views
// with stride 1: tick_prestage on its factorisations in shared memory and
// the rest in a scenario-major workspace, tick_qpchain on a copy of its
// inputs in shared memory.  The code is
// __host__ __device__ and templated on the scalar type, so a host compiler
// can run it scenario by scenario against the plain torch tick; nvcc builds
// the float instances only.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define DWBC_HD __host__ __device__
#define DWBC_HDI __host__ __device__ __forceinline__
#else
#define DWBC_HD
#define DWBC_HDI inline
#endif

namespace dwbc {

// ---------------------------------------------------------------- views
template <typename T>
struct V {                       // strided vector of one lane
  T* p;
  long long s;                   // stride between elements = B
  DWBC_HDI T& operator[](int i) const { return p[(long long)i * s]; }
  DWBC_HDI V at(int off) const { return V{p + (long long)off * s, s}; }
};

template <typename T>
struct M {                       // strided row-major matrix of one lane
  T* p;
  long long s;
  int ld;                        // row length of the underlying storage
  DWBC_HDI T& operator()(int i, int j) const {
    return p[((long long)i * ld + j) * s];
  }
  DWBC_HDI M sub(int i, int j) const {
    return M{p + ((long long)i * ld + j) * s, s, ld};
  }
};

// Bump allocator over one lane's slice of an element-leading buffer.  With
// a null base it only counts elements, which is how the host sizes the
// buffers: the same layout code runs on both sides.
template <typename T>
struct Arena {
  T* base;
  long long s;
  long long off;
  DWBC_HDI M<T> mat(int r, int c, int ld = 0) {     // rows of ld ≥ c (default c)
    ld = ld > c ? ld : c;
    M<T> m{base ? base + off * s : nullptr, s, ld};
    off += (long long)r * ld;
    return m;
  }
  DWBC_HDI V<T> vec(int n) {
    V<T> v{base ? base + off * s : nullptr, s};
    off += n;
    return v;
  }
};

// NaN-propagating clamps (a NaN pivot stays NaN, as in the plain version)
template <typename T> DWBC_HDI T clamp_min(T a, T lo) { return a < lo ? lo : a; }
template <typename T> DWBC_HDI T clamp_max(T a, T hi) { return a > hi ? hi : a; }
template <typename T> DWBC_HDI T vmax(T a, T b) { return b > a ? b : a; }
template <typename T> DWBC_HDI T vmin(T a, T b) { return b < a ? b : a; }

DWBC_HDI float rsqrt_(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
DWBC_HDI double rsqrt_(double x) { return 1.0 / sqrt(x); }

// ------------------------------------------------------ the packed table
// Built by ops/tick_cuda.py::kernel_table; integers are stored as exact
// floats.  Header slots, then sections in this order:
//   parent[nbody] q_index[nbody] owner[ndof] axis[nbody,3] X_rot[nbody,3,3]
//   X_trans[nbody,3] com[nbody,3] inertia[nbody,3,3] mass[nbody]
//   amask[nbody,ndof] gravity[3] pt_link[npts] pt_off[npts,3]
//   contact[nc,CFIELDS] c_rmask[nc,6] c_cmask[nc,CROWS] c_blk[nc,CROWS,6]
//   task[ntask,4] tlim[mdof, only with a torque limit]
// The configurations taken: one to NC_MAX contacts of any type (6D, POINT,
// LINE; in masked mode a candidate set, each padded to 6 jacobian rows and
// CROWS constraint rows), with or without a torque limit, at most NLEV_MAX
// task levels of tasks in level order, NTASK_MAX in all.  Header slots 0-9
// hold the dims, 10 the masked flag, 11 the task count, 12 whether a task
// is the whole-body COM, 13 the model's total mass, 14 whether the torques
// are limited, 16-19 the task dofs per level.  Contact c's fields: its
// point slot, its link, its type, its first row in J_C and its rows there
// (6D 6, POINT 3, LINE 5; masked 6), its first constraint row and its
// constraint rows (6D 10, POINT 6, LINE 8; masked 10); then its live
// jacobian rows and live constraint rows (0/1, read in masked mode: POINT
// keeps the translation rows and the cone, LINE drops the local-x moment
// and the y-edge ZMP rows), and its constraint block, its rows × its J_C
// rows in the top-left corner of a CROWS × 6 slot.  Task k's four fields:
// its level, its point slot (TASK_TOT: the whole-body COM), and the rows it
// takes of that point's 6-row jacobian, first row and count (0, 6: 6D; 0,
// 3: position; 3, 3: rotation).
constexpr int HDR = 32;
constexpr int NLEV_MAX = 4;
constexpr int NTASK_MAX = 16;    // the servo's task mask is an int
constexpr int NC_MAX = 4;
constexpr int H_MASKED = 10, H_NTASK = 11, H_TOT = 12, H_MASS = 13, H_LIM = 14, H_LEV_T = 16;
constexpr int TASK_FIELDS = 4, TASK_TOT = -1;
constexpr int CFIELDS = 7;       // slot, link, type, J_C row, rows, constraint row, rows
constexpr int CROWS = 10;        // constraint rows of a 6D contact
constexpr int CONTACT_LINE = 2;  // wbc/types.py's contact types: 0 6D, 1 POINT, 2 LINE

template <typename T>
struct Tab {
  int nbody, ndof, mdof, npts, nc, cdof, cfree, krows, nlev, nq, ntask;
  bool masked;                   // a per-scenario contact mask picks the candidates
  bool tot;                      // a task on the whole-body COM
  bool lim;                      // a torque limit: the QPs' mirrored ±τ rows
  T mtot;                        // the model's total mass
  const T *hdr, *parent, *qidx, *owner, *axis, *xrot, *xtrans, *com, *inertia,
      *mass, *amask, *gravity, *pt_link, *pt_off, *contact, *c_rmask, *c_cmask, *c_blk,
      *task, *tlim;

  DWBC_HD explicit Tab(const T* t) {
    nbody = (int)t[0]; ndof = (int)t[1]; mdof = (int)t[2]; npts = (int)t[3];
    nc = (int)t[4]; cdof = (int)t[5]; cfree = (int)t[6]; krows = (int)t[7];
    nlev = (int)t[8]; nq = (int)t[9];
    masked = t[H_MASKED] != (T)0;
    ntask = (int)t[H_NTASK];
    tot = t[H_TOT] != (T)0;
    lim = t[H_LIM] != (T)0;
    mtot = t[H_MASS];
    hdr = t;
    const T* o = t + HDR;
    parent = o;  o += nbody;
    qidx = o;    o += nbody;
    owner = o;   o += ndof;
    axis = o;    o += nbody * 3;
    xrot = o;    o += nbody * 9;
    xtrans = o;  o += nbody * 3;
    com = o;     o += nbody * 3;
    inertia = o; o += nbody * 9;
    mass = o;    o += nbody;
    amask = o;   o += nbody * ndof;
    gravity = o; o += 3;
    pt_link = o; o += npts;
    pt_off = o;  o += npts * 3;
    contact = o; o += nc * CFIELDS;
    c_rmask = o; o += nc * 6;
    c_cmask = o; o += nc * CROWS;
    c_blk = o;   o += nc * CROWS * 6;
    task = o;    o += ntask * TASK_FIELDS;
    tlim = o;
  }
  // read from the table, not from an array of the struct: a run-time
  // index into a local array would put it in the stack frame
  DWBC_HDI int lev_t(int h) const { return (int)hdr[H_LEV_T + h]; }
  DWBC_HDI int task_lev(int k) const { return (int)task[TASK_FIELDS * k]; }
  DWBC_HDI int task_slot(int k) const { return (int)task[TASK_FIELDS * k + 1]; }
  DWBC_HDI int task_r0(int k) const { return (int)task[TASK_FIELDS * k + 2]; }
  DWBC_HDI int task_nr(int k) const { return (int)task[TASK_FIELDS * k + 3]; }
  DWBC_HDI int c_slot(int c) const { return (int)contact[CFIELDS * c]; }
  DWBC_HDI int c_link(int c) const { return (int)contact[CFIELDS * c + 1]; }
  DWBC_HDI bool c_line(int c) const { return (int)contact[CFIELDS * c + 2] == CONTACT_LINE; }
  DWBC_HDI int c_j0(int c) const { return (int)contact[CFIELDS * c + 3]; }
  DWBC_HDI int c_dof(int c) const { return (int)contact[CFIELDS * c + 4]; }
  DWBC_HDI int c_k0(int c) const { return (int)contact[CFIELDS * c + 5]; }
  DWBC_HDI int c_nk(int c) const { return (int)contact[CFIELDS * c + 6]; }
  DWBC_HDI int tmax() const {
    int t = 0;
    for (int h = 0; h < nlev; ++h) t = lev_t(h) > t ? lev_t(h) : t;
    return t;
  }
  DWBC_HDI int tsum() const {                               // Σ task dofs
    int t = 0;
    for (int h = 0; h < nlev; ++h) t += lev_t(h);
    return t;
  }
  DWBC_HDI int mirror() const { return lim ? mdof : 0; }    // mirrored ±τ row pairs
  DWBC_HDI int mrows() const { return 2 * mirror() + krows; }   // QP rows m
  DWBC_HDI int srows() const { return mdof + krows; }       // rows of C's storage
  DWBC_HDI int nqp() const { return nlev + (cfree > 0 ? 1 : 0); }   // + redistribution
};

// ------------------------------------------ the prestage output ("pre")
// Same order as ops/tick_cuda.py::pre_layout.  The levels' Nt blocks
// follow each other (level h: mdof × lev_t(h), at Σ_{h'<h} lev_t(h')
// columns' worth of rows).  Masked mode appends the per-lane constraint-row
// mask (krows) and the active contact dof (1).  A servo'd call appends the
// f* of every level (Σ lev_t rows: the servo's blend on servo'd tasks, the
// caller's f* elsewhere), which the QP chain then reads, and per task its
// point's state: pos (3), vel (3), rot (9, row-major), w (3).  The views
// of a level or a task are computed from offsets, never picked from an
// array by a run-time index.
constexpr int TSTATE = 18;

template <typename T>
struct Pre {
  V<T> tg, PC;
  M<T> Jbar_act, NwJw, Nt0, Atemp;
  V<T> bA0, health, crow, acdof, fstar, tstate0;
  DWBC_HD Pre(Arena<T>& a, const Tab<T>& tb, bool servo) {
    tg = a.vec(tb.mdof);
    PC = a.vec(tb.cdof);
    Jbar_act = a.mat(tb.cdof, tb.mdof);
    NwJw = a.mat(tb.mdof, tb.cfree);
    Nt0 = M<T>{a.vec(tb.mdof * tb.tsum()).p, a.s, 0};
    Atemp = a.mat(tb.krows, tb.mdof);
    bA0 = a.vec(tb.krows);
    health = a.vec(1);
    crow = tb.masked ? a.vec(tb.krows) : V<T>{nullptr, 0};
    acdof = tb.masked ? a.vec(1) : V<T>{nullptr, 0};
    fstar = servo ? a.vec(tb.tsum()) : V<T>{nullptr, 0};
    tstate0 = servo ? a.vec(TSTATE * tb.ntask) : V<T>{nullptr, 0};
  }
  // the Nt block (mdof × t) of the level whose first task dof is toff
  DWBC_HDI M<T> Nt(int mdof, int toff, int t) const {
    return M<T>{Nt0.p + (long long)mdof * toff * Nt0.s, Nt0.s, t};
  }
  DWBC_HDI V<T> tstate(int k) const { return tstate0.at(TSTATE * k); }
};

// --------------------------------------------------- the tick's results
// Same order as ops/tick_cuda.py::out_layout.
template <typename T>
struct Out {
  V<T> tg, tt, tc, tcmd, cforce, gap, pres, health;
  DWBC_HD Out(Arena<T>& a, const Tab<T>& tb) {
    tg = a.vec(tb.mdof);
    tt = a.vec(tb.mdof);
    tc = a.vec(tb.mdof);
    tcmd = a.vec(tb.mdof);
    cforce = a.vec(tb.cdof);
    gap = a.vec(1);
    pres = a.vec(1);
    health = a.vec(1);
  }
};

// ------------------------------------------- warm state: (x, λ) per QP
// x (n) then λ (m) of each QP in turn: QP h < nlev has n = lev_t(h) +
// cfree, the redistribution QP (only where cfree > 0) n = cfree; every QP
// has m = krows rows, and 2·mdof more with a torque limit.  Same order as ops/tick_cuda.py::warm_layout
// (TickPlan.qp_dims).
template <typename T>
DWBC_HDI long long warm_elems(const Tab<T>& tb) {
  return (long long)tb.tsum() + (long long)tb.nqp() * (tb.cfree + tb.mrows());
}

#ifdef __CUDACC__
// A kernel's resources at a launch shape, for the record: out = registers
// per thread, local (spilled) bytes per thread, shared bytes per block
// (static and dynamic), threads per block, resident blocks per SM.
template <typename K>
int kernel_info(K kernel, int threads, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + dyn_smem);
  out[3] = threads;
  out[4] = blocks;
  return (int)rc;
}
#endif

}  // namespace dwbc
