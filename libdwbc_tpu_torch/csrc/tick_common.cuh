// Shared definitions of the WBC tick kernels: strided lane views, the
// packed model/config table, and the per-lane layouts of the buffers the
// wrappers in ops/tick_cuda.py allocate.
//
// Layout: one thread computes one scenario ("lane").  Every buffer is
// element-leading, [elem][B] with the batch contiguous, so element e of lane
// b lives at base[e * B + b] and a warp's 32 lanes touch 32 neighbouring
// words.  The lane code is __host__ __device__ and templated on the scalar
// type, so a host compiler can run it lane by lane against the plain torch
// tick; nvcc builds the float instances only.
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
  DWBC_HDI M<T> mat(int r, int c) {
    M<T> m{base ? base + off * s : nullptr, s, c};
    off += (long long)r * c;
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
//   c_slot[nc] c_link[nc] c_blk[nc,10,6] spec_slot[2] spec_mode[2]
//   tlim[mdof]
// The configurations taken are the flagship's shape: 6D contacts, at most
// NLEV_MAX task levels of one link task each, 6D or rotation.
constexpr int HDR = 32;
constexpr int NLEV_MAX = 2;
constexpr int CROWS = 10;        // constraint rows of a 6D contact
enum { SPEC_6D = 0, SPEC_ROT = 1 };

template <typename T>
struct Tab {
  int nbody, ndof, mdof, npts, nc, cdof, cfree, krows, nlev, nq;
  int lev_t[NLEV_MAX];
  const T *parent, *qidx, *owner, *axis, *xrot, *xtrans, *com, *inertia,
      *mass, *amask, *gravity, *pt_link, *pt_off, *c_slot, *c_link, *c_blk,
      *spec_slot, *spec_mode, *tlim;

  DWBC_HD explicit Tab(const T* t) {
    nbody = (int)t[0]; ndof = (int)t[1]; mdof = (int)t[2]; npts = (int)t[3];
    nc = (int)t[4]; cdof = (int)t[5]; cfree = (int)t[6]; krows = (int)t[7];
    nlev = (int)t[8]; nq = (int)t[9];
    for (int h = 0; h < NLEV_MAX; ++h) lev_t[h] = (int)t[10 + h];
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
    c_slot = o;  o += nc;
    c_link = o;  o += nc;
    c_blk = o;   o += nc * CROWS * 6;
    spec_slot = o; o += NLEV_MAX;
    spec_mode = o; o += NLEV_MAX;
    tlim = o;
  }
  DWBC_HDI int tmax() const {
    int t = 0;
    for (int h = 0; h < nlev; ++h) t = lev_t[h] > t ? lev_t[h] : t;
    return t;
  }
  DWBC_HDI int mrows() const { return 2 * mdof + krows; }   // QP rows m
  DWBC_HDI int srows() const { return mdof + krows; }       // stored rows
};

// ------------------------------------------ the prestage output ("pre")
// Same order as ops/tick_cuda.py::pre_layout.
template <typename T>
struct Pre {
  V<T> tg, PC;
  M<T> Jbar_act, NwJw, Nt[NLEV_MAX], Atemp;
  V<T> bA0, health;
  DWBC_HD Pre(Arena<T>& a, const Tab<T>& tb) {
    tg = a.vec(tb.mdof);
    PC = a.vec(tb.cdof);
    Jbar_act = a.mat(tb.cdof, tb.mdof);
    NwJw = a.mat(tb.mdof, tb.cfree);
    for (int h = 0; h < tb.nlev; ++h) Nt[h] = a.mat(tb.mdof, tb.lev_t[h]);
    Atemp = a.mat(tb.krows, tb.mdof);
    bA0 = a.vec(tb.krows);
    health = a.vec(1);
  }
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
// QP h < nlev has n = lev_t[h] + cfree; the redistribution QP n = cfree;
// every QP has m = 2·mdof + krows rows.  Same order as
// ops/tick_cuda.py::warm_layout.
template <typename T>
struct Warm {
  V<T> x[NLEV_MAX + 1], lam[NLEV_MAX + 1];
  DWBC_HD Warm(Arena<T>& a, const Tab<T>& tb) {
    for (int h = 0; h <= tb.nlev; ++h) {
      int n = h < tb.nlev ? tb.lev_t[h] + tb.cfree : tb.cfree;
      x[h] = a.vec(n);
      lam[h] = a.vec(tb.mrows());
    }
  }
};

}  // namespace dwbc
