// The on-device trajectory-PD servo of one task (a link's point or the
// whole-body COM), one lane: the servo branch of tick_prestage.
//
// Replaces the servo branch of the TPU kernel wbc/fused.py::FusedTick.
// _run_pallas: libdwbc_tpu/ops/tick_kernel.py::_servo_fstar_el and its
// primitives (_quintic_el, _matrix_to_quat_el, _quat_slerp_el,
// _quat_to_matrix_el, _rotation_log_el, _get_phi_el).  A quintic position
// trajectory, a slerp rotation trajectory with quintic time scaling, the
// GetPhi rotation error and a PD law with acceleration feedforward and ±max
// error clamps, then the use_pos / use_rot blend into the task's f* rows.
// A few hundred scalar operations per servo'd task: negligible beside the
// prestage's factorisations, so it runs as plain per-thread code after them.
// The branches and clamps are the plain version's, kept as branches.
#pragma once

#include "tick_common.cuh"

namespace dwbc {

// The 20 ServoParams fields of one servo'd task in the servo buffer, in
// sorted-name order (ops/tick_cuda.py::SERVO_FIELDS), element-leading.
constexpr int SERVO_ELEMS = 68;

template <typename T>
struct ServoIn {
  V<T> max_d_err, max_p_err, pos_a, pos_d, pos_des, pos_init, pos_p, rot_d,
      rot_des, rot_init, rot_p, t, t0, tf, use_pos, use_rot, vel_des,
      vel_init, w_des, w_init;
  DWBC_HD explicit ServoIn(Arena<T>& a) {
    max_d_err = a.vec(6);
    max_p_err = a.vec(6);
    pos_a = a.vec(3);
    pos_d = a.vec(3);
    pos_des = a.vec(3);
    pos_init = a.vec(3);
    pos_p = a.vec(3);
    rot_d = a.vec(3);
    rot_des = a.vec(9);
    rot_init = a.vec(9);
    rot_p = a.vec(3);
    t = a.vec(1);
    t0 = a.vec(1);
    tf = a.vec(1);
    use_pos = a.vec(1);
    use_rot = a.vec(1);
    vel_des = a.vec(3);
    vel_init = a.vec(3);
    w_des = a.vec(3);
    w_init = a.vec(3);
  }
};

// ±lim clamp (lim = +inf is off); NaN-propagating like the plain version.
template <typename T> DWBC_HDI T clip_sym(T x, T lim) { return vmin(vmax(x, -lim), lim); }

// Quintic from (x0, v0, 0) at t0 to (xf, vf, 0) at tf, held outside.
template <typename T>
DWBC_HDI void quintic(T t, T t0, T tf, T x0, T v0, T xf, T vf, T& pos, T& vel,
                      T& acc) {
  const T ts = tf - t0;
  const T ts2 = ts * ts, ts3 = ts2 * ts, ts4 = ts2 * ts2, ts5 = ts4 * ts;
  const T b1 = xf - x0 - v0 * ts, b2 = vf - v0;
  const T a4 = ((T)20 * b1 - (T)8 * b2 * ts) / ((T)2 * ts3);
  const T a5 = ((T)-30 * b1 + (T)14 * b2 * ts) / ((T)2 * ts4);
  const T a6 = ((T)12 * b1 - (T)6 * b2 * ts) / ((T)2 * ts5);
  const T tc = vmin(vmax(t, t0), tf) - t0;
  const T tc2 = tc * tc, tc3 = tc2 * tc, tc4 = tc2 * tc2, tc5 = tc4 * tc;
  if (t < t0) {
    pos = x0; vel = v0; acc = 0;
  } else if (t > tf) {
    pos = xf; vel = vf; acc = 0;
  } else {
    pos = x0 + v0 * tc + a4 * tc3 + a5 * tc4 + a6 * tc5;
    vel = v0 + (T)3 * a4 * tc2 + (T)4 * a5 * tc3 + (T)5 * a6 * tc4;
    acc = (T)6 * a4 * tc + (T)12 * a5 * tc2 + (T)20 * a6 * tc3;
  }
}

// Row-major 3×3 (strided) → quaternion (x, y, z, w), w ≥ 0: the trace
// candidate, else x-, y- or z-major, in the plain version's order.
template <typename T>
DWBC_HDI void matrix_to_quat(V<T> R, T q[4]) {
  const T m00 = R[0], m01 = R[1], m02 = R[2], m10 = R[3], m11 = R[4],
          m12 = R[5], m20 = R[6], m21 = R[7], m22 = R[8];
  const T tr = m00 + m11 + m22;
  if (tr > (T)0) {
    const T r = sqrt(vmax((T)1 + tr, (T)1e-30)) / (T)2;
    q[0] = (m21 - m12) / ((T)4 * r); q[1] = (m02 - m20) / ((T)4 * r);
    q[2] = (m10 - m01) / ((T)4 * r); q[3] = r;
  } else if (m00 >= m11 && m00 >= m22) {
    const T r = sqrt(vmax((T)1 + m00 - m11 - m22, (T)1e-30)) / (T)2;
    q[0] = r; q[1] = (m01 + m10) / ((T)4 * r);
    q[2] = (m02 + m20) / ((T)4 * r); q[3] = (m21 - m12) / ((T)4 * r);
  } else if (m11 >= m22) {
    const T r = sqrt(vmax((T)1 - m00 + m11 - m22, (T)1e-30)) / (T)2;
    q[0] = (m01 + m10) / ((T)4 * r); q[1] = r;
    q[2] = (m12 + m21) / ((T)4 * r); q[3] = (m02 - m20) / ((T)4 * r);
  } else {
    const T r = sqrt(vmax((T)1 - m00 - m11 + m22, (T)1e-30)) / (T)2;
    q[0] = (m02 + m20) / ((T)4 * r); q[1] = (m12 + m21) / ((T)4 * r);
    q[2] = r; q[3] = (m10 - m01) / ((T)4 * r);
  }
  if (q[3] < (T)0)
    for (int k = 0; k < 4; ++k) q[k] = -q[k];
}

// Slerp from q0 (s = 0) to q1 (s = 1) along the shorter arc; linear weights
// where sin θ < 1e-8.
template <typename T>
DWBC_HDI void quat_slerp(const T q0[4], const T q1_in[4], T s, T out[4]) {
  T d = q0[0] * q1_in[0] + q0[1] * q1_in[1] + q0[2] * q1_in[2] + q0[3] * q1_in[3];
  const T sgn = d < (T)0 ? (T)-1 : (T)1;
  d = vmin(fabs(d), (T)1);
  const T theta = acos(d), sin_theta = sin(theta);
  const bool small = sin_theta < (T)1e-8;
  const T denom = small ? (T)1 : sin_theta;
  const T w0 = small ? (T)1 - s : sin(((T)1 - s) * theta) / denom;
  const T w1 = small ? s : sin(s * theta) / denom;
  T n = 0;
  for (int k = 0; k < 4; ++k) {
    out[k] = w0 * q0[k] + w1 * (sgn * q1_in[k]);
    n += out[k] * out[k];
  }
  n = sqrt(n);
  for (int k = 0; k < 4; ++k) out[k] = out[k] / n;
}

template <typename T>
DWBC_HDI void quat_to_matrix(const T qv[4], T R[9]) {
  const T x = qv[0], y = qv[1], z = qv[2], w = qv[3];
  const T n = x * x + y * y + z * z + w * w;
  const T s = n > (T)0 ? (T)2 / n : (T)0;
  const T xs = x * s, ys = y * s, zs = z * s;
  const T wx = w * xs, wy = w * ys, wz = w * zs;
  const T xx = x * xs, xy = x * ys, xz = x * zs;
  const T yy = y * ys, yz = y * zs, zz = z * zs;
  R[0] = (T)1 - (yy + zz); R[1] = xy - wz; R[2] = xz + wy;
  R[3] = xy + wz; R[4] = (T)1 - (xx + zz); R[5] = yz - wx;
  R[6] = xz - wy; R[7] = yz + wx; R[8] = (T)1 - (xx + yy);
}

// Matrix log of a rotation as angle·axis; scale ½ where |sin θ| < 1e-8.
template <typename T>
DWBC_HDI void rotation_log(const T R[9], T v[3]) {
  const T tr = R[0] + R[4] + R[8];
  const T theta = acos(vmin(vmax((tr - (T)1) / (T)2, (T)-1), (T)1));
  const T sin_t = sin(theta);
  const bool small = fabs(sin_t) < (T)1e-8;
  const T scale = small ? (T)0.5 : theta / ((T)2 * sin_t);
  v[0] = (R[7] - R[5]) * scale;
  v[1] = (R[2] - R[6]) * scale;
  v[2] = (R[3] - R[1]) * scale;
}

// The servo of one task at its point's state (pos, vel, rot row-major, w) →
// f6 = [f*_pos; f*_rot].
template <typename T>
DWBC_HD void servo_fstar(const ServoIn<T>& sp, const T pos[3], const T vel[3],
                         const T rot[9], const T w[3], T f6[6]) {
  const T t = sp.t[0], t0 = sp.t0[0], tf = sp.tf[0];
  for (int k = 0; k < 3; ++k) {
    T pt, vt, at;
    quintic(t, t0, tf, sp.pos_init[k], sp.vel_init[k], sp.pos_des[k], sp.vel_des[k],
            pt, vt, at);
    const T p_err = clip_sym(pt - pos[k], sp.max_p_err[k]);
    const T d_err = clip_sym(vt - vel[k], sp.max_d_err[k]);
    f6[k] = sp.pos_a[k] * at + sp.pos_p[k] * p_err + sp.pos_d[k] * d_err;
  }

  T s, sd, sdd;
  quintic(t, t0, tf, (T)0, (T)0, (T)1, (T)0, s, sd, sdd);
  T q0[4], qf[4], qs[4], Rt[9], Rrel[9], aa[3];
  matrix_to_quat(sp.rot_init, q0);
  matrix_to_quat(sp.rot_des, qf);
  quat_slerp(q0, qf, s, qs);
  quat_to_matrix(qs, Rt);
  for (int i = 0; i < 3; ++i)          // rot_des · rot_initᵀ
    for (int j = 0; j < 3; ++j) {
      T acc = sp.rot_des[3 * i] * sp.rot_init[3 * j];
      for (int k = 1; k < 3; ++k) acc += sp.rot_des[3 * i + k] * sp.rot_init[3 * j + k];
      Rrel[3 * i + j] = acc;
    }
  rotation_log(Rrel, aa);
  // GetPhi(rot, Rt) = ½ Σ_c col_c(rot) × col_c(Rt)
  T phi[3] = {0, 0, 0};
  for (int c = 0; c < 3; ++c) {
    const T a0 = rot[c], a1 = rot[3 + c], a2 = rot[6 + c];
    const T b0 = Rt[c], b1 = Rt[3 + c], b2 = Rt[6 + c];
    phi[0] += a1 * b2 - a2 * b1;
    phi[1] += a2 * b0 - a0 * b2;
    phi[2] += a0 * b1 - a1 * b0;
  }
  for (int k = 0; k < 3; ++k) {
    // during the blend the feedforward is the slerp rate; once the spline
    // completes (s = 1, sd = 0) it hands off to the terminal w_des
    const T w_traj = aa[k] * sd + (s >= (T)1 ? sp.w_des[k] : (T)0);
    const T r_err = clip_sym((T)0.5 * phi[k], sp.max_p_err[3 + k]);
    const T wd_err = clip_sym(w_traj - w[k], sp.max_d_err[3 + k]);
    f6[3 + k] = sp.rot_p[k] * r_err + sp.rot_d[k] * wd_err;
  }
}

}  // namespace dwbc
