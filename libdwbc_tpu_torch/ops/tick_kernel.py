"""The fused WBC tick, element-leading, in plain PyTorch: q → τ.

Counterpart of ``libdwbc_tpu/ops/tick_kernel.py::TickProgram``, static and
masked (a candidate contact set with a per-scenario contact mask), with the
on-device trajectory-PD servo.  It is the plain version of the two CUDA
kernels in ``csrc/`` and has the same stage boundary:

* ``prestage(q, cmask, qdot, servo_req) -> dict``: forward kinematics with a quaternion base, dof
  frames, point jacobians, the world-origin composite-rigid-body mass matrix
  A, G = −A[0:3]ᵀg, A⁻¹, the contact space (J_C, Mc, Λc, J̄c, P_C, rank
  health), the kernel basis V2, the factored W-apply, NwJw, τ_grav, the
  per-level JKT and Ntorque, and the constraint rows Atemp, bA0; with a
  servo request also the per-body velocities and each servo'd task link's
  (pos, vel, rot, w);
* ``_apply_servos_el(pre, fstars, servos)``: each servo'd task link's f*
  rows from its trajectory PD (``_servo_fstar_el``), blended by use_pos /
  use_rot;
* ``qpchain(pre, fstars, warm, iters) -> dict``: the per-level one-sided
  Mehrotra IPMs with mirrored ±τ-limit rows, the redistribution QP, the
  torque sums and the contact force.

Values are element-leading with the batch trailing (``ops/elemlin.py``),
on any device and in float32 or float64.  At float32 the task-space
inverses get the relative ridge 1e-4·max|diag| and the IPM its float32
constants, exactly as the JAX program does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import elemlin as el
from ..wbc import types as T

_SIX = (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_6D_CUSTOM_FRAME)
_POS = (T.TASK_LINK_POSITION, T.TASK_LINK_POSITION_COM_FRAME,
        T.TASK_LINK_POSITION_CUSTOM_FRAME)
_COM_FRAME = (T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_POSITION_COM_FRAME)
_CUSTOM = (T.TASK_LINK_6D_CUSTOM_FRAME, T.TASK_LINK_POSITION_CUSTOM_FRAME,
           T.TASK_LINK_ROTATION_CUSTOM_FRAME)


# μ and max |r_p| at or below which the tick IPM stops on a lost Gram pivot
# (TickProgram._ipm): the tick's failure bars, PipelineConfig.qp_fail_gap /
# qp_fail_pres (csrc/ipm.cuh::kLostPivotNear)
LOST_PIVOT_NEAR = 1e-3

# elem shapes of ServoParams fields (wbc/pipeline.py::ServoParams): FusedTick
# tells batched from unbatched leaves by them, and the CUDA prestage reads a
# servo'd task's fields in their sorted order (68 values)
SERVO_ELEM_SHAPES = dict(
    t=(), t0=(), tf=(), use_pos=(), use_rot=(),
    pos_init=(3,), vel_init=(3,), pos_des=(3,), vel_des=(3,),
    w_init=(3,), w_des=(3,), pos_p=(3,), pos_d=(3,), pos_a=(3,),
    rot_p=(3,), rot_d=(3,), rot_init=(3, 3), rot_des=(3, 3),
    max_p_err=(6,), max_d_err=(6,),
)


# ---------------------------------------------------------------------------
# Element-leading rotation and servo primitives: (elem...)+bt counterparts of
# kin/rotations.py, utils/traj.py::quintic_spline and
# wbc/pipeline.py::servo_fstar
# ---------------------------------------------------------------------------

def _quat_to_matrix_el(qv):
    """(4,)+bt (x, y, z, w) → (3, 3)+bt."""
    x, y, z, w = qv[0], qv[1], qv[2], qv[3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], 0),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], 0),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], 0),
    ], 0)


def _matrix_to_quat_el(R):
    """(3, 3)+bt → (4,)+bt with w ≥ 0; the four candidates in the order of
    kin/rotations.py::matrix_to_quat."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, 1e-30)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], 0)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], 0)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], 0)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], 0)
    use0 = (tr > 0.0)[None]
    usex = ((m00 >= m11) & (m00 >= m22))[None]
    usey = (m11 >= m22)[None]
    q = torch.where(use0, q0, torch.where(usex, q1, torch.where(usey, q2, q3)))
    return torch.where(q[3:4] < 0, -q, q)


def _quat_slerp_el(q0, q1, t):
    """(4,)+bt, (4,)+bt, (*bt) → (4,)+bt."""
    d = (q0 * q1).sum(0)
    q1 = torch.where(d[None] < 0, -q1, q1)
    d = torch.clamp(d.abs(), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-8
    denom = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / denom)
    w1 = torch.where(small, t, torch.sin(t * theta) / denom)
    out = w0[None] * q0 + w1[None] * q1
    return out / torch.sqrt((out * out).sum(0))[None]


def _rotation_log_el(R):
    """(3, 3)+bt → angle·axis (3,)+bt."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], 0)
    sin_t = torch.sin(theta)
    small = sin_t.abs() < 1e-8
    scale = torch.where(small, 0.5, theta / (2.0 * torch.where(small, 1.0, sin_t)))
    return v * scale[None]


def _get_phi_el(Rc, Rd):
    """½ Σ_i col_i(Rc) × col_i(Rd) (DWBC::GetPhi)."""
    s = el.cross(Rc[:, 0], Rd[:, 0])
    s = s + el.cross(Rc[:, 1], Rd[:, 1])
    s = s + el.cross(Rc[:, 2], Rd[:, 2])
    return 0.5 * s


def _quintic_el(t, t0, tf, x0, v0, xf, vf):
    """Quintic with zero end accelerations on (k,)+bt end points and (*bt)
    clocks (quintic_spline with a0 = af = 0)."""
    ts = tf - t0
    ts3, ts4, ts5 = ts**3, ts**4, ts**5
    b1 = xf - x0 - v0 * ts[None]
    b2 = vf - v0
    a4 = (20.0 * b1 - 8.0 * b2 * ts[None]) / (2.0 * ts3)[None]
    a5 = (-30.0 * b1 + 14.0 * b2 * ts[None]) / (2.0 * ts4)[None]
    a6 = (12.0 * b1 - 6.0 * b2 * ts[None]) / (2.0 * ts5)[None]
    tc = (torch.minimum(torch.maximum(t, t0), tf) - t0)[None]
    pos = x0 + v0 * tc + a4 * tc**3 + a5 * tc**4 + a6 * tc**5
    vel = v0 + 3 * a4 * tc**2 + 4 * a5 * tc**3 + 5 * a6 * tc**4
    acc = 6 * a4 * tc + 12 * a5 * tc**2 + 20 * a6 * tc**3
    before, after = (t < t0)[None], (t > tf)[None]
    pos = torch.where(before, x0, torch.where(after, xf, pos))
    vel = torch.where(before, v0, torch.where(after, vf, vel))
    acc = torch.where(before | after, 0.0, acc)
    return pos, vel, acc


def _servo_fstar_el(sp, pos, vel, rot, w):
    """The trajectory and PD servo of one task link, element-leading: sp
    holds the ServoParams fields as (elem...)+bt tensors.  Returns (6,)+bt
    [f*_pos; f*_rot]."""
    def clip(x, lim):
        return torch.minimum(torch.maximum(x, -lim), lim)

    pos_traj, vel_traj, acc_traj = _quintic_el(
        sp["t"], sp["t0"], sp["tf"], sp["pos_init"], sp["vel_init"], sp["pos_des"],
        sp["vel_des"])
    p_err = clip(pos_traj - pos, sp["max_p_err"][0:3])
    d_err = clip(vel_traj - vel, sp["max_d_err"][0:3])
    f_pos = sp["pos_a"] * acc_traj + sp["pos_p"] * p_err + sp["pos_d"] * d_err

    z = torch.zeros_like(sp["t"])[None]
    s_sc, sd_sc, _ = _quintic_el(sp["t"], sp["t0"], sp["tf"], z, z, z + 1.0, z)
    s_sc, sd_sc = s_sc[0], sd_sc[0]
    q0 = _matrix_to_quat_el(sp["rot_init"])
    qf = _matrix_to_quat_el(sp["rot_des"])
    rot_traj = _quat_to_matrix_el(_quat_slerp_el(q0, qf, s_sc))
    aa = _rotation_log_el(el.mmT(sp["rot_des"], sp["rot_init"]))
    w_traj = aa * sd_sc[None] + torch.where(s_sc[None] >= 1.0, sp["w_des"], 0.0)
    r_err = clip(_get_phi_el(rot, rot_traj), sp["max_p_err"][3:6])
    wd_err = clip(w_traj - w, sp["max_d_err"][3:6])
    f_rot = sp["rot_p"] * r_err + sp["rot_d"] * wd_err
    return torch.cat([f_pos, f_rot], 0)


def _np_zmp_block(lx, ly):
    Z = np.zeros((4, 6))
    Z[0, 2], Z[0, 4] = -lx, -1.0
    Z[1, 2], Z[1, 4] = -lx, 1.0
    Z[2, 2], Z[2, 3] = -ly, -1.0
    Z[3, 2], Z[3, 3] = -ly, 1.0
    return Z


def _np_force_block(mu, mu_z):
    F = np.zeros((6, 6))
    F[0, 0], F[0, 2] = 1.0, -mu
    F[1, 0], F[1, 2] = -1.0, -mu
    F[2, 1], F[2, 2] = 1.0, -mu
    F[3, 1], F[3, 2] = -1.0, -mu
    F[4, 5], F[4, 2] = 1.0, -mu_z
    F[5, 5], F[5, 2] = -1.0, -mu_z
    return F


def np_constraint_block(c):
    """Static per-contact constraint block: ZMP rows, then the friction
    pyramid and the torsional friction rows."""
    Z = _np_zmp_block(c.plane_x, c.plane_y)
    F = _np_force_block(c.friction_ratio, c.friction_ratio_z)
    if c.contact_type == T.CONTACT_6D:
        return np.concatenate([Z, F], axis=0)
    if c.contact_type == T.CONTACT_POINT:
        return F[:, 0:3]
    if c.contact_type == T.CONTACT_LINE:
        cols = [0, 1, 2, 4, 5]
        return np.concatenate([Z[0:2][:, cols], F[:, cols]], axis=0)
    raise ValueError(c.contact_type)


_ROW_MASK = {               # live rows of a candidate's 6 padded jacobian rows
    T.CONTACT_6D: np.ones(6),
    T.CONTACT_POINT: np.array([1.0, 1, 1, 0, 0, 0]),
    T.CONTACT_LINE: np.array([1.0, 1, 1, 0, 1, 1]),   # local-x moment dropped
}
_CROW_MASK = {              # live rows of a candidate's padded [ZMP(4); cone(6)]
    T.CONTACT_6D: np.ones(10),
    T.CONTACT_POINT: np.array([0.0, 0, 0, 0, 1, 1, 1, 1, 1, 1]),
    T.CONTACT_LINE: np.array([1.0, 1, 0, 0, 1, 1, 1, 1, 1, 1]),
}


class TickPlan:
    """The static plan of one tick configuration (numpy only): the tree,
    the point-jacobian slots (contacts first, then task points), the
    contact and constraint dims, and the QP dims per level.

    masked=True: ``cfg.contacts`` is a candidate set, padded to 6 jacobian
    rows and 10 constraint rows each, and a per-scenario contact mask picks
    the active candidates (``row_mask`` and ``crow_mask`` are the static
    per-type masks of those padded rows)."""

    def __init__(self, model, cfg, masked=False):
        m = model
        if not m.floating:
            raise ValueError("fused tick: floating-base models only")
        self.model = model
        self.cfg = cfg
        self.masked = masked
        self.nbody = int(m.nbody)
        self.ndof = int(m.ndof)
        self.nq = int(m.nq)
        self.mdof = int(m.model_dof)
        self.parent = [int(x) for x in m.parent]
        self.q_index = [int(x) for x in m.q_index]
        self.com = np.asarray(m.com, np.float64)
        self.amask = np.asarray(m.ancestor_mask, np.float64)

        # dof owners: the body carrying each joint dof; base dofs -> body 0
        owner = np.zeros(self.ndof, np.int64)
        for i in range(1, self.nbody):
            owner[self.q_index[i]] = i
        self.owner = [int(x) for x in owner]
        # A[i, j] (i ≤ j) is filled only where dof i lies on the chain
        # root → body(j)
        self.anc_pairs = np.array([
            [i <= j and self.amask[self.owner[j], i] > 0.5
             for j in range(self.ndof)]
            for i in range(self.ndof)
        ])

        self.points: list[tuple[int, tuple[float, float, float]]] = []

        def point_slot(link, pt):
            e = (int(link), tuple(float(x) for x in np.asarray(pt)))
            if e not in self.points:
                self.points.append(e)
            return self.points.index(e)

        self.contact_slots = [point_slot(c.link, c.contact_point)
                              for c in cfg.contacts]
        self.task_slots = []          # per level: list of (kind, slot, mode)
        self.uses_tot = False
        for level in cfg.task_specs:
            lv = []
            for spec in level:
                mode, link = spec[0], spec[1]
                pt = np.asarray(spec[2], np.float64) if len(spec) > 2 else None
                if link == self.nbody:
                    lv.append(("tot", None, mode))
                    self.uses_tot = True
                elif mode in _COM_FRAME:
                    lv.append(("pt", point_slot(link, self.com[link]), mode))
                elif pt is not None and mode in _CUSTOM:
                    lv.append(("pt", point_slot(link, pt), mode))
                else:
                    lv.append(("pt", point_slot(link, (0.0, 0.0, 0.0)), mode))
            self.task_slots.append(lv)
        self.level_tdofs = [sum(6 if mode in _SIX else 3 for _, _, mode in lv)
                            for lv in self.task_slots]

        if masked:
            # padded layout: every candidate gets 6 jacobian rows and the
            # full (10, 6) [ZMP; cone] block; per-type dead rows are masked
            # statically, inactive candidates per scenario
            nc = len(cfg.contacts)
            self.cdof = 6 * nc
            self.const_blocks = [np.concatenate([
                _np_zmp_block(c.plane_x, c.plane_y),
                _np_force_block(c.friction_ratio, c.friction_ratio_z)], 0)
                for c in cfg.contacts]
            self.row_mask = np.concatenate([_ROW_MASK[c.contact_type] for c in cfg.contacts])
            self.crow_mask = np.concatenate([_CROW_MASK[c.contact_type]
                                             for c in cfg.contacts])
        else:
            self.cdof = sum(c.contact_dof for c in cfg.contacts)
            self.const_blocks = [np_constraint_block(c) for c in cfg.contacts]
        self.cfree = max(self.cdof - 6, 0)
        self.k_rows = sum(b.shape[0] for b in self.const_blocks)
        self.tlim = (None if cfg.torque_limit is None
                     else np.asarray(cfg.torque_limit, np.float64))

        # QP (n, m) per level + redistribution: the warm-state contract
        lim_rows = 2 * self.mdof if self.tlim is not None else 0
        self.qp_dims = [(t + self.cfree, lim_rows + self.k_rows)
                        for t in self.level_tdofs]
        if self.cfree > 0:
            self.qp_dims.append((self.cfree, lim_rows + self.k_rows))


class TickProgram(nn.Module):
    """Plain element-leading tick for one configuration.  The model's
    constant tables are buffers in ``dtype`` on ``device``.  masked=True:
    the multi-contact-mode tick over a candidate set (see ``TickPlan``).

    ``hold_lost_pivots`` (default True): the IPM's handling of a lost Gram
    pivot (``_ipm``); False runs the JAX package's recurrence, which steps
    from the clamped factor, for comparisons."""

    def __init__(self, model, cfg, device, dtype, masked=False):
        super().__init__()
        from ..convert import tick_tables

        self.plan = TickPlan(model, cfg, masked=masked)
        self.dtype = dtype
        self.hold_lost_pivots = True
        for name, t in tick_tables(model, cfg, device, dtype).items():
            self.register_buffer(name, t, persistent=False)

    # ----------------------------------------------------------- prestage
    def prestage(self, q, cmask=None, qdot=None, servo_req=None):
        """q (nq,)+bt → dict of what the QP chain and the result need.
        cmask (nc,)+bt: per-scenario 0/1 activity of each candidate contact
        (masked mode only); the dict then also holds ``crow_mask``
        (k_rows,)+bt and ``active_cdof`` (*bt).  servo_req: per level, per
        task spec, whether the spec is servo'd; the dict then holds
        ``task_states[(level, spec)] = (pos, vel, rot, w)`` of each, from the
        per-body velocities of qdot (ndof,)+bt."""
        P = self.plan
        dtype = q.dtype
        f32 = dtype == torch.float32
        bt = q.shape[1:]
        nb = len(bt)
        zero = torch.zeros_like(q[0])

        def c_(t):                      # constant → broadcast over bt
            t = t.to(device=q.device, dtype=dtype)
            return t.reshape(tuple(t.shape) + (1,) * nb)

        # ---------------- FK
        x_, y_, z_, w_ = q[3], q[4], q[5], q[P.ndof]
        n2 = x_ * x_ + y_ * y_ + z_ * z_ + w_ * w_
        s = torch.where(n2 > 0, 2.0 / n2, zero)
        xs, ys, zs = x_ * s, y_ * s, z_ * s
        wx, wy, wz = w_ * xs, w_ * ys, w_ * zs
        xx, xy, xz = x_ * xs, x_ * ys, x_ * zs
        yy, yz, zz = y_ * ys, y_ * zs, z_ * zs
        R0 = torch.stack([
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], 0),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], 0),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], 0),
        ], 0)
        p0 = q[0:3]

        I3 = c_(torch.eye(3, dtype=dtype, device=q.device))
        R, p = [R0], [p0]
        axis_w = [torch.zeros_like(p0)]
        com_w = [p0 + el.mv(R0, c_(self.com[0]))]
        for i in range(1, P.nbody):
            par = P.parent[i]
            qi = q[P.q_index[i]]
            c, sn = torch.cos(qi), torch.sin(qi)
            Rj = c * I3 + sn * c_(self.axis_skew[i]) + (1.0 - c) * c_(self.axis_outer[i])
            Ri = el.mm(R[par], el.mm(c_(self.X_rot[i]).expand_as(Rj), Rj))
            pi = p[par] + el.mv(R[par], c_(self.X_trans[i]))
            R.append(Ri)
            p.append(pi)
            axis_w.append(el.mv(Ri, c_(self.axis[i])))
            com_w.append(pi + el.mv(Ri, c_(self.com[i])))

        # ---------------- dof frames: base translation, base rotation about
        # R0's columns, then one revolute axis per joint
        ax = torch.cat([el.eye(3, zero), R0,
                        torch.stack([axis_w[P.owner[j]]
                                     for j in range(6, P.ndof)], 1)], 1)
        og = torch.stack([p0] * 6 + [p[P.owner[j]] for j in range(6, P.ndof)], 1)

        # ---------------- point jacobians (6, ndof)+bt per planned point
        J_pts = []
        for k, (link, pt) in enumerate(P.points):
            pw = p[link] + el.mv(R[link], c_(self.pt_off[k])) if any(pt) else p[link]
            rel = pw[:, None] - og
            jvr = torch.stack([
                ax[1] * rel[2] - ax[2] * rel[1],
                ax[2] * rel[0] - ax[0] * rel[2],
                ax[0] * rel[1] - ax[1] * rel[0],
            ], 0)
            jv = torch.cat([ax[:, 0:3], jvr[:, 3:]], 1)
            jw = torch.cat([torch.zeros_like(ax[:, 0:3]), ax[:, 3:]], 1)
            mask = c_(self.amask[link])[None]
            J_pts.append(torch.cat([jv * mask, jw * mask], 0))

        # ---------------- mass matrix: world-origin composite rigid body
        Rs = torch.stack(R, 0)                           # (nbody,3,3)+bt
        cw = torch.stack(com_w, 0)                       # (nbody,3)+bt
        mass = self.mass.reshape((-1,) + (1,) * nb)
        Icm = torch.einsum("bik...,bkl,bjl...->bij...", Rs, self.inertia, Rs)
        cc = (cw * cw).sum(1)
        I_ang = (Icm - mass[:, None, None] * cw[:, :, None] * cw[:, None, :]
                 + (mass * cc)[:, None, None] * I3[None])
        zb = torch.zeros_like(cw[:, 0])
        chat = torch.stack([
            torch.stack([zb, -cw[:, 2], cw[:, 1]], 1),
            torch.stack([cw[:, 2], zb, -cw[:, 0]], 1),
            torch.stack([-cw[:, 1], cw[:, 0], zb], 1),
        ], 1)                                            # (nbody,3,3)+bt
        mchat = mass[:, None, None] * chat
        mEye = (mass[:, None, None] * I3[None]).expand_as(chat)
        IC = torch.cat([torch.cat([I_ang, mchat], 2),
                        torch.cat([-mchat, mEye], 2)], 1)  # (nbody,6,6)+bt
        IC = list(IC.unbind(0))
        for i in range(P.nbody - 1, 0, -1):
            IC[P.parent[i]] = IC[P.parent[i]] + IC[i]

        S = torch.cat([ax, el.cross(og, ax)], 0)         # (6, ndof)+bt
        S[:, 0:3] = c_(torch.cat([torch.zeros(3, 3), torch.eye(3)], 0))
        ICo = torch.stack([IC[P.owner[j]] for j in range(P.ndof)], 0)
        F = torch.einsum("jab...,bj...->aj...", ICo, S)  # (6, ndof)+bt
        anc = self.anc_pairs.reshape(tuple(self.anc_pairs.shape) + (1,) * nb)
        Aup = torch.where(anc, el.mTm(S, F), zero)
        A = Aup + Aup.transpose(0, 1) * (1.0 - c_(torch.eye(P.ndof, dtype=dtype)))

        # gravity vector: G = −A[0:3,:]ᵀ g
        G = None
        for i in range(3):
            gi = float(P.model.gravity[i])
            if gi != 0.0:
                t = A[i] * (-gi)
                G = t if G is None else G + t

        A_inv = el.psd_inverse(A)
        out = {}

        if P.uses_tot:
            M = float(P.model.total_mass)
            skm = el.mm(R0, A[3:6, 0:3]) / M
            cfb = torch.stack([skm[2, 1], skm[0, 2], skm[1, 0]], 0)
            cfb_hat = torch.stack([
                torch.stack([zero, -cfb[2], cfb[1]], 0),
                torch.stack([cfb[2], zero, -cfb[0]], 0),
                torch.stack([-cfb[1], cfb[0], zero], 0),
            ], 0)
            CMM_bot = el.mm(el.transpose(cfb_hat), A[0:3]) + el.mm(R0, A[3:6])
            com_inertia = (el.mm(el.mm(R0, A[3:6, 3:6]), el.transpose(R0))
                           - M * el.mm(cfb_hat, el.transpose(cfb_hat)))
            Lci = el.chol(com_inertia)
            y = el.solve_lower(Lci, CMM_bot)
            U = el.transpose(Lci)
            xs_ = [None] * 3
            for i2 in reversed(range(3)):
                acc = y[i2]
                for k2 in range(i2 + 1, 3):
                    acc = acc - U[i2, k2][None] * xs_[k2]
                xs_[i2] = acc / U[i2, i2][None]
            out["Jcom_total"] = torch.cat([A[0:3] / M, torch.stack(xs_, 0)], 0)

        # ---------------- servo'd task links' states (pipeline._task_state)
        if servo_req is not None and any(any(lv) for lv in servo_req):
            if qdot is None:
                raise ValueError("a servo'd tick needs qdot")
            # per-body angular and origin velocities, world frame
            w_b, v_b = [el.mv(R0, qdot[3:6])], [qdot[0:3]]
            for i in range(1, P.nbody):
                par = P.parent[i]
                w_b.append(w_b[par] + axis_w[i] * qdot[P.q_index[i]][None])
                v_b.append(v_b[par] + el.cross(w_b[par], p[i] - p[par]))
            tstates = {}
            for h, lv in enumerate(servo_req):
                for j, need in enumerate(lv):
                    if not need:
                        continue
                    kind, slot, _ = P.task_slots[h][j]
                    if kind == "tot":
                        M = float(P.model.total_mass)
                        skm = el.mm(R0, A[3:6, 0:3]) / M
                        cpos = torch.stack([skm[2, 1], skm[0, 2], skm[1, 0]], 0) + q[0:3]
                        cvel = el.mv(out["Jcom_total"], qdot)[0:3]
                        tstates[(h, j)] = (cpos, cvel, el.eye(3, zero), torch.zeros_like(cpos))
                        continue
                    link, pt = P.points[slot]
                    ppos, pvel = p[link], v_b[link]
                    if any(pt):
                        rr = el.mv(R[link], c_(self.pt_off[slot]))
                        ppos, pvel = ppos + rr, pvel + el.cross(w_b[link], rr)
                    tstates[(h, j)] = (ppos, pvel, R[link], w_b[link])
            out["task_states"] = tstates

        # ---------------- contact jacobian rows (per contact type; masked:
        # 6 padded rows per candidate, LINE moment rows contact-local so the
        # statically dead row is the local-x moment)
        Jc_rows = []
        for slot, c in zip(P.contact_slots, P.cfg.contacts):
            J6 = J_pts[slot]
            if c.contact_type == T.CONTACT_LINE:
                Jloc = el.mm(el.transpose(R[c.link]), J6[3:6])
                Jc_rows.append(torch.cat([J6[0:3], Jloc if P.masked else Jloc[1:3]], 0))
            elif c.contact_type == T.CONTACT_POINT and not P.masked:
                Jc_rows.append(J6[0:3])
            else:
                Jc_rows.append(J6)
        J_C = torch.cat(Jc_rows, 0)                      # (cdof, ndof)+bt
        row_mask = None
        if P.masked:
            row_mask = torch.repeat_interleave(cmask, 6, 0) * c_(torch.as_tensor(P.row_mask))
            J_C = J_C * row_mask[:, None]

        # ---------------- contact space
        JAinv = el.mm(J_C, A_inv)
        Mc = el.mmT_sym(JAinv, J_C)
        if P.masked:
            # +1 on the inactive diagonal: the active block inverts exactly
            Mc = el.diag_add(Mc, list(1.0 - row_mask))
        health = torch.minimum(
            el.chol_health(Mc),
            el.chol_health(el.mTm_sym(J_C[:, 0:6], J_C[:, 0:6])),
        )
        Lambda_c = el.psd_inverse(Mc)
        if P.masked:
            Lambda_c = Lambda_c * row_mask[:, None] * row_mask[None]
        Jbar = el.mm(Lambda_c, JAinv)                    # J̄_cᵀ (cdof, ndof)+bt
        P_C = el.mv(Jbar, G)
        NCG = G - el.mTv(J_C, P_C)
        Wfree = A_inv[6:, 6:] - el.mTm_sym(JAinv[:, 6:], Jbar[:, 6:])

        # W⁻¹ is never formed: it is applied through the Cholesky factor of
        # Wfree + V2V2ᵀ with a rank-cfree correction
        V2T = None
        if P.cfree > 0 and not P.masked:
            Ny = el.complete_basis(J_C[:, 0:6])[:, 6:]   # (cdof, cfree)+bt
            V2T = el.qr_thin(el.mTm(J_C[:, 6:], Ny))     # (mdof, cfree)+bt
            L_W, idg_W = el.chol_factor(Wfree + el.mmT_sym(V2T, V2T))
            NwJw = el.mm(V2T, el.qr_pinv(el.mm(Jbar[0:P.cfree, 6:], V2T)))
        elif P.cfree > 0:
            # masked kernel basis: rank active_cdof − 6 ≤ cfree; the dead
            # directions are exact zero columns, compacted to the right
            Ny = el.complete_basis(J_C[:, 0:6])[:, 6:]
            V2T, _ = el.compact_columns(el.orthonormalize_drop(el.mTm(J_C[:, 6:], Ny)))
            L_W, idg_W = el.chol_factor(Wfree + el.mmT_sym(V2T, V2T))
            # NwJw normalises against the first (active_cdof − 6) ACTIVE rows
            # of J̄ᵀ: sel[t, i] = 1 iff row i is the t-th active row and
            # t < active_cdof − 6; the inner system's dead rows and columns
            # are padded with identity
            lim = row_mask.sum(0) - 6.0
            idx = torch.cumsum(row_mask, 0) - 1.0        # (# active rows ≤ i) − 1
            t = el._bt(torch.arange(P.cfree, dtype=dtype, device=q.device), nb)
            live = (t < lim[None]).to(dtype)             # (cfree,)+bt
            sel = (row_mask[None] * ((idx[None] - t[:, None]).abs() < 0.5).to(dtype)
                   * live[:, None])                      # (cfree, cdof)+bt
            inner = el.mm(sel, el.mm(Jbar[:, 6:], V2T)) * live[:, None] * live[None]
            inner = el.diag_add(inner, list(1.0 - live))
            NwJw = el.mm(V2T, el.qr_pinv(inner)) * live[None]
        else:
            L_W, idg_W = el.chol_factor(Wfree)
            NwJw = None

        def W_apply(Bm):
            """W⁻¹ @ Bm for a (mdof, t)+bt right-hand side."""
            Y = el.cho_solve_mat(L_W, idg_W, Bm)
            if V2T is not None:
                Y = Y - el.mm(V2T, el.mTm(V2T, Bm))
            return Y

        torque_grav = W_apply(el.mv(A_inv[6:], NCG)[:, None])[:, 0]

        def _reg(Ms):
            """κ-bounding relative ridge 1e-4·max|diag|, float32 only."""
            if not f32:
                return Ms
            dmax = torch.stack([Ms[i, i].abs() for i in range(Ms.shape[0])], 0).amax(0)
            return el.diag_add(Ms, [1e-4 * dmax] * Ms.shape[0])

        # ---------------- per-level JKT + Ntorque
        Ntorques = []
        prev_null = None                                  # None == identity
        for lv, slots in enumerate(P.task_slots):
            trows = []
            for kind, slot, mode in slots:
                J6 = out["Jcom_total"] if kind == "tot" else J_pts[slot]
                trows.append(J6 if mode in _SIX else J6[0:3] if mode in _POS
                             else J6[3:6])
            J_task = torch.cat(trows, 0)                  # (t, ndof)+bt
            JtA = el.mm(J_task, A_inv)
            JAN = JtA - el.mm(el.mmT(JtA, J_C), Jbar)
            Lam = el.psd_inverse(_reg(el.mmT_sym(JAN, J_task)))
            Q = el.mm(Lam, JAN)[:, 6:]                    # (t, mdof)+bt
            WQt = W_apply(el.transpose(Q))                # (mdof, t)+bt
            inv_mid = el.psd_inverse(_reg(el.mm_sym(Q, WQt)))
            J_kt = el.mm(WQt, inv_mid)
            JktLam = el.mm(J_kt, Lam)
            Ntorques.append(JktLam if prev_null is None else el.mm(prev_null, JktLam))
            if lv < len(P.task_slots) - 1:
                nn_ = el.eye(P.mdof, zero) - el.mm(J_kt, Q)
                prev_null = nn_ if prev_null is None else el.mm(prev_null, nn_)

        # ---------------- constraint rows: CM blocks, Atemp, bA0
        Atemp_rows, bA0_rows = [], []
        r = 0
        for k, c in enumerate(P.cfg.contacts):
            blk = P.const_blocks[k]
            RT = el.transpose(R[c.link])
            if c.contact_type == T.CONTACT_LINE:
                # the moment rows of J_C are already contact-local: they pass
                # through (masked: all three, of which local x is dead)
                CMi = torch.cat([el.mm_sd(blk[:, 0:3], RT),
                                 el.smat(blk[:, 3:6] if P.masked else blk[:, 3:5], zero)], 1)
            elif c.contact_type == T.CONTACT_POINT and not P.masked:
                CMi = el.mm_sd(blk, RT)
            else:
                CMi = torch.cat([el.mm_sd(blk[:, 0:3], RT), el.mm_sd(blk[:, 3:6], RT)], 1)
            dd = 6 if P.masked else c.contact_dof
            Atemp_rows.append(el.mm(CMi, Jbar[r:r + dd, 6:]))
            bA0_rows.append(el.mv(CMi, P_C[r:r + dd]))
            r += dd

        out.update(
            torque_grav=torque_grav,
            P_C=P_C,
            Jbar_act=Jbar[:, 6:],
            NwJw=NwJw,
            Ntorques=Ntorques,
            Atemp=torch.cat(Atemp_rows, 0),              # (k_rows, mdof)+bt
            bA0=torch.cat(bA0_rows, 0),                  # (k_rows,)+bt
            health=health,
        )
        if P.masked:
            out["crow_mask"] = (torch.repeat_interleave(cmask, 10, 0)
                                * c_(torch.as_tensor(P.crow_mask)))
            # per-lane active contact dof: the reference runs the
            # redistribution QP only when it exceeds 6
            out["active_cdof"] = row_mask.sum(0)
        return out

    # ------------------------------------------------------------ the IPM
    def _ipm(self, Hdiag, C, d, iters, warm, mirror):
        """One-sided QP min ½xᵀdiag(Hdiag)x s.t. Cx ≤ d.  C holds the STORED
        rows [B; D]; the mirrored −B block is folded into every reduction
        over the m = me + mirror rows.  Returns (x, s, lam, gap, pres)."""
        dtype = C.dtype
        f32 = dtype == torch.float32
        hold = self.hold_lost_pivots
        n, me = C.shape[1], C.shape[0]
        mr = mirror
        m = me + mr
        ridge = 1e-6 if f32 else 1e-9
        s_floor = 1e-10 if f32 else 1e-14
        w_cap = 1e8 if f32 else 1e12
        mu_tol = 5e-8 if f32 else 1e-13
        Hr_list = [h + ridge for h in Hdiag]
        Hr = torch.tensor(Hr_list, dtype=dtype, device=C.device).reshape(
            (n,) + (1,) * (C.ndim - 2))

        def matvec_C(x):
            acc = el.mv(C, x)                             # (me,)+bt
            return torch.cat([acc[:mr], -acc[:mr], acc[mr:]], 0) if mr else acc

        def fold(v, sign):
            if mr == 0:
                return v
            return torch.cat([v[:mr] + sign * v[mr:2 * mr], v[2 * mr:]], 0)

        def matvec_CT(v):
            return el.mTv(C, fold(v, -1.0))

        def chol_d(K):
            """Right-looking Cholesky, sqrt pivots clamped at 1e-30; also,
            per lane, whether a pivot was lost: fell to the clamp or, at
            float32, below 1e-6 of its diagonal entry before elimination (in
            float32 near convergence λ/s ~ 1e6 cancels a pivot of ~1 to
            noise or ≤ 0; on active constraints far from it the Gram is as
            ill-conditioned).  A lost pivot's reciprocal is 0 and its column
            leaves the elimination, so a step holds that variable (its dx is
            0) and moves the others (Wright's modified Cholesky for IPMs)."""
            L = torch.zeros_like(K)
            inv_diag = []
            S = K
            collapsed = torch.zeros_like(K[0, 0], dtype=torch.bool)
            for j in range(n):
                dj = torch.sqrt(torch.clamp_min(S[0, 0], 1e-30))
                inv_d = 1.0 / dj
                if hold:
                    lost = ~(S[0, 0] >= 1e-30)
                    if f32:
                        lost = lost | (S[0, 0] < 1e-6 * K[j, j])
                    collapsed = collapsed | lost
                    inv_d = torch.where(lost, torch.zeros_like(inv_d), inv_d)
                col = torch.cat([dj[None], S[1:, 0] * inv_d[None]], 0)
                L[j:, j] = col
                if j < n - 1:
                    ct = col[1:]
                    S = S[1:, 1:] - ct[:, None] * ct[None]
                inv_diag.append(inv_d)
            return L, torch.stack(inv_diag, 0), collapsed

        def cho_solve_vec(L, inv_diag, b):
            return el.cho_solve_mat(L, inv_diag, b[:, None])[:, 0]

        def factor(x, s_, lam):
            inv_s = 1.0 / torch.clamp_min(s_, s_floor)
            r_d = Hr * x + matvec_CT(lam)
            r_p = matvec_C(x) + s_ - d
            w = torch.clamp(lam * inv_s, 0.0, w_cap)
            K = el.diag_add(el.mTm(C * fold(w, 1.0)[:, None], C), Hr_list)
            L, inv_diag, collapsed = chol_d(K)
            return inv_s, r_d, r_p, w, L, inv_diag, collapsed

        def newton(fac, s_, lam, sigma_mu):
            inv_s, r_d, r_p, w, L, inv_diag, _ = fac
            r_c = s_ * lam - sigma_mu
            rhs = -r_d - matvec_CT(w * r_p - r_c * inv_s)
            dx = cho_solve_vec(L, inv_diag, rhs)
            ds = -(r_p + matvec_C(dx))
            dlam = -(r_c + lam * ds) * inv_s
            return dx, ds, dlam

        def alpha_max(v, dv):
            neg = dv < 0
            ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                                torch.full_like(v, 1e20))
            return torch.clamp_max(0.995 * ratio.amin(0), 1.0)

        if warm is not None:
            x, lam_in = warm
            s_ = torch.clamp_min(d - matvec_C(x), 1e-4)
            # clipped above too: a prior tick that hit an ε-infeasible row
            # legitimately diverged its dual
            lam = torch.clamp(lam_in, 1e-4, w_cap)
        else:
            x = torch.zeros((n,) + d.shape[1:], dtype=dtype, device=d.device)
            s_ = torch.clamp_min(d, 1.0)
            lam = torch.ones_like(d)

        for _ in range(iters):
            mu = (s_ * lam).sum(0) / m
            live = (mu > mu_tol).to(dtype)
            fac = factor(x, s_, lam)
            dx_a, ds_a, dlam_a = newton(fac, s_, lam, torch.zeros_like(s_))
            a_p = alpha_max(s_, ds_a)
            a_d = alpha_max(lam, dlam_a)
            mu_aff = ((s_ + a_p[None] * ds_a) * (lam + a_d[None] * dlam_a)).sum(0) / m
            sigma = (mu_aff / torch.clamp_min(mu, 1e-30)) ** 3
            target = sigma[None] * mu[None] - ds_a * dlam_a
            dx, ds, dlam = newton(fac, s_, lam, target)
            if warm is not None:
                a_pc = live * alpha_max(s_, ds)
                a_dc = live * alpha_max(lam, dlam)
            else:
                a_pc = live * torch.minimum(alpha_max(s_, ds), alpha_max(lam, dlam))
                a_dc = a_pc
            # skip a non-finite step, and on a lost pivot the step of a lane
            # already within the failure bars (the guard against moving
            # a converged lane along float32 noise); any other lane steps
            # with the lost pivot's variable held (chol_d)
            near = (mu <= LOST_PIVOT_NEAR) & (fac[2].abs().amax(0) <= LOST_PIVOT_NEAR)
            ok = ((dx * 0.0).sum(0) == 0.0) & ~(fac[6] & near)
            x = torch.where(ok, x + a_pc[None] * dx, x)
            s_ = torch.where(ok, s_ + a_pc[None] * ds, s_)
            # dual cap: keeps gap and the warm carry finite on ε-infeasible rows
            lam = torch.where(ok, torch.clamp_max(lam + a_dc[None] * dlam, w_cap), lam)

        slack = d - matvec_C(x)
        pres = torch.clamp_min(-slack, 0.0).amax(0)
        # normalized complementarity: a divergent-dual row counts ≈|slack|
        gap = (slack.abs() * (lam / (1.0 + lam))).sum(0) / m
        return x, s_, lam, gap, pres

    # ----------------------------------------------------------- QP chain
    def qpchain(self, pre, fstars, warm=None, iters=25):
        """The per-level task QPs, then the contact redistribution QP, with
        the torque sums.  warm: per QP (x, lam) element-leading, or None."""
        P = self.plan
        tg = pre["torque_grav"]
        NwJw = pre["NwJw"]
        Atemp = pre["Atemp"]
        bA0 = pre["bA0"]
        use_lim = P.tlim is not None
        mirror = P.mdof if use_lim else 0
        tlim = (self.tlim.to(tg.dtype).reshape((-1,) + (1,) * (tg.ndim - 1))
                if use_lim else None)

        crow = pre.get("crow_mask")

        def rows(blk, tau):
            """Stored constraint rows [blk; −Atemp·blk] and bounds; masked:
            the rows of inactive candidates become 0·x ≤ 1."""
            D = -el.mm(Atemp, blk)
            ub_c = el.mv(Atemp, tau) - bA0
            if crow is not None:
                D = D * crow[:, None]
                ub_c = torch.where(crow > 0.5, ub_c, torch.ones_like(ub_c))
            if not use_lim:
                return D, ub_c
            d = torch.cat([tlim - tau, tlim + tau, ub_c], 0)
            return torch.cat([blk, D], 0), d

        tau_task = torch.zeros_like(tg)
        tau_contact = torch.zeros_like(tg)
        gap = torch.zeros_like(tg[0])
        pres = torch.zeros_like(tg[0])
        warm_out = []
        nlev = len(P.task_slots)
        for h in range(nlev):
            Nt = pre["Ntorques"][h]                       # (mdof, t)+bt
            t = Nt.shape[1]
            blk = Nt if NwJw is None else torch.cat([Nt, NwJw], 1)
            nv = blk.shape[1]
            Cs, d = rows(blk, tg + tau_task + el.mv(Nt, fstars[h]))
            x, _, lam, g_, p_ = self._ipm((1.0,) * t + (0.0,) * (nv - t), Cs, d,
                                          iters, None if warm is None else warm[h],
                                          mirror)
            warm_out.append((x, lam))
            tau_task = tau_task + el.mv(Nt, fstars[h] + x[:t])
            if NwJw is not None:
                tau_contact = el.mv(NwJw, x[t:])
            gap = torch.maximum(gap, g_)
            pres = torch.maximum(pres, p_)

        if NwJw is not None:
            Cs, d = rows(NwJw, tg + tau_task + tau_contact)
            x, _, lam, g_, p_ = self._ipm((1.0,) * P.cfree, Cs, d, iters,
                                          None if warm is None else warm[nlev],
                                          mirror)
            warm_out.append((x, lam))
            tau_contact = tau_contact + el.mv(NwJw, x)
            if crow is not None:
                # a single-support lane has no redistribution problem (the
                # reference skips the QP unless active_cdof > 6): the padded
                # QP still runs, but its ε-infeasible dead rows must not
                # reach the lane's diagnostics
                live_redis = (pre["active_cdof"] > 6.5).to(g_.dtype)
                g_, p_ = g_ * live_redis, p_ * live_redis
            gap = torch.maximum(gap, g_)
            pres = torch.maximum(pres, p_)

        tau_cmd = tg + tau_task + tau_contact
        return dict(
            torque_grav=tg,
            torque_task=tau_task,
            torque_contact=tau_contact,
            torque_cmd=tau_cmd,
            contact_force=el.mv(pre["Jbar_act"], tau_cmd) - pre["P_C"],
            qp_gap=gap,
            qp_primal_res=pres,
            health=pre["health"],
            warm_out=tuple(warm_out),
        )

    # ------------------------------------------------------------ servos
    def servo_request(self, servos):
        """Per level, per task spec: whether ``servos`` (per level None or
        a tuple of per-spec dict-or-None) servos that spec."""
        return tuple(
            tuple(False for _ in slots) if h >= len(servos) or servos[h] is None
            else tuple(sp is not None for sp in servos[h])
            for h, slots in enumerate(self.plan.task_slots))

    def _apply_servos_el(self, pre, fstars, servos):
        """f* per level with the rows of each servo'd task link replaced by
        its trajectory-PD output (pipeline._apply_servos, element-leading).
        servos: per level None or a per-spec tuple of dict-or-None, each
        dict the ServoParams fields as (elem...)+bt tensors."""
        out_fs = []
        for h, slots in enumerate(self.plan.task_slots):
            f = fstars[h]
            lvl = servos[h] if h < len(servos) else None
            if lvl is None:
                out_fs.append(f)
                continue
            rows, off = [], 0
            for j, (_, _, mode) in enumerate(slots):
                nr = 6 if mode in _SIX else 3
                fj = f[off:off + nr]
                off += nr
                sp = lvl[j]
                if sp is None:
                    rows.append(fj)
                    continue
                f6 = _servo_fstar_el(sp, *pre["task_states"][(h, j)])
                up, ur = sp["use_pos"][None], sp["use_rot"][None]
                if mode in _SIX:
                    rows.append(torch.cat([up * f6[0:3] + (1.0 - up) * fj[0:3],
                                           ur * f6[3:6] + (1.0 - ur) * fj[3:6]], 0))
                elif mode in _POS:
                    rows.append(up * f6[0:3] + (1.0 - up) * fj)
                else:
                    rows.append(ur * f6[3:6] + (1.0 - ur) * fj)
            out_fs.append(torch.cat(rows, 0))
        return tuple(out_fs)

    def prestage_servo(self, q, cmask, qdot, fstars, servos):
        """The servo'd prestage as the CUDA kernel returns it: the fields
        and task states of ``prestage``, and under "fstars" the f* of every
        level with the servo's blend."""
        pre = self.prestage(q, cmask, qdot=qdot, servo_req=self.servo_request(servos))
        pre["fstars"] = list(self._apply_servos_el(pre, fstars, servos))
        return pre

    def tick(self, q, fstars, warm=None, iters=25, cmask=None, qdot=None, servos=None):
        """Full tick, element-leading: q (nq,)+bt → result dict.  cmask
        (nc,)+bt is required in masked mode and refused otherwise; servos
        (see ``_apply_servos_el``) need qdot (ndof,)+bt."""
        if (cmask is not None) != self.plan.masked:
            raise ValueError("a contact mask goes with masked mode, and only there")
        if servos is None:
            return self.qpchain(self.prestage(q, cmask), fstars, warm=warm, iters=iters)
        pre = self.prestage_servo(q, cmask, qdot, fstars, servos)
        return self.qpchain(pre, pre["fstars"], warm=warm, iters=iters)
