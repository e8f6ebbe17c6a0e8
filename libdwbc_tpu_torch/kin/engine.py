"""Batched kinematics and dynamics in torch (counterpart of
``libdwbc_tpu/kin/engine.py``): one function of (q, q̇) gives forward
kinematics, per-body velocities, body and point jacobians by ancestor-mask
products, the mass matrix as one Gram product, bias forces, A⁻¹, the COM,
the centroidal momentum matrix and the COM jacobian.

Conventions (RBDL parity, as in the JAX module): floating-base q is
``[x y z, qx qy qz, θ_1..θ_m, qw]`` (the quaternion's w at q[ndof]); q̇ is
``[v_world(3), ω_body(3), θ̇]``; jacobians are position rows first
``[Jv; Jw]``.  Leading batch dims are carried throughout.

``backend="cuda"`` routes A⁻¹ of a CUDA float32 batch to the ``psd_inverse``
kernel (``ops/linalg_cuda.py``); everything else is torch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import linalg_cuda
from ..ops import smallmat as sm
from .rotations import axis_angle_matrix, quat_to_matrix, skew


class FK(NamedTuple):
    """Forward-kinematics result (world frame). Leading batch dims allowed."""

    R: torch.Tensor          # (nbody,3,3) body→world rotation
    p: torch.Tensor          # (nbody,3)   body origin
    axis_w: torch.Tensor     # (nbody,3)   world joint axis (zeros for base)
    com_w: torch.Tensor      # (nbody,3)   body COM in world


class KinState(NamedTuple):
    """Everything UpdateKinematics produces."""

    q: torch.Tensor
    qdot: torch.Tensor
    R: torch.Tensor
    p: torch.Tensor
    w: torch.Tensor          # (nbody,3) body angular velocity, world frame
    v: torch.Tensor          # (nbody,3) body-origin linear velocity, world frame
    com_w: torch.Tensor
    J: torch.Tensor          # (nbody,6,ndof), or (len(J_bodies),6,ndof) when narrowed
    Jcom: torch.Tensor       # (nbody,6,ndof) at body COMs
    A: torch.Tensor          # (ndof,ndof) mass matrix
    A_inv: torch.Tensor
    B: torch.Tensor          # (ndof,) nonlinear effects incl. gravity
    G: torch.Tensor          # (ndof,) gravity vector (COM-jacobian form)
    com_pos: torch.Tensor
    com_vel: torch.Tensor
    com_inertia: torch.Tensor
    CMM: torch.Tensor        # (6,ndof) centroidal momentum matrix
    Jcom_total: torch.Tensor  # (6,ndof) COM 'link' jacobian = SI⁻¹·CMM
    J_pts: torch.Tensor = None  # (P,6,ndof) jacobians of update(points=...)


class Kinematics:
    """Kinematics/dynamics of one model; constants are made per dtype and
    device on first use."""

    def __init__(self, model, backend: str = "torch"):
        self.model = model
        m = model
        self.backend = backend
        self.nbody = m.nbody
        self.ndof = m.ndof
        # symmetric PSD square root of each body inertia, float64 numpy eigh
        # (massless pseudo-bodies stay exact): Iw = (R·S)(R·S)ᵀ
        ev, U = np.linalg.eigh(np.asarray(m.inertia, np.float64))
        inertia_sqrt = np.einsum("bij,bj,bkj->bik", U, np.sqrt(np.maximum(ev, 0.0)), U)
        self._np_consts = dict(
            X_T_rot=m.X_T_rot, X_T_trans=m.X_T_trans, axis=m.axis,
            mass=m.mass, com=m.com, inertia=m.inertia,
            sqrt_mass=np.sqrt(np.maximum(np.asarray(m.mass, np.float64), 0.0)),
            inertia_sqrt=inertia_sqrt, amask=m.ancestor_mask, gravity=m.gravity,
        )
        is_trans = np.zeros(self.ndof)
        if m.floating:
            is_trans[0:3] = 1.0            # the base's translation dofs
        self._np_consts["is_trans"] = is_trans
        self._cache = {}
        self.parent = [int(x) for x in m.parent]
        self.q_index = [int(x) for x in m.q_index]
        self.total_mass = m.total_mass
        owner = np.zeros(self.ndof, dtype=np.int64)
        for i in range(1, self.nbody):
            owner[self.q_index[i]] = i
        self._owner = owner

    def _c(self, name, like):
        key = (name, like.dtype, like.device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                np.asarray(self._np_consts[name], np.float64), dtype=like.dtype,
                device=like.device)
        return self._cache[key]

    # ------------------------------------------------------------------ FK
    def fk(self, q) -> FK:
        m = self.model
        X_rot, X_trans = self._c("X_T_rot", q), self._c("X_T_trans", q)
        axis, com = self._c("axis", q), self._c("com", q)
        if m.floating:
            quat = torch.stack([q[..., 3], q[..., 4], q[..., 5], q[..., self.ndof]], dim=-1)
            R0 = quat_to_matrix(quat)
            p0 = q[..., 0:3]
        else:
            R0 = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:-1] + (3, 3))
            p0 = q.new_zeros(q.shape[:-1] + (3,))
        Rs, ps, axs = [R0], [p0], [torch.zeros_like(p0)]
        for i in range(1, self.nbody):
            par = self.parent[i]
            Rj = axis_angle_matrix(axis[i], q[..., self.q_index[i]])
            Ri = Rs[par] @ (X_rot[i] @ Rj)
            ps.append(ps[par] + Rs[par] @ X_trans[i])
            Rs.append(Ri)
            axs.append(Ri @ axis[i])
        R = torch.stack(Rs, dim=-3)
        p = torch.stack(ps, dim=-2)
        axis_w = torch.stack(axs, dim=-2)
        com_w = p + (R @ com[..., None])[..., 0]
        return FK(R, p, axis_w, com_w)

    # ---------------------------------------------------------- velocities
    def velocities(self, fk: FK, qdot):
        """Per-body angular/origin-linear velocity (world)."""
        if self.model.floating:
            w0 = (fk.R[..., 0, :, :] @ qdot[..., 3:6, None])[..., 0]
            v0 = qdot[..., 0:3]
        else:
            w0 = qdot.new_zeros(qdot.shape[:-1] + (3,))
            v0 = torch.zeros_like(w0)
        ws, vs = [w0], [v0]
        for i in range(1, self.nbody):
            par = self.parent[i]
            qd = qdot[..., self.q_index[i]]
            ws.append(ws[par] + fk.axis_w[..., i, :] * qd[..., None])
            r = fk.p[..., i, :] - fk.p[..., par, :]
            vs.append(vs[par] + torch.linalg.cross(ws[par], r, dim=-1))
        return torch.stack(ws, dim=-2), torch.stack(vs, dim=-2)

    # ----------------------------------------------------------- jacobians
    def _dof_frames(self, fk: FK):
        """Per-dof world axis and origin; the owner body of a dof carries its
        axis, the base's translation dofs are pure linear."""
        dof_axis = fk.axis_w[..., self._owner, :]
        dof_origin = fk.p[..., self._owner, :]
        if self.model.floating:
            R0 = fk.R[..., 0, :, :]
            eye = torch.eye(3, dtype=R0.dtype, device=R0.device).expand(R0.shape)
            base_axis = torch.cat([eye, R0.transpose(-1, -2)], dim=-2)
            dof_axis = torch.cat([base_axis, dof_axis[..., 6:, :]], dim=-2)
            base_origin = fk.p[..., 0:1, :].expand(fk.p.shape[:-2] + (6, 3))
            dof_origin = torch.cat([base_origin, dof_origin[..., 6:, :]], dim=-2)
        return dof_axis, dof_origin, self._c("is_trans", fk.p)

    def point_jacobians(self, fk: FK, points, body_mask):
        """Jacobians [Jv;Jw] (...,P,6,ndof) of world ``points`` (...,P,3)
        attached to the bodies whose ancestor masks are ``body_mask``
        (P,ndof): one masked cross-product pass, component-major."""
        dof_axis, dof_origin, is_trans = self._dof_frames(fk)
        ax = dof_axis.transpose(-1, -2)[..., None, :, :]            # (...,1,3,ndof)
        og = dof_origin.transpose(-1, -2)                            # (...,3,ndof)
        rel = points[..., :, :, None] - og[..., None, :, :]          # (...,P,3,ndof)
        jv_rot = torch.linalg.cross(ax.expand(rel.shape), rel, dim=-2)
        jv = torch.where(is_trans > 0, ax, jv_rot)
        jw = torch.where(is_trans > 0, torch.zeros_like(ax), ax)
        mask = body_mask[..., :, None, :]
        jv = jv * mask
        jw = (jw * mask).expand(jv.shape)
        return torch.cat([jv, jw], dim=-2)

    def body_jacobians(self, fk: FK):
        """(J, Jcom): (...,nbody,6,ndof) at body origins and COMs."""
        amask = self._c("amask", fk.p)
        return (self.point_jacobians(fk, fk.p, amask),
                self.point_jacobians(fk, fk.com_w, amask))

    # ---------------------------------------------------------------- CRBA
    def mass_matrix(self, fk: FK, Jcom):
        """A = KᵀK with K = [√m_b·Jv_b ; (R_b·I_b^½)ᵀJw_b] stacked over
        bodies: equal to the CRBA mass matrix and exactly symmetric."""
        sqrt_m = self._c("sqrt_mass", fk.p)
        S = self._c("inertia_sqrt", fk.p)
        RS = fk.R @ S                                                # (...,b,3,3)
        Kv = sqrt_m[:, None, None] * Jcom[..., :, 0:3, :]
        Kw = RS.transpose(-1, -2) @ Jcom[..., :, 3:6, :]
        K = torch.cat([Kv, Kw], dim=-2)
        Kf = K.reshape(K.shape[:-3] + (self.nbody * 6, self.ndof))
        return Kf.transpose(-1, -2) @ Kf

    # ------------------------------------------------------ bias (nonlin.)
    def bias_forces(self, fk: FK, w, v, Jcom):
        """C(q,q̇)q̇ + G by Newton-Euler with q̈ = 0, mapped through the COM
        jacobians (RBDL NonlinearEffects parity)."""
        mass = self._c("mass", fk.p)
        inertia = self._c("inertia", fk.p)
        grav = self._c("gravity", fk.p)
        cross = torch.linalg.cross
        dws = [torch.zeros_like(w[..., 0, :])]
        dvs = [torch.zeros_like(w[..., 0, :])]
        for i in range(1, self.nbody):
            par = self.parent[i]
            dws.append(dws[par] + cross(w[..., par, :], w[..., i, :] - w[..., par, :]))
            r = fk.p[..., i, :] - fk.p[..., par, :]
            dvs.append(dvs[par] + cross(dws[par], r)
                       + cross(w[..., par, :], v[..., i, :] - v[..., par, :]))
        dw = torch.stack(dws, dim=-2)
        dv = torch.stack(dvs, dim=-2)
        rc = fk.com_w - fk.p
        a_com = dv + cross(dw, rc) + cross(w, cross(w, rc))
        Iw = fk.R @ inertia @ fk.R.transpose(-1, -2)
        f = mass[:, None] * (a_com - grav)
        n = (Iw @ dw[..., None])[..., 0] + cross(w, (Iw @ w[..., None])[..., 0])
        Jv = Jcom[..., :, 0:3, :]
        Jw = Jcom[..., :, 3:6, :]
        return (torch.einsum("...bin,...bi->...n", Jv, f)
                + torch.einsum("...bin,...bi->...n", Jw, n))

    # ------------------------------------------------------------- update
    def update(self, q, qdot, J_bodies=None, points=None) -> KinState:
        """Full kinematics/dynamics update.

        J_bodies: optional tuple of body indices — origin jacobians
            (``KinState.J``) only for those bodies (the COM jacobians are
            always complete).
        points: optional tuple of ``(body, (x,y,z))`` body-fixed points;
            their world jacobians come back in ``KinState.J_pts``, from the
            same masked pass as J and Jcom.
        """
        dtype = q.dtype
        fk = self.fk(q)
        w, v = self.velocities(fk, qdot)

        amask_np = np.asarray(self._np_consts["amask"], np.float64)
        pts = [fk.com_w]
        masks = [amask_np]
        if J_bodies is None:
            pts.append(fk.p)
            masks.append(amask_np)
            nj = self.nbody
        else:
            idx = np.asarray(J_bodies, np.int64)
            pts.append(fk.p[..., idx, :])
            masks.append(amask_np[idx])
            nj = len(J_bodies)
        if points:
            for b, lp in points:
                lp_t = torch.as_tensor(np.asarray(lp, np.float64), dtype=dtype,
                                       device=q.device)
                p_w = fk.p[..., b, :] + (fk.R[..., b, :, :] @ lp_t)
                pts.append(p_w[..., None, :])
                masks.append(amask_np[int(b)][None, :])
        batch = torch.broadcast_shapes(*(p.shape[:-2] for p in pts))
        pts = [p.expand(batch + p.shape[-2:]) for p in pts]
        Jall = self.point_jacobians(
            fk, torch.cat(pts, dim=-2),
            torch.as_tensor(np.concatenate(masks, axis=0), dtype=dtype, device=q.device))
        Jcom = Jall[..., : self.nbody, :, :]
        J = Jall[..., self.nbody : self.nbody + nj, :, :]
        J_pts = Jall[..., self.nbody + nj :, :, :] if points else None

        A = self.mass_matrix(fk, Jcom)
        if linalg_cuda.use_kernel(A, self.backend):
            A_inv = linalg_cuda.psd_inverse(A.contiguous())
        elif self.ndof <= 48:
            A_inv = sm.psd_inverse(A)
        else:
            L = torch.linalg.cholesky(A)
            eye = torch.eye(self.ndof, dtype=dtype, device=q.device).expand(A.shape)
            A_inv = torch.cholesky_solve(eye, L)

        B = self.bias_forces(fk, w, v, Jcom)

        M = self.total_mass
        grav = self._c("gravity", q)
        R0 = fk.R[..., 0, :, :]
        eye3 = torch.eye(3, dtype=dtype, device=q.device)
        if self.model.floating:
            # COM from the mass-matrix coupling block (src/dwbc.cpp:320-324)
            skm = R0 @ A[..., 3:6, 0:3] / M
            com_from_base = torch.stack(
                [skm[..., 2, 1], skm[..., 0, 2], skm[..., 1, 0]], dim=-1)
            com_pos = com_from_base + q[..., 0:3]
            # CMM (src/dwbc.cpp:331-341)
            cm_rot6 = q.new_zeros(q.shape[:-1] + (6, 6))
            cm_rot6[..., 0:3, 0:3] = eye3
            cm_rot6[..., 3:6, 3:6] = R0
            cm_rot6[..., 3:6, 0:3] = skew(com_from_base).transpose(-1, -2)
            CMM = cm_rot6 @ A[..., 0:6, :]
            sk = skew(com_from_base)
            com_inertia = (R0 @ A[..., 3:6, 3:6] @ R0.transpose(-1, -2)
                           - M * sk @ sk.transpose(-1, -2))
            SI = q.new_zeros(q.shape[:-1] + (6, 6))
            SI[..., 0:3, 0:3] = eye3 * M
            SI[..., 3:6, 3:6] = com_inertia
            # SI is SPD and block-diagonal: one 6×6 Cholesky solve
            Jcom_total = sm.psd_solve(SI, CMM)
            G = -torch.einsum("...in,i->...n", Jcom_total[..., 0:3, :], M * grav)
            com_vel = torch.einsum("...in,...n->...i", Jcom_total, qdot)[..., 0:3]
        else:
            mass = self._c("mass", q)
            com_pos = torch.einsum("b,...bi->...i", mass, fk.com_w) / M
            CMM = q.new_zeros(q.shape[:-1] + (6, self.ndof))
            com_inertia = q.new_zeros(q.shape[:-1] + (3, 3))
            Jcom_total = torch.einsum("b,...bin->...in", mass, Jcom) / M
            G = -torch.einsum("...in,i->...n", Jcom_total[..., 0:3, :], M * grav)
            com_vel = torch.einsum("...in,...n->...i", Jcom_total[..., 0:3, :], qdot)

        return KinState(
            q=q, qdot=qdot, R=fk.R, p=fk.p, w=w, v=v, com_w=fk.com_w,
            J=J, Jcom=Jcom, A=A, A_inv=A_inv, B=B, G=G,
            com_pos=com_pos, com_vel=com_vel, com_inertia=com_inertia,
            CMM=CMM, Jcom_total=Jcom_total, J_pts=J_pts,
        )

    # ------------------------------------------------- arbitrary points
    def frame_point_jacobian(self, fk: FK, body: int, local_point):
        """Jacobian [Jv;Jw] of a body-fixed point (reference GetPointJac)."""
        p_w = fk.p[..., body, :] + (fk.R[..., body, :, :] @ local_point[..., None])[..., 0]
        amask = self._c("amask", fk.p)[body]
        return self.point_jacobians(fk, p_w[..., None, :], amask[None, :])[..., 0, :, :]
