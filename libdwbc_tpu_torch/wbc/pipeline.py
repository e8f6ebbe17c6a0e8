"""The tick's configuration and results, the on-device servo, and
``CompiledTick`` (counterpart of ``libdwbc_tpu/wbc/pipeline.py``:
``TickResult``, ``qp_error_flag``, ``ServoParams``, ``make_servo``,
``servo_fstar``, ``PipelineConfig``, ``standard_tocabi_config``, the
jacobian plan and ``CompiledTick``).

``CompiledTick`` is the tick written as batched tensor algebra — kinematics,
the contact-space factorization, the task hierarchy and its QPs — the
independent formulation beside the element-leading ``FusedTick``.  With
``backend="cuda"`` its two SPD inverses (A at n = 39, W + V2ᵀV2 at n = 33
on the flagship) run the ``psd_inverse`` kernel and its QPs the
``qp_solve`` kernel; everything else is torch ops on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..kin.engine import FK, Kinematics
from ..kin.rotations import get_phi, matrix_to_quat, quat_slerp, quat_to_matrix, rotation_log
from ..utils.traj import quintic_spline
from . import dynamics as dyn
from . import types as T
from .hqp import contact_constraint_blocks, solve_contact_redistribution_qp, solve_task_level_qp


class TickResult(NamedTuple):
    torque_grav: torch.Tensor
    torque_task: torch.Tensor
    torque_contact: torch.Tensor
    torque_cmd: torch.Tensor
    contact_force: torch.Tensor       # observed contact wrench under torque_cmd
    qp_gap: torch.Tensor              # worst normalized complementarity across QPs
    qp_primal_res: torch.Tensor       # worst primal violation across QPs
    contact_rank_health: torch.Tensor  # contact-space rank indicator (tiny = degenerate)
    qp_error: torch.Tensor            # per-lane solver-failure flag (bool): a real
    # primal violation, a real complementarity gap, or a non-finite torque in
    # any QP of the tick; serving loops hold or zero flagged lanes


def qp_error_flag(gap, pres, torque_cmd, cfg):
    """Per-lane failure flag from the tick diagnostics.  The thresholds sit
    orders of magnitude above any healthy solve and far below garbage;
    non-finite torque is always a failure."""
    finite = torch.isfinite(torque_cmd).all(dim=-1)
    return (~finite) | (gap > cfg.qp_fail_gap) | (pres > cfg.qp_fail_pres)


class ServoParams(NamedTuple):
    """On-device trajectory and PD servo of ONE task link: a quintic
    position trajectory and a slerp rotation trajectory with quintic time
    scaling, tracked by a PD law (the reference's
    ``TaskLink::SetTrajectoryQuintic/SetTrajectoryRotation`` with
    ``GetFstarPosPD``/``GetFstarRotPD``).  Every field broadcasts over
    leading batch dims, so each scenario can track its own trajectory on its
    own clock.

    use_pos / use_rot: 1 replaces that half of the caller's f* with the
    servo's, 0 keeps the caller's.  max_p_err / max_d_err clamp the p and d
    errors [pos(3); rot(3)] to ±max before the gains; +inf is off.
    """

    t: torch.Tensor          # current control time
    t0: torch.Tensor
    tf: torch.Tensor
    pos_init: torch.Tensor   # (...,3)
    vel_init: torch.Tensor
    pos_des: torch.Tensor
    vel_des: torch.Tensor
    rot_init: torch.Tensor   # (...,3,3)
    w_init: torch.Tensor     # (...,3)
    rot_des: torch.Tensor
    w_des: torch.Tensor
    pos_p: torch.Tensor      # (...,3) gains
    pos_d: torch.Tensor
    pos_a: torch.Tensor
    rot_p: torch.Tensor
    rot_d: torch.Tensor
    max_p_err: torch.Tensor  # (...,6) [pos(3); rot(3)] clamp, +inf = off
    max_d_err: torch.Tensor
    use_pos: torch.Tensor    # () 1.0 / 0.0
    use_rot: torch.Tensor


def make_servo(
    pos_init=None, pos_des=None, vel_init=None, vel_des=None,
    rot_init=None, rot_des=None, w_init=None, w_des=None,
    t=0.0, t0=0.0, tf=1.0,
    pos_p=400.0, pos_d=40.0, pos_a=1.0, rot_p=400.0, rot_d=40.0,
    max_p_err=None, max_d_err=None, dtype=torch.float32, device=None,
) -> ServoParams:
    """ServoParams with the reference demos' gains; scalars broadcast.  A
    half whose target is omitted (pos_des or rot_des None) is switched off:
    its use flag is 0, its points zero and its rotations the identity."""
    kw = dict(dtype=dtype, device=device)

    def a(v):
        return torch.as_tensor(v, **kw)

    def f(v, shape):
        v = a(v)
        return v.expand(shape) if v.ndim == 0 else v

    use_pos = pos_des is not None
    use_rot = rot_des is not None
    z3 = torch.zeros(3, **kw)
    eye = torch.eye(3, **kw)
    inf = float("inf")
    return ServoParams(
        t=a(t), t0=a(t0), tf=a(tf),
        pos_init=f(0.0 if pos_init is None else pos_init, (3,)) if use_pos else z3,
        vel_init=f(0.0 if vel_init is None else vel_init, (3,)),
        pos_des=f(pos_des, (3,)) if use_pos else z3,
        vel_des=f(0.0 if vel_des is None else vel_des, (3,)),
        rot_init=eye if rot_init is None else a(rot_init),
        w_init=f(0.0 if w_init is None else w_init, (3,)),
        rot_des=eye if rot_des is None else a(rot_des),
        w_des=f(0.0 if w_des is None else w_des, (3,)),
        pos_p=f(pos_p, (3,)), pos_d=f(pos_d, (3,)), pos_a=f(pos_a, (3,)),
        rot_p=f(rot_p, (3,)), rot_d=f(rot_d, (3,)),
        max_p_err=f(inf if max_p_err is None else max_p_err, (6,)),
        max_d_err=f(inf if max_d_err is None else max_d_err, (6,)),
        use_pos=a(1.0 if use_pos else 0.0),
        use_rot=a(1.0 if use_rot else 0.0),
    )


def servos_to(servos, dtype, device):
    """The nested per-level / per-spec ServoParams (None entries pass) with
    every field as a tensor of ``dtype`` on ``device``."""
    if servos is None:
        return None
    return tuple(None if lvl is None else tuple(
        None if sp is None else ServoParams(*(torch.as_tensor(v, dtype=dtype, device=device)
                                              for v in sp))
        for sp in lvl) for lvl in servos)


def _clamp(x, lim):
    """±lim symmetric clamp; lim = +inf is off."""
    return torch.minimum(torch.maximum(x, -lim), lim)


def servo_fstar(sp: ServoParams, pos, vel, rot, w):
    """The trajectory and PD servo of one task link at its current state
    (pos, vel, rot, w) → the 6 rows [f*_pos; f*_rot]: quintic position
    trajectory with acceleration feedforward, slerp rotation trajectory with
    quintic time scaling and the GetPhi error, PD on the clamped errors.
    Broadcasts over leading batch dims, a batched clock sp.t included."""
    t, t0, tf = sp.t[..., None], sp.t0[..., None], sp.tf[..., None]
    z = torch.zeros_like(sp.pos_init)
    pos_traj, vel_traj, acc_traj = quintic_spline(
        t, t0, tf, sp.pos_init, sp.vel_init, z, sp.pos_des, sp.vel_des, z)
    p_err = _clamp(pos_traj - pos, sp.max_p_err[..., 0:3])
    d_err = _clamp(vel_traj - vel, sp.max_d_err[..., 0:3])
    f_pos = sp.pos_a * acc_traj + sp.pos_p * p_err + sp.pos_d * d_err

    s, sd, _ = quintic_spline(sp.t, sp.t0, sp.tf, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    rot_traj = quat_to_matrix(quat_slerp(matrix_to_quat(sp.rot_init),
                                         matrix_to_quat(sp.rot_des), s))
    aa = rotation_log(sp.rot_des @ sp.rot_init.transpose(-1, -2))
    # during the blend the feedforward is the slerp rate; once the spline
    # completes (s = 1, sd = 0) it hands off to the terminal w_des
    w_traj = aa * sd[..., None] + torch.where(s[..., None] >= 1.0, sp.w_des, 0.0)
    r_err = _clamp(get_phi(rot, rot_traj), sp.max_p_err[..., 3:6])
    wd_err = _clamp(w_traj - w, sp.max_d_err[..., 3:6])
    f_rot = sp.rot_p * r_err + sp.rot_d * wd_err
    return torch.cat(torch.broadcast_tensors(f_pos, f_rot), dim=-1)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    contacts: tuple[T.ContactDef, ...]       # active contacts only
    task_specs: tuple[tuple[tuple, ...], ...]  # per level: ((mode, link[, point]), ...)
    torque_limit: np.ndarray | None
    qp_iters: int = 25
    use_hqp: bool = True
    # per-lane qp_error thresholds (see TickResult.qp_error / qp_error_flag)
    qp_fail_gap: float = 1e-3
    qp_fail_pres: float = 1e-3


def standard_tocabi_config(
    model,
    both_feet: bool = True,
    torque_limit: float = 300.0,
    qp_iters: int = 25,
    swing_task: bool = False,
) -> PipelineConfig:
    """The reference test configuration: double-support stand, pelvis 6D +
    upper-body rotation tasks; optional swing-foot task (single support,
    3-level hierarchy)."""
    foot = dict(
        contact_type=T.CONTACT_6D,
        contact_point=np.array([0.03, 0.0, -0.1585]),
        contact_direction=np.array([0.0, 0.0, 1.0]),
        plane_x=0.15,
        plane_y=0.075,
        active=True,
    )
    contacts = [T.ContactDef(link=6, **foot)]
    if both_feet:
        contacts.append(T.ContactDef(link=12, **foot))
    task_specs = [((T.TASK_LINK_6D, 0),), ((T.TASK_LINK_ROTATION, 15),)]
    if swing_task:
        task_specs.append(((T.TASK_LINK_6D, 12),))  # swing right foot
    return PipelineConfig(
        contacts=tuple(contacts),
        task_specs=tuple(tuple(s) for s in task_specs),
        torque_limit=np.full(model.model_dof, torque_limit),
        qp_iters=qp_iters,
    )


_SIX_MODES = (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_6D_CUSTOM_FRAME)
_POS_MODES = (T.TASK_LINK_POSITION, T.TASK_LINK_POSITION_COM_FRAME,
              T.TASK_LINK_POSITION_CUSTOM_FRAME)


def _parse_task_spec(spec):
    """task_specs entry (mode, link) or (mode, link, (px, py, pz)) →
    (mode, link, body-frame task point or None)."""
    mode, link = spec[0], spec[1]
    point = np.asarray(spec[2], np.float64) if len(spec) > 2 else None
    return mode, link, point


def _plan_jacobians(model, cfg):
    """Static jacobian plan: the body-origin jacobians the tick reads
    (``J_bodies``, None when that would be every body), the body-fixed
    points (contact points first, then custom-frame task points; repeated
    pairs share one row), and per level the slot of each task spec."""
    points = []

    def _point_slot(link, pt):
        entry = (int(link), tuple(float(x) for x in np.asarray(pt)))
        if entry not in points:
            points.append(entry)
        return points.index(entry)

    for c in cfg.contacts:
        _point_slot(c.link, c.contact_point)
    j_bodies: list[int] = []
    slots = []
    for level in cfg.task_specs:
        lvl_slots = []
        for spec in level:
            mode, link, point = _parse_task_spec(spec)
            if link == model.nbody:
                lvl_slots.append(("tot", None))
            elif mode in (T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_POSITION_COM_FRAME):
                lvl_slots.append(("com", link))
            elif point is not None and mode in (T.TASK_LINK_6D_CUSTOM_FRAME,
                                                T.TASK_LINK_POSITION_CUSTOM_FRAME):
                lvl_slots.append(("pt", _point_slot(link, point)))
            else:
                if int(link) not in j_bodies:
                    j_bodies.append(int(link))
                lvl_slots.append(("J", (link, j_bodies.index(int(link)))))
        slots.append(tuple(lvl_slots))
    if len(j_bodies) >= model.nbody:
        j_bodies = None  # narrowing buys nothing; keep identity order
    return (None if j_bodies is None else tuple(j_bodies)), tuple(points), tuple(slots)


def _resolve_task_jacobian(kin, model, cfg, task_slots, st, fk, level, dtype):
    """One level's task jacobian from the slot plan; st may come from a
    narrowed or a full update."""
    narrowed = st.J.shape[-3] != model.nbody
    rows = []
    for spec, (kind, payload) in zip(cfg.task_specs[level], task_slots[level]):
        mode, link, point = _parse_task_spec(spec)
        if kind == "tot":
            J6 = st.Jcom_total
        elif kind == "com":
            J6 = st.Jcom[..., payload, :, :]
        elif kind == "pt":
            if st.J_pts is not None:
                J6 = st.J_pts[..., payload, :, :]
            else:
                J6 = kin.frame_point_jacobian(
                    fk, link, torch.as_tensor(point, dtype=dtype, device=st.q.device))
        else:
            blink, bidx = payload
            J6 = st.J[..., bidx if narrowed else blink, :, :]
        if mode in _SIX_MODES:
            rows.append(J6)
        elif mode in _POS_MODES:
            rows.append(J6[..., 0:3, :])
        else:
            rows.append(J6[..., 3:6, :])
    return torch.cat(rows, dim=-2)


def _task_state(model, dtype, st, mode, link, point):
    """Current (pos, vel, rot, w) of a task link for the servo: the COM for
    the virtual COM link, else the link's origin, COM or custom point."""
    if link == model.nbody:
        eye = torch.eye(3, dtype=dtype, device=st.com_pos.device)
        return (st.com_pos, st.com_vel, eye.expand(st.com_pos.shape[:-1] + (3, 3)),
                torch.zeros_like(st.com_vel))
    rot = st.R[..., link, :, :]
    wvel = st.w[..., link, :]
    if mode in (T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_POSITION_COM_FRAME):
        r = st.com_w[..., link, :] - st.p[..., link, :]
    elif point is not None:
        r = torch.einsum("...ij,j->...i", rot,
                         torch.as_tensor(point, dtype=dtype, device=rot.device))
    else:
        r = torch.zeros_like(wvel)
    return (st.p[..., link, :] + r, st.v[..., link, :] + torch.linalg.cross(wvel, r, dim=-1),
            rot, wvel)


def _apply_servos(model, cfg, dtype, st, level: int, fstar, servos_level):
    """Level ``level``'s f* with the rows of every servo'd task link
    replaced by the servo's output, blended per wrench half by use_pos /
    use_rot (the reference's f* dispatch in UpdateTaskSpace).  Shared by
    CompiledTick and MaskedTick."""
    rows, off = [], 0
    for spec, sp in zip(cfg.task_specs[level], servos_level):
        mode, link, point = _parse_task_spec(spec)
        nrows = 6 if mode in _SIX_MODES else 3
        f_in = fstar[..., off:off + nrows]
        off += nrows
        if sp is None:
            rows.append(f_in)
            continue
        f6 = servo_fstar(sp, *_task_state(model, dtype, st, mode, link, point))
        up, ur = sp.use_pos[..., None], sp.use_rot[..., None]
        if mode in _SIX_MODES:
            fp = up * f6[..., 0:3] + (1.0 - up) * f_in[..., 0:3]
            fr = ur * f6[..., 3:6] + (1.0 - ur) * f_in[..., 3:6]
            rows.append(torch.cat(torch.broadcast_tensors(fp, fr), dim=-1))
        elif mode in _POS_MODES:
            rows.append(up * f6[..., 0:3] + (1.0 - up) * f_in)
        else:
            rows.append(ur * f6[..., 3:6] + (1.0 - ur) * f_in)
    batch = torch.broadcast_shapes(*(r.shape[:-1] for r in rows))
    return torch.cat([r.expand(batch + r.shape[-1:]) for r in rows], dim=-1)


def _level_dims(model, cfg):
    """(nv, rows) of each QP of the tick, in call order: one per task level,
    then the redistribution QP."""
    cfree = sum(c.contact_dof for c in cfg.contacts) - 6
    k = sum(c.constraint_number for c in cfg.contacts)
    lim_rows = 2 * model.model_dof if cfg.torque_limit is not None else 0
    dims = [(sum(6 if spec[0] in _SIX_MODES else 3 for spec in level) + cfree, lim_rows + k)
            for level in cfg.task_specs]
    dims.append((cfree, lim_rows + k))
    return dims


def card_setup(name: str, device, dtype, backend: str) -> torch.device:
    """The device of a module that routes work to the CUDA kernels:
    ``backend="cuda"`` needs a CUDA device and float32; float32 products on
    the card are pinned exact (no TF32 rounding)."""
    device = torch.device(device)
    if backend not in ("torch", "cuda"):
        raise ValueError(f"backend must be 'torch' or 'cuda', got {backend!r}")
    if backend == "cuda":
        if not torch.cuda.is_available() or device.type != "cuda":
            raise RuntimeError(f"{name}(backend='cuda') needs a CUDA device")
        if dtype != torch.float32:
            raise TypeError(f"the CUDA kernels of {name} are float32")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


class CompiledTick(nn.Module):
    """One WBC tick for a fixed configuration, batched over leading dims of
    (q, q̇, f*) — the same serving contract as ``FusedTick``
    (``init_warm``, ``_tick_impl``, warm (x, λ) per QP)."""

    def __init__(self, model, cfg, device, dtype=torch.float32, backend="cuda"):
        super().__init__()
        device = card_setup("CompiledTick", device, dtype, backend)
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        self.backend = backend
        self.kin = Kinematics(model, backend=backend)
        self._J_bodies, self._points, self._task_slots = _plan_jacobians(model, cfg)
        self._dims = _level_dims(model, cfg)
        self.register_buffer("axis", torch.as_tensor(
            np.asarray(model.axis, np.float64), dtype=dtype, device=device), persistent=False)
        tlim = (None if cfg.torque_limit is None else torch.as_tensor(
            np.asarray(cfg.torque_limit, np.float64), dtype=dtype, device=device))
        self.register_buffer("tlim", tlim, persistent=False)
        self._consts = [dyn.contact_constraint_block(
            c.contact_type, c.plane_x, c.plane_y, c.friction_ratio, c.friction_ratio_z,
            dtype=dtype, device=device) for c in cfg.contacts]

    def init_warm(self, batch=()):
        """Cold warm state: per QP (zeros (batch, n), ones (batch, m))."""
        batch = tuple(batch)
        kw = dict(dtype=self.dtype, device=self.device)
        return tuple((torch.zeros(batch + (nv,), **kw), torch.ones(batch + (rows,), **kw))
                     for nv, rows in self._dims)

    # ---------------------------------------- pieces the loop's simulator reads
    def _fk_from_state(self, st):
        return FK(R=st.R, p=st.p, axis_w=(st.R @ self.axis[..., None])[..., 0], com_w=st.com_w)

    def _contact_jacobian_from_state(self, st):
        return self._contact_jacobian(self._fk_from_state(st))

    def _contact_jacobian(self, fk: FK):
        """The stacked contact jacobian rows at the contact points of fk."""
        return torch.cat([dyn.contact_jacobian_rows(
            self.kin.frame_point_jacobian(fk, c.link, torch.as_tensor(
                np.asarray(c.contact_point, np.float64), dtype=self.dtype, device=self.device)),
            fk.R[..., c.link, :, :], c.contact_type) for c in self.cfg.contacts], dim=-2)

    def _tick_impl(self, q, qdot, fstars, warm=None, qp_iters=None, servos=None):
        """q (B, nq) or (nq,), q̇ alike, f* per level (B, t) or (t,), warm per
        QP (x, λ) or None → TickResult, and the warm state out when warm was
        given.  servos: per level None or a tuple of per-spec ServoParams
        or None; a servo'd task link's f* comes from its trajectory PD."""
        cfg, bk = self.cfg, self.backend
        m = self.model.model_dof

        def as_t(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        q, qdot = as_t(q), as_t(qdot)
        fstars = tuple(as_t(f) for f in fstars)
        if warm is not None:
            warm = tuple((as_t(x), as_t(lam)) for x, lam in warm)
        servos = servos_to(servos, self.dtype, self.device)
        st = self.kin.update(q, qdot, J_bodies=self._J_bodies, points=self._points)
        fk = self._fk_from_state(st)

        J_C = torch.cat([dyn.contact_jacobian_rows(st.J_pts[..., i, :, :],
                                                   st.R[..., c.link, :, :], c.contact_type)
                         for i, c in enumerate(cfg.contacts)], dim=-2)
        cs = dyn.contact_space(J_C, st.A_inv, backend=bk)
        torque_grav, P_C = dyn.gravity_compensation(st.A_inv, cs.W_inv, cs.N_C,
                                                    cs.J_C_INV_T, st.G)
        A_const, A_rot = contact_constraint_blocks(
            self._consts, [dyn.contact_rotation_block(c.contact_type, st.R[..., c.link, :, :])
                           for c in cfg.contacts])

        batch = q.shape[:-1]
        kw = dict(dtype=self.dtype, device=self.device)
        torque_task = torch.zeros(batch + (m,), **kw)
        torque_contact = torch.zeros(batch + (m,), **kw)
        gap = torch.zeros(batch, **kw)
        pres = torch.zeros(batch, **kw)
        iters = cfg.qp_iters if qp_iters is None else qp_iters
        warm_out = []

        prev_null = torch.eye(m, **kw).expand(batch + (m, m))
        for h in range(len(cfg.task_specs)):
            J_task = _resolve_task_jacobian(self.kin, self.model, cfg, self._task_slots,
                                            st, fk, h, self.dtype)
            tf = dyn.task_jkt(J_task, st.A_inv, cs.N_C, cs.W_inv, backend=bk)
            fstar = fstars[h]
            if servos is not None and servos[h] is not None:
                fstar = _apply_servos(self.model, cfg, self.dtype, st, h, fstar, servos[h])
            JktL = tf.J_kt @ tf.Lambda_task
            if cfg.use_hqp:
                res = solve_task_level_qp(
                    prev_null @ JktL, fstar, torque_grav + torque_task, cs.NwJw,
                    cs.J_C_INV_T, P_C, A_const, A_rot, self.tlim, iters=iters,
                    warm=None if warm is None else warm[h], backend=bk)
                warm_out.append((res.x, res.lam))
                torque_h = (JktL @ (fstar + res.f_star_delta)[..., None])[..., 0]
                torque_contact = (cs.NwJw @ res.contact_qp[..., None])[..., 0]
                gap = torch.maximum(gap, res.gap)
                pres = torch.maximum(pres, res.primal_res)
            else:
                torque_h = (JktL @ fstar[..., None])[..., 0]
            if h == 0:
                torque_task = torque_h
            else:
                torque_task = torque_task + (prev_null @ torque_h[..., None])[..., 0]
            prev_null = dyn.task_null_space(tf.J_kt, tf.Lambda_task, J_task,
                                            cs.A_inv_N_C, prev_null)

        if cfg.use_hqp and cs.NwJw.shape[-1] > 0:
            sol = solve_contact_redistribution_qp(
                torque_grav + torque_task + torque_contact, cs.NwJw, cs.J_C_INV_T, P_C,
                A_const, A_rot, self.tlim, iters=iters,
                warm=None if warm is None else warm[len(cfg.task_specs)], backend=bk)
            warm_out.append((sol.x, sol.lam))
            torque_contact = torque_contact + (cs.NwJw @ sol.x[..., None])[..., 0]
            gap = torch.maximum(gap, sol.gap)
            pres = torch.maximum(pres, sol.primal_res)

        torque_cmd = torque_grav + torque_task + torque_contact
        result = TickResult(
            torque_grav=torque_grav,
            torque_task=torque_task,
            torque_contact=torque_contact,
            torque_cmd=torque_cmd,
            contact_force=dyn.contact_force_from_torque(torque_cmd, cs.J_C_INV_T, P_C),
            qp_gap=gap,
            qp_primal_res=pres,
            contact_rank_health=cs.rank_health,
            qp_error=qp_error_flag(gap, pres, torque_cmd, cfg),
        )
        return (result, tuple(warm_out)) if warm is not None else result

    def forward(self, q, qdot, fstars, warm=None, qp_iters=None, servos=None):
        return self._tick_impl(q, qdot, fstars, warm=warm, qp_iters=qp_iters, servos=servos)
