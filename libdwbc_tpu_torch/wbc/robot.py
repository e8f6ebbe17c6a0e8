"""RobotData facade in torch: the user-facing controller object
(counterpart of ``libdwbc_tpu/wbc/robot.py``).

API-compatible in spirit and naming with the reference's ``DWBC::RobotData``
(include/dwbc.h:59-430): the object holds the static configuration (model,
contact definitions, task definitions, limits) and the last computed state,
and every stage is a function of ``(q, q̇, f*)`` in the pipeline modules.
One robot per object, unbatched, stage by stage, as the reference runs.

Unlike the JAX facade it runs eagerly: there is no per-shape stage cache.
``backend="cuda"`` routes the stages' SPD inverses (A at n = 39, W + V2ᵀV2
at n = 33, A_R and the reduced W + V2ᵀV2) to the ``psd_inverse`` kernel and
the task-level and redistribution QPs to the ``qp_solve`` kernel wherever
the routing rules (``linalg_cuda.use_kernel``, ``qp_cuda.kernel_takes``)
take them, batch 1 included.  The LQP and JACC methods' QPs carry equality
rows or more than 24 variables and run the plain IPM on any device,
but for the reduced cascade's level of 18 variables, which ``qp_solve``
takes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kin.centroidal import angular_momentum_matrix, virtual_cmm
from ..kin.engine import FK, Kinematics, KinState
from ..kin.rotations import skew
from ..model import surgery
from ..model.compile import RobotModel, compile_from_links, compile_urdf
from ..ops.qp import solve_qp
from ..utils import traj as TJ
from . import dynamics as dyn
from . import lqp
from . import reduced as red
from . import types as T
from .hqp import contact_constraint_blocks, solve_contact_redistribution_qp, solve_task_level_qp
from .pipeline import card_setup

_POS_MODES = (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_6D_CUSTOM_FRAME,
              T.TASK_LINK_POSITION, T.TASK_LINK_POSITION_COM_FRAME,
              T.TASK_LINK_POSITION_CUSTOM_FRAME)
_ROT_MODES = (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_6D_CUSTOM_FRAME,
              T.TASK_LINK_ROTATION, T.TASK_LINK_ROTATION_CUSTOM_FRAME)
_COM_FRAME_MODES = (T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_POSITION_COM_FRAME)
_CUSTOM_FRAME_MODES = (T.TASK_LINK_6D_CUSTOM_FRAME, T.TASK_LINK_POSITION_CUSTOM_FRAME)
_SIX_MODES = (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_6D_CUSTOM_FRAME)


def _np(t):
    return t.detach().cpu().numpy()


class RobotData:
    """Stateful facade over the pipeline (the reference's parity surface).

    ``RobotData(dtype=torch.float32, device=None, backend="cuda")``:
    ``device=None`` is the card.  The JAX facade defaults to float64, its
    CPU parity surface; this one defaults to serving on the card, where
    only float32 reaches the kernels.  On the CPU pass
    ``RobotData(torch.float64, device="cpu", backend="torch")``.
    ``backend="cuda"`` on a CPU device, or with another dtype than
    float32, raises.  Methods that return numpy in the JAX facade return
    numpy here; the stored stage results are tensors on ``device``."""

    RANK_HEALTH_THRESHOLD_F32 = 2e-3
    RANK_HEALTH_THRESHOLD_F64 = 1e-7
    # failure thresholds of the abort path (the JAX facade's): orders of
    # magnitude above a healthy solve and far below garbage
    QP_FAIL_PRES = 1e-3
    QP_FAIL_GAP = 1e-3

    def __init__(self, dtype=torch.float32, device=None, backend="cuda"):
        device = card_setup("RobotData", "cuda" if device is None else device, dtype, backend)
        self.dtype = dtype
        self.device = device
        self.backend = backend
        self.model: RobotModel | None = None
        self.kin: Kinematics | None = None
        self.cc_: list[T.ContactDef] = []
        self.ts_: list[T.TaskDef] = []
        self.torque_limit_: np.ndarray | None = None
        self._fstars: dict[int, np.ndarray] = {}
        self._custom_J: dict[int, np.ndarray] = {}
        self._traj: dict[tuple, dict] = {}
        self.control_time_ = 0.0
        self.state: KinState | None = None
        self.torque_grav_ = None
        self.torque_task_ = None
        self.torque_contact_ = None
        self.qp_iters = 25
        # QP health bookkeeping: every solve's gap and primal residual
        self.qp_success_count_ = 0
        self.qp_fail_count_ = 0
        self.qp_history_ = []
        # sticky per-call failure flag (src/dwbc.cpp:836-846), reset at
        # each CalcTaskControlTorque entry
        self.qp_error_ = 0
        self.lqp_level_times_ = []
        self.lqp_level_times_max_ = {}
        self.torque_lqp_R_ = None
        self._reduced_degenerate = False

    def _t(self, x):
        """x as a tensor of the facade's dtype on its device."""
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype, device=self.device)

    def _eye(self, n):
        return torch.eye(n, dtype=self.dtype, device=self.device)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ model
    def SetModel(self, model: RobotModel):
        """Use a compiled model (e.g. ``RobotModel.load`` of an npz)."""
        self.model = model
        self.kin = Kinematics(model, backend=self.backend)

    def _report(self, verbose):
        if verbose:
            print(f"model '{self.model.name}': system dof {self.model.ndof}, "
                  f"model dof {self.model.model_dof}, bodies {self.model.nbody}")

    def LoadModelData(self, urdf_path: str, floating: bool = True, verbose: int = 0):
        """Compile a URDF (a path or an XML string) into the model."""
        self.SetModel(compile_urdf(urdf_path, floating))
        self._report(verbose)

    def InitModelWithLinkJoint(self, links, joints, name="programmatic", verbose: int = 0):
        """Build the model from parallel Link/Joint vectors, no URDF
        (``InitModelWithLinkJoint``, src/dwbc.cpp:2425-2471); joints[i]
        connects links[i] to its parent (joints[0] is the root joint)."""
        self.SetModel(compile_from_links(list(links), list(joints), name=name))
        self._report(verbose)

    @property
    def system_dof_(self):
        return self.model.ndof

    @property
    def model_dof_(self):
        return self.model.model_dof

    def SetTorqueLimit(self, tlim):
        self.torque_limit_ = np.asarray(tlim, dtype=np.float64)

    def _tlim(self):
        return None if self.torque_limit_ is None else self._t(self.torque_limit_)

    # ---------------------------------------------------------- contacts
    def AddContactConstraint(self, link, contact_type, contact_point, contact_vector,
                             lx=0.0, ly=0.0, verbose=False):
        if isinstance(link, str):
            link = self.model.body_index(link)
        if any(c.link == link for c in self.cc_):
            return
        self.cc_.append(T.ContactDef(
            link=int(link), contact_type=contact_type,
            contact_point=np.asarray(contact_point, dtype=np.float64),
            contact_direction=np.asarray(contact_vector, dtype=np.float64),
            plane_x=float(lx), plane_y=float(ly)))

    def ClearContactConstraint(self):
        self.cc_.clear()

    def SetContact(self, *flags: bool):
        for c, f in zip(self.cc_, flags):
            c.active = bool(f)
        for c in self.cc_[len(flags):]:
            c.active = False

    def SetFrictionRatio(self, idx: int, mu: float, mu_z: float):
        self.cc_[idx].friction_ratio = mu
        self.cc_[idx].friction_ratio_z = mu_z

    @property
    def contact_dof_(self) -> int:
        return sum(c.contact_dof for c in self.cc_ if c.active)

    def active_contacts(self) -> list[T.ContactDef]:
        return [c for c in self.cc_ if c.active]

    # ------------------------------------------------------------- tasks
    def AddTaskSpace(self, heirarchy: int, task_mode, link=None, task_point=None,
                     task_dof: int | None = None, verbose=False):
        """Either (mode, link, point) for a link task appended to or merged
        into the given hierarchy level, or task_dof for a custom-J task."""
        if task_dof is not None:
            self.ts_.append(T.TaskDef(links=[], custom_dof=task_dof))
            return
        if isinstance(link, str):
            link = self.model.body_index(link)
        tp = np.zeros(3) if task_point is None else np.asarray(task_point, float)
        tl = T.TaskLinkDef(mode=task_mode, link=int(link), task_point=tp)
        if heirarchy == len(self.ts_):
            self.ts_.append(T.TaskDef(links=[tl]))
        elif heirarchy < len(self.ts_):
            self.ts_[heirarchy].links.append(tl)
        else:
            raise ValueError("hierarchy index out of order")

    def AddTaskLink(self, heirarchy: int, task_mode, link, task_point=None):
        self.AddTaskSpace(heirarchy, task_mode, link, task_point)

    def ClearTaskSpace(self):
        self.ts_.clear()
        self._fstars.clear()

    def SetTaskSpace(self, heirarchy: int, f_star, J_task=None):
        self._fstars[heirarchy] = np.asarray(f_star, dtype=np.float64)
        if J_task is not None:
            self._custom_J[heirarchy] = np.asarray(J_task, dtype=np.float64)

    # --------------------------------------------- trajectory servo layer
    # (TaskLink::SetTrajectoryQuintic / SetTrajectoryRotation / SetTaskGain,
    #  src/task.cpp:223-266; f* in UpdateTaskSpace, src/dwbc.cpp:685-793)
    def SetTaskGain(self, heirarchy, pos_p, pos_d, pos_a, rot_p, rot_d, rot_a,
                    link_idx: int = 0):
        self._traj.setdefault((heirarchy, link_idx), {})["gains"] = tuple(
            np.asarray(v, dtype=np.float64) for v in (pos_p, pos_d, pos_a, rot_p, rot_d, rot_a))

    def SetTrajectoryQuintic(self, heirarchy, start_time, end_time, pos_init, vel_init,
                             pos_desired, vel_desired, link_idx: int = 0):
        self._traj.setdefault((heirarchy, link_idx), {})["pos"] = (
            float(start_time), float(end_time),
            *(np.asarray(v, float) for v in (pos_init, vel_init, pos_desired, vel_desired)))

    def SetTrajectoryRotation(self, heirarchy, start_time, end_time, rot_init, twist_init,
                              rot_desired, twist_desired, link_idx: int = 0):
        self._traj.setdefault((heirarchy, link_idx), {})["rot"] = (
            float(start_time), float(end_time),
            *(np.asarray(v, float) for v in (rot_init, twist_init, rot_desired, twist_desired)))

    def UpdateTaskSpace(self, control_time: float | None = None):
        """Refresh the trajectory-servo f* of every task link with an active
        trajectory (the reference does this inside UpdateTaskSpace)."""
        if control_time is not None:
            self.control_time_ = float(control_time)
        t = self.control_time_
        st = self.state
        nbody = self.model.nbody
        for h, td in enumerate(self.ts_):
            if td.custom_dof:
                continue
            cursor = 0
            fstar = np.array(self._fstars.get(h, np.zeros(td.task_dof)), dtype=np.float64)
            if fstar.shape[0] != td.task_dof:
                fstar = np.zeros(td.task_dof)
            for j, tl in enumerate(td.links):
                cfg = self._traj.get((h, j))
                if cfg:
                    g = [self._t(v) for v in cfg["gains"]]
                    if tl.mode in _POS_MODES and "pos" in cfg:
                        t0, tf, pi, vi, pd_, vd = cfg["pos"]
                        if tl.link < nbody:
                            pts = st.com_w if tl.mode in _COM_FRAME_MODES else st.p
                            cur_p, cur_v = pts[tl.link], st.v[tl.link]
                        else:
                            cur_p, cur_v = st.com_pos, st.com_vel
                        f, _, _ = TJ.fstar_pos_pd(
                            t, t0, tf, self._t(pi), self._t(vi), self._t(pd_), self._t(vd),
                            cur_p, cur_v, g[0], g[1], g[2])
                        fstar[cursor:cursor + 3] = _np(f)
                    if tl.mode in _ROT_MODES and "rot" in cfg:
                        t0, tf, ri, wi, rdes, wdes = cfg["rot"]
                        off = 3 if tl.t_dof == 6 else 0
                        link = min(tl.link, nbody - 1)
                        f, _, _ = TJ.fstar_rot_pd(
                            t, t0, tf, self._t(ri), self._t(wi), self._t(rdes), self._t(wdes),
                            st.R[link], st.w[link], g[3], g[4])
                        fstar[cursor + off:cursor + off + 3] = _np(f)
                cursor += tl.t_dof
            self._fstars[h] = fstar

    # -------------------------------------------------------- kinematics
    def UpdateKinematics(self, q, qdot, qddot=None, update_kinematics=True):
        """Per-tick state ingest (RobotData::UpdateKinematics,
        src/dwbc.cpp:279-371).  q̈ is stored for observability and not
        threaded into the tick: no consumer of the reference's control path
        reads a body acceleration (COMPONENTS.md)."""
        self.qddot = None if qddot is None else self._t(qddot)
        self.state = self.kin.update(self._t(q), self._t(qdot))
        return self.state

    # ------------------------------------------------- static assemblies
    def _fk(self, st: KinState) -> FK:
        """An FK view of the stored state."""
        axis_w = (st.R @ self.kin._c("axis", st.p)[..., None])[..., 0]
        return FK(R=st.R, p=st.p, axis_w=axis_w, com_w=st.com_w)

    def _contact_jacobian(self, st: KinState):
        """Stacked J_C of the active contacts (src/dwbc.cpp:433-454)."""
        con = self.active_contacts()
        if not con:
            raise ValueError("no active contact: the contact jacobian has no rows")
        fk = self._fk(st)
        return torch.cat([dyn.contact_jacobian_rows(
            self.kin.frame_point_jacobian(fk, c.link, self._t(c.contact_point)),
            st.R[c.link], c.contact_type) for c in con], dim=-2)

    def _task_jacobian(self, st: KinState, h: int):
        td = self.ts_[h]
        if td.custom_dof:
            return self._t(self._custom_J[h])
        fk = self._fk(st)
        rows = []
        for tl in td.links:
            link = tl.link
            if link == self.model.nbody:  # the virtual COM link
                J6 = st.Jcom_total
            elif tl.mode in _COM_FRAME_MODES:
                J6 = st.Jcom[link]
            elif tl.mode in _CUSTOM_FRAME_MODES:
                J6 = self.kin.frame_point_jacobian(fk, link, self._t(tl.task_point))
            else:
                J6 = st.J[link]
            if tl.mode in _SIX_MODES:
                rows.append(J6)
            elif tl.mode in _POS_MODES:
                rows.append(J6[0:3])
            else:  # rotation tasks
                rows.append(J6[3:6])
        return torch.cat(rows, dim=-2)

    def _constraint_blocks(self, st: KinState):
        con = self.active_contacts()
        consts = [dyn.contact_constraint_block(c.contact_type, c.plane_x, c.plane_y,
                                               c.friction_ratio, c.friction_ratio_z,
                                               dtype=self.dtype, device=self.device)
                  for c in con]
        rots = [dyn.contact_rotation_block(c.contact_type, st.R[c.link]) for c in con]
        return contact_constraint_blocks(consts, rots)

    # ----------------------------------------------------------- pipeline
    def CalcContactConstraint(self):
        """The contact-space factorization; returns 0 when its rank health
        falls below the threshold of the dtype (the numeric analog of the
        reference's "Contact Space Factorization Error", src/wbd.cpp:126-136,
        calibrated by benchmarks/rank_health_calib.py), else 1."""
        st = self.state
        self.J_C = self._contact_jacobian(st)
        self.cspace = dyn.contact_space(self.J_C, st.A_inv, backend=self.backend)
        self.contact_rank_health = self.cspace.rank_health
        thresh = (self.RANK_HEALTH_THRESHOLD_F32 if self.dtype == torch.float32
                  else self.RANK_HEALTH_THRESHOLD_F64)
        return 0 if float(self.cspace.rank_health.min()) < thresh else 1

    def CalcGravCompensation(self):
        st, cs = self.state, self.cspace
        self.torque_grav_, self.P_C = dyn.gravity_compensation(
            st.A_inv, cs.W_inv, cs.N_C, cs.J_C_INV_T, st.G)
        return _np(self.torque_grav_)

    def CalcTaskSpace(self):
        st, cs = self.state, self.cspace
        self._task_factors = []
        self._nulls = []
        prev_null = self._eye(self.model_dof_)
        for h in range(len(self.ts_)):
            J_task = self._task_jacobian(st, h)
            tf = dyn.task_jkt(J_task, st.A_inv, cs.N_C, cs.W_inv, backend=self.backend)
            self._task_factors.append((J_task, tf))
            prev_null = dyn.task_null_space(tf.J_kt, tf.Lambda_task, J_task, cs.A_inv_N_C,
                                            prev_null)
            self._nulls.append(prev_null)

    def _solve_with_retry(self, solve):
        """qpOASES-wrapper semantics: a failed solve retries from scratch at
        10× the iteration budget (src/qp_wrapper.cpp:298-363)."""
        res = solve(self.qp_iters)
        if self._qp_failed(res):
            res = solve(self.qp_iters * 10)
        return res

    def CalcTaskControlTorque(self, hqp: bool = True, init: bool = True,
                              update_task_space: bool = True):
        if update_task_space:
            self.CalcTaskSpace()
        st, cs = self.state, self.cspace
        m = self.model_dof_
        torque_task = self._zeros(m)
        torque_contact = self._zeros(m)
        tlim = self._tlim()
        A_const, A_rot = self._constraint_blocks(st)
        self.qp_results = []
        self.qp_error_ = 0
        for h, (J_task, tf) in enumerate(self._task_factors):
            fstar = self._t(self._fstars[h])
            JktL = tf.J_kt @ tf.Lambda_task
            if hqp:
                Ntorque = JktL if h == 0 else self._nulls[h - 1] @ tf.J_kt @ tf.Lambda_task
                tau_prev = self.torque_grav_ + torque_task
                res = self._solve_with_retry(lambda iters: solve_task_level_qp(
                    Ntorque, fstar, tau_prev, cs.NwJw, cs.J_C_INV_T, self.P_C, A_const,
                    A_rot, tlim, iters=iters, backend=self.backend))
                self.qp_results.append(res)
                self._record_qp(f"task{h}", res.gap, res.primal_res)
                if self._qp_failed(res):
                    # abort the cascade to the safe hold: zero task and
                    # contact torques, the error flagged, return 0
                    # (src/dwbc.cpp:836-846); GetControlTorque then serves
                    # gravity compensation alone
                    self.torque_task_ = self._zeros(m)
                    self.torque_contact_ = self._zeros(m)
                    self.qp_error_ = 1
                    return 0
                torque_h = JktL @ (fstar + res.f_star_delta)
                torque_contact = cs.NwJw @ res.contact_qp
            else:
                torque_h = JktL @ fstar
            torque_task = torque_h if h == 0 else torque_task + self._nulls[h - 1] @ torque_h
        self.torque_task_ = torque_task
        self.torque_contact_ = torque_contact
        return 1

    def CalcContactRedistribute(self, hqp: bool = True, init: bool = True):
        st, cs = self.state, self.cspace
        m = self.model_dof_
        torque_input = self.torque_grav_ + self.torque_task_ + self.torque_contact_
        if hqp:
            if cs.NwJw.shape[-1] == 0:
                # contact_dof ≤ 6: nothing to redistribute (the reference's
                # `if (contact_dof > 0)` guard, src/dwbc.cpp:1424)
                self.cf_redis_qp_ = self._zeros(0)
                return 1
            tlim = self._tlim()
            A_const, A_rot = self._constraint_blocks(st)
            sol = self._solve_with_retry(lambda iters: solve_contact_redistribution_qp(
                torque_input, cs.NwJw, cs.J_C_INV_T, self.P_C, A_const, A_rot, tlim,
                iters=iters, backend=self.backend))
            self._record_qp("redistribution", sol.gap, sol.primal_res)
            if self._qp_failed(sol):
                # a failed redistribution: zero contact_qp, qp_error,
                # return 0 (src/dwbc.cpp:1117-1125)
                self.cf_redis_qp_ = torch.zeros_like(sol.x)
                self.qp_error_ = 1
                return 0
            self.cf_redis_qp_ = sol.x
            self.torque_contact_ = self.torque_contact_ + cs.NwJw @ sol.x
            return 1
        # the closed-form two-foot redistribution (src/dwbc.cpp:1572-1612)
        if self.contact_dof_ != 12:
            self.torque_contact_ = self._zeros(m)
            return 0
        cf = dyn.contact_force_from_torque(torque_input, cs.J_C_INV_T, self.P_C)
        pc = [st.p[c.link] + st.R[c.link] @ self._t(c.contact_point)
              for c in self.active_contacts()]
        # the base's yaw (rpy of the pelvis rotation, eulerAngles(2,1,0))
        R0 = st.R[0]
        Rz = dyn.yaw_rotation(-torch.atan2(R0[1, 0], R0[0, 0]))
        rot12 = torch.block_diag(Rz, Rz, Rz, Rz)
        P1 = Rz @ (pc[0] - st.com_pos)
        P2 = Rz @ (pc[1] - st.com_pos)
        _, redist, _ = dyn.contact_redistribute_two(0.99, 0.26, 0.1, 1.0, 0.9, 0.9, P1, P2,
                                                    rot12 @ cf)
        fc_redist = rot12.T @ redist
        desired = -cf[6:12] + fc_redist[6:12]
        V2T = cs.V2.transpose(-1, -2)
        M = cs.J_C_INV_T[:, -m:][6:12, :] @ V2T
        self.torque_contact_ = V2T @ torch.linalg.inv(M) @ desired
        return 1

    # ------------------------------------------------------ model surgery
    # (the reference mutates RBDL internals and renumbers,
    #  src/dwbc.cpp:1821-2382; here a recompiled model and renumbering by
    #  body name)
    def _apply_surgery(self, new_model):
        old_names = self.model.body_names
        cc_names = [old_names[c.link] for c in self.cc_]
        ts_names = [[old_names[tl.link] if tl.link < len(old_names) else "COM"
                     for tl in td.links] for td in self.ts_]
        self.SetModel(new_model)
        kept = {nm: i for i, nm in enumerate(new_model.body_names)}
        self.cc_ = [T.ContactDef(**{**c.__dict__, "link": kept[nm]})
                    for c, nm in zip(self.cc_, cc_names) if nm in kept]
        self.ts_ = [T.TaskDef(links=[
            T.TaskLinkDef(tl.mode, kept[nm] if nm in kept else new_model.nbody, tl.task_point)
            for tl, nm in zip(td.links, names) if nm in kept or nm == "COM"],
            custom_dof=td.custom_dof) for td, names in zip(self.ts_, ts_names)]
        self.state = None

    def _body(self, link):
        return int(self.model.body_index(link) if isinstance(link, str) else link)

    def DeleteLink(self, link, verbose=False):
        self._apply_surgery(surgery.delete_subtree(self.model, self._body(link)))

    def ChangeLinkToFixedJoint(self, link, verbose=False):
        self._apply_surgery(surgery.change_link_to_fixed(self.model, self._body(link)))

    def AddLink(self, parent, name, joint_type, axis, origin_xyz, origin_rpy, mass, com,
                inertia, verbose=False):
        self._apply_surgery(surgery.add_link(
            self.model, self._body(parent), name, joint_type, np.asarray(axis, float),
            np.asarray(origin_xyz, float), np.asarray(origin_rpy, float), float(mass),
            np.asarray(com, float), np.asarray(inertia, float)))

    def ChangeLinkInertia(self, link, mass, com, inertia, verbose=False):
        self._apply_surgery(surgery.change_link_inertia(
            self.model, self._body(link), float(mass), np.asarray(com, float),
            np.asarray(inertia, float)))

    # ------------------------------------------- LQP (acceleration level)
    def getContactConstraintMatrix(self):
        """C = −A_const·A_rot (src/dwbc.cpp:480-513)."""
        A_const, A_rot = self._constraint_blocks(self.state)
        return -(A_const @ A_rot)

    def ConfigureLQP(self, init: bool = True):
        """Build the acceleration-level lexicographic cascade
        (src/dwbc.cpp:4304-4430)."""
        st = self.state
        self.J_C = self._contact_jacobian(st)
        self._lqp_levels = lqp.build_lqp_levels(
            st.A, st.B, self.J_C, self.getContactConstraintMatrix(),
            [self._task_jacobian(st, h) for h in range(len(self.ts_))],
            [self._t(self._fstars[h]) for h in range(len(self.ts_))])
        n = self.model.ndof
        y0 = self._zeros(n + self.J_C.shape[-2])
        y0[:n] = -(st.A_inv @ st.B)
        self._lqp_y0 = y0
        return 1

    def CalcControlTorqueLQP(self, init: bool = True):
        """Solve the cascade and recover the actuated torque
        (src/dwbc.cpp:4432); the per-level assembly and solve times go to
        ``lqp_level_times_`` (surfaced by GetQPStats)."""
        timers: list = []
        res = lqp.solve_cascade(self._lqp_levels, self._lqp_y0, qp_iters=self.qp_iters,
                                timers=timers, backend=self.backend)
        self._record_lqp_times(timers)
        self.lqp_result = res
        st = self.state
        self.torque_lqp_ = lqp.lqp_torque_from_solution(res.y, st.A, st.B, self.J_C)
        return _np(self.torque_lqp_)

    def _record_lqp_times(self, timers: list):
        """Per-level step times and their running maxima (the reference's
        HQP_Hierarch::qp_update_time_max_, src/dwbc_hqp.cpp:615-626)."""
        self.lqp_level_times_ = timers
        for t in timers:
            mx = self.lqp_level_times_max_.setdefault(t["level"],
                                                      dict(update_us=0.0, solve_us=0.0))
            mx["update_us"] = max(mx["update_us"], t["update_us"])
            mx["solve_us"] = max(mx["solve_us"], t["solve_us"])

    # ------------------------------------- acceleration-level JACC QPs
    def _jacc_qp(self, A_mat, G_vec, J_C, CCM, task_Js, fstars, n, mdof, nphys):
        """The per-level JACC QPs over x = [q̈; τ; f_c; δf*] with the
        equations of motion as an equality (src/dwbc.cpp:3772-4122): τ boxed
        at ±200 on its first ``nphys`` entries, q̈ of the joints at ±10;
        each level keeps the earlier levels' tasks at their solved f*.
        Returns the last level's solution."""
        c = J_C.shape[-2]
        t_i, c_i = n, n + mdof
        ST = self._zeros(n, mdof)
        ST[6:, :] = self._eye(mdof)
        prev, sol = [], None
        for J_task, fstar in zip(task_Js, fstars):
            t = J_task.shape[-2]
            d_i = n + mdof + c
            nv = d_i + t
            H = self._zeros(nv, nv)
            H[:n, :n] = A_mat
            H[d_i:, d_i:] = 100.0 * self._eye(t)
            g = self._zeros(nv)

            eom = self._zeros(n, nv)
            eom[:, :n] = A_mat
            eom[:, t_i:c_i] = -ST
            eom[:, c_i:d_i] = J_C.T
            eqs, ebs = [eom], [-G_vec]
            con = self._zeros(c, nv)
            con[:, :n] = J_C
            eqs.append(con)
            ebs.append(self._zeros(c))
            for Jp, fp in prev:
                row = self._zeros(Jp.shape[-2], nv)
                row[:, :n] = Jp
                eqs.append(row)
                ebs.append(fp)
            row = self._zeros(t, nv)
            row[:, :n] = J_task
            row[:, d_i:] = -self._eye(t)
            eqs.append(row)
            ebs.append(fstar)

            cone = self._zeros(CCM.shape[0], nv)
            cone[:, c_i:d_i] = CCM
            qdd = self._zeros(mdof, nv)
            qdd[:, 6:n] = self._eye(mdof)
            tau = self._zeros(nphys, nv)
            tau[:, t_i:t_i + nphys] = self._eye(nphys)
            A = torch.cat([cone, qdd, -qdd, tau, -tau], dim=0)
            ub = torch.cat([self._zeros(CCM.shape[0])]
                           + [torch.full((mdof,), 10.0, dtype=self.dtype, device=self.device)] * 2
                           + [torch.full((nphys,), 200.0, dtype=self.dtype,
                                         device=self.device)] * 2)
            sol = solve_qp(H, g, A, None, ub, torch.cat(eqs, dim=0), torch.cat(ebs, dim=0),
                           iters=self.qp_iters, backend=self.backend)
            prev.append((J_task, fstar + sol.x[d_i:]))
        return sol

    def CalcTaskControlTorqueJACC(self, init: bool = True):
        """Per-level acceleration QP over x = [q̈; τ; f_c; δf*] with the full
        equations of motion as an equality (``CalcSingleTaskTorqueWithJACC_QP``,
        src/dwbc.cpp:3772-3944).  Returns the last level's torque."""
        st = self.state
        n, mdof = self.model.ndof, self.model_dof_
        self.J_C = self._contact_jacobian(st)
        res = self._jacc_qp(st.A, st.G, self.J_C, self.getContactConstraintMatrix(),
                            [self._task_jacobian(st, h) for h in range(len(self.ts_))],
                            [self._t(self._fstars[h]) for h in range(len(self.ts_))],
                            n, mdof, mdof)
        self.jacc_result = res
        self.torque_jacc_ = res.x[n:n + mdof]
        self.acc_jacc_ = res.x[:n]
        return _np(self.torque_jacc_)

    def _J_CR(self):
        """J_C in reduced coordinates: its virtual-and-contact-chain columns."""
        idx = self._ridx
        J_CR = self._zeros(self.J_C.shape[-2], idx.reduced_system_dof)
        J_CR[:, :idx.vc_dof] = self.J_C[:, self._index(idx.vc_joints)]
        return J_CR

    def _index(self, a):
        return torch.as_tensor(a, device=self.device)

    def CalcTaskControlTorqueJACC_R(self, init: bool = True):
        """Reduced-coordinate acceleration QPs over x = [q̈_R; τ_R; f_c; δf*]
        (``CalcSingleTaskTorqueWithJACC_QP_R``, src/dwbc.cpp:3946-4122): the
        equations of motion in reduced coordinates, tasks projected through
        J̄_Rᵀ; the torque box on the physical contact-chain joints only (the
        six virtual lumped-body torques are unbounded, src/dwbc.cpp:4081).
        Needs ReducedDynamicsCalculate and ReducedCalcContactConstraint."""
        st, idx, rd = self.state, self._ridx, self.rdyn
        n, mdof = idx.reduced_system_dof, idx.reduced_model_dof
        self.J_C = self._contact_jacobian(st)
        JRIT_T = rd.J_R_INV_T.T
        res = self._jacc_qp(rd.A_R, rd.G_R, self._J_CR(), self.getContactConstraintMatrix(),
                            [self._task_jacobian(st, h) @ JRIT_T for h in range(len(self.ts_))],
                            [self._t(self._fstars[h]) for h in range(len(self.ts_))],
                            n, mdof, mdof - 6)
        self.jacc_r_result = res
        self.torque_jacc_R_ = res.x[n:n + mdof]
        self.acc_jacc_R_ = res.x[:n]
        self.torque_jacc_full_ = self._recompose(self.torque_jacc_R_, rd.G_NC)
        return _np(self.torque_jacc_R_)

    def _recompose(self, tau_R, tau_nc):
        """The full actuated torque of a reduced one: the contact-chain
        joints exact, the nc joints J_I_ncᵀ τ_R(lumped) + N_I_nc τ_nc
        (src/dwbc.cpp:3442-3443)."""
        co, rd = self._ridx.co_dof, self.rdyn
        return torch.cat([tau_R[:co], rd.J_I_nc.T @ tau_R[co:] + rd.N_I_nc @ tau_nc])

    def _nc_levels(self):
        """Task levels on the non-contact chain (neither a contact-chain
        link nor the COM)."""
        co_set = set(self._ridx.co_links)
        return [h for h, td in enumerate(self.ts_)
                if any(tl.link not in co_set and tl.link != self.model.nbody
                       for tl in td.links)]

    def _fstar_local(self, h, t, fstar, base_acc):
        """A nc task's f* relative to the decided base motion: the
        reference's Ja·(f* − q̈_base) with the moment-arm coupling for a 6D
        task (src/dwbc.cpp:4151-4154), f* − ω̇_base for a rotation task."""
        if t == 6:
            link = self.ts_[h].links[0].link
            st = self.state
            Ja = self._eye(6)
            Ja[0:3, 3:6] = skew(st.p[link] - st.p[0])
            return Ja @ (fstar - base_acc)
        return fstar - base_acc[3:6]

    def CalcTaskControlTorqueJACC_R_NC(self, prev_acc=None, init: bool = True):
        """Non-contact-chain acceleration QP with the lumped-COM coupling
        (``CalcSingleTaskTorqueWithJACC_QP_R_NC``, src/dwbc.cpp:4124-4302),
        given the reduced JACC solution's accelerations ``prev_acc``
        (reduced_system_dof: head 6 the floating base, tail 6 the lumped nc
        body), over x = [q̈_nc; τ_nc; g_acc(6); δf*]:

            min ‖g_acc‖² + 5‖δf*‖²
            s.t.  A_nc q̈_nc − τ_nc     = −G_nc     (nc equations of motion)
                  J_I_nc q̈_nc − g_acc  = ḡ_prev    (COM coupling)
                  J_task,nc q̈_nc − δf* = f*_local  (task)

        The box bounds are not enforced, as in the reference
        (DeleteSubjectToX, src/dwbc.cpp:4292).  Returns τ_nc."""
        st, idx, rd = self.state, self._ridx, self.rdyn
        ncd = idx.nc_dof
        prev_acc = self._t(self.acc_jacc_R_ if prev_acc is None else prev_acc)
        nc_levels = self._nc_levels()
        if not nc_levels:
            raise ValueError("no non-contact-chain task level configured")
        nc_h = nc_levels[0]   # the reference passes ts_.back()
        J_task = self._task_jacobian(st, nc_h)
        t = J_task.shape[-2]
        Jt_nc = J_task[:, self._index(idx.nc_joints)]
        fstar_local = self._fstar_local(nc_h, t, self._t(self._fstars[nc_h]), prev_acc[0:6])

        nv = 2 * ncd + 6 + t
        t_i, g_i, d_i = ncd, 2 * ncd, 2 * ncd + 6
        H = self._zeros(nv, nv)
        H[g_i:d_i, g_i:d_i] = self._eye(6)
        H[d_i:, d_i:] = 5.0 * self._eye(t)
        g = self._zeros(nv)
        Aeq = self._zeros(ncd + 6 + t, nv)
        Aeq[:ncd, :ncd] = rd.A_NC_joint
        Aeq[:ncd, t_i:g_i] = -self._eye(ncd)
        Aeq[ncd:ncd + 6, :ncd] = rd.J_I_nc
        Aeq[ncd:ncd + 6, g_i:d_i] = -self._eye(6)
        Aeq[ncd + 6:, :ncd] = Jt_nc
        Aeq[ncd + 6:, d_i:] = -self._eye(t)
        beq = torch.cat([-rd.G_NC, prev_acc[-6:], fstar_local])
        # an equality-only QP: one always-satisfied dummy inequality row
        sol = solve_qp(H, g, self._zeros(1, nv), None, torch.ones(1, dtype=self.dtype,
                                                                  device=self.device),
                       Aeq, beq, iters=self.qp_iters, backend=self.backend)
        self.jacc_r_nc_result = sol
        self._record_qp("jacc_r_nc", sol.gap, sol.primal_res)
        self.acc_jacc_nc_ = sol.x[:ncd]
        self.torque_jacc_nc_ = sol.x[t_i:g_i]
        self.gacc_jacc_nc_ = sol.x[g_i:d_i]
        self.fstar_jacc_nc_ = sol.x[d_i:]
        return _np(self.torque_jacc_nc_)

    def ConfigureLQP_R(self, init: bool = True):
        """Reduced-coordinate LQP cascade (src/dwbc.cpp:4504-4632): the
        priority scheme of ConfigureLQP over y = [q̈_R; f_c], the nc tasks
        left to the _R_NC cascade; G_R is the bias vector there (the
        reference uses G_R, not B_R, src/dwbc.cpp:4555)."""
        st, idx, rd = self.state, self._ridx, self.rdyn
        self.J_C = self._contact_jacobian(st)
        J_CR = self._J_CR()
        nc = set(self._nc_levels())
        levels = [h for h in range(len(self.ts_)) if h not in nc]
        JRIT_T = rd.J_R_INV_T.T
        self._lqp_r_levels = lqp.build_lqp_levels(
            rd.A_R, rd.G_R, J_CR, self.getContactConstraintMatrix(),
            [self._task_jacobian(st, h) @ JRIT_T for h in levels],
            [self._t(self._fstars[h]) for h in levels])
        r_sys = idx.reduced_system_dof
        y0 = self._zeros(r_sys + J_CR.shape[-2])
        y0[:r_sys] = -(rd.A_R_inv @ rd.G_R)
        self._lqp_r_y0 = y0
        self._lqp_r_JCR = J_CR
        return 1

    def CalcControlTorqueLQP_R(self, init: bool = True):
        """Solve the reduced cascade; the reduced actuated torque and the
        full command recomposed (the contact-chain joints exact, the nc
        joints the lumped-wrench map and gravity, src/dwbc.cpp:3442-3443)."""
        timers: list = []
        res = lqp.solve_cascade(self._lqp_r_levels, self._lqp_r_y0, qp_iters=self.qp_iters,
                                timers=timers, backend=self.backend)
        self._record_lqp_times(timers)
        self.lqp_r_result = res
        rd = self.rdyn
        self.torque_lqp_R_ = lqp.lqp_torque_from_solution(res.y, rd.A_R, rd.G_R,
                                                          self._lqp_r_JCR)
        self.torque_lqp_ = self._recompose(self.torque_lqp_R_, rd.G_NC)
        return _np(self.torque_lqp_)

    def ConfigureLQP_R_NC(self, q_acc_R, init: bool = True):
        """Non-contact-chain LQP (src/dwbc.cpp:4634-4760): given the reduced
        solution's base and lumped accelerations q_acc_R (r_sys), the nc
        joint accelerations under the lumped-body coupling J_I_nc q̈_nc =
        −f*_gnc and one upper-body task level."""
        st, idx, rd = self.state, self._ridx, self.rdyn
        ncd = idx.nc_dof
        q_acc_R = self._t(q_acc_R)
        A_nc = rd.A_NC_joint
        cost = A_nc / torch.linalg.matrix_norm(A_nc) * 5.0
        # L0: eq J_I_nc q̈ = −f*_gnc; ineq the nc torque limits, gravity-biased
        tlim = torch.full((ncd,), 200.0, dtype=self.dtype, device=self.device)
        levels = [lqp.LQPLevel(A=torch.cat([A_nc, -A_nc], dim=-2),
                               a=torch.cat([-tlim + rd.G_NC, -tlim - rd.G_NC], dim=-1),
                               B=rd.J_I_nc, b=q_acc_R[-6:], rank=6, H=cost)]
        # L1: the first nc task level, its f* relative to the base
        # acceleration (src/dwbc.cpp:4737-4746); the reference builds one
        nc_levels = self._nc_levels()
        if nc_levels:
            h = nc_levels[0]
            Jt_full = self._task_jacobian(st, h)
            t = Jt_full.shape[-2]
            fstar_local = self._fstar_local(h, t, self._t(self._fstars[h]), q_acc_R[0:6])
            alim = torch.full((ncd,), 5.0, dtype=self.dtype, device=self.device)
            levels.append(lqp.LQPLevel(
                A=torch.cat([self._eye(ncd), -self._eye(ncd)], dim=-2),
                a=torch.cat([-alim, -alim], dim=-1),
                B=Jt_full[:, self._index(idx.nc_joints)], b=-fstar_local, rank=t, H=cost))
        self._lqp_nc_levels = levels
        self._lqp_nc_y0 = self._zeros(ncd)
        return 1

    def CalcControlTorqueLQP_R_NC(self, init: bool = True):
        """solvefirst, then sequential, over the nc cascade
        (src/dwbc.cpp:4479-4502); τ_nc = A_NC q̈_nc + G_NC.  Also recomposes
        the full command ``torque_lqp_`` with this τ_nc in place of the
        gravity filler CalcControlTorqueLQP_R left there (the sequence of the
        reference's DoF-sweep harness, tests/sp_test/dof_comparison.cpp:229-252)."""
        timers: list = []
        res = lqp.solve_cascade(self._lqp_nc_levels, self._lqp_nc_y0, solve_level0=True,
                                qp_iters=self.qp_iters, timers=timers, backend=self.backend)
        self._record_lqp_times(timers)
        self.lqp_nc_result = res
        rd = self.rdyn
        tau_nc = rd.A_NC_joint @ res.y + rd.G_NC
        self.torque_lqp_nc_ = tau_nc
        if self.torque_lqp_R_ is not None:
            self.torque_lqp_ = self._recompose(self.torque_lqp_R_, tau_nc)
        return _np(tau_nc)

    # ------------------------------------------------- reduced (`_R`) path
    def ReducedDynamicsCalculate(self, verbose=False):
        self._ridx = red.classify_chains(self.model, [c.link for c in self.active_contacts()])
        if self._ridx.nc_dof == 0:
            # every joint is on the contact chain: nothing to lump, and the
            # reduced pipeline degenerates to the full one
            self._reduced_degenerate = True
            self.rdyn = None
            return None
        self._reduced_degenerate = False
        self.rdyn = red.reduced_dynamics(self.model, self._ridx, self.state,
                                         backend=self.backend)
        return self.rdyn

    def ReducedCalcContactConstraint(self):
        if self._reduced_degenerate:
            return self.CalcContactConstraint()
        st = self.state
        self.J_C = self._contact_jacobian(st)
        self.cspace_r, self.J_CR = red.reduced_contact_space(self._ridx, self.J_C, self.rdyn,
                                                             backend=self.backend)
        # the full contact space stays needed for the nc tasks' Λ (the
        # reference recomputes J_C_INV_T and N_C, src/dwbc.cpp:3104-3110)
        self.cspace = dyn.contact_space(self.J_C, st.A_inv, backend=self.backend)
        return 1

    def ReducedCalcGravCompensation(self):
        if self._reduced_degenerate:
            return self.CalcGravCompensation()
        st, cs = self.state, self.cspace
        self.torque_grav_, self.torque_grav_R_, self.P_CR = red.reduced_gravity(
            self._ridx, self.cspace_r, self.rdyn, st.G)
        _, self.P_C = dyn.gravity_compensation(st.A_inv, cs.W_inv, cs.N_C, cs.J_C_INV_T, st.G)
        return _np(self.torque_grav_)

    def ReducedCalcTaskSpace(self):
        """Task classification and the reduced JKT (src/dwbc.cpp:3152-3253)."""
        st, idx, rd = self.state, self._ridx, self.rdyn
        vcj, ncj = self._index(idx.vc_joints), self._index(idx.nc_joints)
        r_sys, vc = idx.reduced_system_dof, idx.vc_dof
        # the base link's 6D JKT in reduced coordinates (src/dwbc.cpp:3159-3160)
        self._J_base_R_kt, self._lambda_base_R = self._jkt_r(st.J[0][:, :r_sys])
        co_set = set(idx.co_links)
        nbody = self.model.nbody
        self._rtasks = []
        prev_null = self._eye(idx.reduced_model_dof)
        nc_h = 0
        for h, td in enumerate(self.ts_):
            J_task = self._task_jacobian(st, h)
            is_cmm = any(tl.link == nbody for tl in td.links)
            is_co = any(tl.link in co_set and tl.link != nbody for tl in td.links)
            is_nc = any(tl.link not in co_set and tl.link != nbody for tl in td.links)
            JR = self._zeros(J_task.shape[-2], r_sys)
            JR[:, :vc] = J_task[:, vcj]
            entry = dict(J_task=J_task, cmm=is_cmm, co=is_co, nc=is_nc, h=h)
            if is_cmm or (is_co and not is_nc):
                if is_cmm:
                    JR[:, vc:] = J_task[:, ncj] @ rd.J_I_nc_inv_T.T
                J_kt_R, Lambda = self._jkt_r(JR)
                entry.update(J_task_R=JR, J_kt_R=J_kt_R, Lambda=Lambda)
                null = dyn.task_null_space(J_kt_R, Lambda, JR, self.cspace_r.A_inv_N_C,
                                           prev_null)
            elif is_nc and not is_co:
                Lambda = dyn._psd_inv_reg(J_task @ self.cspace.A_inv_N_C @ J_task.T,
                                          self.backend)
                JR[:, vc:] = J_task[:, ncj] @ rd.J_I_nc_inv_T.T
                entry.update(J_task_R=JR, J_kt_R=None, Lambda=Lambda,
                             J_task_NC=J_task[:, ncj], nc_h=nc_h)
                nc_h += 1
                null = prev_null  # nc tasks consume no reduced null space
            else:
                # a level spanning both chains is undefined in the reference
                # too ("UNDEFINED TASK TYPE", src/task.cpp:134-143): fail
                # loudly instead of leaving it unsolved
                raise NotImplementedError(
                    "a task level spanning both contact-chain and non-contact-chain links "
                    "is undefined in the reduced formulation (reference: 'UNDEFINED TASK "
                    "TYPE', src/task.cpp:134-143); split the level or use the "
                    "full-dimension pipeline")
            entry["null"] = null
            self._rtasks.append(entry)
            prev_null = null

    def _reduced_tlim(self):
        """Torque limits in reduced coordinates: the physical limits on the
        contact-chain joints, none on the 6 virtual lumped-body dofs (the
        reference slices torque_limit_[0:reduced_model_dof],
        src/dwbc.cpp:3513, which puts joint limits on the virtual dofs)."""
        if self.torque_limit_ is None:
            return None
        co_act = self._ridx.co_joints - 6
        return self._t(np.concatenate([self.torque_limit_[co_act], np.full(6, np.inf)]))

    def _jkt_r(self, J_task_R):
        """CalculateJKT_R (src/wbd.cpp:220-226)."""
        csr = self.cspace_r
        JAN = J_task_R @ csr.A_inv_N_C
        M = JAN @ J_task_R.T
        Lambda = dyn._psd_inv_reg(0.5 * (M + M.T), self.backend)
        Q = (Lambda @ JAN)[:, 6:]
        QWQ = Q @ csr.W_inv @ Q.T
        J_kt = csr.W_inv @ Q.T @ dyn._psd_inv_reg(0.5 * (QWQ + QWQ.T), self.backend)
        return J_kt, Lambda

    def _reduced_task_qp(self, Ntorque, fstar, tau_prev, tlim, A_const, A_rot):
        csr = self.cspace_r
        return solve_task_level_qp(Ntorque, fstar, tau_prev, csr.NwJw, csr.J_C_INV_T,
                                   self.P_CR, A_const, A_rot, tlim, iters=self.qp_iters,
                                   backend=self.backend)

    def ReducedCalcTaskControlTorque(self, hqp: bool = True, init: bool = True,
                                     calc_task_space: bool = True):
        """src/dwbc.cpp:3255-3446."""
        if self._reduced_degenerate:
            return self.CalcTaskControlTorque(hqp, init)
        if calc_task_space:
            self.ReducedCalcTaskSpace()
        st, idx, rd = self.state, self._ridx, self.rdyn
        r_model = idx.reduced_model_dof
        co = idx.co_dof
        ncj = self._index(idx.nc_joints)
        R0 = st.R[0]
        tlim = self._reduced_tlim()
        A_const, A_rot = self._constraint_blocks(st)
        torque_task_R = self._zeros(r_model)
        torque_task_NC = self._zeros(idx.nc_dof)
        force_on_nc_r = self._zeros(6)
        first_nc = None
        self._r_qp_results = []

        def null_before(h):
            return self._rtasks[h - 1]["null"] if h > 0 else self._eye(r_model)

        for e in self._rtasks:
            h = e["h"]
            fstar = self._t(self._fstars[h])
            if e["nc"] and not e["co"]:
                J_task = e["J_task"]
                temp = J_task.T @ (e["Lambda"] @ fstar)
                torque_nc = temp[ncj]
                f_on_nc = torch.cat([temp[0:3], R0 @ temp[3:6]])
                force_on_nc_r = force_on_nc_r + f_on_nc
                th_R = torch.cat([self._J_base_R_kt[:co] @ f_on_nc,
                                  rd.J_I_nc_inv_T @ torque_nc])
                if e["nc_h"] == 0:
                    first_nc = e
                    e["torque_null_h_R"] = null_before(h) @ th_R
                    e["torque_null_h_nc"] = torque_nc
                else:
                    prev_e = self._rtasks[h - 1]
                    Jp = prev_e["J_task"]
                    null_force = prev_e["Lambda"] @ (
                        Jp @ (self.cspace.A_inv_N_C @ (J_task.T @ (e["Lambda"] @ fstar))))
                    temp2 = Jp.T @ null_force
                    e["torque_null_h_nc"] = torque_nc - temp2[ncj]
                    temp2 = torch.cat([temp2[0:3], R0 @ temp2[3:6], temp2[6:]])
                    nthr = torch.cat([
                        th_R[:co] - self._J_base_R_kt[:co] @ temp2[0:6],
                        rd.J_I_nc_inv_T @ (torque_nc - prev_e["J_task_NC"].T @ null_force)])
                    e["torque_null_h_R"] = prev_e["null"] @ nthr
                    force_on_nc_r = force_on_nc_r - temp2[0:6]
                if not hqp:
                    torque_task_R = torque_task_R + e["torque_null_h_R"]
                    torque_task_NC = torque_task_NC + e["torque_null_h_nc"]
            else:
                prev_null = null_before(h)
                JktL = e["J_kt_R"] @ e["Lambda"]
                if hqp:
                    res = self._reduced_task_qp(prev_null @ JktL, fstar,
                                                self.torque_grav_R_ + torque_task_R, tlim,
                                                A_const, A_rot)
                    self._r_qp_results.append(res)
                    th_R = JktL @ (fstar + res.f_star_delta)
                else:
                    th_R = JktL @ fstar
                torque_task_R = torque_task_R + (th_R if h == 0 else prev_null @ th_R)

        torque_task_R_qp = self._zeros(r_model)
        if hqp:
            # the nc chain's resultant-force QP sees the torque WITHOUT the
            # nc contributions (src/dwbc.cpp:3422), which are added after
            if first_nc is not None:
                res = self._reduced_task_qp(null_before(first_nc["h"]) @ self._J_base_R_kt,
                                            force_on_nc_r, self.torque_grav_R_ + torque_task_R,
                                            tlim, A_const, A_rot)
                self._r_qp_results.append(res)
                torque_task_R_qp = self._J_base_R_kt @ res.f_star_delta
                torque_task_R_qp[co:] = 0.0
            for e in self._rtasks:
                if e["nc"] and not e["co"]:
                    torque_task_R = torque_task_R + e["torque_null_h_R"]
                    torque_task_NC = torque_task_NC + e["torque_null_h_nc"]

        # recomposition to the full actuated torque (src/dwbc.cpp:3442-3443)
        self.torque_task_R_ = torque_task_R
        self.torque_task_ = self._recompose(torque_task_R + torque_task_R_qp, torque_task_NC)
        self.torque_contact_ = self._zeros(self.model_dof_)
        return 1

    def ReducedCalcContactRedistribute(self, hqp: bool = True, init: bool = True,
                                       tangential_weight: bool = True):
        """src/dwbc.cpp:3758-3770 and CalcContactRedistributeR (4776-4992).
        tangential_weight=True is the reference's reduced objective (the
        tangential contact forces); False the full path's min-norm one."""
        if self._reduced_degenerate:
            return self.CalcContactRedistribute(hqp, init)
        csr = self.cspace_r
        A_const, A_rot = self._constraint_blocks(self.state)
        sol = solve_contact_redistribution_qp(
            self.torque_grav_R_ + self.torque_task_R_, csr.NwJw, csr.J_C_INV_T, self.P_CR,
            A_const, A_rot, self._reduced_tlim(), iters=self.qp_iters,
            tangential_weight=tangential_weight, backend=self.backend)
        self.redist_r_result = sol
        tc = self._zeros(self.model_dof_)
        cdof = self.contact_dof_
        tc[:cdof] = (csr.NwJw @ sol.x)[:cdof]
        self.torque_contact_ = tc
        return 1

    # --------------------------------------------------- QP statistics
    def _qp_failed(self, res) -> bool:
        """The analog of qpOASES' failure status (src/qp_wrapper.cpp:298-363):
        a real primal violation, a real complementarity gap, or a non-finite
        solution."""
        if not bool(torch.isfinite(res.x).all()):
            return True
        return (float(res.primal_res.max()) > self.QP_FAIL_PRES
                or float(res.gap.max()) > self.QP_FAIL_GAP)

    def _record_qp(self, name: str, gap, primal_res, tol: float = 1e-5):
        ok = bool(primal_res < tol)
        self.qp_success_count_ += int(ok)
        self.qp_fail_count_ += int(not ok)
        self.qp_history_.append(dict(name=name, gap=float(gap), primal_res=float(primal_res),
                                     ok=ok))

    def GetQPStats(self):
        """Solver health (the reference's data_confirmation success counters)
        and the per-level LQP times (the per-hierarchy qp_update/solve
        time fields, include/dwbc_hqp.h:98-102)."""
        return dict(
            solves=len(self.qp_history_),
            success=self.qp_success_count_,
            fail=self.qp_fail_count_,
            qp_error=self.qp_error_,
            worst_primal_res=max((h["primal_res"] for h in self.qp_history_), default=0.0),
            worst_gap=max((h["gap"] for h in self.qp_history_), default=0.0),
            lqp_level_times=self.lqp_level_times_,
            lqp_level_times_max=self.lqp_level_times_max_,
        )

    # ---------------------------------------------------------- centroidal
    def CalcAngularMomentumMatrix(self):
        """The explicit 3×ndof angular-momentum matrix about the whole-body
        COM (src/dwbc.cpp:1633-1680)."""
        return _np(angular_momentum_matrix(self.kin, self.state))

    def CalcVirtualCMM(self, body_mask=None, about=None):
        """The angular-momentum matrix of a body subset about a point
        (``CalcVirtualCMM``, src/dwbc.cpp:1682-1709): a 0/1 (nbody,) mask
        of the links (None: all) and the point (None: the whole-body COM)."""
        return _np(virtual_cmm(self.kin, self.state, body_mask, about))

    # ------------------------------------------------------------ observers
    def getContactForce(self, command_torque):
        return _np(dyn.contact_force_from_torque(self._t(command_torque),
                                                 self.cspace.J_C_INV_T, self.P_C))

    def getZMP(self, contact_force):
        """The aggregate ZMP of the per-contact wrenches (src/dwbc.cpp:898-939)."""
        cf = np.asarray(contact_force)
        st = self.state
        con = self.active_contacts()
        poss, offs, off, total_fz = [], [], 0, 0.0
        for c in con:
            poss.append(_np(st.p[c.link] + st.R[c.link] @ self._t(c.contact_point)))
            offs.append(off)
            total_fz += cf[off + 2]
            off += c.contact_dof
        zmp = np.zeros(3)
        for c, pw, o in zip(con, poss, offs):
            fz = cf[o + 2]
            if fz > -1e-3 or c.contact_type == T.CONTACT_POINT:
                zp = pw   # a point contact's ZMP is its own position
            elif c.contact_type == T.CONTACT_LINE:
                # the line wrench [f(3), my, mz]: the CoP moves along the line
                zp = pw + np.array([-cf[o + 3] / fz, 0.0, 0.0])
            else:
                zp = pw + np.array([-cf[o + 4] / fz, cf[o + 3] / fz, 0.0])
            zmp += zp * fz / total_fz
        return zmp

    def torque_command(self):
        return _np(self.torque_grav_ + self.torque_task_ + self.torque_contact_)

    def GetControlTorque(self):
        """τ_cmd = τ_grav + τ_task + τ_contact (include/dwbc.h:409, summed as
        rl_wbc_bridge.cpp:131-139 does)."""
        return self.torque_command()
