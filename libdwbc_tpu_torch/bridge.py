"""RL environment bridge (counterpart of ``libdwbc_tpu/bridge.py``, the
reference's pybind11 module src/pybind/rl_wbc_bridge.cpp).

The fixed Tocabi setup (two 6D foot contacts, a pelvis 6D task over an
upper-body rotation task, ±300 Nm limits), the MuJoCo qpos quaternion
reorder, and the gravity → task → redistribution tick.  ``RlWBCBridge``
drives one environment through ``RobotData``; ``BatchedRlWBCBridge`` solves
N environments per call through one ``CompiledTick``.  Both run on the card
by default (``backend="cuda"``: the SPD inverses on ``psd_inverse``, the
QPs on ``qp_solve``); pass ``device="cpu", backend="torch"`` for the plain
version.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "models", "tocabi.npz")


def _standard_robot(model_path: str | None = None, urdf_path: str | None = None,
                    dtype=torch.float32, device=None, backend="cuda"):
    """A RobotData in the reference's RL configuration."""
    from .model.compile import RobotModel
    from .wbc import types as T
    from .wbc.robot import RobotData

    rd = RobotData(dtype, device, backend)
    if urdf_path:
        rd.LoadModelData(urdf_path, True, 0)
    else:
        rd.SetModel(RobotModel.load(model_path or _DEFAULT_MODEL))
    rd.AddContactConstraint(6, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddContactConstraint(12, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddTaskSpace(0, T.TASK_LINK_6D, 0, np.zeros(3))
    rd.AddTaskSpace(1, T.TASK_LINK_ROTATION, 15, np.zeros(3))
    rd.SetTorqueLimit(np.full(rd.model_dof_, 300.0))
    return rd


def mujoco_to_dwbc_q(qpos: np.ndarray, system_dof: int, model_dof: int,
                     dtype=np.float64) -> np.ndarray:
    """MuJoCo qpos [x y z, qw qx qy qz, joints] → RBDL layout
    [x y z, qx qy qz, joints, qw] (rl_wbc_bridge.cpp:88-98), over any
    leading batch dimensions."""
    qpos = np.asarray(qpos, dtype)
    q = np.zeros(qpos.shape[:-1] + (system_dof + 1,), dtype)
    q[..., 0:3] = qpos[..., 0:3]
    q[..., 3:6] = qpos[..., 4:7]
    q[..., system_dof] = qpos[..., 3]
    q[..., 6:6 + model_dof] = qpos[..., 7:7 + model_dof]
    return q


class RlWBCBridge:
    """Single-environment bridge (the reference class's surface,
    rl_wbc_bridge.h:46-77)."""

    def __init__(self, env_id: int = 0, model_path: str | None = None,
                 urdf_path: str | None = None, dtype=torch.float32, device=None,
                 backend="cuda"):
        self.rd_ = _standard_robot(model_path, urdf_path, dtype, device, backend)
        self._task_init = True

    def UpdateKinematics(self, qpos, qvel, qacc):
        q = mujoco_to_dwbc_q(qpos, self.rd_.system_dof_, self.rd_.model_dof_)
        self.rd_.UpdateKinematics(q, np.asarray(qvel, float), np.asarray(qacc, float))

    def SetContact(self, left: bool, right: bool):
        self.rd_.SetContact(left, right)
        self.rd_.CalcContactConstraint()
        self.rd_.CalcTaskSpace()

    def SetTaskSpace(self, heirarchy: int, f_star):
        self.rd_.SetTaskSpace(heirarchy, np.asarray(f_star, float))

    def CalcTorque(self):
        self.rd_.CalcGravCompensation()
        self.rd_.CalcTaskControlTorque(True, self._task_init, update_task_space=False)
        self.rd_.CalcContactRedistribute(True, self._task_init)
        self._task_init = False

    def getTorqueCommand(self):
        return list(np.asarray(self.rd_.torque_command(), dtype=np.float32))

    def Reset(self):
        self._task_init = True

    def reflectAction(self, action):  # parity stub (the reference's is commented out)
        pass


class BatchedRlWBCBridge:
    """Vectorized bridge: one CompiledTick over N environments.

    qpos (N, nq_mujoco), qvel and qacc (N, ndof), f* per level (N, t).
    ``solve`` casts its inputs to the tick's dtype (float32 by default,
    float64 on the CPU for a reference)."""

    def __init__(self, n_envs: int, model_path: str | None = None, qp_iters: int = 12,
                 dtype=None, device=None, backend="cuda"):
        from .model.compile import RobotModel
        from .wbc.pipeline import CompiledTick, standard_tocabi_config

        self.model = RobotModel.load(model_path or _DEFAULT_MODEL)
        cfg = standard_tocabi_config(self.model, qp_iters=qp_iters)
        self.tick = CompiledTick(self.model, cfg, "cuda" if device is None else device,
                                 dtype=dtype or torch.float32, backend=backend)
        self.n_envs = n_envs

    def solve(self, qpos, qvel, qacc, fstar0, fstar1):
        m = self.model
        dt = np.float64 if self.tick.dtype == torch.float64 else np.float32
        qs = mujoco_to_dwbc_q(qpos, m.ndof, m.model_dof, dt)
        res = self.tick._tick_impl(qs, np.asarray(qvel, dt),
                                   (np.asarray(fstar0, dt), np.asarray(fstar1, dt)))
        return res.torque_cmd.cpu().numpy()
