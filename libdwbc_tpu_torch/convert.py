"""Carrying a model and a tick configuration into the port.

* ``model_from_numpy`` builds the port's ``RobotModel`` from the arrays and
  metadata of a compiled ``.npz`` model;
* ``from_jax_model`` and ``config_from_jax`` copy the numpy fields of the JAX
  package's ``RobotModel`` and ``PipelineConfig`` objects (duck-typed: this
  module imports no JAX);
* ``tick_tables`` builds the plain tick's constant buffers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model.compile import RobotModel
from .wbc import types as T
from .wbc.pipeline import PipelineConfig


def model_from_numpy(arrays: dict, meta: dict) -> RobotModel:
    """RobotModel from an npz's arrays and its decoded JSON metadata."""
    z = arrays
    nbody = len(meta["body_names"])
    base_dof = 6 if meta["floating"] else 0
    ndof = base_dof + nbody - 1
    return RobotModel(
        name=meta["name"],
        floating=meta["floating"],
        nbody=nbody,
        ndof=ndof,
        nq=ndof + 1 if meta["floating"] else ndof,
        model_dof=ndof - base_dof,
        body_names=tuple(meta["body_names"]),
        joint_names=tuple(meta["joint_names"]),
        parent=z["parent"],
        q_index=z["q_index"],
        X_T_rot=z["X_T_rot"],
        X_T_trans=z["X_T_trans"],
        axis=z["axis"],
        mass=z["mass"],
        com=z["com"],
        inertia=z["inertia"],
        ancestor_mask=z["ancestor_mask"],
        joint_limit_lower=z["joint_limit_lower"],
        joint_limit_upper=z["joint_limit_upper"],
        effort_limit=z["effort_limit"],
        velocity_limit=z["velocity_limit"],
        damping=z["damping"],
        fixed_frames={
            k: (int(v[0]), np.array(v[1]), np.array(v[2]))
            for k, v in meta["fixed_frames"].items()
        },
        total_mass=float(np.sum(z["mass"])),
        gravity=z["gravity"],
    )


def from_jax_model(m) -> RobotModel:
    """The port's RobotModel from the JAX package's, field for field."""
    vals = {}
    for f in dataclasses.fields(RobotModel):
        v = getattr(m, f.name)
        if isinstance(v, np.ndarray):
            v = np.array(v)
        elif f.name == "fixed_frames":
            v = {k: (int(b), np.array(R), np.array(p)) for k, (b, R, p) in v.items()}
        vals[f.name] = v
    return RobotModel(**vals)


def config_from_jax(cfg) -> PipelineConfig:
    """The port's PipelineConfig from the JAX package's."""
    contacts = tuple(
        T.ContactDef(**{f.name: getattr(c, f.name)
                        for f in dataclasses.fields(T.ContactDef)})
        for c in cfg.contacts
    )
    return PipelineConfig(
        contacts=contacts,
        task_specs=tuple(tuple(tuple(s) for s in lv) for lv in cfg.task_specs),
        torque_limit=(None if cfg.torque_limit is None
                      else np.array(cfg.torque_limit, np.float64)),
        qp_iters=int(cfg.qp_iters),
        use_hqp=bool(cfg.use_hqp),
        qp_fail_gap=float(cfg.qp_fail_gap),
        qp_fail_pres=float(cfg.qp_fail_pres),
    )


def _skew(a):
    return np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                     [-a[1], a[0], 0.0]])


def tick_tables(model, cfg, device, dtype) -> dict:
    """Constant tensors of the plain tick of one configuration, in
    ``dtype`` on ``device``."""
    from .ops.tick_kernel import TickPlan

    plan = TickPlan(model, cfg)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    axis = np.asarray(model.axis, np.float64)
    out = dict(
        axis=t(axis),
        axis_skew=t(np.stack([_skew(a) for a in axis])),
        axis_outer=t(np.einsum("bi,bj->bij", axis, axis)),
        X_rot=t(model.X_T_rot),
        X_trans=t(model.X_T_trans),
        com=t(model.com),
        inertia=t(model.inertia),
        mass=t(model.mass),
        amask=t(model.ancestor_mask),
        anc_pairs=torch.as_tensor(plan.anc_pairs, device=device),
        pt_off=t(np.array([pt for _, pt in plan.points], np.float64).reshape(-1, 3)),
    )
    if plan.tlim is not None:
        out["tlim"] = t(plan.tlim)
    return out
