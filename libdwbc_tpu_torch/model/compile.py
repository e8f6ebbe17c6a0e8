"""Compiled robot model: the static arrays of a kinematic tree, read from npz.

Numpy only.  Field for field the same record as
``libdwbc_tpu/model/compile.py::RobotModel``, whose compiler writes the
``.npz`` artifacts under ``models/``; this package only loads them.  Body 0
is the (floating) base; ``nq = ndof + 1`` when floating, with the base
quaternion's w stored at ``q[ndof]`` (RBDL layout).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static description of a floating- or fixed-base kinematic tree."""

    name: str
    floating: bool
    nbody: int                 # number of moving bodies (incl. base)
    ndof: int                  # system dof (generalized velocities)
    nq: int                    # size of q vector
    model_dof: int             # actuated joints = ndof - 6 (floating) | ndof

    body_names: tuple[str, ...]        # (nbody,)
    joint_names: tuple[str, ...]       # (nbody,) joint above each body ('' for base)
    parent: np.ndarray                 # (nbody,) int32, parent body, -1 for base
    q_index: np.ndarray                # (nbody,) int32, qdot index of body's joint dof
    X_T_rot: np.ndarray                # (nbody,3,3) joint frame rotation in parent frame
    X_T_trans: np.ndarray              # (nbody,3) joint frame origin in parent frame
    axis: np.ndarray                   # (nbody,3) revolute axis in child frame

    mass: np.ndarray                   # (nbody,) lumped body mass
    com: np.ndarray                    # (nbody,3) lumped COM in body frame
    inertia: np.ndarray                # (nbody,3,3) lumped inertia about COM, body frame

    ancestor_mask: np.ndarray          # (nbody, ndof) float, 1 where dof moves body
    joint_limit_lower: np.ndarray      # (model_dof,)
    joint_limit_upper: np.ndarray      # (model_dof,)
    effort_limit: np.ndarray           # (model_dof,)
    velocity_limit: np.ndarray         # (model_dof,)
    damping: np.ndarray                # (model_dof,)

    # frames merged away by fixed-joint lumping: name -> (body index, R, p)
    fixed_frames: dict[str, tuple[int, np.ndarray, np.ndarray]]

    total_mass: float
    gravity: np.ndarray                # (3,)

    @staticmethod
    def load(path: str) -> "RobotModel":
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrays.pop("meta")).decode())
        from ..convert import model_from_numpy

        return model_from_numpy(arrays, meta)
