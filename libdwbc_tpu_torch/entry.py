"""Serving entry points of the port: the flagship tick (fused or compiled)
and its example inputs (counterparts of ``__graft_entry__._model_and_tick`` and
``_example_inputs``).

The flagship is the 33-DoF Tocabi (``models/tocabi.npz``) standing in
double support with 6D feet on links 6 and 12, a 6D pelvis task over a
rotation task on link 15, torques limited to ±300 Nm.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .model.compile import RobotModel
from .wbc.fused import FusedTick
from .wbc.pipeline import CompiledTick, standard_tocabi_config

MODEL_PATH = Path(__file__).resolve().parent.parent / "models" / "tocabi.npz"


def _model_and_tick(device=None, dtype=torch.float32, qp_iters=12, backend="cuda",
                    fused=True):
    """(model, tick) for the flagship configuration: ``FusedTick`` when
    ``fused``, else ``CompiledTick`` (as the JAX entry returns off the TPU).
    ``device`` defaults to the card; pass "cpu" (with backend="torch") for
    the plain version on the CPU."""
    model = RobotModel.load(str(MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=qp_iters)
    cls = FusedTick if fused else CompiledTick
    return model, cls(model, cfg, device="cuda" if device is None else device,
                      dtype=dtype, backend=backend)


def _example_inputs(model, dtype=np.float32):
    """A standing q, zero q̇ and one f* per task level (numpy)."""
    q = np.zeros(model.nq, dtype=dtype)
    q[2] = 0.92983
    q[model.nq - 1] = 1.0
    joints = np.array(
        [0, 0, -0.24, 0.6, -0.36, 0] * 2
        + [0, 0, 0]
        + [0.3, 0.3, 1.5, -1.27, -1, 0, -1, 0]
        + [0, 0]
        + [-0.3, -0.3, -1.5, 1.27, 1, 0, 1, 0],
        dtype=dtype,
    )
    q[6 : 6 + 33] = joints
    qdot = np.zeros(model.ndof, dtype=dtype)
    fstars = (
        np.array([0.1, 0.5, 0.1, 0.1, -0.1, 0.1], dtype=dtype),
        np.array([0.1, -0.1, 0.1], dtype=dtype),
    )
    return q, qdot, fstars
