"""Serving entry points of the port: the flagship tick (fused or compiled,
static or masked) and its example inputs (counterparts of
``__graft_entry__._model_and_tick`` and ``_example_inputs``).

The flagship is the 33-DoF Tocabi (``models/tocabi.npz``) standing in
double support with 6D feet on links 6 and 12, a 6D pelvis task over a
rotation task on link 15, torques limited to ±300 Nm.  Its masked form
takes the two feet as a candidate set and one support hypothesis per
scenario (``_masked_inputs``: the 4096-scenario sweep of
``benchmarks/masked_bench.py``).
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
                    fused=True, masked=False):
    """(model, tick) for the flagship configuration: ``FusedTick`` when
    ``fused``, else ``CompiledTick`` (as the JAX entry returns off the TPU);
    ``masked`` gives ``FusedTick(masked=True)``, whose calls take a contact
    mask over the two feet.  ``device`` defaults to the card; pass "cpu"
    (with backend="torch") for the plain version on the CPU."""
    model = RobotModel.load(str(MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=qp_iters)
    device = "cuda" if device is None else device
    if masked:
        return model, FusedTick(model, cfg, device, dtype=dtype, backend=backend,
                                masked=True)
    cls = FusedTick if fused else CompiledTick
    return model, cls(model, cfg, device=device, dtype=dtype, backend=backend)


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


def _masked_inputs(model, B=4096, seed=0):
    """The masked sweep's inputs (numpy float32): B standing states with legs
    [0, 0, −0.24, 0.6, −0.36, 0]×2, zero arms and 0.02·N(0,1) on the
    joints, zero q̇, f* = ([0.1, 0.3, 0.1, 0, 0, 0], [0.05, 0, 0]) on every
    lane, and the support hypotheses both feet, left, right cycled over the
    lanes (``benchmarks/masked_bench.py:64-81``)."""
    rng = np.random.default_rng(seed)
    q = np.zeros(model.nq, np.float32)
    q[2] = 0.92983
    q[model.ndof] = 1.0
    q[6:18] = np.array([0, 0, -0.24, 0.6, -0.36, 0] * 2, np.float32)
    qs = np.tile(q, (B, 1))
    qs[:, 6:6 + model.model_dof] += 0.02 * rng.standard_normal(
        (B, model.model_dof)).astype(np.float32)
    qds = np.zeros((B, model.ndof), np.float32)
    fstars = (np.tile(np.array([0.1, 0.3, 0.1, 0, 0, 0], np.float32), (B, 1)),
              np.tile(np.array([0.05, 0, 0], np.float32), (B, 1)))
    masks = np.array([[1, 1], [1, 0], [0, 1]], np.float32)[np.arange(B) % 3]
    return qs, qds, fstars, masks
