"""Host-side (numpy) rotation helpers for the model compiler (counterpart
of ``libdwbc_tpu/model/rotations_np.py``)."""

from __future__ import annotations

import numpy as np


def rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF roll-pitch-yaw (extrinsic x-y-z) to rotation matrix.

    Returns R mapping child-frame coordinates to parent-frame coordinates:
    R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
    """
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def matrix_to_rpy(R: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rpy_to_matrix` (extrinsic x-y-z / intrinsic ZYX).

    Lets programmatic model construction accept rotation matrices (the
    reference's ``Joint::joint_rotation_``) while the compiler's joint
    records carry URDF rpy.  At the pitch singularity (|R[2,0]| = 1) the
    roll/yaw split is chosen with yaw = 0."""
    p = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    if abs(R[2, 0]) < 1.0 - 1e-12:
        r = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock: cos(p)=0
        r = np.arctan2(-R[1, 2], R[1, 1])
        y = 0.0
    return np.array([r, p, y], dtype=np.float64)


def skew_np(v: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]]
    )
