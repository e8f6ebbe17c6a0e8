"""Rotation primitives in torch, batch-major (counterpart of the part of
``libdwbc_tpu/kin/rotations.py`` that the kinematics needs: ``skew``,
``quat_to_matrix``, ``axis_angle_matrix``)."""

from __future__ import annotations

import torch


def skew(v):
    """Skew-symmetric matrix of v (…,3) → (…,3,3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def quat_to_matrix(q_xyzw):
    """Quaternion (x,y,z,w) to rotation matrix (body→world), unnormalized-safe."""
    x, y, z, w = q_xyzw[..., 0], q_xyzw[..., 1], q_xyzw[..., 2], q_xyzw[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.where(n > 0, n, torch.ones_like(n)),
                    torch.zeros_like(n))
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def axis_angle_matrix(axis, angle):
    """Rodrigues rotation about ``axis`` (…,3, unit) by ``angle`` (…)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    aaT = axis[..., :, None] * axis[..., None, :]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return c * eye + s * K + (1.0 - c) * aaT
