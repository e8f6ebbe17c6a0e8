"""Rotation and quaternion primitives in torch, batch-major (counterpart of
``libdwbc_tpu/kin/rotations.py``).  Quaternions are (x, y, z, w).  The
1e-30 floors, the small-angle branches and the branch order of
``matrix_to_quat`` are the JAX module's: they decide parity."""

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


def matrix_to_quat(R):
    """Rotation matrix (body→world) → quaternion with w ≥ 0: the four
    candidate constructions (trace, then x-, y-, z-major), picked per
    element in that order."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, 1e-30)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)
    use0 = (tr > 0.0)[..., None]
    usex = ((m00 >= m11) & (m00 >= m22))[..., None]
    usey = (m11 >= m22)[..., None]
    q = torch.where(use0, q0, torch.where(usex, q1, torch.where(usey, q2, q3)))
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_mul(a, b):
    """Hamilton product a ⊗ b."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_slerp(q0, q1, t):
    """Spherical interpolation from q0 (t = 0) to q1 (t = 1) along the
    shorter arc; linear weights where sin θ < 1e-8."""
    d = (q0 * q1).sum(-1)
    q1 = torch.where(d[..., None] < 0, -q1, q1)
    d = torch.clamp(d.abs(), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-8
    denom = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / denom)
    w1 = torch.where(small, t, torch.sin(t * theta) / denom)
    out = w0[..., None] * q0 + w1[..., None] * q1
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def rotation_log(R):
    """Matrix log of a rotation as angle·axis (…, 3); scale ½ where
    |sin θ| < 1e-8."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    small = sin_t.abs() < 1e-8
    scale = torch.where(small, 0.5, theta / (2.0 * torch.where(small, 1.0, sin_t)))
    return v * scale[..., None]


def get_phi(R_current, R_desired):
    """Orientation error ½ Σ_i col_i(R_current) × col_i(R_desired)
    (DWBC::GetPhi)."""
    s = torch.linalg.cross(R_current[..., :, 0], R_desired[..., :, 0], dim=-1)
    s = s + torch.linalg.cross(R_current[..., :, 1], R_desired[..., :, 1], dim=-1)
    s = s + torch.linalg.cross(R_current[..., :, 2], R_desired[..., :, 2], dim=-1)
    return 0.5 * s
