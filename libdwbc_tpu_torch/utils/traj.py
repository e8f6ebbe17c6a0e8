"""Trajectory generation and the operational-space PD servo in torch
(counterpart of ``libdwbc_tpu/utils/traj.py``): ``quintic_spline``
(src/math.cpp:127-186), ``cubic`` (187-224), ``rotation_cubic`` (226-274),
the TaskLink PD servos ``fstar_pos_pd`` / ``fstar_rot_pd`` (``GetFstarPosPD``
/ ``GetFstarRotPD``, src/task.cpp:268-339) and ``second_order_lpf``.  All
broadcast over leading batch dims, so each scenario of a batch can run its
own clock.  The on-device servo of the tick (``wbc/pipeline.py::
servo_fstar``) builds on ``quintic_spline``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kin.rotations import get_phi, matrix_to_quat, quat_slerp, quat_to_matrix, rotation_log


def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _clock(t, t0, tf, like):
    """(t, t0, tf) as tensors of ``like``'s dtype and device."""
    return _t(t, like), _t(t0, like), _t(tf, like)


def quintic_spline(t, t0, tf, x0, v0, a0, xf, vf, af):
    """Quintic interpolation from (x0, v0, a0) at t0 to (xf, vf, af) at tf;
    returns (pos, vel, acc), each shaped like broadcast(t, x0), held at the
    end values outside [t0, tf]."""
    ts = tf - t0
    ts2, ts3, ts4, ts5 = ts**2, ts**3, ts**4, ts**5
    a1, a2, a3 = x0, v0, a0 / 2.0
    # the 3×3 system for a4..a6 in closed form
    b1 = xf - x0 - v0 * ts - a0 * ts2 / 2.0
    b2 = vf - v0 - a0 * ts
    b3 = af - a0
    a4 = (20.0 * b1 - 8.0 * b2 * ts + b3 * ts2) / (2.0 * ts3)
    a5 = (-30.0 * b1 + 14.0 * b2 * ts - 2.0 * b3 * ts2) / (2.0 * ts4)
    a6 = (12.0 * b1 - 6.0 * b2 * ts + b3 * ts2) / (2.0 * ts5)

    tc = torch.minimum(torch.maximum(t, t0), tf) - t0
    pos = a1 + a2 * tc + a3 * tc**2 + a4 * tc**3 + a5 * tc**4 + a6 * tc**5
    vel = a2 + 2 * a3 * tc + 3 * a4 * tc**2 + 4 * a5 * tc**3 + 5 * a6 * tc**4
    acc = 2 * a3 + 6 * a4 * tc + 12 * a5 * tc**2 + 20 * a6 * tc**3

    before = t < t0
    after = t > tf

    def held(v_in, v_end, v):
        return torch.where(before, v_in, torch.where(after, v_end, v))

    return held(x0, xf, pos), held(v0, vf, vel), held(a0, af, acc)


def cubic(t, t0, tf, x0, xf, v0, vf):
    """Cubic interpolation (position only), held at the end values outside
    [t0, tf] (src/math.cpp:187-224)."""
    ts = tf - t0
    t = torch.as_tensor(t)
    tc = torch.minimum(torch.maximum(t, _t(t0, t)), _t(tf, t)) - t0
    total_x = xf - x0
    c2 = 3.0 * total_x / ts**2 - 2.0 * v0 / ts - vf / ts
    c3 = -2.0 * total_x / ts**3 + (v0 + vf) / ts**2
    x = x0 + v0 * tc + c2 * tc**2 + c3 * tc**3
    return torch.where(t < t0, _t(x0, x), torch.where(t > tf, _t(xf, x), x))


def rotation_cubic(t, t0, tf, R0, Rf):
    """Rotation interpolation with cubic time scaling by quaternion slerp
    (``rotationCubic``, src/math.cpp:226-274)."""
    tau = cubic(t, t0, tf, 0.0, 1.0, 0.0, 0.0)
    return quat_to_matrix(quat_slerp(matrix_to_quat(R0), matrix_to_quat(Rf), tau))


class ServoGains(NamedTuple):
    pos_p: torch.Tensor
    pos_d: torch.Tensor
    pos_a: torch.Tensor
    rot_p: torch.Tensor
    rot_d: torch.Tensor
    rot_a: torch.Tensor


def fstar_pos_pd(t, t0, tf, pos_init, vel_init, pos_des, vel_des, current_pos, current_vel,
                 p_gain, d_gain, a_gain):
    """Operational-space position PD with acceleration feedforward on a
    quintic trajectory (``GetFstarPosPD``, src/task.cpp:268-294): (f*, the
    position error, the velocity error)."""
    t, t0, tf = _clock(t, t0, tf, pos_init)
    pos_traj, vel_traj, acc_traj = quintic_spline(
        t, t0, tf, pos_init, vel_init, torch.zeros_like(pos_init), pos_des, vel_des,
        torch.zeros_like(pos_des))
    p_err = pos_traj - current_pos
    d_err = vel_traj - current_vel
    return a_gain * acc_traj + p_gain * p_err + d_gain * d_err, p_err, d_err


def fstar_rot_pd(t, t0, tf, rot_init, w_init, rot_des, w_des, current_rot, current_w,
                 p_gain, d_gain):
    """Operational-space rotation PD on a slerp trajectory with quintic time
    scaling (``GetFstarRotPD``, src/task.cpp:296-339): (f*, the rotation
    error, the angular velocity error)."""
    t, t0, tf = _clock(t, t0, tf, rot_init)
    s, sd, _ = quintic_spline(t, t0, tf, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    rot_traj = quat_to_matrix(quat_slerp(matrix_to_quat(rot_init), matrix_to_quat(rot_des), s))
    aa = rotation_log(rot_des @ rot_init.transpose(-1, -2))
    w_traj = aa * sd[..., None] if sd.ndim < aa.ndim else aa * sd
    p_err = get_phi(current_rot, rot_traj)
    d_err = w_traj - current_w
    return p_gain * p_err + d_gain * d_err, p_err, d_err


def second_order_lpf(x_k, x_k1, x_k2, y_k1, y_k2, fc, d, hz):
    """One step of the second-order low-pass filter (src/math.cpp:330-347)."""
    omega = 2.0 * math.pi * fc / hz
    D = 4.0 + 4.0 * d * omega + omega * omega
    return ((8.0 - 2.0 * omega * omega) / D * y_k1
            - (4.0 - 4.0 * d * omega + omega * omega) / D * y_k2
            + omega * omega / D * (x_k + 2.0 * x_k1 + x_k2))
