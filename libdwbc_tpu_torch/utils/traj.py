"""Trajectory generation in torch (counterpart of the part of
``libdwbc_tpu/utils/traj.py`` that the on-device servo needs:
``quintic_spline``).  Broadcasts over leading batch dims, so each scenario
of a batch can run its own clock."""

from __future__ import annotations

import torch


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
