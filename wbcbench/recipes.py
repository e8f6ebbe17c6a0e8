"""The traffic recipes: how a mix's data file becomes the states and task
accelerations handed to the controller.  Frozen copies of the port's example
inputs (``entry._example_inputs``, ``_masked_inputs``, ``_hands_feet_inputs``,
``_rt_state``, ``_grid_inputs``), parameterised by the mix's file and drawn
on the device from the run's seed.

Every seed gives the same sizes and the same kind of draw; only the values
differ.
"""

from __future__ import annotations

import numpy as np
import torch


def standing(traffic: dict, nq: int, ndof: int) -> tuple[np.ndarray, tuple]:
    """The mix's standing q (float64: the pelvis at its height, the base
    quaternion's w = 1, the joints of ``pose``) and its f* per level."""
    q = np.zeros(nq)
    q[2] = traffic["pelvis_height"]
    q[ndof] = 1.0
    pose = np.asarray(traffic["pose"], np.float64)
    q[6:6 + pose.shape[0]] = pose
    return q, tuple(np.asarray(f, np.float64) for f in traffic["fstar"])


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def draw_batch(traffic: dict, q0: np.ndarray, fs0: tuple, lead: tuple, gen, device):
    """One new draw of a batch (float32 on ``device``): the standing q with
    ``joint_noise``·N(0,1) on every joint, zero q̇, and f* with
    ``fstar_noise``·N(0,1) on every row (bench.py:76-86,
    ``entry._masked_inputs``)."""
    md = q0.shape[0] - 7
    q = torch.as_tensor(q0, dtype=torch.float32, device=device).expand(lead + q0.shape).clone()
    q[..., 6:6 + md] += traffic["joint_noise"] * torch.randn(
        lead + (md,), generator=gen, device=device)
    qd = torch.zeros(lead + (q0.shape[0] - 1,), device=device)
    fs = []
    for f in fs0:
        ft = torch.as_tensor(f, dtype=torch.float32, device=device).expand(lead + f.shape)
        if traffic["fstar_noise"]:
            ft = ft + traffic["fstar_noise"] * torch.randn(lead + f.shape, generator=gen,
                                                           device=device)
        fs.append(ft.contiguous())
    return q, qd, tuple(fs)


def hypothesis_masks(traffic: dict, rows: np.ndarray, cols: int, device) -> torch.Tensor:
    """(len(rows), cols, nc) contact masks: grid row h takes hypothesis
    h mod len(hypotheses) (both feet, left, right)."""
    hyp = np.asarray(traffic["hypotheses"], np.float32)
    m = hyp[np.asarray(rows) % len(hyp)]
    return torch.as_tensor(np.repeat(m[:, None], cols, 1), device=device)


def rt_state(traffic: dict, nq: int, ndof: int, phase: int):
    """The single-lane stream (``entry._rt_state``): state vector of tick t
    [q, q̇, f* per level, t] in float64, each joint at 0.02·sin(ωt + j), one
    period every ``period_ticks``, f* moved by 0.05·cos(ωt + level); the
    stream starts at tick ``phase``."""
    q0, fs0 = standing(traffic, nq, ndof)
    md = ndof - 6
    j = np.arange(md)
    w = 2.0 * np.pi / traffic["period_ticks"]
    amp, famp, dt = traffic["joint_amp"], traffic["fstar_amp"], traffic["dt"]

    def state_at(t):
        t = t + phase
        q = q0.copy()
        q[6:6 + md] += amp * np.sin(w * t + j)
        qd = np.zeros(ndof)
        qd[6:6 + md] = amp * w / dt * np.cos(w * t + j)
        return np.concatenate([q, qd] + [f + famp * np.cos(w * t + i)
                                         for i, f in enumerate(fs0)] + [[float(t)]])

    return state_at


def nudge(q: torch.Tensor, tau: torch.Tensor, gain: float) -> torch.Tensor:
    """The rollouts' data-dependent transition (bench.py:104-112): every
    joint moved by gain·tanh(τ_cmd), so that each tick depends on the one
    before it."""
    md = tau.shape[-1]
    out = q.clone()
    out[..., 6:6 + md] += gain * torch.tanh(tau)
    return out
