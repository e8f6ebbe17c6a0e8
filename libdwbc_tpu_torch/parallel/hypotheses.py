"""Contact-mode hypothesis sweep (counterpart of
``libdwbc_tpu/parallel/hypotheses.py``).

The reference switches contact modes by resizing its matrices at run time
(``SetContact`` booleans → a new J_C shape, include/dwbc.h:432-474): one
mode per process.  Here one ``CompiledTick`` is built per contact mode up
front, and each scenario of a batch names its mode: each mode's tick runs
on the lanes that chose it (a gather, the tick, a scatter), which takes
the place of the JAX sweep's vmapped ``lax.switch``.  Contact forces are
padded to the widest mode.  On the card each mode's
``CompiledTick(backend="cuda")`` runs its SPD inverses on ``psd_inverse``
and its QPs on ``qp_solve``.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch

from ..wbc import types as T
from ..wbc.pipeline import CompiledTick, PipelineConfig


def contact_mode_ticks(model, contacts: Sequence[T.ContactDef], task_specs, torque_limit,
                       qp_iters: int = 12, dtype=torch.float32, min_active: int = 1,
                       device=None, backend="cuda"):
    """(modes, ticks): one CompiledTick per subset of ``contacts`` with at
    least ``min_active`` of them, the subsets in the JAX package's order
    (all contacts first)."""
    device = "cuda" if device is None else device
    modes, ticks = [], []
    for bits in itertools.product([True, False], repeat=len(contacts)):
        if sum(bits) < min_active:
            continue
        cfg = PipelineConfig(contacts=tuple(c for c, b in zip(contacts, bits) if b),
                             task_specs=tuple(tuple(s) for s in task_specs),
                             torque_limit=torque_limit, qp_iters=qp_iters)
        modes.append(bits)
        ticks.append(CompiledTick(model, cfg, device, dtype=dtype, backend=backend))
    return modes, ticks


def make_hypothesis_tick(model, modes, ticks):
    """(mode_idx, q, q̇, f*) → (τ_cmd, τ_grav, τ_task, τ_contact, contact
    force padded to the widest mode, gap, primal residual), batched over
    the leading dim of every input: each mode's tick on the lanes whose
    mode_idx names it."""
    mdof = model.model_dof
    max_c = max(sum(c.contact_dof for c in t.cfg.contacts) for t in ticks)

    def tick_fn(mode_idx, q, qdot, fstars):
        tk = ticks[0]
        kw = dict(dtype=tk.dtype, device=tk.device)
        q = torch.as_tensor(q, **kw)
        qdot = torch.as_tensor(qdot, **kw)
        fstars = tuple(torch.as_tensor(f, **kw) for f in fstars)
        mode_idx = torch.as_tensor(mode_idx, device=tk.device)
        batch = q.shape[:-1]
        outs = [torch.zeros(batch + (w,), **kw) for w in (mdof, mdof, mdof, mdof, max_c)]
        outs += [torch.zeros(batch, **kw) for _ in range(2)]
        for i, tick in enumerate(ticks):
            lanes = (mode_idx == i).nonzero(as_tuple=True)
            if lanes[0].numel() == 0:
                continue
            res = tick._tick_impl(q[lanes], qdot[lanes], tuple(f[lanes] for f in fstars))
            for out, v in zip(outs, (res.torque_cmd, res.torque_grav, res.torque_task,
                                     res.torque_contact, res.contact_force, res.qp_gap,
                                     res.qp_primal_res)):
                out[lanes + (slice(0, v.shape[-1]),) if v.ndim > 1 else lanes] = v
        return tuple(outs)

    return tick_fn


def hypothesis_sweep(model, modes, ticks, mode_idx, q, qdot, fstars,
                     cost_weights=(1.0, 1e6)):
    """The batched sweep: a contact-mode index, a state and task targets
    per scenario.  mode_idx (B,), q (B, nq), q̇ (B, n), f* per level
    (B, t).  Returns (τ_cmd (B, m), cost (B,), the best scenario's index):
    the cost is command effort plus an infeasibility penalty, the
    hypothesis-selection metric."""
    tau, _, _, _, _, _, pres = make_hypothesis_tick(model, modes, ticks)(mode_idx, q, qdot,
                                                                         fstars)
    w_eff, w_pen = cost_weights
    cost = w_eff * (tau ** 2).sum(-1) + w_pen * pres
    return tau, cost, torch.argmin(cost)
