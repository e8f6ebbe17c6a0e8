"""The benchmark's plain reference: the tick of a configuration in plain
PyTorch (``tick.py``, a frozen copy of the port's element-leading tick),
built from the configuration file and the model's npz alone.

It imports nothing of the port and takes nothing the port made: the
benchmark hands it the same inputs it handed the port, and reads the
port's outputs only to judge them (``wbcbench/check.py``).

``RefTick`` serves the tick's batch-major contract (``init_warm``,
``_tick_impl``), so that the control run can put it in the port's place.
"""

from __future__ import annotations

import collections
from pathlib import Path

import numpy as np
import torch

from .model import load_model
from .tick import TickProgram
from .types import config_from_file

ROOT = Path(__file__).resolve().parents[2]

# the fields of a tick's result, in the port's order
Result = collections.namedtuple("Result", (
    "torque_grav", "torque_task", "torque_contact", "torque_cmd", "contact_force",
    "qp_gap", "qp_primal_res", "contact_rank_health", "qp_error"))

# qp_error's bars (the reference's qpOASES failure policy as the tick states it)
FAIL_GAP = FAIL_PRES = 1e-3


def plan_of(config: dict):
    """The reference's static plan of a configuration (its shapes)."""
    from .tick import TickPlan

    model = load_model(ROOT / config["model"])
    return TickPlan(model, config_from_file(config, model.model_dof),
                    masked=bool(config["masked"]))


class _Cfg:
    def __init__(self, task_specs, qp_iters):
        self.task_specs, self.qp_iters = task_specs, qp_iters


class RefTick:
    """The reference tick of one configuration file, in ``dtype`` on
    ``device``."""

    def __init__(self, config: dict, device, dtype=torch.float64):
        self.model = load_model(ROOT / config["model"])
        rcfg = config_from_file(config, self.model.model_dof)
        self.masked = bool(config["masked"])
        self.prog = TickProgram(self.model, rcfg, torch.device(device), dtype,
                                masked=self.masked)
        self.plan = self.prog.plan
        self.cfg = _Cfg(rcfg.task_specs, config["cold_iters"])
        self.dtype = dtype
        self.device = torch.device(device)

    def init_warm(self, batch=()):
        batch = tuple(batch)
        return tuple((torch.zeros(batch + (n,), dtype=self.dtype, device=self.device),
                      torch.ones(batch + (m,), dtype=self.dtype, device=self.device))
                     for n, m in self.plan.qp_dims)

    def tick_el(self, q, fstars, cmask, warm, iters):
        """Batch-major (B, ...) inputs → the plain tick's dict, batch-major,
        with its prestage under "pre"."""
        def el(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device).T.contiguous()

        pre = self.prog.prestage(el(q), None if cmask is None else el(cmask))
        w = None if warm is None else [(el(x), el(lam)) for x, lam in warm]
        out = self.prog.qpchain(pre, [el(f) for f in fstars], warm=w, iters=iters)
        res = {k: v.movedim(-1, 0) for k, v in out.items() if k != "warm_out"}
        res["warm_out"] = tuple((x.movedim(-1, 0), lam.movedim(-1, 0))
                                for x, lam in out["warm_out"])
        res["pre"] = pre
        return res

    def _tick_impl(self, q, qdot, fstars, contact_mask=None, warm=None, qp_iters=None,
                   servos=None):
        """The port's tick contract: (B, ...) or unbatched inputs →
        ``Result`` (and the warm state out when ``warm`` was given)."""
        if servos is not None:
            raise ValueError("the reference tick serves no servos")
        if (contact_mask is not None) != self.masked:
            raise ValueError("a contact mask goes with a masked configuration, and only there")

        def as_t(x):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                   dtype=self.dtype, device=self.device)

        q = as_t(q)
        batched = q.ndim == 2
        one = (lambda x: x) if batched else (lambda x: x[None])
        fstars = [one(as_t(f)) for f in fstars]
        cmask = None
        if contact_mask is not None:
            cmask = as_t(contact_mask)
            cmask = cmask.expand(q.shape[0] if batched else 1, -1) if cmask.ndim == 1 else cmask
        w = None if warm is None else [(one(as_t(x)), one(as_t(lam))) for x, lam in warm]
        out = self.tick_el(one(q), fstars, cmask, w, self.cfg.qp_iters if qp_iters is None
                           else qp_iters)
        tau = out["torque_cmd"]
        err = (~torch.isfinite(tau).all(-1)) | (out["qp_gap"] > FAIL_GAP) | (
            out["qp_primal_res"] > FAIL_PRES)
        res = Result(out["torque_grav"], out["torque_task"], out["torque_contact"], tau,
                     out["contact_force"], out["qp_gap"], out["qp_primal_res"],
                     out["health"], err)
        wout = out["warm_out"]
        if not batched:
            res = Result(*(r[0] for r in res))
            wout = tuple((x[0], lam[0]) for x, lam in wout)
        return (res, wout) if warm is not None else res
