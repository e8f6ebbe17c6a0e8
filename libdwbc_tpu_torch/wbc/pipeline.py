"""Tick configuration and result records (counterpart of
``libdwbc_tpu/wbc/pipeline.py``: ``TickResult``, ``qp_error_flag``,
``PipelineConfig``, ``standard_tocabi_config``)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import types as T


class TickResult(NamedTuple):
    torque_grav: torch.Tensor
    torque_task: torch.Tensor
    torque_contact: torch.Tensor
    torque_cmd: torch.Tensor
    contact_force: torch.Tensor       # observed contact wrench under torque_cmd
    qp_gap: torch.Tensor              # worst normalized complementarity across QPs
    qp_primal_res: torch.Tensor       # worst primal violation across QPs
    contact_rank_health: torch.Tensor  # contact-space rank indicator (tiny = degenerate)
    qp_error: torch.Tensor            # per-lane solver-failure flag (bool): a real
    # primal violation, a real complementarity gap, or a non-finite torque in
    # any QP of the tick; serving loops hold or zero flagged lanes


def qp_error_flag(gap, pres, torque_cmd, cfg):
    """Per-lane failure flag from the tick diagnostics.  The thresholds sit
    orders of magnitude above any healthy solve and far below garbage;
    non-finite torque is always a failure."""
    finite = torch.isfinite(torque_cmd).all(dim=-1)
    return (~finite) | (gap > cfg.qp_fail_gap) | (pres > cfg.qp_fail_pres)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    contacts: tuple[T.ContactDef, ...]       # active contacts only
    task_specs: tuple[tuple[tuple, ...], ...]  # per level: ((mode, link[, point]), ...)
    torque_limit: np.ndarray | None
    qp_iters: int = 25
    use_hqp: bool = True
    # per-lane qp_error thresholds (see TickResult.qp_error / qp_error_flag)
    qp_fail_gap: float = 1e-3
    qp_fail_pres: float = 1e-3


def standard_tocabi_config(
    model,
    both_feet: bool = True,
    torque_limit: float = 300.0,
    qp_iters: int = 25,
    swing_task: bool = False,
) -> PipelineConfig:
    """The reference test configuration: double-support stand, pelvis 6D +
    upper-body rotation tasks; optional swing-foot task (single support,
    3-level hierarchy)."""
    foot = dict(
        contact_type=T.CONTACT_6D,
        contact_point=np.array([0.03, 0.0, -0.1585]),
        contact_direction=np.array([0.0, 0.0, 1.0]),
        plane_x=0.15,
        plane_y=0.075,
        active=True,
    )
    contacts = [T.ContactDef(link=6, **foot)]
    if both_feet:
        contacts.append(T.ContactDef(link=12, **foot))
    task_specs = [((T.TASK_LINK_6D, 0),), ((T.TASK_LINK_ROTATION, 15),)]
    if swing_task:
        task_specs.append(((T.TASK_LINK_6D, 12),))  # swing right foot
    return PipelineConfig(
        contacts=tuple(contacts),
        task_specs=tuple(tuple(s) for s in task_specs),
        torque_limit=np.full(model.model_dof, torque_limit),
        qp_iters=qp_iters,
    )
