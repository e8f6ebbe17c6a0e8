"""Shared enums/constants mirroring the reference's public vocabulary
(include/dwbc_contact_constraint.h:19-25, include/dwbc_task.h:23-33)."""

from __future__ import annotations

import dataclasses

import numpy as np

# contact types
CONTACT_6D = 0
CONTACT_POINT = 1
CONTACT_LINE = 2

CONTACT_DOF = {CONTACT_6D: 6, CONTACT_POINT: 3, CONTACT_LINE: 5}
CONTACT_CONSTRAINT_ZMP = 4
CONTACT_CONSTRAINT_FORCE = 6
# Live constraint rows per type.  The reference declares ZMP+FORCE = 10 for
# CONTACT_LINE (contact_constraint.cpp:24-28) but never implements line
# contacts (Update commented out, :63-69); a zero-width line has only 2 CoP
# rows (±my ≤ lx·fz), so the live count here is 8 (see
# dynamics.contact_constraint_block).
CONTACT_CONSTRAINTS = {
    CONTACT_6D: CONTACT_CONSTRAINT_ZMP + CONTACT_CONSTRAINT_FORCE,
    CONTACT_LINE: 2 + CONTACT_CONSTRAINT_FORCE,
    CONTACT_POINT: CONTACT_CONSTRAINT_FORCE,
}

# task link modes
TASK_LINK_6D = 0
TASK_LINK_6D_COM_FRAME = 1
TASK_LINK_6D_CUSTOM_FRAME = 2
TASK_LINK_POSITION = 3
TASK_LINK_POSITION_COM_FRAME = 4
TASK_LINK_POSITION_CUSTOM_FRAME = 5
TASK_LINK_ROTATION = 6
TASK_LINK_ROTATION_CUSTOM_FRAME = 7

TASK_DOF = {
    TASK_LINK_6D: 6,
    TASK_LINK_6D_COM_FRAME: 6,
    TASK_LINK_6D_CUSTOM_FRAME: 6,
    TASK_LINK_POSITION: 3,
    TASK_LINK_POSITION_COM_FRAME: 3,
    TASK_LINK_POSITION_CUSTOM_FRAME: 3,
    TASK_LINK_ROTATION: 3,
    TASK_LINK_ROTATION_CUSTOM_FRAME: 3,
}

TASK_CUSTOM = 0x4
TASK_UNDEFINED = -1


@dataclasses.dataclass
class ContactDef:
    """Static contact definition (the reference's ContactConstraint state,
    include/dwbc_contact_constraint.h:27-80)."""

    link: int
    contact_type: int
    contact_point: np.ndarray        # (3,) in link frame
    contact_direction: np.ndarray    # (3,)
    plane_x: float                   # half-length of contact patch (x)
    plane_y: float                   # half-width (y)
    friction_ratio: float = 0.2
    friction_ratio_z: float = 0.2
    active: bool = False

    @property
    def contact_dof(self) -> int:
        return CONTACT_DOF[self.contact_type]

    @property
    def constraint_number(self) -> int:
        return CONTACT_CONSTRAINTS[self.contact_type]


@dataclasses.dataclass
class TaskLinkDef:
    mode: int
    link: int
    task_point: np.ndarray

    @property
    def t_dof(self) -> int:
        return TASK_DOF[self.mode]


@dataclasses.dataclass
class TaskDef:
    """One hierarchy level: one or more task links, or a custom J/f*."""

    links: list[TaskLinkDef]
    custom_dof: int = 0   # >0 for fully custom J_task tasks

    @property
    def task_dof(self) -> int:
        if self.custom_dof:
            return self.custom_dof
        return sum(l.t_dof for l in self.links)
