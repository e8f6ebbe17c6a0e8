"""The reference's vocabulary of contacts and tasks (the reference's public
constants, include/dwbc_contact_constraint.h:19-25, include/dwbc_task.h:23-33),
and the plain description of one controller configuration."""

from __future__ import annotations

import dataclasses

import numpy as np

CONTACT_6D = 0
CONTACT_POINT = 1
CONTACT_LINE = 2
CONTACT_DOF = {CONTACT_6D: 6, CONTACT_POINT: 3, CONTACT_LINE: 5}
CONTACT_TYPES = {"6D": CONTACT_6D, "POINT": CONTACT_POINT, "LINE": CONTACT_LINE}

TASK_LINK_6D = 0
TASK_LINK_6D_COM_FRAME = 1
TASK_LINK_6D_CUSTOM_FRAME = 2
TASK_LINK_POSITION = 3
TASK_LINK_POSITION_COM_FRAME = 4
TASK_LINK_POSITION_CUSTOM_FRAME = 5
TASK_LINK_ROTATION = 6
TASK_LINK_ROTATION_CUSTOM_FRAME = 7
TASK_MODES = {"6D": TASK_LINK_6D, "POSITION": TASK_LINK_POSITION,
              "ROTATION": TASK_LINK_ROTATION}


@dataclasses.dataclass(frozen=True)
class Contact:
    link: int
    contact_type: int
    contact_point: np.ndarray
    plane_x: float
    plane_y: float
    friction_ratio: float = 0.2
    friction_ratio_z: float = 0.2

    @property
    def contact_dof(self) -> int:
        return CONTACT_DOF[self.contact_type]


@dataclasses.dataclass(frozen=True)
class Config:
    """What the reference tick reads of a configuration."""

    contacts: tuple
    task_specs: tuple
    torque_limit: np.ndarray | None


def config_from_file(spec: dict, model_dof: int) -> Config:
    """The reference's configuration from a benchmark configuration file's
    ``contacts``, ``tasks`` and ``torque_limit``."""
    contacts = tuple(Contact(link=c["link"], contact_type=CONTACT_TYPES[c["type"]],
                             contact_point=np.asarray(c["point"], np.float64),
                             plane_x=c["plane"][0], plane_y=c["plane"][1],
                             friction_ratio=c["friction"][0], friction_ratio_z=c["friction"][1])
                     for c in spec["contacts"])
    tasks = tuple(tuple((TASK_MODES[mode], link) for mode, link in level)
                  for level in spec["tasks"])
    lim = spec["torque_limit"]
    return Config(contacts, tasks, None if lim is None else np.full(model_dof, float(lim)))
