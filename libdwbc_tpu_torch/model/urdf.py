"""URDF parsing into raw host-side structures.

The front end of the model compiler (counterpart of
``libdwbc_tpu/model/urdf.py``): it reads a URDF file into plain Python
records, numpy only; ``model/compile.py`` turns them into a RobotModel.

Parity notes (vs reference libdwbc, which delegates to RBDL-orb's URDF
reader, src/dwbc.cpp:115):

* urdfdom stores joints in a ``std::map`` keyed by joint *name*, so each
  link's child joints end up ordered **alphabetically by joint name**.  The
  RBDL reader then walks the tree depth-first (pre-order).  We replicate
  both so that generalized-coordinate indices match the reference bit for
  bit (this is what makes ``left_foot_id == 6`` in the reference tests).
* Fixed joints do not allocate DoFs; their subtree inertia is lumped into
  the nearest moving ancestor (see compile.py), mirroring RBDL's fixed-body
  merging.
"""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET

import numpy as np


@dataclasses.dataclass
class UrdfInertial:
    mass: float
    com: np.ndarray          # (3,) COM position in link frame
    inertia: np.ndarray      # (3,3) inertia about COM, link frame

    @staticmethod
    def zero() -> "UrdfInertial":
        return UrdfInertial(0.0, np.zeros(3), np.zeros((3, 3)))


@dataclasses.dataclass
class UrdfLink:
    name: str
    inertial: UrdfInertial


@dataclasses.dataclass
class UrdfJoint:
    name: str
    joint_type: str          # 'revolute' | 'continuous' | 'fixed' | 'prismatic' | 'floating'
    parent: str
    child: str
    origin_xyz: np.ndarray   # (3,) child-frame origin in parent frame
    origin_rpy: np.ndarray   # (3,) fixed rotation (URDF roll-pitch-yaw)
    axis: np.ndarray         # (3,) joint axis in child (joint) frame
    limit_lower: float = -math.inf
    limit_upper: float = math.inf
    limit_effort: float = math.inf
    limit_velocity: float = math.inf
    damping: float = 0.0


@dataclasses.dataclass
class UrdfModel:
    name: str
    links: dict[str, UrdfLink]
    joints: dict[str, UrdfJoint]
    root_link: str
    # child joints per link, alphabetical by joint name (urdfdom map order)
    child_joints: dict[str, list[str]]


def _floats(s: str | None, n: int, default: float = 0.0) -> np.ndarray:
    if s is None:
        return np.full(n, default, dtype=np.float64)
    vals = [float(x) for x in s.split()]
    assert len(vals) == n, f"expected {n} floats, got {s!r}"
    return np.array(vals, dtype=np.float64)


def _parse_inertial(link_el: ET.Element) -> UrdfInertial:
    el = link_el.find("inertial")
    if el is None:
        return UrdfInertial.zero()
    origin = el.find("origin")
    xyz = _floats(origin.get("xyz") if origin is not None else None, 3)
    rpy = _floats(origin.get("rpy") if origin is not None else None, 3)
    mass_el = el.find("mass")
    mass = float(mass_el.get("value")) if mass_el is not None else 0.0
    inertia_el = el.find("inertia")
    if inertia_el is not None:
        ixx = float(inertia_el.get("ixx", 0.0))
        ixy = float(inertia_el.get("ixy", 0.0))
        ixz = float(inertia_el.get("ixz", 0.0))
        iyy = float(inertia_el.get("iyy", 0.0))
        iyz = float(inertia_el.get("iyz", 0.0))
        izz = float(inertia_el.get("izz", 0.0))
        inertia = np.array(
            [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]], dtype=np.float64
        )
    else:
        inertia = np.zeros((3, 3))
    # URDF allows a rotated inertial frame; rotate the inertia tensor into the
    # link frame so downstream code never sees the inertial-frame rotation.
    if np.any(rpy != 0.0):
        from .rotations_np import rpy_to_matrix

        R = rpy_to_matrix(rpy)
        inertia = R @ inertia @ R.T
    return UrdfInertial(mass, xyz, inertia)


def parse_urdf(path_or_string: str) -> UrdfModel:
    """Parse a URDF file (path or XML string) into an UrdfModel."""
    if path_or_string.lstrip().startswith("<"):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()
    assert root.tag == "robot", f"not a URDF robot element: {root.tag}"

    links: dict[str, UrdfLink] = {}
    for link_el in root.findall("link"):
        name = link_el.get("name")
        links[name] = UrdfLink(name, _parse_inertial(link_el))

    joints: dict[str, UrdfJoint] = {}
    for joint_el in root.findall("joint"):
        name = joint_el.get("name")
        jtype = joint_el.get("type")
        parent = joint_el.find("parent").get("link")
        child = joint_el.find("child").get("link")
        origin = joint_el.find("origin")
        xyz = _floats(origin.get("xyz") if origin is not None else None, 3)
        rpy = _floats(origin.get("rpy") if origin is not None else None, 3)
        axis_el = joint_el.find("axis")
        axis = _floats(axis_el.get("xyz") if axis_el is not None else "1 0 0", 3)
        limit = joint_el.find("limit")
        kw = {}
        if limit is not None:
            kw = dict(
                limit_lower=float(limit.get("lower", -math.inf)),
                limit_upper=float(limit.get("upper", math.inf)),
                limit_effort=float(limit.get("effort", math.inf)),
                limit_velocity=float(limit.get("velocity", math.inf)),
            )
        dyn = joint_el.find("dynamics")
        if dyn is not None:
            kw["damping"] = float(dyn.get("damping", 0.0))
        joints[name] = UrdfJoint(name, jtype, parent, child, xyz, rpy, axis, **kw)

    # Root link: the link that is never a child.
    children = {j.child for j in joints.values()}
    roots = [nm for nm in links if nm not in children]
    assert len(roots) == 1, f"expected a single root link, got {roots}"

    # Child joints per link, alphabetical by joint name (urdfdom std::map order).
    child_joints: dict[str, list[str]] = {nm: [] for nm in links}
    for jname in sorted(joints):
        child_joints[joints[jname].parent].append(jname)

    return UrdfModel(
        name=root.get("name", "robot"),
        links=links,
        joints=joints,
        root_link=roots[0],
        child_joints=child_joints,
    )
