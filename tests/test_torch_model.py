"""The port's model compiler (``model/urdf.py``, ``model/compile.py``,
``model/rotations_np.py``) and model surgery (``model/surgery.py``)
against the JAX package's: the same inputs give every ``RobotModel`` field
equal in both packages (numpy only; exact but for float64 summation order,
held to 1e-12)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")

# a floating base, a fixed joint to lump (a sensor plate with mass, its own
# fixed child), a revolute chain whose child joints sort out of document
# order, a rotated inertial frame, limits and damping
URDF = """<?xml version="1.0"?>
<robot name="probe">
  <link name="base">
    <inertial><origin xyz="0.01 0 0.02" rpy="0 0 0"/><mass value="5.0"/>
      <inertia ixx="0.1" ixy="0.001" ixz="0" iyy="0.12" iyz="0" izz="0.09"/></inertial>
  </link>
  <link name="plate">
    <inertial><origin xyz="0 0.03 0" rpy="0.1 0 0.2"/><mass value="0.4"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.003" iyz="0" izz="0.004"/></inertial>
  </link>
  <link name="sensor">
    <inertial><mass value="0.1"/>
      <inertia ixx="1e-4" ixy="0" ixz="0" iyy="1e-4" iyz="0" izz="1e-4"/></inertial>
  </link>
  <link name="thigh">
    <inertial><origin xyz="0 0 -0.15"/><mass value="2.0"/>
      <inertia ixx="0.02" ixy="0" ixz="0.001" iyy="0.02" iyz="0" izz="0.005"/></inertial>
  </link>
  <link name="shin">
    <inertial><origin xyz="0 0 -0.12"/><mass value="1.5"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.002"/></inertial>
  </link>
  <link name="foot">
    <inertial><origin xyz="0.03 0 -0.02"/><mass value="0.8"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.002"/></inertial>
  </link>
  <link name="arm">
    <inertial><origin xyz="0 0.1 0"/><mass value="1.0"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.01"/></inertial>
  </link>
  <joint name="z_plate_joint" type="fixed">
    <parent link="base"/><child link="plate"/><origin xyz="0 0 0.1" rpy="0 0.2 0"/>
  </joint>
  <joint name="sensor_joint" type="fixed">
    <parent link="plate"/><child link="sensor"/><origin xyz="0.02 0 0.01" rpy="0 0 0.3"/>
  </joint>
  <joint name="b_hip" type="revolute">
    <parent link="base"/><child link="thigh"/><origin xyz="0 -0.1 -0.05" rpy="0 0 0"/>
    <axis xyz="0 1 0"/><limit lower="-1.5" upper="1.2" effort="200" velocity="8"/>
    <dynamics damping="0.5"/>
  </joint>
  <joint name="c_knee" type="revolute">
    <parent link="thigh"/><child link="shin"/><origin xyz="0 0 -0.3" rpy="0 0 0"/>
    <axis xyz="0 1 0"/><limit lower="0" upper="2.4" effort="150" velocity="10"/>
  </joint>
  <joint name="d_ankle" type="continuous">
    <parent link="shin"/><child link="foot"/><origin xyz="0 0 -0.25" rpy="0.05 0 0"/>
    <axis xyz="1 0 0"/>
  </joint>
  <joint name="a_shoulder" type="revolute">
    <parent link="base"/><child link="arm"/><origin xyz="0 0.2 0.3" rpy="0 0 1.57"/>
    <axis xyz="0 0 1"/><limit lower="-3" upper="3" effort="50" velocity="5"/>
  </joint>
</robot>
"""


def assert_models_equal(a, b, tol=1e-12):
    """Every RobotModel field of a (JAX) equal to b's (the port's)."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "fixed_frames":
            assert va.keys() == vb.keys()
            for k in va:
                assert va[k][0] == vb[k][0], k
                for x, y in zip(va[k][1:], vb[k][1:]):
                    assert np.abs(np.asarray(x) - np.asarray(y)).max() <= tol, k
        elif isinstance(vb, np.ndarray):
            assert va.shape == vb.shape and va.dtype == vb.dtype, f.name
            np.testing.assert_allclose(va, vb, rtol=0, atol=tol, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("floating", [True, False])
def test_compile_urdf_matches_jax(floating):
    from libdwbc_tpu.model.compile import compile_urdf as jcompile
    from libdwbc_tpu_torch.model.compile import compile_urdf

    a, b = jcompile(URDF, floating=floating), compile_urdf(URDF, floating=floating)
    assert_models_equal(a, b)
    # alphabetical child joints: the arm (a_shoulder) before the leg (b_hip)
    assert b.body_names == ("base", "arm", "thigh", "shin", "foot")
    assert set(b.fixed_frames) == {"plate", "sensor"} and b.model_dof == 4
    assert b.body_index("FOOT") == 4 and b.body_index("sensor") == 0
    assert b.children(0) == [1, 2]


def test_parse_urdf_matches_jax():
    from libdwbc_tpu.model.urdf import parse_urdf as jparse
    from libdwbc_tpu_torch.model.urdf import parse_urdf

    a, b = jparse(URDF), parse_urdf(URDF)
    assert (a.name, a.root_link, a.child_joints) == (b.name, b.root_link, b.child_joints)
    for k in a.links:
        ia, ib = a.links[k].inertial, b.links[k].inertial
        assert ia.mass == ib.mass and np.array_equal(ia.com, ib.com)
        assert np.array_equal(ia.inertia, ib.inertia)
    for k in a.joints:
        ja, jb = dataclasses.asdict(a.joints[k]), dataclasses.asdict(b.joints[k])
        for f in ja:
            assert np.array_equal(np.asarray(ja[f]), np.asarray(jb[f])), (k, f)


def test_rotations_np_match_jax():
    from libdwbc_tpu.model import rotations_np as jr
    from libdwbc_tpu_torch.model import rotations_np as pr

    rng = np.random.default_rng(0)
    for rpy in list(rng.uniform(-3, 3, (8, 3))) + [np.array([0.3, np.pi / 2, -0.2])]:
        R = pr.rpy_to_matrix(rpy)
        assert np.array_equal(R, jr.rpy_to_matrix(rpy))
        assert np.array_equal(pr.matrix_to_rpy(R), jr.matrix_to_rpy(R))
        assert np.abs(pr.rpy_to_matrix(pr.matrix_to_rpy(R)) - R).max() <= 1e-12
        assert np.array_equal(pr.skew_np(rpy), jr.skew_np(rpy))


def _links(pkg):
    """A floating base with a fixed plate, a two-joint leg and an arm, as
    parallel link/joint vectors of package pkg's specs."""
    L, J = pkg.LinkSpec, pkg.JointSpec
    eye = np.eye(3)
    links = [L("torso", 6.0, np.array([0, 0, 0.05]), 0.1 * eye, -1),
             L("hip", 1.5, np.array([0, 0, -0.1]), 0.01 * eye, 0),
             L("plate", 0.3, np.array([0.01, 0, 0]), 0.001 * eye, 0),
             L("leg", 2.0, np.array([0, 0, -0.2]), np.diag([0.02, 0.02, 0.004]), 1),
             L("arm", 1.0, np.array([0, 0.1, 0]), 0.005 * eye, 0)]
    joints = [J("floating", name="root"),
              J("revolute", np.array([0, 1.0, 0]), np.array([0, -0.1, -0.1]), name="hip_j",
                limit_lower=-1.0, limit_upper=1.0, limit_effort=100.0),
              J("fixed", origin_xyz=np.array([0, 0, 0.2]), origin_rpy=np.array([0.1, 0, 0])),
              J("revolute", np.array([1.0, 0, 0]), np.array([0, 0, -0.35]),
                origin_rot=pkg_rot(0.2), name="knee_j", damping=0.3),
              J("revolute", np.array([0, 0, 1.0]), np.array([0, 0.25, 0.3]), name="arm_j")]
    return links, joints


def pkg_rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def test_compile_from_links_matches_jax():
    from libdwbc_tpu.model import compile as jc
    from libdwbc_tpu_torch.model import compile as pc

    a = jc.compile_from_links(*_links(jc), name="vec")
    b = pc.compile_from_links(*_links(pc), name="vec")
    assert_models_equal(a, b)
    assert b.body_names == ("torso", "hip", "leg", "arm") and "plate" in b.fixed_frames


SURGERY = {
    "delete_subtree": lambda s, m: s.delete_subtree(m, 7),
    "change_link_to_fixed": lambda s, m: s.change_link_to_fixed(m, 31),
    "change_link_to_fixed_mid": lambda s, m: s.change_link_to_fixed(m, 14),
    "add_link_revolute": lambda s, m: s.add_link(
        m, 23, "tool", "revolute", np.array([0, 0, 1.0]), np.array([0, 0, -0.1]),
        np.array([0.1, 0, 0]), 0.5, np.array([0, 0, -0.03]), np.diag([1e-3, 1e-3, 5e-4])),
    "add_link_fixed": lambda s, m: s.add_link(
        m, 31, "camera", "fixed", np.zeros(3), np.array([0.05, 0, 0]), np.array([0, 0.3, 0]),
        0.2, np.array([0.01, 0, 0]), np.diag([2e-4, 2e-4, 1e-4])),
    "change_link_inertia": lambda s, m: s.change_link_inertia(
        m, 15, 9.0, np.array([0.0, 0.02, 0.2]), np.diag([0.2, 0.25, 0.1])),
}


@pytest.mark.parametrize("op", sorted(SURGERY))
def test_surgery_matches_jax(op):
    from libdwbc_tpu.model import surgery as jsurg
    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu_torch.model import surgery
    from libdwbc_tpu_torch.model.compile import RobotModel

    jm, pm = JModel.load(MODEL), RobotModel.load(MODEL)
    frames = dict(pm.fixed_frames)
    a, b = SURGERY[op](jsurg, jm), SURGERY[op](surgery, pm)
    assert_models_equal(a, b)
    assert pm.fixed_frames == frames           # the input model is not changed


def test_save_load_round_trip(tmp_path):
    """compile → save → load gives the same model, field for field, and
    the JAX package reads the port's artifact as its own."""
    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu_torch.model.compile import RobotModel, compile_urdf

    m = compile_urdf(URDF)
    path = str(tmp_path / "probe.npz")
    m.save(path)
    assert_models_equal(RobotModel.load(path), m, tol=0.0)
    assert_models_equal(JModel.load(path), m, tol=0.0)
    # the shipped artifact: loaded and saved again, unchanged
    tocabi = RobotModel.load(MODEL)
    tocabi.save(str(tmp_path / "tocabi.npz"))
    assert_models_equal(RobotModel.load(str(tmp_path / "tocabi.npz")), tocabi, tol=0.0)
