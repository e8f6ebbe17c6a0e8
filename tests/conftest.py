"""Test bootstrap: force CPU (8 virtual devices for sharding tests) + x64.

Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE = "/root/reference"
URDF = os.path.join(REFERENCE, "tests", "dyros_tocabi.urdf")
URDF_UB = os.path.join(REFERENCE, "tests", "dyros_tocabi_ub.urdf")
GOLDEN_DIR = os.path.join(REFERENCE, "tests", "cases")

HAVE_REFERENCE = os.path.isdir(REFERENCE)

# Reference unit-test configurations (tests/dwbc_test.cpp:29-260).
CASE_Q = {
    1: np.array(
        [0, 0, -0.24, 0.6, -0.36, 0] * 2
        + [0, 0, 0]
        + [0.3, 0.3, 1.5, -1.27, -1, 0, -1, 0]
        + [0, 0]
        + [-0.3, -0.3, -1.5, 1.27, 1, 0, 1, 0],
        dtype=np.float64,
    ),
    2: np.array(
        [0.1, 0, -0.24, 0.5, -0.6, 0]
        + [0.05, 0, -0.21, 0.7, -0.31, 0]
        + [0, 0, 0]
        + [0.2, 0.5, 1.5, -1.27, -1.2, 0, -1, 0]
        + [0, 0]
        + [-0.3, -0.3, -1.5, 1.27, 1.3, 0.1, 1.3, 0],
        dtype=np.float64,
    ),
}
CASE_FSTAR = {
    1: (np.array([0.1, 4.0, 0.1, 0.1, -0.1, 0.1]), np.array([0.1, -0.1, 0.1])),
    2: (np.array([0.4, 2.0, 0.1, 0.3, -0.1, 0.1]), np.array([0.1, 0.1, 0.1])),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips without one")


def full_q(joints, base=(0, 0, 0.92983, 0, 0, 0), qw=1.0):
    q = np.zeros(40)
    q[0:6] = base
    q[6:39] = joints
    q[39] = qw
    return q


@pytest.fixture(scope="session")
def tocabi_model():
    from libdwbc_tpu.model.compile import compile_urdf

    return compile_urdf(URDF, floating=True)


@pytest.fixture(scope="session")
def tocabi_kin(tocabi_model):
    from libdwbc_tpu.kin.engine import Kinematics

    return Kinematics(tocabi_model)


def make_standard_robot(case: int = 1):
    """RobotData in the reference unit tests' configuration."""
    from libdwbc_tpu.wbc import types as T
    from libdwbc_tpu.wbc.robot import RobotData

    rd = RobotData()
    rd.LoadModelData(URDF, True, 0)
    rd.AddContactConstraint(6, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddContactConstraint(12, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddContactConstraint(23, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.04, 0.04)
    rd.AddContactConstraint(31, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.04, 0.04)
    rd.AddTaskSpace(0, T.TASK_LINK_6D, 0, np.zeros(3))
    rd.AddTaskSpace(1, T.TASK_LINK_ROTATION, 15, np.zeros(3))
    rd.SetTorqueLimit(np.full(33, 300.0))
    rd.UpdateKinematics(full_q(CASE_Q[case]), np.zeros(39))
    rd.SetContact(True, True)
    f1, f2 = CASE_FSTAR[case]
    rd.SetTaskSpace(0, f1)
    rd.SetTaskSpace(1, f2)
    return rd
