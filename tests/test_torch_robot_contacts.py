"""The port's facade (``wbc/robot.py::RobotData``) against the JAX
package's beyond the flagship's two feet, float64 on the CPU:

* the reference unit tests' four 6D contacts (``conftest.make_standard_robot``:
  the feet and 4 cm pads on links 23 and 31), all active — the contact
  space's 18 free directions, task QPs of 24 and 21 variables;
* BASELINE's config 3: the left foot alone (no free contact space: the
  ``NwJw.shape[-1] == 0`` branch of CalcContactRedistribute) under a 6D
  pelvis task, the link-15 rotation task and a 6D swing-foot task on link
  12;
* the upper body (``models/tocabi_ub.npz``, a fixed base, no contacts):
  its kinematic state and angular-momentum matrices; its contact stage
  refuses, as the JAX facade's does.

The same CASE_Q / CASE_FSTAR inputs as ``test_torch_robot.py``, with a
seeded third-level f*.  Limits: pre-QP algebra and τ_grav 1e-8, the QP
outputs 1e-6; config 3's τ_task, τ_cmd and contact force 1e-4 (SINGLE_TOL):
the task operators J_kt·Λ carry its level QPs' 1e-7 differences to the
torques as 4.4e-6 and to the contact force as 6.7e-6.
"""

import os

import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q
from test_torch_robot import (GROUPS, PRE_TOL, QP_TOL, assert_close, err, jax_robot,
                              np_, observers, osf_tick, port_robot, state_fields)

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWING_FSTAR = np.random.default_rng(9).uniform(-0.2, 0.2, 6)
# config 3's torques and contact force (module docstring): over 10x the
# measured 4.4e-6 and 6.7e-6
SINGLE_TOL = {"torque_task": 1e-4, "torque_cmd": 1e-4, "contact_force": 1e-4}


def four_contacts(rd, types):
    for link, lx in ((23, 0.04), (31, 0.04)):
        rd.AddContactConstraint(link, types.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], lx, lx)
    return (True,) * 4


def swing(rd, types):
    rd.AddTaskSpace(2, types.TASK_LINK_6D, 12, np.zeros(3))
    return (True, False)


def levels(n):
    return ("task_status",) + tuple(f"qp{h}.{k}" for h in range(n) for k in (
        "f_star_delta", "contact_qp", "gap", "primal_res")) + ("torque_task",
                                                               "torque_contact_tasks")


CONFIGS = {"four contacts": four_contacts, "config 3": swing}


@pytest.fixture(scope="module")
def ticks():
    """Each configuration's OSF-HQP tick and observers on CASE 1 and 2 in
    both packages (one facade per package and configuration)."""
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu_torch.wbc import types as T

    out = {}
    for name, setup in CONFIGS.items():
        for tag, rd, types in (("jax", jax_robot(), JT), ("port", port_robot(), T)):
            flags = setup(rd, types)
            for case in (1, 2):
                rd.UpdateKinematics(full_q(CASE_Q[case]), np.zeros(39))
                rd.SetContact(*flags)
                fs = CASE_FSTAR[case] + ((SWING_FSTAR,) if name == "config 3" else ())
                for h, f in enumerate(fs):
                    rd.SetTaskSpace(h, f)
                res = osf_tick(rd)
                res.update(observers(rd))
                res["n_qp"] = len(rd.qp_results)
                res["nwjw_cols"] = rd.cspace.NwJw.shape[-1]
                out[(name, tag, case)] = res
    return out


@pytest.mark.parametrize("case", [1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_osf_tick_matches_jax(ticks, name, case, group):
    keys, tol = GROUPS[group]
    got, want = ticks[(name, "port", case)], ticks[(name, "jax", case)]
    n_levels = 3 if name == "config 3" else 2
    if group == "task_space":
        keys = tuple(f"{k}{h}" for h in range(n_levels)
                     for k in ("J_task", "Lambda", "J_kt", "Q", "null"))
    elif group == "task_qp":
        keys = levels(n_levels)
    single = SINGLE_TOL if name == "config 3" else {}
    assert_close(got, {k: want[k] for k in keys if k not in single}, tol)
    for k in single.keys() & set(keys):
        assert err(got[k], want[k]) <= single[k], (k, err(got[k], want[k]))
    assert got["contact_status"] == 1 and got["qp_error"] == 0
    assert got["n_qp"] == want["n_qp"] == n_levels
    assert got["nwjw_cols"] == {"four contacts": 18, "config 3": 0}[name]


@pytest.mark.parametrize("case", [1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_observers_match_jax(ticks, name, case):
    got, want = ticks[(name, "port", case)], ticks[(name, "jax", case)]
    keys = ("contact_force", "zmp", "amm", "vcmm_all", "vcmm_upper", "stats.solves",
            "stats.success", "stats.fail", "stats.qp_error", "stats.worst_primal_res",
            "stats.worst_gap")
    single = {"contact_force": SINGLE_TOL["contact_force"]} if name == "config 3" else {}
    assert_close(got, {k: want[k] for k in keys if k not in single}, QP_TOL)
    for k, tol in single.items():
        assert err(got[k], want[k]) <= tol, (k, err(got[k], want[k]))


def test_single_support_redistribution_is_empty(ticks):
    """Config 3: no free contact directions, so CalcContactRedistribute
    returns 1 with an empty redistribution and τ_contact left as the task
    QPs made it (zero: no free contact space)."""
    got = ticks[("config 3", "port", 1)]
    assert got["redist_status"] == 1 and got["cf_redis_qp"].shape == (0,)
    assert np.abs(got["torque_contact"]).max() == 0.0


@pytest.fixture(scope="module")
def upper_body():
    from libdwbc_tpu.kin.engine import Kinematics as JKin
    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu.wbc.robot import RobotData as JRobot
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.robot import RobotData

    path = os.path.join(ROOT, "models", "tocabi_ub.npz")
    jr = JRobot()
    jr.model = JModel.load(path)
    jr.kin = JKin(jr.model)
    pr = RobotData(torch.float64, "cpu", "torch")
    pr.SetModel(RobotModel.load(path))
    rng = np.random.default_rng(2)
    arms = [0.3, 0.3, 1.5, -1.27, -1, 0, -1, 0]
    q = np.array([0, 0, 0] + arms + [0, 0] + [-a for a in arms]) + 0.05 * rng.standard_normal(21)
    qd = 0.3 * rng.standard_normal(21)
    for rd in (jr, pr):
        rd.UpdateKinematics(q, qd)
    return jr, pr


def test_upper_body_state_and_momentum(upper_body):
    jr, pr = upper_body
    assert not pr.model.floating and pr.system_dof_ == pr.model_dof_ == 21
    assert_close(state_fields(pr), state_fields(jr), PRE_TOL)
    mask = np.zeros(pr.model.nbody)
    mask[4:13] = 1.0
    for args in ((), (mask, [0.2, 0.1, 0.3])):
        assert err(pr.CalcVirtualCMM(*args), jr.CalcVirtualCMM(*args)) <= PRE_TOL
    assert err(pr.CalcAngularMomentumMatrix(), jr.CalcAngularMomentumMatrix()) <= PRE_TOL


def test_upper_body_without_contacts_refuses_the_contact_stage(upper_body):
    """No contact: the contact jacobian has no rows, and both facades'
    CalcContactConstraint raise ValueError."""
    for rd in upper_body:
        with pytest.raises(ValueError):
            rd.CalcContactConstraint()


def test_four_contacts_factorization_is_consistent(ticks):
    """The four-contact contact space on the port's side: N_C annihilates
    the contact rows' dynamics (J_C A⁻¹N_C = 0), NwJw spans 18 directions,
    J̄_cᵀ inverts J_C."""
    got = ticks[("four contacts", "port", 1)]
    assert np.abs(got["J_C"] @ got["A_inv_N_C"]).max() <= 1e-9
    assert np.abs(got["J_C_INV_T"] @ got["J_C"].T - np.eye(24)).max() <= 1e-9
    assert np.linalg.matrix_rank(got["NwJw"]) == 18
    assert float(np_(got["rank_health"])) > 1e-4
