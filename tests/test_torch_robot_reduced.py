"""The port's facade on the reduced-dimension (``_R``) path against the JAX
package's, float64 on the CPU: ReducedDynamicsCalculate,
ReducedCalcContactConstraint, ReducedCalcGravCompensation,
ReducedCalcTaskSpace, ReducedCalcTaskControlTorque (with and without the
QPs) and ReducedCalcContactRedistribute, on the flagship (two feet; the
pelvis task on the contact chain, the torso rotation on the lumped upper
body) and on config 3 (the left foot; the torso and the swing foot both on
the non-contact chain, so the second nc level's null-space terms run), on
CASE_Q / CASE_FSTAR 1 and 2.

Limits: the reduced dynamics, the contact spaces, the task factors and
τ_grav 1e-8; QP-dependent outputs 1e-6.  Config 3's QPs sit on nearly
dependent active rows (ROADMAP §3): its torques take the flat-face limits
(τ_task and τ_task_R 2e-3, τ_contact and τ_cmd 5e-2) and its QP solutions
test_torch_reduced.py's 2e-3 (measured: x 5.6e-5, τ_task_R 1.2e-4).
"""

import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q
from test_torch_robot import (FLAT, PRE_TOL, QP_TOL, assert_close, err, jax_robot, np_,
                              port_robot)

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

SWING_FSTAR = np.random.default_rng(9).uniform(-0.2, 0.2, 6)
RDYN = ("mass_nc", "com_pos_nc", "inertia_nc", "cmm_nc", "J_I_nc", "A_NC_joint", "J_R",
        "A_R_inv", "A_R", "J_I_nc_inv_T", "N_I_nc", "J_R_INV_T", "G_R", "G_NC")


def reduced_tick(rd, hqp=True):
    """The reduced chain stage by stage, as numpy."""
    out = {"rdyn_none": rd.ReducedDynamicsCalculate() is None}
    out.update({f"rdyn.{k}": np_(getattr(rd.rdyn, k)) for k in RDYN})
    out["contact_status"] = rd.ReducedCalcContactConstraint()
    cs = rd.cspace_r
    out.update({f"csr.{k}": np_(getattr(cs, k)) for k in (
        "Lambda_c", "J_C_INV_T", "N_C", "A_inv_N_C", "W", "W_inv", "NwJw", "rank_health")})
    out["csr.V2TV2"] = np_(cs.V2.transpose(-1, -2) @ cs.V2)
    out["J_CR"] = np_(rd.J_CR)
    out["grav_return"] = rd.ReducedCalcGravCompensation()
    out.update(torque_grav_R=np_(rd.torque_grav_R_), P_CR=np_(rd.P_CR), P_C=np_(rd.P_C))
    out["task_status"] = rd.ReducedCalcTaskControlTorque(hqp)
    out["J_base_R_kt"] = np_(rd._J_base_R_kt)
    for e in rd._rtasks:
        h = e["h"]
        for k in ("J_task_R", "J_kt_R", "Lambda", "null", "torque_null_h_R",
                  "torque_null_h_nc"):
            if e.get(k) is not None:
                out[f"task{h}.{k}"] = np_(e[k])
    if hqp:
        for i, r in enumerate(rd._r_qp_results):
            out.update({f"qp{i}.f_star_delta": np_(r.f_star_delta),
                        f"qp{i}.contact_qp": np_(r.contact_qp), f"qp{i}.gap": np_(r.gap),
                        f"qp{i}.primal_res": np_(r.primal_res)})
    out["torque_task_R"] = np_(rd.torque_task_R_)
    out["torque_task"] = np_(rd.torque_task_)
    if hqp and rd.cspace_r.NwJw.shape[-1]:
        out["redist_status"] = rd.ReducedCalcContactRedistribute(hqp)
    out["torque_contact"] = np_(rd.torque_contact_)
    out["torque_cmd"] = np_(rd.GetControlTorque())
    return out


QP_KEYS = ("task_status", "torque_task_R", "torque_task", "redist_status", "torque_contact",
           "torque_cmd")


def is_qp_key(k):
    return k in QP_KEYS or k.startswith("qp") or ".torque_null" in k


@pytest.fixture(scope="module")
def ticks():
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu_torch.wbc import types as T

    out = {}
    for name in ("flagship", "config 3"):
        for tag, rd, types in (("jax", jax_robot(), JT), ("port", port_robot(), T)):
            if name == "config 3":
                rd.AddTaskSpace(2, types.TASK_LINK_6D, 12, np.zeros(3))
            for case in (1, 2):
                for hqp in (True, False):
                    rd.UpdateKinematics(full_q(CASE_Q[case]), np.zeros(39))
                    rd.SetContact(True, name == "flagship")
                    fs = CASE_FSTAR[case] + ((SWING_FSTAR,) if name == "config 3" else ())
                    for h, f in enumerate(fs):
                        rd.SetTaskSpace(h, f)
                    out[(name, tag, case, hqp)] = reduced_tick(rd, hqp)
    return out


@pytest.mark.parametrize("hqp", [True, False])
@pytest.mark.parametrize("case", [1, 2])
@pytest.mark.parametrize("name", ["flagship", "config 3"])
@pytest.mark.parametrize("part", ["pre_qp", "qp"])
def test_reduced_chain_matches_jax(ticks, name, case, hqp, part):
    got, want = ticks[(name, "port", case, hqp)], ticks[(name, "jax", case, hqp)]
    assert got.keys() == want.keys()
    keys = [k for k in want if is_qp_key(k) == (part == "qp")]
    flat = {}
    if name == "config 3" and part == "qp":
        # the first QP's float64 polish turns summation order into 6e-5 in
        # x on these rows (test_torch_reduced.py's config 3 limits)
        flat = dict(FLAT, torque_task_R=FLAT["torque_task"],
                    **{k: 2e-3 for k in keys if k.endswith(("f_star_delta", "contact_qp"))})
    assert_close(got, {k: want[k] for k in keys if k not in flat},
                 QP_TOL if part == "qp" else PRE_TOL)
    for k in flat.keys() & set(keys):
        assert err(got[k], want[k]) <= flat[k], (k, err(got[k], want[k]))
    assert not got["rdyn_none"] and got["contact_status"] == 1


def test_reduced_shapes(ticks):
    """The flagship's reduced coordinates: 12 contact-chain joints, 24
    reduced system dofs, 18 reduced model dofs; three QPs (the pelvis
    level, the nc resultant, the redistribution — the last stored apart);
    config 3: 6 contact-chain joints, the pelvis level and the nc
    resultant, no free contact space."""
    f, c3 = ticks[("flagship", "port", 1, True)], ticks[("config 3", "port", 1, True)]
    assert f["rdyn.A_R"].shape == (24, 24) and f["csr.W_inv"].shape == (18, 18)
    assert c3["rdyn.A_R"].shape == (18, 18) and c3["csr.NwJw"].shape == (12, 0)
    assert sorted(k for k in f if k.endswith(".gap")) == ["qp0.gap", "qp1.gap"]
    assert sorted(k for k in c3 if k.endswith(".gap")) == ["qp0.gap", "qp1.gap"]
    assert "redist_status" in f and "redist_status" not in c3
