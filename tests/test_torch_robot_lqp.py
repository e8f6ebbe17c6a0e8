"""The port's facade on the acceleration-level methods against the JAX
package's, float64 on the CPU, on the flagship and CASE_Q / CASE_FSTAR 1
and 2: ConfigureLQP / CalcControlTorqueLQP, CalcTaskControlTorqueJACC,
CalcTaskControlTorqueJACC_R, CalcTaskControlTorqueJACC_R_NC,
ConfigureLQP_R / CalcControlTorqueLQP_R and ConfigureLQP_R_NC /
CalcControlTorqueLQP_R_NC, and GetQPStats' per-level LQP times.

Limits: the cascades' inputs (each level's A, a, B, b, H) 1e-8 (the nc
cascade's targets, taken from the reduced cascade's solution, 1e-6); torques,
accelerations and y 1e-6.  One departure: the reduced cascade on CASE 2
(CalcControlTorqueLQP_R) has its level-1 slack face nearly flat — the JAX
polish lands on a vertex with zero slack, the port's IPM point keeps
slacks of 2.6e-5 and the two contact forces part by 0.34 N along the
feet's internal-force direction, which the cascade leaves free.  There the
lexicographic objectives (each level's equality residual and violation
norms, and its H cost) are held within 1e-4 and the accelerations within
1e-6, and y's contact forces and the torques made from them are not
compared.  The nc cascade reads only the accelerations: on CASE 2 they
part by 8.0e-7, its targets and y by as much, and τ_nc = A_NC q̈_nc + G_NC
by 2.0e-6, held to 1e-5 (NC_TOL).  On CASE 1 every output is held to 1e-6.
"""

import re

import numpy as np
import pytest
import torch

from test_torch_robot import PRE_TOL, QP_TOL, assert_close, jax_robot, np_, port_robot, set_case

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)


def level_inputs(levels, tag):
    out = {}
    for i, L in enumerate(levels):
        for k in ("A", "a", "B", "b", "H"):
            v = getattr(L, k)
            if v is not None:
                out[f"{tag}{i}.{k}"] = np_(v)
        out[f"{tag}{i}.rank"] = L.rank
    return out


def lexicographic(levels, y):
    """Per level: ‖B y + b‖, ‖max(A y + a, 0)‖ (rows normalized, as the
    cascade normalizes them) and yᵀHy."""
    out = []
    for L in levels:
        B, b = np_(L.B), np_(L.b)
        nb = np.linalg.norm(B, axis=-1)
        nb[nb == 0] = 1.0
        row = [np.linalg.norm((B @ y + b) / nb)]
        if L.A is not None:
            A, a = np_(L.A), np_(L.a)
            na = np.linalg.norm(A, axis=-1)
            na[na == 0] = 1.0
            row.append(np.linalg.norm(np.maximum((A @ y + a) / na, 0.0)))
        if L.H is not None:
            row.append(y @ np_(L.H) @ y)
        out.append(row)
    return np.array(out, dtype=object)


def acceleration_methods(rd):
    out = {"lqp_status": rd.ConfigureLQP()}
    out.update(level_inputs(rd._lqp_levels, "lqp"))
    out["lqp_y0"] = np_(rd._lqp_y0)
    out["torque_lqp"] = rd.CalcControlTorqueLQP()
    out["lqp_y"] = np_(rd.lqp_result.y)
    out["stats_lqp_levels"] = [t["level"] for t in rd.GetQPStats()["lqp_level_times"]]
    out["torque_jacc"] = rd.CalcTaskControlTorqueJACC()
    out["acc_jacc"] = np_(rd.acc_jacc_)
    rd.ReducedDynamicsCalculate()
    rd.ReducedCalcContactConstraint()
    out["torque_jacc_R"] = rd.CalcTaskControlTorqueJACC_R()
    out["acc_jacc_R"] = np_(rd.acc_jacc_R_)
    out["torque_jacc_full"] = np_(rd.torque_jacc_full_)
    out["torque_jacc_nc"] = rd.CalcTaskControlTorqueJACC_R_NC()
    out["acc_jacc_nc"] = np_(rd.acc_jacc_nc_)
    out["gacc_jacc_nc"] = np_(rd.gacc_jacc_nc_)
    out["lqp_r_status"] = rd.ConfigureLQP_R()
    out.update(level_inputs(rd._lqp_r_levels, "lqp_r"))
    out["torque_lqp_R_full"] = rd.CalcControlTorqueLQP_R()
    out["torque_lqp_R"] = np_(rd.torque_lqp_R_)
    r_sys = rd._ridx.reduced_system_dof
    y_r = np_(rd.lqp_r_result.y)
    out["lqp_r_qdd"], out["lqp_r_fc"] = y_r[:r_sys], y_r[r_sys:]
    out["lqp_r_lex"] = lexicographic(rd._lqp_r_levels, y_r)
    out["lqp_nc_status"] = rd.ConfigureLQP_R_NC(rd.lqp_r_result.y[:r_sys])
    out.update(level_inputs(rd._lqp_nc_levels, "lqp_nc"))
    out["torque_lqp_nc"] = rd.CalcControlTorqueLQP_R_NC()
    out["torque_lqp_full"] = np_(rd.torque_lqp_)
    stats = rd.GetQPStats()
    out["stats_levels"] = [t["level"] for t in stats["lqp_level_times"]]
    out["stats_max_levels"] = sorted(stats["lqp_level_times_max"])
    out["stats_times"] = stats["lqp_level_times"]
    return out


@pytest.fixture(scope="module")
def results():
    out = {}
    robots = (("jax", jax_robot()), ("port", port_robot()))
    for case in (1, 2):
        for tag, rd in robots:
            set_case(rd, case)
            out[(tag, case)] = acceleration_methods(rd)
    return out


INPUT_KEY = re.compile(r"^(lqp|lqp_r|lqp_nc)\d+\.|^lqp_y0$")
# the outputs that carry the reduced cascade's contact forces (held
# through its objectives on CASE 2)
REDUCED_LQP = ("torque_lqp_R_full", "torque_lqp_R", "lqp_r_fc", "torque_lqp_full")
# τ_nc on CASE 2 (module docstring): 5x the measured 2.0e-6
NC_TOL = 1e-5


@pytest.mark.parametrize("case", [1, 2])
def test_cascade_inputs_match_jax(results, case):
    got, want = results[("port", case)], results[("jax", case)]
    keys = [k for k in want if INPUT_KEY.match(k)]
    assert len(keys) > 30
    # the nc cascade's targets come from the reduced cascade's solution
    from_qp = [k for k in keys if k.startswith("lqp_nc") and k.endswith(".b")]
    assert_close(got, {k: want[k] for k in keys if not k.endswith(".rank")
                       and k not in from_qp}, PRE_TOL)
    assert_close(got, {k: want[k] for k in from_qp}, QP_TOL)
    assert all(got[k] == want[k] for k in keys if k.endswith(".rank"))


@pytest.mark.parametrize("case", [1, 2])
@pytest.mark.parametrize("method", ["lqp", "jacc", "jacc_R", "jacc_R_NC", "lqp_R", "lqp_R_NC"])
def test_method_matches_jax(results, case, method):
    got, want = results[("port", case)], results[("jax", case)]
    keys = {"lqp": ("lqp_status", "torque_lqp", "lqp_y"),
            "jacc": ("torque_jacc", "acc_jacc"),
            "jacc_R": ("torque_jacc_R", "acc_jacc_R", "torque_jacc_full"),
            "jacc_R_NC": ("torque_jacc_nc", "acc_jacc_nc", "gacc_jacc_nc"),
            "lqp_R": ("lqp_r_status", "lqp_r_qdd", "torque_lqp_R_full", "torque_lqp_R",
                      "lqp_r_fc"),
            "lqp_R_NC": ("lqp_nc_status", "torque_lqp_nc", "torque_lqp_full")}[method]
    if case == 2 and method in ("lqp_R", "lqp_R_NC"):
        # the flat level-1 face (module docstring): the objectives instead
        lex_g, lex_w = got["lqp_r_lex"], want["lqp_r_lex"]
        for row_g, row_w in zip(lex_g, lex_w):
            assert np.abs(np.array(row_g) - np.array(row_w)).max() <= 1e-4, (row_g, row_w)
        keys = tuple(k for k in keys if k not in REDUCED_LQP)
        if method == "lqp_R_NC":
            assert_close(got, {"torque_lqp_nc": want["torque_lqp_nc"]}, NC_TOL)
            keys = tuple(k for k in keys if k != "torque_lqp_nc")
    assert_close(got, {k: want[k] for k in keys}, QP_TOL)


def test_qp_stats_carry_level_times(results):
    """GetQPStats: each cascade's solved levels with their host times, and
    the running maxima per level, as the JAX facade reports them."""
    got, want = results[("port", 2)], results[("jax", 2)]
    assert got["stats_lqp_levels"] == want["stats_lqp_levels"] == [1, 2, 3]
    assert got["stats_levels"] == want["stats_levels"] == [0, 1]
    assert got["stats_max_levels"] == want["stats_max_levels"] == [0, 1, 2, 3]
    assert all(t["update_us"] >= 0 and t["solve_us"] > 0 for t in got["stats_times"])


def test_nc_methods_need_an_nc_task():
    """No task on the non-contact chain: JACC_R_NC refuses (both packages)."""
    for rd in (jax_robot(), port_robot()):
        rd.ts_.pop()
        set_case(rd, 1)
        rd.ReducedDynamicsCalculate()
        rd.ReducedCalcContactConstraint()
        rd.CalcTaskControlTorqueJACC_R()
        with pytest.raises(ValueError, match="non-contact-chain"):
            rd.CalcTaskControlTorqueJACC_R_NC()
