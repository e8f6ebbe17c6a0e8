"""The port's controller facade (``wbc/robot.py::RobotData``) and its
single-environment RL bridge against the JAX package's, float64 on the
CPU, on the flagship: ``models/tocabi.npz`` with the two 6D feet, the
pelvis 6D task over the link-15 rotation task and ±300 Nm limits, as
``bridge._standard_robot`` builds it, on the reference's standing cases
``CASE_Q`` / ``CASE_FSTAR`` 1 and 2.

The OSF-HQP tick stage by stage (UpdateKinematics, CalcContactConstraint,
CalcGravCompensation, CalcTaskSpace, CalcTaskControlTorque,
CalcContactRedistribute), the observers and GetQPStats; the no-QP path
and the closed-form two-foot redistribution; a forced QP failure (the 10×
retry, then the gravity hold with ``qp_error_``); trajectories through
UpdateTaskSpace; model surgery and its renumbering; the RL bridge; a model
from a URDF string and from link/joint vectors.

Limits: the pre-QP algebra (the kinematic state, J_C, the contact space,
the task factors and null spaces) and τ_grav 1e-8; QP-dependent outputs
1e-6.  The JAX facade jits each stage once per shape in this process (the
first tick ~30 s): the cases share one JAX facade, so its stages compile
once.
"""

import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

PRE_TOL = 1e-8
QP_TOL = 1e-6
# CLAUDE.md's limits where a QP's active rows make its solution a face
FLAT = {"torque_task": 2e-3, "torque_contact": 5e-2, "torque_cmd": 5e-2}


def np_(x):
    """A JAX array, a tensor or a number as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def err(a, b):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max(initial=0.0))


def assert_close(got, want, tol):
    """Every key of want within tol of got's; the errors by key."""
    errs = {k: err(got[k], want[k]) for k in want}
    bad = {k: e for k, e in errs.items() if not e <= tol}
    assert not bad, bad
    return errs


def port_robot(model=None, dtype=torch.float64):
    """The port's facade in the flagship's configuration on the CPU."""
    from libdwbc_tpu_torch import bridge

    rd = bridge._standard_robot(dtype=dtype, device="cpu", backend="torch")
    if model is not None:
        rd.SetModel(model)
    return rd


def jax_robot():
    from libdwbc_tpu import bridge

    return bridge._standard_robot()


def set_case(rd, case, contacts=(True, True)):
    rd.UpdateKinematics(full_q(CASE_Q[case]), np.zeros(39))
    rd.SetContact(*contacts)
    for h, f in enumerate(CASE_FSTAR[case]):
        rd.SetTaskSpace(h, f)


def state_fields(rd):
    st = rd.state
    return dict(A=st.A, A_inv=st.A_inv, B=st.B, G=st.G, J=st.J, Jcom=st.Jcom, R=st.R, p=st.p,
                com_pos=st.com_pos, com_inertia=st.com_inertia, CMM=st.CMM,
                Jcom_total=st.Jcom_total)


def cspace_fields(rd):
    cs = rd.cspace
    return dict(J_C=rd.J_C, Lambda_c=cs.Lambda_c, J_C_INV_T=cs.J_C_INV_T, N_C=cs.N_C,
                A_inv_N_C=cs.A_inv_N_C, W=cs.W, W_inv=cs.W_inv, NwJw=cs.NwJw,
                rank_health=cs.rank_health,
                # V2, an orthonormal basis of W's null space, is unique up
                # to a rotation within it: its projector V2ᵀV2 is compared
                V2TV2=cs.V2.transpose(-1, -2) @ cs.V2)


def task_fields(rd):
    out = {}
    for h, ((J_task, tf), null) in enumerate(zip(rd._task_factors, rd._nulls)):
        out.update({f"J_task{h}": J_task, f"Lambda{h}": tf.Lambda_task, f"J_kt{h}": tf.J_kt,
                    f"Q{h}": tf.Q, f"null{h}": null})
    return out


def osf_tick(rd, hqp=True):
    """The OSF-HQP tick stage by stage: every stage's return value and
    result, as numpy."""
    out = {"contact_status": rd.CalcContactConstraint()}
    out.update({k: np_(v) for k, v in state_fields(rd).items()})
    out.update({k: np_(v) for k, v in cspace_fields(rd).items()})
    out["grav_return"] = rd.CalcGravCompensation()
    out["torque_grav"], out["P_C"] = np_(rd.torque_grav_), np_(rd.P_C)
    out["task_status"] = rd.CalcTaskControlTorque(hqp)
    out.update({k: np_(v) for k, v in task_fields(rd).items()})
    if hqp:
        for h, r in enumerate(rd.qp_results):
            out.update({f"qp{h}.f_star_delta": np_(r.f_star_delta),
                        f"qp{h}.contact_qp": np_(r.contact_qp), f"qp{h}.gap": np_(r.gap),
                        f"qp{h}.primal_res": np_(r.primal_res)})
    out["torque_task"] = np_(rd.torque_task_)
    out["torque_contact_tasks"] = np_(rd.torque_contact_)
    out["redist_status"] = rd.CalcContactRedistribute(hqp)
    if hqp:
        out["cf_redis_qp"] = np_(rd.cf_redis_qp_)
    out["torque_contact"] = np_(rd.torque_contact_)
    out["torque_cmd"] = np_(rd.GetControlTorque())
    out["qp_error"] = rd.qp_error_
    return out


# the groups of osf_tick's outputs and their limits
PRE_KEYS = ("A", "A_inv", "B", "G", "J", "Jcom", "R", "p", "com_pos", "com_inertia", "CMM",
            "Jcom_total", "J_C", "Lambda_c", "J_C_INV_T", "N_C", "A_inv_N_C", "W", "W_inv",
            "V2TV2", "NwJw", "rank_health")
GROUPS = {
    "state": (("A", "A_inv", "B", "G", "J", "Jcom", "R", "p", "com_pos", "com_inertia", "CMM",
               "Jcom_total"), PRE_TOL),
    "contact_space": (("contact_status", "J_C", "Lambda_c", "J_C_INV_T", "N_C", "A_inv_N_C",
                       "W", "W_inv", "V2TV2", "NwJw", "rank_health"), PRE_TOL),
    "gravity": (("grav_return", "torque_grav", "P_C"), PRE_TOL),
    "task_space": (tuple(f"{k}{h}" for h in range(2)
                         for k in ("J_task", "Lambda", "J_kt", "Q", "null")), PRE_TOL),
    "task_qp": (("task_status",) + tuple(f"qp{h}.{k}" for h in range(2) for k in (
        "f_star_delta", "contact_qp", "gap", "primal_res")) + ("torque_task",
                                                               "torque_contact_tasks"), QP_TOL),
    "redistribution": (("redist_status", "cf_redis_qp", "torque_contact", "torque_cmd",
                        "qp_error"), QP_TOL),
}


def observers(rd):
    """The facade's observers after a tick: contact force and ZMP under
    τ_cmd, the angular-momentum matrices, QP statistics."""
    cf = rd.getContactForce(rd.GetControlTorque())
    mask = np.zeros(rd.model.nbody)
    mask[15:] = 1.0
    stats = rd.GetQPStats()
    return dict(contact_force=cf, zmp=rd.getZMP(cf), amm=rd.CalcAngularMomentumMatrix(),
                vcmm_all=rd.CalcVirtualCMM(), vcmm_upper=rd.CalcVirtualCMM(mask, [0.1, 0.0, 0.8]),
                **{f"stats.{k}": stats[k] for k in ("solves", "success", "fail", "qp_error",
                                                    "worst_primal_res", "worst_gap")})


@pytest.fixture(scope="module")
def robots():
    """One JAX and one port facade, shared by the module's cases."""
    return jax_robot(), port_robot()


@pytest.fixture(scope="module")
def ticks(robots):
    """The OSF-HQP tick and the observers on CASE 1 and 2, both packages."""
    jr, pr = robots
    out = {}
    for case in (1, 2):
        for tag, rd in (("jax", jr), ("port", pr)):
            set_case(rd, case)
            out[(tag, case)] = {**osf_tick(rd), **observers(rd)}
    return out


@pytest.mark.parametrize("case", [1, 2])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_osf_tick_matches_jax(ticks, case, group):
    keys, tol = GROUPS[group]
    want = {k: ticks[("jax", case)][k] for k in keys}
    assert_close(ticks[("port", case)], want, tol)
    if group == "contact_space":
        assert ticks[("port", case)]["contact_status"] == 1
    if group == "redistribution":
        assert ticks[("port", case)]["qp_error"] == 0


@pytest.mark.parametrize("case", [1, 2])
def test_observers_match_jax(ticks, case):
    got, want = ticks[("port", case)], ticks[("jax", case)]
    keys = ("contact_force", "zmp", "amm", "vcmm_all", "vcmm_upper", "stats.solves",
            "stats.success", "stats.fail", "stats.qp_error", "stats.worst_primal_res",
            "stats.worst_gap")
    assert_close(got, {k: want[k] for k in keys}, QP_TOL)
    # the explicit angular-momentum matrix is the CMM's angular rows
    assert err(got["amm"], got["CMM"][3:6]) <= PRE_TOL


@pytest.mark.parametrize("case", [1, 2])
def test_no_qp_path_and_closed_form_redistribution(robots, case):
    """hqp=False: the task torques from f* alone, and the closed-form
    two-foot redistribution (src/dwbc.cpp:1572-1612)."""
    outs = []
    for rd in robots:
        set_case(rd, case)
        outs.append(osf_tick(rd, hqp=False))
    want, got = outs
    keys = ("task_status", "torque_task", "torque_contact_tasks", "redist_status",
            "torque_contact", "torque_cmd")
    assert_close(got, {k: want[k] for k in keys}, PRE_TOL)
    assert got["redist_status"] == 1 and np.abs(got["torque_contact"]).max() > 1.0


def test_closed_form_needs_two_feet(robots):
    """One foot down: the closed form refuses (0) and zeroes τ_contact."""
    for rd in robots:
        set_case(rd, 1, contacts=(True, False))
        rd.CalcContactConstraint()
        rd.CalcGravCompensation()
        rd.CalcTaskControlTorque(False)
        assert rd.CalcContactRedistribute(False) == 0
        assert np.abs(np_(rd.torque_contact_)).max() == 0.0


@pytest.fixture
def qp_calls(monkeypatch):
    """Count the facade's task and redistribution QP solves (both packages)
    by their iteration budgets."""
    import libdwbc_tpu.wbc.robot as jrobot
    import libdwbc_tpu_torch.wbc.robot as probot

    calls = {"jax": [], "port": []}

    def counted(tag, name, fn):
        def run(*a, **kw):
            calls[tag].append((name, kw["iters"]))
            return fn(*a, **kw)
        return run

    task, redist = jrobot._task_qp, jrobot._redist_qp
    monkeypatch.setattr(jrobot, "_task_qp", lambda: counted("jax", "task", task()))
    monkeypatch.setattr(jrobot, "_redist_qp", lambda: counted("jax", "redist", redist()))
    monkeypatch.setattr(probot, "solve_task_level_qp",
                        counted("port", "task", probot.solve_task_level_qp))
    monkeypatch.setattr(probot, "solve_contact_redistribution_qp",
                        counted("port", "redist", probot.solve_contact_redistribution_qp))
    return calls


@pytest.mark.parametrize("iters", [1, 0])
def test_qp_failure_retries_then_holds(robots, qp_calls, iters):
    """A budget too small: one iteration fails every QP, the retry at 10
    solves it; none fails both, and the facade aborts to the gravity hold
    (τ_task = τ_contact = 0, ``qp_error_`` 1, return 0), as the JAX facade
    does."""
    outs = []
    for rd in robots:
        rd.qp_iters = iters
        try:
            set_case(rd, 1)
            outs.append(osf_tick(rd) if iters else {
                "contact_status": rd.CalcContactConstraint(),
                "grav_return": rd.CalcGravCompensation(),
                "task_status": rd.CalcTaskControlTorque(),
                "torque_task": np_(rd.torque_task_), "torque_contact": np_(rd.torque_contact_),
                "torque_cmd": np_(rd.GetControlTorque()), "qp_error": rd.qp_error_,
                "stats.qp_error": rd.GetQPStats()["qp_error"]})
        finally:
            rd.qp_iters = 25
    want, got = outs
    assert qp_calls["port"] == qp_calls["jax"]
    if iters:
        assert qp_calls["port"] == [("task", 1), ("task", 10)] * 2 + [("redist", 1),
                                                                      ("redist", 10)]
        assert got["qp_error"] == 0 and got["redist_status"] == 1
        keys = [k for k in GROUPS["task_qp"][0] + GROUPS["redistribution"][0]
                if not k.endswith(".gap")]
        assert_close(got, {k: want[k] for k in keys}, QP_TOL)
    else:
        assert qp_calls["port"] == [("task", 0), ("task", 0)]
        assert got["task_status"] == 0 and got["qp_error"] == 1 == got["stats.qp_error"]
        assert np.abs(got["torque_task"]).max() == 0 == np.abs(got["torque_contact"]).max()
        assert_close(got, want, PRE_TOL)
        assert err(got["torque_cmd"], got["grav_return"]) == 0.0


def test_update_task_space_trajectories(robots):
    """Trajectory servos through UpdateTaskSpace: a quintic pelvis
    position and rotation trajectory and a torso rotation, at a time
    inside them; f* per level, then the QP tick on it."""
    from scipy.spatial.transform import Rotation

    Rd = Rotation.from_euler("xyz", [0.05, -0.03, 0.1]).as_matrix()
    outs = []
    for rd in robots:
        set_case(rd, 2)
        st = rd.state
        p0, R0 = np_(st.p[0]), np_(st.R[0])
        rd.SetTaskGain(0, [400.0] * 3, [40.0] * 3, [1.0] * 3, [300.0] * 3, [30.0] * 3,
                       [1.0] * 3)
        rd.SetTrajectoryQuintic(0, 0.0, 1.0, p0, np.zeros(3), p0 + [0.02, -0.01, -0.03],
                                np.zeros(3))
        rd.SetTrajectoryRotation(0, 0.0, 1.0, R0, np.zeros(3), R0 @ Rd, np.zeros(3))
        rd.SetTaskGain(1, [0.0] * 3, [0.0] * 3, [0.0] * 3, [200.0] * 3, [20.0] * 3, [1.0] * 3)
        rd.SetTrajectoryRotation(1, 0.2, 0.8, np_(st.R[15]), np.zeros(3), Rd, np.zeros(3))
        rd.UpdateTaskSpace(0.45)
        out = {f"fstar{h}": rd._fstars[h] for h in range(2)}
        out.update(osf_tick(rd))
        rd._traj.clear()
        outs.append(out)
    want, got = outs
    assert np.abs(got["fstar0"]).max() > 0.1 and np.abs(got["fstar1"]).max() > 0.1
    assert_close(got, {k: want[k] for k in ("fstar0", "fstar1")}, PRE_TOL)
    assert_close(got, {k: want[k] for k in ("torque_grav", "J_kt0", "J_kt1")}, PRE_TOL)
    # these f* drive the second task QP onto active rows where its solution
    # is a face (the f_c block of its H is zero): the JAX float64 polish
    # lands on a vertex (gap 2e-14), the port's is refused by the same
    # acceptance test on roundoff-different inputs and keeps the IPM point
    # (gap 5e-12), 2e-4 Nm away — the flat-face limits
    for k, tol in FLAT.items():
        assert err(got[k], want[k]) <= tol, (k, err(got[k], want[k]))


SURGERY = {
    "ChangeLinkInertia": lambda rd: rd.ChangeLinkInertia(
        15, 9.0, [0.0, 0.02, 0.2], np.diag([0.2, 0.25, 0.1])),
    "AddLink": lambda rd: rd.AddLink(
        31, "camera", "fixed", np.zeros(3), [0.05, 0, 0], [0, 0.3, 0], 0.2, [0.01, 0, 0],
        np.diag([2e-4, 2e-4, 1e-4])),
    "DeleteLink": lambda rd: rd.DeleteLink("L_Shoulder1_Link"),
    "ChangeLinkToFixedJoint": lambda rd: rd.ChangeLinkToFixedJoint(33),
}


@pytest.mark.parametrize("op", sorted(SURGERY))
def test_surgery_then_tick(op):
    """A surgery op on a fresh facade in each package (the JAX
    ``add_link(..., "fixed")`` writes into its input model's fixed
    frames), the contacts and tasks renumbered by name, then a tick: the
    full tick where the shapes are the flagship's, the pre-QP stages where
    the op changes the dof count (a new JAX compile per stage)."""
    from test_torch_model import assert_models_equal

    outs = []
    for rd in (jax_robot(), port_robot()):
        SURGERY[op](rd)
        n = rd.model.ndof
        if n != 39:
            q = np.zeros(n + 1)
            q[2], q[n] = 0.92983, 1.0
            q[6:n] = full_q(CASE_Q[1])[6:6 + n - 6]
            rd.UpdateKinematics(q, np.zeros(n))
            rd.SetContact(True, True)
            out = {"contact_status": rd.CalcContactConstraint(),
                   "grav_return": rd.CalcGravCompensation(),
                   **{k: np_(v) for k, v in state_fields(rd).items()},
                   **{k: np_(v) for k, v in cspace_fields(rd).items()}}
        else:
            set_case(rd, 1)
            out = osf_tick(rd)
        out["model"] = rd.model
        out["cc"] = [(c.link, c.contact_type) for c in rd.cc_]
        out["ts"] = [[(tl.mode, tl.link) for tl in td.links] for td in rd.ts_]
        outs.append(out)
    want, got = outs
    assert_models_equal(want.pop("model"), got.pop("model"))
    assert got.pop("cc") == want.pop("cc") and got.pop("ts") == want.pop("ts")
    pre = {k: v for k, v in want.items() if k in PRE_KEYS or k in GROUPS["gravity"][0]
           or k == "contact_status"}
    assert_close(got, pre, PRE_TOL)
    assert_close(got, {k: v for k, v in want.items() if k not in pre}, QP_TOL)


def test_surgery_renumbers_by_name():
    """A task on a deleted link is dropped, one on the COM kept, the
    contacts on surviving links renumbered (both packages)."""
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu_torch.wbc import types as T

    outs = []
    for rd, types in ((jax_robot(), JT), (port_robot(), T)):
        rd.AddTaskSpace(2, types.TASK_LINK_POSITION, rd.model.nbody)
        rd.AddTaskSpace(2, types.TASK_LINK_ROTATION, 22)
        rd.DeleteLink(20)
        outs.append(([(c.link, c.contact_type) for c in rd.cc_],
                     [[(tl.mode, tl.link) for tl in td.links] for td in rd.ts_]))
    assert outs[0] == outs[1]
    assert outs[1][1][2] == [(T.TASK_LINK_POSITION, outs[1][1][2][0][1])]


def test_rl_bridge_matches_jax():
    """RlWBCBridge from a MuJoCo-layout qpos: kinematics, contact, task
    space, then CalcTorque, twice (the second tick warm in the reference)."""
    from libdwbc_tpu import bridge as jb
    from libdwbc_tpu_torch import bridge as pb

    rng = np.random.default_rng(11)
    jbr = jb.RlWBCBridge()
    pbr = pb.RlWBCBridge(dtype=torch.float64, device="cpu", backend="torch")
    q = full_q(CASE_Q[2])
    for k in range(2):
        qpos = np.concatenate([q[0:3], [q[39]], q[3:6], q[6:39]])
        qpos[7:] += 0.01 * rng.standard_normal(33)
        qvel = 0.05 * rng.standard_normal(39)
        fs = [f + 0.1 * rng.standard_normal(f.shape) for f in CASE_FSTAR[2]]
        outs = []
        for br in (jbr, pbr):
            br.UpdateKinematics(qpos, qvel, np.zeros(39))
            br.SetContact(True, True)
            for h, f in enumerate(fs):
                br.SetTaskSpace(h, f)
            br.CalcTorque()
            outs.append((np.asarray(br.getTorqueCommand()), np_(br.rd_.torque_grav_)))
        (tj, gj), (tp, gp) = outs
        assert len(tp) == 33 and err(gp, gj) <= PRE_TOL
        # getTorqueCommand is float32, as the reference's
        assert err(tp, tj) <= 1e-4 + QP_TOL and err(pbr.rd_.GetControlTorque(),
                                                   jbr.rd_.GetControlTorque()) <= QP_TOL
        assert pbr.rd_.qp_error_ == 0 and not pbr._task_init
    pbr.Reset()
    assert pbr._task_init


def test_model_from_urdf_string_and_link_vectors():
    """LoadModelData on a URDF string and InitModelWithLinkJoint on
    link/joint vectors: the model and its kinematic state as the JAX
    facade's."""
    from libdwbc_tpu.model import compile as jc
    from libdwbc_tpu.wbc.robot import RobotData as JRobot
    from libdwbc_tpu_torch.model import compile as pc
    from libdwbc_tpu_torch.wbc.robot import RobotData
    from test_torch_model import URDF, _links, assert_models_equal

    rng = np.random.default_rng(3)
    for build_j, build_p in (
            (lambda r: r.LoadModelData(URDF, True, 0), lambda r: r.LoadModelData(URDF, True, 0)),
            (lambda r: r.InitModelWithLinkJoint(*_links(jc), name="vec"),
             lambda r: r.InitModelWithLinkJoint(*_links(pc), name="vec"))):
        jr, pr = JRobot(), RobotData(torch.float64, "cpu", "torch")
        build_j(jr)
        build_p(pr)
        assert_models_equal(jr.model, pr.model)
        n = pr.system_dof_
        q = np.zeros(n + 1)
        q[n] = 1.0
        q[6:n] = 0.3 * rng.standard_normal(n - 6)
        qd = 0.2 * rng.standard_normal(n)
        jr.UpdateKinematics(q, qd)
        pr.UpdateKinematics(q, qd)
        assert_close(state_fields(pr), state_fields(jr), PRE_TOL)
        assert pr.model_dof_ == jr.model_dof_ == n - 6


def test_contact_and_task_bookkeeping():
    """The setters: a duplicate contact ignored, names resolved, contact
    flags padded with False, friction ratios, merged task levels, an
    out-of-order level refused, custom-J tasks, clearing."""
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu_torch.wbc import types as T

    outs = []
    for rd, types in ((jax_robot(), JT), (port_robot(), T)):
        rd.AddContactConstraint(6, types.CONTACT_6D, [0, 0, 0], [0, 0, 1])
        rd.AddContactConstraint(rd.model.body_names[23], types.CONTACT_POINT, [0, 0, -0.1],
                                [0, 0, 1])
        rd.SetContact(True, False, True)
        rd.SetFrictionRatio(2, 0.5, 0.3)
        rd.AddTaskLink(1, types.TASK_LINK_POSITION, "L_Shoulder1_Link", [0.0, 0.1, 0.0])
        rd.AddTaskSpace(2, None, task_dof=4)
        with pytest.raises(ValueError):
            rd.AddTaskSpace(5, types.TASK_LINK_6D, 0)
        snap = ([(c.link, c.contact_type, c.active, c.friction_ratio, c.friction_ratio_z)
                 for c in rd.cc_], rd.contact_dof_,
                [(td.task_dof, [(tl.mode, tl.link, tuple(tl.task_point)) for tl in td.links])
                 for td in rd.ts_], rd.system_dof_, rd.model_dof_)
        rd.ClearContactConstraint()
        rd.ClearTaskSpace()
        outs.append((snap, len(rd.cc_), len(rd.ts_)))
    assert outs[0] == outs[1]
    assert outs[1][0][1] == 9 and outs[1][1:] == (0, 0)


def test_refusals_without_a_card():
    from libdwbc_tpu_torch.wbc.robot import RobotData

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RobotData()
    with pytest.raises(RuntimeError, match="CUDA"):
        RobotData(torch.float32, "cpu", "cuda")
    with pytest.raises(ValueError):
        RobotData(torch.float64, "cpu", "pallas")
