"""The port's on-device servo against the JAX package's, at float64 on the
CPU: the rotation and trajectory primitives, the servo law (batch-major
``servo_fstar`` and element-leading ``_servo_fstar_el``), the servo'd task
links' states of the plain prestage and the f* blend, one cold servo'd
fused tick (static, masked, and BASELINE's config 3: single support with a
swing-foot third level, every level servo'd), and the port's three servo'd tick
formulations against each other.  Also, at float32, the servo'd closed
loop's qp_error count against the JAX package's IPM recurrence.

The JAX references run eagerly in one module fixture (about 40 s): the
prestage with a servo request, its ``_apply_servos_el``, and a cold
25-iteration servo'd tick of the static and of the masked
``FusedTick(backend="xla")`` on B = 2 moving states, and one of config 3.
Tolerances: the
primitives and the servo law 1e-12, task states and blended f* 1e-10 (the
JAX package's own bar, tests/test_fused_servo.py), the cold tick 1e-8 (the
same recurrence), and across formulations the repository's policy (τ_grav
1e-8, τ_task 2e-3, τ_cmd 5e-2).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
B = 2
MASKS = np.array([[1, 1], [1, 0]], np.float64)
TAUS = ("torque_grav", "torque_task", "torque_cmd")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _rotations(rng, n):
    """n random rotations (n, 3, 3), float64."""
    from libdwbc_tpu_torch.kin.rotations import axis_angle_matrix

    ax = rng.standard_normal((n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    return axis_angle_matrix(torch.as_tensor(ax), torch.as_tensor(rng.uniform(-3.1, 3.1, n)))


def _branch_rotations():
    """Rotations that take each branch of matrix_to_quat: trace > 0, and
    the x-, y- and z-major candidates (3 rad about each axis)."""
    from libdwbc_tpu_torch.kin.rotations import axis_angle_matrix

    axes = torch.eye(3, dtype=torch.float64)
    R = axis_angle_matrix(axes, torch.full((3,), 3.0, dtype=torch.float64))
    small = axis_angle_matrix(torch.tensor([[0.6, 0.0, 0.8]], dtype=torch.float64),
                              torch.tensor([0.4], dtype=torch.float64))
    return torch.cat([small, R], 0)


def _model():
    from libdwbc_tpu_torch.model.compile import RobotModel

    return RobotModel.load(MODEL)


def _states():
    """B = 2 moving states: lane 0 is tests/test_fused_servo.py's (q̇[3] =
    0.05, q̇[8] = 0.1), lane 1 a perturbed pose with a seeded random q̇."""
    rng = np.random.default_rng(21)
    q = np.tile(full_q(CASE_Q[1]), (B, 1))
    q[1, 6:39] += 0.02 * rng.standard_normal(33)
    qd = np.zeros((B, 39))
    qd[0, 3], qd[0, 8] = 0.05, 0.1
    qd[1] = 0.05 * rng.standard_normal(39)
    return q, qd, tuple(np.tile(f, (B, 1)) for f in CASE_FSTAR[1])


def _jax_servos(q):
    """JAX servos (B = 2): a pelvis 6D servo to a 2 mm offset, its rotation
    turned 0.01 rad about z, the position error clamped at 1 mm and the
    angular velocity error at 0.02 (both active on lane 1), and a link-15
    rotation servo; lane 0 inside its trajectory, lane 1 past its end.
    Gentle gains keep the tick's QPs well conditioned: with a 2 cm step at
    gains 400 a float64 Gram pivot of lane 0's IPM collapses and the two
    packages end 1e-5 Nm apart in τ_task, which would measure roundoff."""
    from libdwbc_tpu.wbc.pipeline import make_servo
    from libdwbc_tpu_torch.entry import _link_frames
    from libdwbc_tpu_torch.kin.rotations import axis_angle_matrix

    p0, R0, R15 = (t.numpy() for t in _link_frames(_model(), q))
    turn = axis_angle_matrix(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                             torch.tensor(0.01, dtype=torch.float64)).numpy()
    t = np.array([0.05, 0.3])
    pelvis = make_servo(pos_init=p0, pos_des=p0 + [0.002, 0.0, 0.001], rot_init=R0,
                        rot_des=turn @ R0, t=t, t0=0.0, tf=0.2, pos_p=100.0, pos_d=10.0,
                        rot_p=100.0, rot_d=10.0, max_p_err=0.001,
                        max_d_err=[1.0, 1.0, 1.0, 0.02, 0.02, 0.02], dtype=jnp.float64)
    torso = make_servo(rot_init=R15, rot_des=R15, t=t, t0=0.0, tf=0.2, rot_p=50.0,
                       rot_d=5.0, dtype=jnp.float64)
    return ((pelvis,), (torso,))


def _jax_swing_servos(q):
    """Config 3's servos (B = 2): ``_jax_servos``'s pelvis and torso, and a
    swing-foot (link 12) servo lifting the foot 2 mm with its rotation held,
    at the same gentle gains and clocks."""
    from libdwbc_tpu.wbc.pipeline import make_servo
    from libdwbc_tpu_torch.kin.engine import Kinematics

    fk = Kinematics(_model()).fk(torch.as_tensor(q))
    pf, Rf = fk.p[:, 12].numpy(), fk.R[:, 12].numpy()
    swing = make_servo(pos_init=pf, pos_des=pf + [0.0, 0.0, 0.002], rot_init=Rf, rot_des=Rf,
                       t=np.array([0.05, 0.3]), t0=0.0, tf=0.2, pos_p=100.0, pos_d=10.0,
                       rot_p=100.0, rot_d=10.0, dtype=jnp.float64)
    return _jax_servos(q) + ((swing,),)


def _to_numpy(servos):
    return tuple(None if lvl is None else tuple(
        None if sp is None else sp._replace(**{f: np.asarray(getattr(sp, f))
                                               for f in sp._fields})
        for sp in lvl) for lvl in servos)


def _port_fused(masked=False, qp_iters=25, swing=False):
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = _model()
    cfg = standard_tocabi_config(m, qp_iters=qp_iters, both_feet=not swing, swing_task=swing)
    return FusedTick(m, cfg, "cpu", torch.float64, backend="torch", masked=masked)


@pytest.fixture(scope="module")
def ref():
    """The JAX references on the states of ``_states`` with the servos of
    ``_jax_servos`` (numpy out)."""
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    q, qd, fs = _states()
    servos = _jax_servos(q)
    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=25)
    ft = FusedTick(m, cfg, dtype=jnp.float64, backend="xla")
    sv_el = tuple(tuple({k: jnp.moveaxis(v, 0, -1) for k, v in d.items()} for d in lvl)
                  for lvl in ft._servos_batched(servos, B))
    pre = ft.prog.prestage(jnp.asarray(q.T), qdot=jnp.asarray(qd.T),
                           servo_req=((True,), (True,)))
    fs_el = ft.prog._apply_servos_el(pre, tuple(jnp.asarray(f.T) for f in fs), sv_el)
    out = dict(servos=_to_numpy(servos), fstars=[np.asarray(f) for f in fs_el],
               task_states={k: [np.asarray(t) for t in v] for k, v in pre["task_states"].items()})
    args = (jnp.asarray(q), jnp.asarray(qd), tuple(map(jnp.asarray, fs)))
    r = ft._tick_impl(*args, servos=servos)
    out["static"] = {k: np.asarray(getattr(r, k)) for k in TAUS}
    ftm = FusedTick(m, cfg, dtype=jnp.float64, backend="xla", masked=True)
    r = ftm._tick_impl(*args, jnp.asarray(MASKS), servos=servos)
    out["masked"] = {k: np.asarray(getattr(r, k)) for k in TAUS}
    swing = _jax_swing_servos(q)
    out["swing_servos"] = _to_numpy(swing)
    fts = FusedTick(m, standard_tocabi_config(m, both_feet=False, swing_task=True, qp_iters=25),
                    dtype=jnp.float64, backend="xla")
    r = fts._tick_impl(*args[:2], args[2] + (jnp.zeros((B, 6)),), servos=swing)
    out["swing"] = {k: np.asarray(getattr(r, k)) for k in TAUS}
    return out


# ------------------------------------------------------------ primitives
def _primitive_cases():
    rng = np.random.default_rng(5)
    R = torch.cat([_branch_rotations(), _rotations(rng, 6)], 0)
    R2 = _rotations(rng, R.shape[0])
    qa = torch.as_tensor(rng.standard_normal((R.shape[0], 4)))
    qa = qa / torch.linalg.vector_norm(qa, dim=-1, keepdim=True)
    qb = torch.as_tensor(rng.standard_normal((R.shape[0], 4)))
    qb = qb / torch.linalg.vector_norm(qb, dim=-1, keepdim=True)
    qb[0] = -qa[0] * (1.0 + 1e-12)            # d < 0 and below the small-angle cutoff
    qb[1] = qa[1] + 1e-10 * qb[1]             # below the cutoff, d > 0
    qb[1] = qb[1] / torch.linalg.vector_norm(qb[1])
    qb[2] = torch.where((qa[2] * qb[2]).sum() < 0, qb[2], -qb[2])   # d < 0
    s = torch.as_tensor(rng.uniform(0.0, 1.0, R.shape[0]))
    from libdwbc_tpu_torch.kin.rotations import axis_angle_matrix
    near = axis_angle_matrix(torch.tensor([[0.0, 0.6, 0.8]] * 3, dtype=torch.float64),
                             torch.tensor([1e-9, 1e-6, 0.0], dtype=torch.float64))
    return dict(R=R, R2=R2, qa=qa, qb=qb, s=s, Rlog=torch.cat([near, R], 0))


@pytest.mark.parametrize("name", ["matrix_to_quat", "quat_mul", "quat_slerp", "rotation_log",
                                  "get_phi", "quat_to_matrix"])
def test_rotation_primitives_match_jax(name):
    """Batch-major (kin/rotations.py) and element-leading (tick_kernel's
    _*_el) forms against kin/rotations.py of the JAX package, ≤ 1e-12."""
    from libdwbc_tpu.kin import rotations as jr
    from libdwbc_tpu_torch.kin import rotations as pr
    from libdwbc_tpu_torch.ops import tick_kernel as tk

    c = _primitive_cases()
    J = {k: jnp.asarray(v.numpy()) for k, v in c.items()}

    def el(x):                        # batch-major → element-leading
        return x.movedim(0, -1)

    def bm(x):                        # element-leading → batch-major
        return x.movedim(-1, 0)

    if name == "matrix_to_quat":
        want = jr.matrix_to_quat(J["R"])
        got = [pr.matrix_to_quat(c["R"]), bm(tk._matrix_to_quat_el(el(c["R"])))]
        # the four candidates are all taken
        tr = c["R"][:, 0, 0] + c["R"][:, 1, 1] + c["R"][:, 2, 2]
        assert bool((tr[0] > 0) & (tr[1:4] < 0).all())
    elif name == "quat_mul":
        want, got = jr.quat_mul(J["qa"], J["qb"]), [pr.quat_mul(c["qa"], c["qb"])]
    elif name == "quat_slerp":
        want = jr.quat_slerp(J["qa"], J["qb"], J["s"])
        got = [pr.quat_slerp(c["qa"], c["qb"], c["s"]),
               bm(tk._quat_slerp_el(el(c["qa"]), el(c["qb"]), c["s"]))]
    elif name == "rotation_log":
        want = jr.rotation_log(J["Rlog"])
        got = [pr.rotation_log(c["Rlog"]), bm(tk._rotation_log_el(el(c["Rlog"])))]
    elif name == "get_phi":
        want = jr.get_phi(J["R"], J["R2"])
        got = [pr.get_phi(c["R"], c["R2"]), bm(tk._get_phi_el(el(c["R"]), el(c["R2"])))]
    else:
        want = jr.quat_to_matrix(J["qa"])
        got = [pr.quat_to_matrix(c["qa"]), bm(tk._quat_to_matrix_el(el(c["qa"])))]
    for g in got:
        assert g.shape == want.shape
        assert _err(g, want) <= 1e-12, f"{name}: {_err(g, want):.3e}"


def test_quintic_spline_matches_jax():
    """utils/traj.py::quintic_spline and tick_kernel's _quintic_el against
    the JAX quintic, clocks before, inside and after [t0, tf]; errors
    relative to max(1, |value|) (the accelerations reach ~1e3)."""
    from libdwbc_tpu.utils.traj import quintic_spline as jq
    from libdwbc_tpu_torch.ops.tick_kernel import _quintic_el
    from libdwbc_tpu_torch.utils.traj import quintic_spline

    rng = np.random.default_rng(8)
    t = np.array([-0.1, 0.0, 0.05, 0.13, 0.2, 0.4])[:, None]
    x0, v0, a0, xf, vf, af = (rng.standard_normal((6, 3)) for _ in range(6))
    want = jq(*(jnp.asarray(a) for a in (t, 0.0, 0.2, x0, v0, a0, xf, vf, af)))
    got = quintic_spline(*(torch.as_tensor(a, dtype=torch.float64)
                           for a in (t, 0.0, 0.2, x0, v0, a0, xf, vf, af)))
    for g, w in zip(got, want):
        assert _err(g, w) / max(1.0, float(np.abs(w).max())) <= 1e-12
    want0 = jq(*(jnp.asarray(a) for a in (t, 0.0, 0.2, x0, v0, 0.0 * a0, xf, vf, 0.0 * af)))
    tt = torch.as_tensor(t[:, 0])
    got0 = _quintic_el(tt, torch.zeros_like(tt), torch.full_like(tt, 0.2),
                       *(torch.as_tensor(a.T) for a in (x0, v0, xf, vf)))
    for g, w in zip(got0, want0):
        assert _err(g.T, w) / max(1.0, float(np.abs(w).max())) <= 1e-12


def test_servo_fstar_matches_jax():
    """servo_fstar and _servo_fstar_el against the JAX servo law at six
    clocks (before, inside, after the trajectory) on random link states and
    gains, with the position and rotation error clamps active on half the
    lanes."""
    from libdwbc_tpu.wbc.pipeline import ServoParams as JServo
    from libdwbc_tpu.wbc.pipeline import servo_fstar as jfstar
    from libdwbc_tpu_torch.convert import servos_from_numpy
    from libdwbc_tpu_torch.ops.tick_kernel import _servo_fstar_el
    from libdwbc_tpu_torch.wbc.pipeline import servo_fstar

    rng = np.random.default_rng(13)
    n = 6
    clamp = np.where(np.arange(n)[:, None] % 2 == 0, 0.05, np.inf) * np.ones((n, 6))
    fields = dict(
        t=np.array([-0.05, 0.0, 0.07, 0.15, 0.3, 0.31]), t0=np.zeros(n), tf=np.full(n, 0.3),
        rot_init=_rotations(rng, n).numpy(), rot_des=_rotations(rng, n).numpy(),
        pos_p=rng.uniform(100, 400, (n, 3)), pos_d=rng.uniform(10, 40, (n, 3)),
        pos_a=np.ones((n, 3)), rot_p=rng.uniform(100, 400, (n, 3)),
        rot_d=rng.uniform(10, 40, (n, 3)), max_p_err=clamp, max_d_err=clamp * 10,
        use_pos=np.ones(n), use_rot=np.ones(n))
    for k in ("pos_init", "vel_init", "pos_des", "vel_des", "w_init", "w_des"):
        fields[k] = rng.standard_normal((n, 3))
    sp_np = JServo(**fields)
    state = [rng.standard_normal((n, 3)), rng.standard_normal((n, 3)),
             _rotations(rng, n).numpy(), rng.standard_normal((n, 3))]
    want = np.asarray(jfstar(JServo(**{k: jnp.asarray(v) for k, v in fields.items()}),
                             *(jnp.asarray(a) for a in state)))
    psp = servos_from_numpy(((sp_np,),))[0][0]
    got = servo_fstar(psp, *(torch.as_tensor(a) for a in state))
    assert _err(got, want) <= 1e-12
    got_el = _servo_fstar_el({k: getattr(psp, k).movedim(0, -1) for k in psp._fields},
                             *(torch.as_tensor(a).movedim(0, -1) for a in state))
    assert _err(got_el.movedim(-1, 0), want) <= 1e-12
    # the clamps were active: the unclamped law differs on those lanes
    free = servo_fstar(psp._replace(max_p_err=torch.full((n, 6), np.inf),
                                    max_d_err=torch.full((n, 6), np.inf)),
                       *(torch.as_tensor(a) for a in state))
    assert _err(free[0::2], got[0::2]) > 1e-3


# ---------------------------------------------- task states and the blend
def test_task_states_and_blend_match_jax(ref):
    """The plain prestage's servo'd task-link states (per-body velocity
    chain of a moving base) and _apply_servos_el's f* against the JAX
    prestage(servo_req) and _apply_servos_el, ≤ 1e-10."""
    from libdwbc_tpu_torch.convert import servos_from_numpy

    q, qd, fs = _states()
    tick = _port_fused()
    prog = tick.prog
    servos = servos_from_numpy(ref["servos"])
    sv_el = tick._servos_el(servos, B)
    pre = prog.prestage(torch.as_tensor(q.T.copy()), qdot=torch.as_tensor(qd.T.copy()),
                        servo_req=prog.servo_request(sv_el))
    for key, want in ref["task_states"].items():
        for g, w in zip(pre["task_states"][key], want):
            assert _err(g, w) <= 1e-10, key
    got = prog._apply_servos_el(pre, [torch.as_tensor(f.T.copy()) for f in fs], sv_el)
    for g, w in zip(got, ref["fstars"]):
        assert _err(g, w) <= 1e-10


def test_apply_servos_matches_jax_pipeline(ref):
    """The batch-major _apply_servos of CompiledTick (on the port's
    kinematics) against the JAX pipeline._apply_servos on the same state,
    and against the element-leading blend, ≤ 1e-10."""
    from libdwbc_tpu.wbc import pipeline as jp
    from libdwbc_tpu_torch.convert import servos_from_numpy
    from libdwbc_tpu_torch.wbc import pipeline as pp
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, standard_tocabi_config

    q, qd, fs = _states()
    m = _model()
    cfg = standard_tocabi_config(m)
    ct = CompiledTick(m, cfg, "cpu", torch.float64, backend="torch")
    st = ct.kin.update(torch.as_tensor(q), torch.as_tensor(qd))
    jst = st._replace(**{k: jnp.asarray(v.numpy()) for k, v in st._asdict().items()
                         if isinstance(v, torch.Tensor)})
    servos = servos_from_numpy(ref["servos"])
    for h in range(2):
        got = pp._apply_servos(m, cfg, torch.float64, st, h, torch.as_tensor(fs[h]), servos[h])
        want = jp._apply_servos(m, cfg, jnp.float64, jst, h, jnp.asarray(fs[h]),
                                ref["servos"][h])
        assert _err(got, want) <= 1e-10
        assert _err(got, ref["fstars"][h].T) <= 1e-10


# ------------------------------------------------------- servo'd ticks
@pytest.mark.parametrize("mode", ["static", "masked", "swing"])
def test_servo_fused_tick_matches_jax(ref, mode):
    """One cold 25-iteration servo'd tick of the plain FusedTick against
    FusedTick(backend="xla"), B = 2 moving states: τ ≤ 1e-8.  swing: config
    3 (single support, every level servo'd, the swing foot lifted)."""
    from libdwbc_tpu_torch.convert import servos_from_numpy

    q, qd, fs = _states()
    tick = _port_fused(masked=mode == "masked", swing=mode == "swing")
    if mode == "swing":
        fs = fs + (np.zeros((B, 6)),)
    args = (q, qd, fs) + ((MASKS,) if mode == "masked" else ())
    servos = ref["swing_servos" if mode == "swing" else "servos"]
    r = tick._tick_impl(*args, servos=servos_from_numpy(servos))
    if mode == "swing":
        assert not bool(r.qp_error.any())
    for k in TAUS:
        assert _err(getattr(r, k), ref[mode][k]) <= 1e-8, (k, _err(getattr(r, k), ref[mode][k]))


def _gentle():
    """tests/test_fused_servo.py:88-101: the standing state at rest, a 2 mm
    pelvis step at gains 100, the torso held."""
    from libdwbc_tpu_torch.entry import _link_frames
    from libdwbc_tpu_torch.wbc.pipeline import make_servo

    q = full_q(CASE_Q[1])[None]
    p0, R0, R15 = _link_frames(_model(), q)
    pelvis = make_servo(pos_init=p0[0], pos_des=p0[0] + torch.tensor([0.002, 0.0, 0.001],
                                                                   dtype=torch.float64),
                        rot_init=R0[0], rot_des=R0[0], t=0.05, t0=0.0, tf=0.2, pos_p=100.0,
                        pos_d=10.0, rot_p=100.0, rot_d=10.0, max_p_err=0.1,
                        dtype=torch.float64)
    torso = make_servo(rot_init=R15[0], rot_des=R15[0], t=0.05, t0=0.0, tf=0.2, rot_p=50.0,
                       rot_d=5.0, dtype=torch.float64)
    return q[0], np.zeros(39), (np.zeros(6), np.zeros(3)), ((pelvis,), (torso,))


@pytest.mark.parametrize("cls", ["CompiledTick", "MaskedTick"])
def test_servo_formulations_agree(cls):
    """The port's CompiledTick(servos=) and MaskedTick(servos=) against its
    servo'd FusedTick at the gentle state: τ_grav 1e-8, τ_task 2e-3, τ_cmd
    5e-2, primal residual < 1e-9."""
    from libdwbc_tpu_torch.wbc.masked import MaskedTick
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, standard_tocabi_config

    q, qd, fs, servos = _gentle()
    m = _model()
    cfg = standard_tocabi_config(m, qp_iters=25)
    if cls == "CompiledTick":
        other = CompiledTick(m, cfg, "cpu", torch.float64, backend="torch")
        ro, rf = (other._tick_impl(q, qd, fs, servos=servos),
                  _port_fused()._tick_impl(q, qd, fs, servos=servos))
    else:
        other = MaskedTick(m, cfg, "cpu", torch.float64, backend="torch")
        mask = np.ones(2)
        ro, rf = (other._tick_impl(q, qd, fs, mask, servos=servos),
                  _port_fused(masked=True)._tick_impl(q, qd, fs, mask, servos=servos))
    assert _err(rf.torque_grav, ro.torque_grav) < 1e-8
    assert _err(rf.torque_task, ro.torque_task) < 2e-3
    assert _err(rf.torque_cmd, ro.torque_cmd) < 5e-2
    assert float(rf.qp_primal_res) < 1e-9 and float(ro.qp_primal_res) < 1e-9
    # the servo moved the task torque off the caller's zero f*
    r0 = _port_fused()._tick_impl(q, qd, fs)
    assert _err(rf.torque_task, r0.torque_task) > 1e-2


def test_float32_servo_loop_flags_fewer_than_jax_recurrence():
    """chip_smoke.py's servo'd closed loop (entry._tracking_inputs: each
    lane's pelvis steps 1 cm over 0.12 s, the torso held; K = 150 at dt =
    1 ms, warm ticks at 7 iterations, gap_fallback 1e-3) on 8 lanes of the
    plain float32 FusedTick against the same loop on the JAX package's IPM
    recurrence (hold_lost_pivots=False), which steps from the clamped
    factor of a Gram that lost a pivot and leaves QPs on active
    constraints unsolved: no more lane-ticks flagged with qp_error, no
    larger primal residual, and every lane's pelvis error halved."""
    from libdwbc_tpu_torch.entry import _link_frames, _tracking_inputs
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import forward_dynamics_transition, make_control_loop
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, standard_tocabi_config

    m = _model()
    cfg = standard_tocabi_config(m, qp_iters=12)
    q, qd, fs, servos, target = _tracking_inputs(m, 8, dtype=np.float64)
    trans = forward_dynamics_transition(CompiledTick(m, cfg, "cpu", torch.float32,
                                                     backend="torch"))
    runs = {}
    for hold in (True, False):
        tick = FusedTick(m, cfg, "cpu", torch.float32, backend="torch")
        tick.prog.hold_lost_pivots = hold
        loop = make_control_loop(tick, transition=trans, K=150, dt=1e-3, warm_start=True,
                                 warm_iters=7, gap_fallback=1e-3)
        runs[hold] = loop(q, qd, fs, servos=servos)
        print(f"float32 servo'd loop, 8 lanes, hold_lost_pivots={hold}: refined ticks "
              f"{runs[hold].refined_ticks}, qp_error lane-ticks {int(runs[hold].qp_error.sum())}"
              f", primal residual max {float(runs[hold].qp_primal_res.max()):.3e}")
    port, jax_rec = runs[True], runs[False]
    assert int(port.qp_error.sum()) <= int(jax_rec.qp_error.sum())
    assert float(port.qp_primal_res.max()) <= float(jax_rec.qp_primal_res.max())
    assert torch.isfinite(port.torques).all()
    p0 = _link_frames(m, q)[0].numpy()
    pf = _link_frames(m, port.q_final.double().numpy())[0].numpy()
    ratio = np.linalg.norm(pf - target, axis=1) / np.linalg.norm(p0 - target, axis=1)
    assert (ratio < 0.5).all(), ratio


def test_make_servo_and_servos_from_numpy_match_jax():
    """make_servo's defaults are the JAX ones (+inf clamps, identity
    rotations, a half without its target switched off), and
    servos_from_numpy carries JAX servos across unchanged, None entries
    included."""
    from libdwbc_tpu.wbc.pipeline import make_servo as jmake
    from libdwbc_tpu_torch.convert import servos_from_numpy
    from libdwbc_tpu_torch.wbc.pipeline import make_servo

    for kw in (dict(pos_des=np.array([0.1, 0.2, 0.3])), dict(rot_des=np.eye(3), rot_p=50.0),
               dict(pos_init=np.array([1.0, 0, 0]), pos_des=np.array([0, 1.0, 0]),
                    max_p_err=0.2, t=0.3)):
        want = jmake(dtype=jnp.float64, **kw)
        got = make_servo(dtype=torch.float64, **kw)
        for f in want._fields:
            w, g = np.asarray(getattr(want, f)), _np(getattr(got, f))
            assert g.shape == w.shape and np.array_equal(g, w), f
    js = ((jmake(pos_des=np.array([0.1, 0, 0]), dtype=jnp.float64),), None,
          (None, jmake(rot_des=np.eye(3), max_d_err=1.0, dtype=jnp.float64)))
    back = servos_from_numpy(_to_numpy(js))
    assert back[1] is None and back[2][0] is None
    for jl, pl in ((js[0][0], back[0][0]), (js[2][1], back[2][1])):
        for f in jl._fields:
            assert np.array_equal(_np(getattr(pl, f)), np.asarray(getattr(jl, f))), f
    assert np.isinf(_np(back[0][0].max_p_err)).all()
