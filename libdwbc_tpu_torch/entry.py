"""Serving entry points of the port: the flagship tick (fused or compiled,
static or masked) and its example inputs (counterparts of
``__graft_entry__._model_and_tick`` and ``_example_inputs``).

The flagship is the 33-DoF Tocabi (``models/tocabi.npz``) standing in
double support with 6D feet on links 6 and 12, a 6D pelvis task over a
rotation task on link 15, torques limited to ±300 Nm.  Its masked form
takes the two feet as a candidate set and one support hypothesis per
scenario (``_masked_inputs``: the 4096-scenario sweep of
``benchmarks/masked_bench.py``).  Its servo'd form drives both task levels
by the on-device trajectory-PD servo (``_servo_inputs``: moving states
with per-lane targets and clocks; ``_tracking_inputs``: a standing robot
whose pelvis steps 1 cm, for the closed loop).

BASELINE's config 3 is single support with a swing-foot third level:
``standard_tocabi_config(model, both_feet=False, swing_task=True)``, the left
foot (link 6) down, a 6D pelvis task, a rotation task on link 15 and a 6D
task on the right foot (link 12); ``_model_and_tick(swing=True)`` serves
it.  Its inputs: ``_swing_inputs`` (the standing state with joint noise)
and ``_swing_servo_inputs`` (every level servo'd: pelvis and torso held,
the swing foot lifted).

``_model_and_tick(reduced=True)`` serves either configuration through
``ReducedTick``, the reduced-dimension tick (the reference's ``_R`` path):
the legs in contact form the contact chain, the rest is lumped into one
virtual body.  On the flagship its QPs are (12, 44), (12, 44) and (6, 44);
on config 3, (6, 22) twice.

The hands-and-feet configuration is the reference's own four-contact
fixture (dwbc_test.cpp:66-71): the flagship's 6D feet and tasks, and POINT
contacts on the hands, links 23 and 31 — a humanoid bracing on a table or
a rail (``_hands_feet_config``).  Its inputs: ``_hands_feet_inputs`` (the
standing state with joint noise) and ``_hands_masked_inputs`` (the four
contacts as candidates, a support hypothesis per scenario).

The controller facade (``wbc/robot.py::RobotData``) serves the flagship and
config 3 one robot at a time: ``_facade`` builds it, ``_facade_cases``
gives the reference unit tests' two standing cases and ``_facade_set``
feeds one into it.

``dryrun_multichip`` (counterpart of ``__graft_entry__.dryrun_multichip``)
runs one sharded step of the scenario mesh (``parallel/mesh.py``) on n
ranks: NCCL with a card per rank, or gloo processes with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .kin.engine import Kinematics
from .kin.rotations import axis_angle_matrix
from .model.compile import RobotModel
from .wbc import types as T
from .wbc.fused import FusedTick
from .wbc.pipeline import CompiledTick, make_servo, standard_tocabi_config
from .wbc.reduced_tick import ReducedTick

MODEL_PATH = Path(__file__).resolve().parent.parent / "models" / "tocabi.npz"


def _model_and_tick(device=None, dtype=torch.float32, qp_iters=12, backend="cuda",
                    fused=True, masked=False, reduced=False, swing=False):
    """(model, tick) for the flagship configuration: ``FusedTick`` when
    ``fused``, else ``CompiledTick`` (as the JAX entry returns off the TPU);
    ``masked`` gives ``FusedTick(masked=True)``, whose calls take a contact
    mask over the two feet; ``reduced`` gives ``ReducedTick``, the
    reduced-dimension tick.  ``swing`` serves BASELINE's config 3 instead
    of the flagship (inputs: ``_swing_inputs``).  ``device`` defaults to
    the card; pass "cpu" (with backend="torch") for the plain version on
    the CPU."""
    model = RobotModel.load(str(MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=qp_iters, both_feet=not swing,
                                 swing_task=swing)
    device = "cuda" if device is None else device
    if reduced:
        return model, ReducedTick(model, cfg, device, dtype=dtype, backend=backend)
    if masked:
        return model, FusedTick(model, cfg, device, dtype=dtype, backend=backend,
                                masked=True)
    cls = FusedTick if fused else CompiledTick
    return model, cls(model, cfg, device=device, dtype=dtype, backend=backend)


def _example_inputs(model, dtype=np.float32):
    """A standing q, zero q̇ and one f* per task level (numpy)."""
    q = np.zeros(model.nq, dtype=dtype)
    q[2] = 0.92983
    q[model.nq - 1] = 1.0
    joints = np.array(
        [0, 0, -0.24, 0.6, -0.36, 0] * 2
        + [0, 0, 0]
        + [0.3, 0.3, 1.5, -1.27, -1, 0, -1, 0]
        + [0, 0]
        + [-0.3, -0.3, -1.5, 1.27, 1, 0, 1, 0],
        dtype=dtype,
    )
    q[6 : 6 + 33] = joints
    qdot = np.zeros(model.ndof, dtype=dtype)
    fstars = (
        np.array([0.1, 0.5, 0.1, 0.1, -0.1, 0.1], dtype=dtype),
        np.array([0.1, -0.1, 0.1], dtype=dtype),
    )
    return q, qdot, fstars


def _masked_inputs(model, B=4096, seed=0):
    """The masked sweep's inputs (numpy float32): B standing states with legs
    [0, 0, −0.24, 0.6, −0.36, 0]×2, zero arms and 0.02·N(0,1) on the
    joints, zero q̇, f* = ([0.1, 0.3, 0.1, 0, 0, 0], [0.05, 0, 0]) on every
    lane, and the support hypotheses both feet, left, right cycled over the
    lanes (``benchmarks/masked_bench.py:64-81``)."""
    rng = np.random.default_rng(seed)
    q = np.zeros(model.nq, np.float32)
    q[2] = 0.92983
    q[model.ndof] = 1.0
    q[6:18] = np.array([0, 0, -0.24, 0.6, -0.36, 0] * 2, np.float32)
    qs = np.tile(q, (B, 1))
    qs[:, 6:6 + model.model_dof] += 0.02 * rng.standard_normal(
        (B, model.model_dof)).astype(np.float32)
    qds = np.zeros((B, model.ndof), np.float32)
    fstars = (np.tile(np.array([0.1, 0.3, 0.1, 0, 0, 0], np.float32), (B, 1)),
              np.tile(np.array([0.05, 0, 0], np.float32), (B, 1)))
    masks = np.array([[1, 1], [1, 0], [0, 1]], np.float32)[np.arange(B) % 3]
    return qs, qds, fstars, masks


def _link_frames(model, q):
    """(pelvis position (B, 3), pelvis rotation (B, 3, 3), link-15 rotation
    (B, 3, 3)) of the states q (B, nq), in float64."""
    fk = Kinematics(model).fk(torch.as_tensor(np.asarray(q, np.float64)))
    return fk.p[:, 0], fk.R[:, 0], fk.R[:, 15]


def _mixed_tasks_config(model, cfg):
    """cfg with a task set of the general plans beside the flagship's: a
    whole-body COM 6D level (``link == nbody``), a custom-frame position
    task on link 15 and a rotation task on link 31 in one level, and a
    COM-frame position task on link 27 (the mixed variant's tasks in the
    port's tests)."""
    tasks = (((T.TASK_LINK_6D, model.nbody),),
             ((T.TASK_LINK_POSITION_CUSTOM_FRAME, 15, np.array([0.1, 0.0, 0.2])),
              (T.TASK_LINK_ROTATION, 31)),
             ((T.TASK_LINK_POSITION_COM_FRAME, 27),))
    return dataclasses.replace(cfg, task_specs=tasks)


def _hands_feet_config(model, hand_type=T.CONTACT_POINT):
    """The flagship with hand contacts of ``hand_type`` beside its 6D feet:
    feet on links 6 and 12 (plane 0.15 × 0.075), hands on links 23 and 31
    (plane 0.04 × 0.04), every contact at [0.03, 0, −0.1585] in its link's
    frame with the normal +z, a cold budget of 25 IPM iterations
    (tests/test_contacts_non6d.py:20-40); the flagship's two task levels and
    ±300 Nm."""
    cfg = standard_tocabi_config(model, qp_iters=25)
    hands = tuple(dataclasses.replace(cfg.contacts[0], link=link, contact_type=hand_type,
                                      plane_x=0.04, plane_y=0.04) for link in (23, 31))
    return dataclasses.replace(cfg, contacts=cfg.contacts + hands)


def _hands_feet_inputs(model, B=1024, seed=0, dtype=np.float32):
    """The hands-and-feet configuration's serving inputs (numpy, ``dtype``):
    ``_swing_inputs``' states — the standing q with 0.02·N(0,1) on the
    joints, zero q̇ — and the flagship's pelvis and torso f* + 0.05·N(0,1)
    per lane."""
    q, qd, fs = _swing_inputs(model, B, seed, dtype)
    return q, qd, fs[:2]


# the masked hands-and-feet sweep's support hypotheses over (left foot,
# right foot, left hand (link 23), right hand (link 31)), cycled over the lanes
HANDS_HYPOTHESES = ("feet", "feet + left hand", "feet + right hand", "feet + both hands")
HANDS_MASKS = np.array([[1, 1, 0, 0], [1, 1, 1, 0], [1, 1, 0, 1], [1, 1, 1, 1]], np.float32)


def _hands_masked_inputs(model, B=4096, seed=0):
    """The masked hands-and-feet sweep's inputs (numpy float32): the four
    contacts of ``_hands_feet_config`` as candidates, ``_hands_feet_inputs``'
    states and f*, and the hypotheses HANDS_HYPOTHESES cycled over the
    lanes."""
    q, qd, fs = _hands_feet_inputs(model, B, seed)
    return q, qd, fs, HANDS_MASKS[np.arange(B) % len(HANDS_MASKS)]


def _swing_inputs(model, B=1024, seed=0, dtype=np.float32):
    """Config 3's serving inputs (numpy, ``dtype``): the standing q (the
    joints of the repo's test case 1) with 0.02·N(0,1) on the joints, zero
    q̇, and f* per level — the flagship's pelvis and torso f* and a zero
    swing-foot f* — each + 0.05·N(0,1) per lane."""
    rng = np.random.default_rng(seed)
    q0, qd0, f0 = _example_inputs(model, np.float64)
    q = np.tile(q0, (B, 1))
    q[:, 6:6 + model.model_dof] += 0.02 * rng.standard_normal((B, model.model_dof))
    fs = tuple(np.tile(f, (B, 1)) + 0.05 * rng.standard_normal((B, f.shape[0]))
               for f in f0 + (np.zeros(6),))
    return (q.astype(dtype), np.tile(qd0, (B, 1)).astype(dtype),
            tuple(f.astype(dtype) for f in fs))


def _swing_servo_inputs(model, B=1024, seed=0, noise=1e-3, lift=0.015, tf=0.15,
                        dtype=np.float32):
    """Config 3's servo'd closed loop (numpy q, q̇, f*; servos): B robots at
    rest in the standing q with noise·N(0,1) on the joints; every level
    servo'd from each lane's own frames at t = 0 — the pelvis held (gains
    400 / 40, tf 0.01), link 15's rotation held (100 / 20, tf 0.01), and
    the right foot (link 12) lifted by ``lift`` m over [0, tf] with its
    rotation held (400 / 40).  Returns also the swing foot's start (B, 3)
    and the pelvis's (B, 3)."""
    rng = np.random.default_rng(seed)
    q0, qd0, _ = _example_inputs(model, np.float64)
    q = np.tile(q0, (B, 1))
    q[:, 6:6 + model.model_dof] += noise * rng.standard_normal((B, model.model_dof))
    fk = Kinematics(model).fk(torch.as_tensor(q))
    p0, R0, R15, pf, Rf = fk.p[:, 0], fk.R[:, 0], fk.R[:, 15], fk.p[:, 12], fk.R[:, 12]
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype
    pelvis = make_servo(pos_init=p0, pos_des=p0, rot_init=R0, rot_des=R0, t0=0.0, tf=0.01,
                        pos_p=400.0, pos_d=40.0, rot_p=400.0, rot_d=40.0, dtype=tdt)
    torso = make_servo(rot_init=R15, rot_des=R15, t0=0.0, tf=0.01, rot_p=100.0, rot_d=20.0,
                       dtype=tdt)
    swing = make_servo(pos_init=pf, pos_des=pf + torch.tensor([0.0, 0.0, lift],
                                                              dtype=torch.float64),
                       rot_init=Rf, rot_des=Rf, t0=0.0, tf=tf, pos_p=400.0, pos_d=40.0,
                       rot_p=400.0, rot_d=40.0, dtype=tdt)
    fs = tuple(np.zeros((B, t), dtype) for t in (6, 3, 6))
    return (q.astype(dtype), np.tile(qd0, (B, 1)).astype(dtype), fs,
            ((pelvis,), (torso,), (swing,)), pf.numpy(), p0.numpy())


def _servo_inputs(model, B=1024, seed=0, dtype=np.float32):
    """The servo'd flagship's inputs (q, q̇, f* in numpy, servos as
    ``ServoParams`` of CPU tensors), all in ``dtype``: the standing q with
    0.02·N(0,1) on the joints and q̇ = 0.05·N(0,1) on all dofs (the base
    moves); a pelvis 6D servo (level 0) to a per-lane target, its position
    p₀ + U[−0.02, 0.02]³ and its rotation R₀ turned about z by U[−0.05,
    0.05] rad, gains 400 / 40, position error clamped at 0.1; a rotation
    servo of link 15 (level 1) holding its rotation, gains 200 / 20; the
    trajectories over t0 = 0, tf = 0.2 and a per-lane clock t in
    U[−0.05, 0.25], so lanes sit before, inside and after them."""
    rng = np.random.default_rng(seed)
    q0, _, f0 = _example_inputs(model, np.float64)
    q = np.tile(q0, (B, 1))
    q[:, 6:6 + model.model_dof] += 0.02 * rng.standard_normal((B, model.model_dof))
    qd = 0.05 * rng.standard_normal((B, model.ndof))
    fs = tuple(np.tile(f, (B, 1)) + 0.05 * rng.standard_normal((B, f.shape[0])) for f in f0)
    p0, R0, R15 = _link_frames(model, q)
    turn = axis_angle_matrix(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                             torch.as_tensor(rng.uniform(-0.05, 0.05, B)))
    t = torch.as_tensor(rng.uniform(-0.05, 0.25, B))
    dp = torch.as_tensor(rng.uniform(-0.02, 0.02, (B, 3)))
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype
    pelvis = make_servo(pos_init=p0, pos_des=p0 + dp, rot_init=R0, rot_des=turn @ R0,
                        t=t, t0=0.0, tf=0.2, pos_p=400.0, pos_d=40.0, rot_p=400.0,
                        rot_d=40.0, max_p_err=0.1, dtype=tdt)
    torso = make_servo(rot_init=R15, rot_des=R15, t=t, t0=0.0, tf=0.2, rot_p=200.0,
                       rot_d=20.0, dtype=tdt)
    return (q.astype(dtype), qd.astype(dtype), tuple(f.astype(dtype) for f in fs),
            ((pelvis,), (torso,)))


def _tracking_inputs(model, B=1024, step=0.01, tf=0.12, dtype=np.float32):
    """The closed loop's inputs (q, q̇, f* in numpy, servos): B standing
    robots at rest, lane b's pelvis servo'd to a ``step`` m move in the
    horizontal direction 2πb/B over [0, tf] (gains 400 / 40, rotation
    held), link 15's rotation held (gains 100 / 20, tf 0.01).  Returns also
    the pelvis targets (B, 3)."""
    q0, qd0, f0 = _example_inputs(model, np.float64)
    q, qd = np.tile(q0, (B, 1)), np.tile(qd0, (B, 1))
    fs = tuple(np.zeros((B, f.shape[0])) for f in f0)
    p0, R0, R15 = _link_frames(model, q)
    phi = 2.0 * np.pi * np.arange(B) / B
    target = p0 + step * torch.as_tensor(np.stack([np.cos(phi), np.sin(phi), 0.0 * phi], 1))
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype
    pelvis = make_servo(pos_init=p0, pos_des=target, rot_init=R0, rot_des=R0, t0=0.0, tf=tf,
                        pos_p=400.0, pos_d=40.0, rot_p=400.0, rot_d=40.0, dtype=tdt)
    torso = make_servo(rot_init=R15, rot_des=R15, t0=0.0, tf=0.01, rot_p=100.0, rot_d=20.0,
                       dtype=tdt)
    return (q.astype(dtype), qd.astype(dtype), tuple(f.astype(dtype) for f in fs),
            ((pelvis,), (torso,)), target.numpy())


# The reference unit tests' standing cases (tests/dwbc_test.cpp:29-260),
# the joints and f* per level that the facade's tests drive.
FACADE_JOINTS = {
    1: [0, 0, -0.24, 0.6, -0.36, 0] * 2 + [0, 0, 0] + [0.3, 0.3, 1.5, -1.27, -1, 0, -1, 0]
       + [0, 0] + [-0.3, -0.3, -1.5, 1.27, 1, 0, 1, 0],
    2: [0.1, 0, -0.24, 0.5, -0.6, 0] + [0.05, 0, -0.21, 0.7, -0.31, 0] + [0, 0, 0]
       + [0.2, 0.5, 1.5, -1.27, -1.2, 0, -1, 0] + [0, 0]
       + [-0.3, -0.3, -1.5, 1.27, 1.3, 0.1, 1.3, 0],
}
FACADE_FSTAR = {
    1: ([0.1, 4.0, 0.1, 0.1, -0.1, 0.1], [0.1, -0.1, 0.1]),
    2: ([0.4, 2.0, 0.1, 0.3, -0.1, 0.1], [0.1, 0.1, 0.1]),
}
# config 3's swing-foot f* in the facade's cases (the facade tests' seeded one)
SWING_FSTAR = np.random.default_rng(9).uniform(-0.2, 0.2, 6)


def _facade_cases(swing=False):
    """{case: (q (40,), q̇ (39,), f* per level)} of the facade's standing
    cases, numpy float64: the pelvis at height 0.92983, zero q̇; config 3
    (``swing``) adds the swing-foot f*."""
    out = {}
    for case, joints in FACADE_JOINTS.items():
        q = np.zeros(40)
        q[2], q[39] = 0.92983, 1.0
        q[6:39] = joints
        fs = tuple(np.array(f, np.float64) for f in FACADE_FSTAR[case])
        out[case] = (q, np.zeros(39), fs + ((SWING_FSTAR,) if swing else ()))
    return out


def _facade(dtype=torch.float32, device=None, backend="cuda", swing=False):
    """(RobotData, contact flags) in the flagship's configuration
    (``bridge._standard_robot``), or config 3's: the left foot down and a 6D
    task on the right foot as the third level."""
    from .bridge import _standard_robot

    rd = _standard_robot(dtype=dtype, device=device, backend=backend)
    if swing:
        rd.AddTaskSpace(2, T.TASK_LINK_6D, 12, np.zeros(3))
    return rd, (True, not swing)


def _facade_set(rd, flags, q, qd, fstars):
    """One tick's inputs into a facade: the state, the contacts, f* per level."""
    rd.UpdateKinematics(q, qd)
    rd.SetContact(*flags)
    for h, f in enumerate(fstars):
        rd.SetTaskSpace(h, f)


# ---------------------------------------------------------------------------
# The multi-card dry run (counterpart of __graft_entry__.py:64-208)
# ---------------------------------------------------------------------------

def _grid_inputs(model, H, R, seed=0, dtype=np.float32):
    """The dry run's (H, R) scenario grid (numpy, ``dtype``): the standing
    state with 0.01·N(0,1) on the joints, zero q̇, the example f* on every
    scenario."""
    q, _, fstars = _example_inputs(model, np.float64)
    rng = np.random.default_rng(seed)
    qs = np.tile(q, (H, R, 1))
    qs[..., 6:6 + model.model_dof] += 0.01 * rng.standard_normal((H, R, model.model_dof))
    return (qs.astype(dtype), np.zeros((H, R, model.ndof), dtype),
            tuple(np.tile(f, (H, R, 1)).astype(dtype) for f in fstars))


def _rt_state(model, period_us):
    """The real-time loop's producer state of tick t, as a function, in
    ``native.TickConsumer``'s layout: the standing q with each joint moved
    by 0.02·sin(ωt + j) (one period every 2,000 ticks), its q̇, the example
    f* moved by 0.05·cos(ωt + level), and t itself."""
    q0, qd0, fs0 = _example_inputs(model, np.float64)
    md = model.model_dof
    phase = np.arange(md)
    w = 2.0 * np.pi / 2000.0

    def state_at(t):
        q = q0.copy()
        q[6:6 + md] += 0.02 * np.sin(w * t + phase)
        qd = qd0.copy()
        qd[6:6 + md] = 0.02 * w / (period_us * 1e-6) * np.cos(w * t + phase)
        return np.concatenate([q, qd] + [f + 0.05 * np.cos(w * t + i) for i, f in
                                         enumerate(fs0)] + [[float(t)]])

    return state_at


def _grid_solve(mesh, grid, dtype=torch.float32, qp_iters=6):
    """One rank's part of a CompiledTick grid solved by ``sharded_batch_solver``
    over ``mesh`` (plain on the CPU, ``backend="cuda"`` on the card): the
    rank makes its block through ``host_local_scenarios`` (held equal to
    ``shard_scenarios``' cut of the full grid), solves it and gathers the
    grid's τ_cmd.  grid: the full (q, q̇, f*) in numpy.  Returns (on every
    rank) τ_cmd (H, R, m) on the CPU, the best scenario, its cost, and the
    mesh slices each rank's ``make_local`` was handed."""
    import torch.distributed as dist

    from .parallel.mesh import (gather_grid, host_local_scenarios, shard_scenarios,
                                sharded_batch_solver)

    dev = mesh.device
    model, tick = _model_and_tick(dev, dtype, qp_iters=qp_iters, fused=False,
                                  backend="cuda" if dev.type == "cuda" else "torch")
    q, qd, fs = grid
    H, R = q.shape[:2]
    hb, rb = H // mesh.shape["hyp"], R // mesh.shape["roll"]
    handed = []

    def make_local(h_sl, r_sl):
        handed.append((h_sl.start, h_sl.stop, r_sl.start, r_sl.stop))
        rows, cols = slice(h_sl.start * hb, h_sl.stop * hb), slice(r_sl.start * rb, r_sl.stop * rb)
        return q[rows, cols], qd[rows, cols], tuple(f[rows, cols] for f in fs)

    block = host_local_scenarios(mesh, make_local)
    cut = shard_scenarios(mesh, q, qd, fs)
    assert all(torch.equal(a, b) for a, b in zip((block[0], block[1]) + block[2],
                                                 (cut[0], cut[1]) + cut[2]))
    step, _ = sharded_batch_solver(tick._tick_impl, mesh)
    res, best, best_cost = step(*block)
    assert res.torque_cmd.shape == (hb, rb, model.model_dof), res.torque_cmd.shape
    tau = gather_grid(mesh, res.torque_cmd)
    slices = [handed[0]]
    if mesh.device_mesh is not None:
        slices = [None] * dist.get_world_size()
        dist.all_gather_object(slices, handed[0])
    return dict(tau=tau.cpu(), best=int(best), best_cost=float(best_cost), slices=slices,
                mesh=mesh.shape)


def _dryrun_rank(mesh):
    """One rank of ``dryrun_multichip``: the three legs of the JAX dry run
    (__graft_entry__.py:64-208) — a CompiledTick grid of (2·n_hyp) ×
    (2·n_roll) through ``sharded_batch_solver``, then the flagship
    ``FusedTick`` at B = 4·n ranks with its batch cut over both mesh axes
    (static, then masked with the support hypotheses cycled over the lanes),
    each held on rank 0 against one unsharded call within 1e-2 Nm.  Plain
    float32 on the CPU, the kernels on the card; 6 IPM iterations."""
    from .parallel.mesh import gather_grid, shard_scenarios, sharded_batch_solver

    n_hyp, n_roll = mesh.ranks.shape
    n = n_hyp * n_roll
    dev = mesh.device
    backend = "cuda" if dev.type == "cuda" else "torch"
    model = RobotModel.load(str(MODEL_PATH))
    H, R = 2 * n_hyp, 2 * n_roll
    grid = _grid_solve(mesh, _grid_inputs(model, H, R))
    assert grid["tau"].shape == (H, R, model.model_dof) and torch.isfinite(grid["tau"]).all()

    # the flagship fused tick, its batch of B = 4·n cut over both axes: the
    # (n_hyp, 4·n_roll) grid of its lanes in order puts lanes 4k … 4k + 3 on
    # rank k, and its flat argmin is the batch's
    B = 4 * n
    q, qd, fs = _grid_inputs(model, 1, B, seed=1)
    q, qd, fs = q[0], qd[0], tuple(f[0] for f in fs)
    masks = np.array([[1, 1], [1, 0], [0, 1]], np.float32)[np.arange(B) % 3]
    cfg = standard_tocabi_config(model, qp_iters=6)

    def as_grid(a):
        return a.reshape((n_hyp, 4 * n_roll) + a.shape[1:])

    out = dict(grid_best=grid["best"], grid_best_cost=grid["best_cost"], mesh=mesh.shape,
               grid=(H, R), batch=B)
    for name, masked in (("fused", False), ("masked", True)):
        tick = FusedTick(model, cfg, dev, backend=backend, masked=masked)
        extra = (masks,) if masked else ()
        step, _ = sharded_batch_solver(tick._tick_impl, mesh)
        blk = shard_scenarios(mesh, as_grid(q), as_grid(qd), tuple(as_grid(f) for f in fs),
                              *(as_grid(a) for a in extra))
        res, best, _ = step(*blk, qp_iters=6)
        tau = gather_grid(mesh, res.torque_cmd).reshape(B, -1)
        assert torch.isfinite(tau).all(), name
        if mesh.rank == 0:
            ref = tick._tick_impl(q, qd, fs, *extra, qp_iters=6).torque_cmd
            out[name] = float((tau - ref).abs().max())
            assert out[name] < 1e-2, f"sharded {name} tick diverges: {out[name]}"
            out[name + "_best"] = int(best)
    return out


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """One sharded batched WBC step over an n-rank ('hyp', 'roll') mesh, the
    three legs of the JAX dry run (``_dryrun_rank``): n processes, NCCL with
    one card each (``device=None``; raises with fewer cards), or gloo on the
    CPU (``device="cpu"``).  Returns rank 0's record (the parities, the best
    scenarios) and prints it.  NCCL has run on the four cards of one host
    (both parities 0.0: a lane's kernels do the same arithmetic at any
    batch), never across hosts."""
    import time

    from .parallel.mesh import run_ranks

    t0 = time.perf_counter()
    out = run_ranks(_dryrun_rank, n_ranks, device)
    print(f"dryrun_multichip ok in {time.perf_counter() - t0:.1f} s (the ranks' start, the "
          f"process group, the three legs): mesh {out['mesh']}, grid "
          f"{out['grid'][0]}x{out['grid'][1]}, best hypothesis {out['grid_best']} cost "
          f"{out['grid_best_cost']:.3f}")
    print(f"dryrun_multichip fused ok: batch {out['batch']} sharded over {n_ranks} ranks, "
          f"fused parity {out['fused']:.2e}, masked parity {out['masked']:.2e}, "
          f"best {out['fused_best']}")
    return out
