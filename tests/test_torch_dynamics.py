"""The port's contact-space dynamics and QP assembly (``wbc/dynamics.py``,
``wbc/hqp.py``) against the JAX package's, float64, on the flagship's
states: the same numpy inputs (from the port's kinematics of two perturbed
standing states) go through both.  The JAX functions run once per module,
eagerly."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import CASE_FSTAR, CASE_Q, full_q

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
TOL = 1e-10
CS_FIELDS = ("Lambda_c", "J_C_INV_T", "N_C", "A_inv_N_C", "W", "W_inv", "V2", "NwJw",
             "rank_health")


def _close(got, ref, tol=TOL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))
    assert err <= tol, f"{err:.3e}"


@pytest.fixture(scope="module")
def state():
    """The port's kinematics of two states, the contact jacobian of the two
    feet, and the tick's pelvis task jacobian, as numpy."""
    from libdwbc_tpu_torch.kin.engine import Kinematics
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc import dynamics as dyn
    from libdwbc_tpu_torch.wbc.pipeline import _plan_jacobians, standard_tocabi_config

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m)
    jb, pts, _ = _plan_jacobians(m, cfg)
    rng = np.random.default_rng(9)
    q = np.stack([full_q(CASE_Q[1]), full_q(CASE_Q[2] + 0.05 * rng.standard_normal(33))])
    st = Kinematics(m).update(torch.as_tensor(q), torch.zeros((2, 39), dtype=torch.float64),
                              J_bodies=jb, points=pts)
    J_C = torch.cat([dyn.contact_jacobian_rows(st.J_pts[:, i], st.R[:, c.link], c.contact_type)
                     for i, c in enumerate(cfg.contacts)], dim=-2)
    return dict(cfg=cfg, J_C=J_C.numpy(), A_inv=st.A_inv.numpy(), G=st.G.numpy(),
                R=st.R.numpy(), J_task=st.J[:, 0].numpy(), J_task1=st.J[:, 1, 3:6].numpy())


@pytest.fixture(scope="module")
def spaces(state):
    """contact_space of both packages on the same inputs."""
    from libdwbc_tpu.wbc import dynamics as jd
    from libdwbc_tpu_torch.wbc import dynamics as dyn

    ref = jd.contact_space(jnp.asarray(state["J_C"]), jnp.asarray(state["A_inv"]))
    got = dyn.contact_space(torch.as_tensor(state["J_C"]), torch.as_tensor(state["A_inv"]))
    return ref, got


@pytest.mark.parametrize("field", CS_FIELDS)
def test_contact_space_matches_jax(spaces, field):
    ref, got = spaces
    _close(getattr(got, field), getattr(ref, field))


def test_gravity_compensation_and_contact_force_match_jax(state, spaces):
    from libdwbc_tpu.wbc import dynamics as jd
    from libdwbc_tpu_torch.wbc import dynamics as dyn

    ref, got = spaces
    G = state["G"]
    jg, jp = jd.gravity_compensation(jnp.asarray(state["A_inv"]), ref.W_inv, ref.N_C,
                                     ref.J_C_INV_T, jnp.asarray(G))
    tg, tp = dyn.gravity_compensation(torch.as_tensor(state["A_inv"]), got.W_inv, got.N_C,
                                      got.J_C_INV_T, torch.as_tensor(G))
    _close(tg, jg)
    _close(tp, jp)
    tau = np.random.default_rng(2).standard_normal((2, 33))
    _close(dyn.contact_force_from_torque(torch.as_tensor(tau), got.J_C_INV_T, tp),
           jd.contact_force_from_torque(jnp.asarray(tau), ref.J_C_INV_T, jp))


@pytest.mark.parametrize("exact_pinv", [False, True])
def test_task_jkt_and_null_space_match_jax(state, spaces, exact_pinv):
    from libdwbc_tpu.wbc import dynamics as jd
    from libdwbc_tpu_torch.wbc import dynamics as dyn

    ref, got = spaces
    J = state["J_task"]
    jf = jd.task_jkt(jnp.asarray(J), jnp.asarray(state["A_inv"]), ref.N_C, ref.W_inv,
                     exact_pinv=exact_pinv)
    tf = dyn.task_jkt(torch.as_tensor(J), torch.as_tensor(state["A_inv"]), got.N_C,
                      got.W_inv, exact_pinv=exact_pinv)
    for name in ("Lambda_task", "J_kt", "Q"):
        _close(getattr(tf, name), getattr(jf, name), 1e-9)
    prev = np.tile(np.eye(33), (2, 1, 1))
    _close(dyn.task_null_space(tf.J_kt, tf.Lambda_task, torch.as_tensor(J), got.A_inv_N_C,
                               torch.as_tensor(prev)),
           jd.task_null_space(jf.J_kt, jf.Lambda_task, jnp.asarray(J), ref.A_inv_N_C,
                              jnp.asarray(prev)), 1e-9)


@pytest.mark.parametrize("ctype", [0, 1, 2])
def test_contact_type_blocks_match_jax(state, ctype):
    """Jacobian rows, constraint block and rotation block of a 6D, point and
    line contact."""
    from libdwbc_tpu.wbc import dynamics as jd
    from libdwbc_tpu_torch.wbc import dynamics as dyn

    J6 = state["J_C"][:, 0:6]
    R = state["R"][:, 6]
    _close(dyn.contact_jacobian_rows(torch.as_tensor(J6), torch.as_tensor(R), ctype),
           jd.contact_jacobian_rows(jnp.asarray(J6), jnp.asarray(R), ctype))
    _close(dyn.contact_constraint_block(ctype, 0.15, 0.075, 0.8, 0.1),
           jd.contact_constraint_block(ctype, 0.15, 0.075, 0.8, 0.1))
    _close(dyn.contact_rotation_block(ctype, torch.as_tensor(R)),
           jd.contact_rotation_block(ctype, jnp.asarray(R)))


@pytest.fixture(scope="module")
def level_inputs(state, spaces):
    """The level-0 QP's inputs of a cold tick, as numpy."""
    from libdwbc_tpu_torch.wbc import dynamics as dyn
    from libdwbc_tpu_torch.wbc.hqp import contact_constraint_blocks

    _, got = spaces
    cfg = state["cfg"]
    A_inv = torch.as_tensor(state["A_inv"])
    tg, P_C = dyn.gravity_compensation(A_inv, got.W_inv, got.N_C, got.J_C_INV_T,
                                       torch.as_tensor(state["G"]))
    tf = dyn.task_jkt(torch.as_tensor(state["J_task"]), A_inv, got.N_C, got.W_inv)
    R = torch.as_tensor(state["R"])
    consts = [dyn.contact_constraint_block(c.contact_type, c.plane_x, c.plane_y,
                                           c.friction_ratio, c.friction_ratio_z)
              for c in cfg.contacts]
    A_const, A_rot = contact_constraint_blocks(
        consts, [dyn.contact_rotation_block(c.contact_type, R[:, c.link]) for c in cfg.contacts])
    return dict(Ntorque=(tf.J_kt @ tf.Lambda_task).numpy(), fstar=np.stack([CASE_FSTAR[1][0]] * 2),
                tau=tg.numpy(), NwJw=got.NwJw.numpy(), JT=got.J_C_INV_T.numpy(),
                P_C=P_C.numpy(), A_const=A_const.numpy(), A_rot=A_rot.numpy(),
                tlim=np.asarray(cfg.torque_limit, np.float64))


def test_task_level_qp_matches_jax(level_inputs):
    from libdwbc_tpu.wbc import hqp as jh
    from libdwbc_tpu_torch.wbc import hqp

    k = level_inputs
    names = ("Ntorque", "fstar", "tau", "NwJw", "JT", "P_C", "A_const", "A_rot", "tlim")
    ref = jh.solve_task_level_qp(*(jnp.asarray(k[n]) for n in names), iters=20)
    got = hqp.solve_task_level_qp(*(torch.as_tensor(k[n]) for n in names), iters=20)
    _close(got.f_star_delta, ref.f_star_delta, 1e-8)
    _close(got.x, ref.x, 1e-6)
    assert float(np.abs(got.gap.numpy() - np.asarray(ref.gap)).max()) <= 1e-10
    assert float(np.abs(got.primal_res.numpy() - np.asarray(ref.primal_res)).max()) <= 1e-10


@pytest.mark.parametrize("tangential", [False, True])
def test_redistribution_qp_matches_jax(level_inputs, tangential):
    from libdwbc_tpu.wbc import hqp as jh
    from libdwbc_tpu_torch.wbc import hqp

    k = level_inputs
    names = ("tau", "NwJw", "JT", "P_C", "A_const", "A_rot", "tlim")
    ref = jh.solve_contact_redistribution_qp(*(jnp.asarray(k[n]) for n in names), iters=20,
                                             tangential_weight=tangential)
    got = hqp.solve_contact_redistribution_qp(*(torch.as_tensor(k[n]) for n in names),
                                              iters=20, tangential_weight=tangential)
    _close(got.x, ref.x, 1e-8)
    assert np.array_equal(got.polished.numpy(), np.asarray(ref.polished))
    assert float(np.abs(got.gap.numpy() - np.asarray(ref.gap)).max()) <= 1e-10
