"""The port's Kinematics (``kin/engine.py``) against the JAX package's, on
the flagship model at float64: every field of ``update`` with the tick's
jacobian narrowing, the full update, and a frame point jacobian.  The JAX
reference runs once per module, eagerly."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import CASE_Q, full_q

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
TOL = 1e-10
FIELDS = ("R", "p", "w", "v", "com_w", "J", "Jcom", "A", "A_inv", "B", "G", "com_pos",
          "com_vel", "com_inertia", "CMM", "Jcom_total", "J_pts")


def _inputs():
    rng = np.random.default_rng(7)
    q = np.stack([full_q(CASE_Q[1]), full_q(CASE_Q[2]),
                  full_q(CASE_Q[1] + 0.1 * rng.standard_normal(33),
                         base=(0.3, -0.2, 0.9, 0.1, -0.2, 0.3), qw=0.93)])
    qd = 0.5 * rng.standard_normal((3, 39))
    return q, qd


@pytest.fixture(scope="module")
def both():
    from libdwbc_tpu.kin.engine import Kinematics as JK
    from libdwbc_tpu.model.compile import RobotModel as JM
    from libdwbc_tpu.wbc.pipeline import _plan_jacobians as jplan, standard_tocabi_config
    from libdwbc_tpu_torch.kin.engine import Kinematics
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.pipeline import _plan_jacobians

    jm, m = JM.load(MODEL), RobotModel.load(MODEL)
    jb, pts, _ = jplan(jm, standard_tocabi_config(jm))
    assert (jb, pts) == _plan_jacobians(m, standard_tocabi_config(m))[:2]
    q, qd = _inputs()
    ref = JK(jm).update(jnp.asarray(q), jnp.asarray(qd), J_bodies=jb, points=pts)
    kin = Kinematics(m)
    got = kin.update(torch.as_tensor(q), torch.as_tensor(qd), J_bodies=jb, points=pts)
    return dict(ref=ref, got=got, kin=kin, jkin=JK(jm), q=q, qd=qd)


@pytest.mark.parametrize("field", FIELDS)
def test_update_field_matches_jax(both, field):
    ref = np.asarray(getattr(both["ref"], field))
    got = getattr(both["got"], field).numpy()
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))
    assert err <= TOL, f"{field}: {err:.3e}"


def test_full_update_and_point_jacobian_match_jax(both):
    q, qd = both["q"][:1], both["qd"][:1]
    ref = both["jkin"].update(jnp.asarray(q), jnp.asarray(qd))
    got = both["kin"].update(torch.as_tensor(q), torch.as_tensor(qd))
    assert got.J.shape == (1, 34, 6, 39) and got.J_pts is None
    assert np.abs(got.J.numpy() - np.asarray(ref.J)).max() <= TOL
    lp = np.array([0.03, 0.0, -0.1585])
    jref = both["jkin"].frame_point_jacobian(both["jkin"].fk(jnp.asarray(q)), 6, jnp.asarray(lp))
    jgot = both["kin"].frame_point_jacobian(both["kin"].fk(torch.as_tensor(q)), 6,
                                            torch.as_tensor(lp))
    assert np.abs(jgot.numpy() - np.asarray(jref)).max() <= TOL


def test_cuda_backend_on_cpu_tensors_launches_nothing(both):
    from libdwbc_tpu_torch.kin.engine import Kinematics
    from libdwbc_tpu_torch.ops import linalg_cuda

    n0 = linalg_cuda.launches["psd_inverse"]
    kin = Kinematics(both["kin"].model, backend="cuda")
    st = kin.update(torch.as_tensor(both["q"], dtype=torch.float32),
                    torch.as_tensor(both["qd"], dtype=torch.float32))
    assert linalg_cuda.launches["psd_inverse"] == n0
    ref = both["got"].A_inv.numpy()
    assert np.abs(st.A_inv.double().numpy() - ref).max() / np.abs(ref).max() < 1e-3
