"""The port's remaining public functions against the JAX package's, float64
on the CPU, within 1e-10: ``kin/centroidal.py``; the closed-form two-contact
redistribution and ``yaw_rotation`` of ``wbc/dynamics.py``; the
trajectories and PD servos of ``utils/traj.py``; ``qr_inv`` and
``inv_via_normal`` of ``ops/smallmat.py``; and ``ops/linalg.py``.  Null
bases are compared by their projectors."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
B = 3
TOL = 1e-10


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= tol * max(1.0, float(np.abs(np.asarray(want)).max())), err


# ----------------------------------------------------------- centroidal

MASK = np.zeros(34)
MASK[[0, 13, 14, 15, 20, 27]] = 1.0
ABOUT = np.array([0.05, -0.02, 0.8])


@pytest.fixture(scope="module")
def centroidal():
    from libdwbc_tpu.kin import centroidal as jc
    from libdwbc_tpu.kin.engine import Kinematics as JKin
    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.kin import centroidal as pc
    from libdwbc_tpu_torch.kin.engine import Kinematics
    from libdwbc_tpu_torch.model.compile import RobotModel

    jm, pm = JModel.load(MODEL), RobotModel.load(MODEL)
    q, _, _ = entry._swing_inputs(pm, B, seed=8, dtype=np.float64)
    qd = 0.1 * np.random.default_rng(8).standard_normal((B, pm.ndof))
    jk = JKin(jm)

    @jax.jit
    def jax_side(q, qd):
        st = jk.update(q, qd)
        return (jc.virtual_cmm(jk, st), jc.virtual_cmm(jk, st, MASK, ABOUT),
                jc.angular_momentum_matrix(jk, st), jc.momentum(st), jc.average_velocity(st),
                st.CMM)

    want = jax_side(jnp.asarray(q), jnp.asarray(qd))
    pk = Kinematics(pm)
    st = pk.update(torch.as_tensor(q), torch.as_tensor(qd))
    got = (pc.virtual_cmm(pk, st), pc.virtual_cmm(pk, st, MASK, ABOUT),
           pc.angular_momentum_matrix(pk, st), pc.momentum(st), pc.average_velocity(st),
           st.CMM)
    narrow = pk.update(torch.as_tensor(q), torch.as_tensor(qd), J_bodies=(0, 15))
    return dict(got=got, want=want, narrow=narrow, kin=pk, pc=pc)


@pytest.mark.parametrize("i, name", enumerate(
    ["virtual_cmm", "virtual_cmm masked about a point", "angular_momentum_matrix",
     "momentum", "average_velocity"]))
def test_centroidal_matches_jax(centroidal, i, name):
    close(centroidal["got"][i], centroidal["want"][i])


def test_angular_momentum_matrix_is_the_cmm(centroidal):
    """The explicit body-by-body matrix equals the CMM's angular rows."""
    close(centroidal["got"][2], centroidal["got"][5][:, 3:6].numpy(), 1e-9)


def test_virtual_cmm_refuses_a_narrowed_state(centroidal):
    with pytest.raises(ValueError, match="full KinState"):
        centroidal["pc"].virtual_cmm(centroidal["kin"], centroidal["narrow"])


# ------------------------------------------- dynamics: two-contact closed form

def _two_contact_inputs():
    rng = np.random.default_rng(9)
    n = 64
    F12 = rng.standard_normal((n, 12)) * np.array([20, 20, 300, 5, 5, 2] * 2)
    F12[:, [2, 8]] = -np.abs(F12[:, [2, 8]]) - 100.0
    P1 = np.stack([rng.uniform(-0.1, 0.1, n), 0.1 + rng.uniform(-0.02, 0.02, n),
                   -0.9 + rng.uniform(-0.02, 0.02, n)], 1)
    P2 = P1 * np.array([1.0, -1.0, 1.0]) + rng.uniform(-0.05, 0.05, (n, 3))
    return (0.9, 0.26, 0.1, 0.3, 0.9, 0.9, P1, P2, F12)


@pytest.mark.parametrize("out", [0, 1, 2])
def test_contact_redistribute_two_matches_jax(out):
    from libdwbc_tpu.wbc import dynamics as jd
    from libdwbc_tpu_torch.wbc import dynamics as pd

    args = _two_contact_inputs()
    want = jd.contact_redistribute_two(*args[:6], *map(jnp.asarray, args[6:]))[out]
    got = pd.contact_redistribute_two(*args[:6], *map(torch.as_tensor, args[6:]))[out]
    close(got, want)


def test_eta_interval_update_matches_jax():
    from libdwbc_tpu.wbc import dynamics as jd
    from libdwbc_tpu_torch.wbc import dynamics as pd

    rng = np.random.default_rng(10)
    A, Bq, C = rng.standard_normal((3, 32))
    A[:4] = 0.0                               # the degenerate a = 0 branch
    lo, hi = np.full(32, 0.1), np.full(32, 0.9)
    want = jd._eta_interval_update(*map(jnp.asarray, (A, Bq, C, lo, hi)))
    got = pd._eta_interval_update(*map(torch.as_tensor, (A, Bq, C, lo, hi)))
    for g, w in zip(got, want):
        close(g, w)


def test_yaw_rotation_matches_jax():
    from libdwbc_tpu.wbc import dynamics as jd
    from libdwbc_tpu_torch.wbc import dynamics as pd

    yaw = np.linspace(-3.0, 3.0, 7)
    close(pd.yaw_rotation(torch.as_tensor(yaw)), jd.yaw_rotation(jnp.asarray(yaw)))


# ------------------------------------------------------------ utils/traj

T_CLOCK = np.array([-0.1, 0.0, 0.13, 0.5, 0.77, 1.0, 1.4])


def test_cubic_and_quintic_match_jax():
    from libdwbc_tpu.utils import traj as jt
    from libdwbc_tpu_torch.utils import traj as pt

    t = T_CLOCK
    close(pt.cubic(torch.as_tensor(t), 0.0, 1.0, 0.2, 1.3, 0.1, -0.4),
          jt.cubic(jnp.asarray(t), 0.0, 1.0, 0.2, 1.3, 0.1, -0.4))
    for g, w in zip(pt.quintic_spline(torch.as_tensor(t), torch.tensor(0.0), torch.tensor(1.0),
                                      0.2, 0.1, 0.0, 1.3, -0.4, 0.5),
                    jt.quintic_spline(jnp.asarray(t), 0.0, 1.0, 0.2, 0.1, 0.0, 1.3, -0.4, 0.5)):
        close(g, w)


def _rotations(n, seed):
    from libdwbc_tpu_torch.kin.rotations import axis_angle_matrix

    rng = np.random.default_rng(seed)
    ax = rng.standard_normal((n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    return axis_angle_matrix(torch.as_tensor(ax), torch.as_tensor(rng.uniform(-2, 2, n))).numpy()


def test_rotation_cubic_matches_jax():
    from libdwbc_tpu.utils import traj as jt
    from libdwbc_tpu_torch.utils import traj as pt

    R0, Rf = _rotations(len(T_CLOCK), 11), _rotations(len(T_CLOCK), 12)
    close(pt.rotation_cubic(torch.as_tensor(T_CLOCK), 0.0, 1.0, torch.as_tensor(R0),
                            torch.as_tensor(Rf)),
          jt.rotation_cubic(jnp.asarray(T_CLOCK), 0.0, 1.0, jnp.asarray(R0), jnp.asarray(Rf)))


@pytest.mark.parametrize("out", [0, 1, 2])
def test_fstar_pos_pd_matches_jax(out):
    from libdwbc_tpu.utils import traj as jt
    from libdwbc_tpu_torch.utils import traj as pt

    rng = np.random.default_rng(13)
    n = len(T_CLOCK)
    vec = [rng.standard_normal((n, 3)) for _ in range(6)]
    gains = (400.0, 40.0, 1.0)
    want = jt.fstar_pos_pd(jnp.asarray(T_CLOCK[:, None]), 0.0, 1.0, *map(jnp.asarray, vec),
                           *gains)[out]
    got = pt.fstar_pos_pd(torch.as_tensor(T_CLOCK[:, None]), 0.0, 1.0,
                          *map(torch.as_tensor, vec), *gains)[out]
    close(got, want)


@pytest.mark.parametrize("out", [0, 1, 2])
def test_fstar_rot_pd_matches_jax(out):
    from libdwbc_tpu.utils import traj as jt
    from libdwbc_tpu_torch.utils import traj as pt

    rng = np.random.default_rng(14)
    n = len(T_CLOCK)
    R0, Rd, Rc = _rotations(n, 15), _rotations(n, 16), _rotations(n, 17)
    w0, wd, wc = (0.3 * rng.standard_normal((n, 3)) for _ in range(3))
    want = jt.fstar_rot_pd(jnp.asarray(T_CLOCK), 0.0, 1.0, *map(jnp.asarray, (R0, w0, Rd, wd, Rc,
                                                                              wc)),
                           400.0, 40.0)[out]
    got = pt.fstar_rot_pd(torch.as_tensor(T_CLOCK), 0.0, 1.0,
                          *map(torch.as_tensor, (R0, w0, Rd, wd, Rc, wc)), 400.0, 40.0)[out]
    close(got, want)


def test_second_order_lpf_and_servo_gains_match_jax():
    from libdwbc_tpu.utils import traj as jt
    from libdwbc_tpu_torch.utils import traj as pt

    x = np.random.default_rng(18).standard_normal((5, 4))
    close(pt.second_order_lpf(*map(torch.as_tensor, x), 15.0, 0.7, 1000.0),
          jt.second_order_lpf(*map(jnp.asarray, x), 15.0, 0.7, 1000.0))
    assert pt.ServoGains._fields == jt.ServoGains._fields


# ------------------------------------------------- ops/smallmat, ops/linalg

def _square(n=7, seed=19, cond=1e3):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((4, n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((4, n, n)))
    s = np.geomspace(1.0, 1.0 / cond, n)
    return np.einsum("bij,j,bkj->bik", U, s, V)


@pytest.mark.parametrize("fn, cond", [("qr_inv", 1e3), ("inv_via_normal", 10.0)])
def test_smallmat_inverses_match_jax(fn, cond):
    """inv_via_normal squares the condition number (its ridge biases by
    1e-12·κ²): held on a well-conditioned matrix, as documented."""
    from libdwbc_tpu.ops import smallmat as js
    from libdwbc_tpu_torch.ops import smallmat as ps

    M = _square(cond=cond)
    got = getattr(ps, fn)(torch.as_tensor(M))
    close(got, getattr(js, fn)(jnp.asarray(M)), 1e-9)
    close(got @ torch.as_tensor(M), np.broadcast_to(np.eye(7), M.shape), 1e-8)


def _psd(n=9, rank=6, seed=20):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((3, n, rank))
    return X @ X.transpose(0, 2, 1)


def test_pinv_psd_fixed_rank_matches_jax():
    from libdwbc_tpu.ops import linalg as jl
    from libdwbc_tpu_torch.ops import linalg as pl

    M = _psd()
    Pg, V2g = pl.pinv_psd_fixed_rank(torch.as_tensor(M), 6)
    Pw, V2w = jl.pinv_psd_fixed_rank(jnp.asarray(M), 6)
    close(Pg, Pw, 1e-9)
    close(V2g.transpose(-1, -2) @ V2g, np.asarray(jnp.swapaxes(V2w, -1, -2) @ V2w))
    close(V2g @ torch.as_tensor(M), np.zeros((3, 3, 9)), 1e-9)


def test_pinv_psd_matches_jax():
    from libdwbc_tpu.ops import linalg as jl
    from libdwbc_tpu_torch.ops import linalg as pl

    M = _psd()
    close(pl.pinv_psd(torch.as_tensor(M)), jl.pinv_psd(jnp.asarray(M)), 1e-9)


@pytest.mark.parametrize("shape", [(5, 8), (8, 5), (6, 6)])
def test_pinv_svd_is_the_pseudo_inverse(shape):
    """pinv_svd against numpy's pseudo-inverse at the same relative
    threshold, on rank-deficient inputs.  The JAX package's pinv_svd
    contracts Vᵀ where V belongs (its einsum "...ji,...i,...ki->...jk"), so
    it fails on a non-square input and returns VᵀΣ⁺Uᵀ on a square one; no
    caller uses it there, and the port computes VΣ⁺Uᵀ."""
    from libdwbc_tpu_torch.ops import linalg as pl

    A = np.random.default_rng(21).standard_normal((3,) + shape)
    A[:, -1] = A[:, 0] + A[:, 1]                     # rank-deficient rows
    got = pl.pinv_svd(torch.as_tensor(A))
    close(got, np.linalg.pinv(A, rcond=1e-6), 1e-9)
    close(torch.as_tensor(A) @ got @ torch.as_tensor(A), A, 1e-9)


def test_null_space_basis_and_solve_psd_match_jax():
    from libdwbc_tpu.ops import linalg as jl
    from libdwbc_tpu_torch.ops import linalg as pl

    A = np.random.default_rng(22).standard_normal((3, 4, 9))
    Zg = pl.null_space_basis(torch.as_tensor(A), 4)
    Zw = jl.null_space_basis(jnp.asarray(A), 4)
    assert tuple(Zg.shape) == (3, 9, 5)
    close(Zg @ Zg.transpose(-1, -2), np.asarray(Zw @ jnp.swapaxes(Zw, -1, -2)))
    close(torch.as_tensor(A) @ Zg, np.zeros((3, 4, 5)), 1e-12)
    M = _psd(rank=9) + np.eye(9)
    b = np.random.default_rng(23).standard_normal((3, 9, 2))
    close(pl.solve_psd(torch.as_tensor(M), torch.as_tensor(b)),
          jl.solve_psd(jnp.asarray(M), jnp.asarray(b)))
