"""The port's lexicographic QP cascade (``wbc/lqp.py``) against the JAX
package's, float64 on the CPU: the flagship's problem (``models/tocabi.npz``,
two 6D feet, the pelvis 6D and torso rotation tasks) built by
``build_lqp_levels`` from the same mass matrix, bias, contact jacobian,
cone rows and task jacobians in both packages, then ``solve_cascade``.
The SVD null basis is unique only up to a rotation within the null space:
y and τ are compared (1e-6), and the null-space projectors Z·Zᵀ (1e-10),
never Z.  The JAX cascade runs jitted once in a module fixture."""

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
B = 2
ITERS = 25


@pytest.fixture(scope="module")
def problem():
    """The flagship's LQP inputs on B perturbed standing states, numpy
    float64: A, the bias B, J_C, −A_const·A_rot, the task jacobians and
    f*, and the seed y0 = [−A⁻¹B; 0]."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.kin.engine import Kinematics
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc import dynamics as dyn
    from libdwbc_tpu_torch.wbc.hqp import contact_constraint_blocks
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m)
    q, _, fs = entry._swing_inputs(m, B, seed=6, dtype=np.float64)
    qd = 0.05 * np.random.default_rng(6).standard_normal((B, m.ndof))
    st = Kinematics(m).update(torch.as_tensor(q), torch.as_tensor(qd), points=tuple(
        (c.link, tuple(c.contact_point)) for c in cfg.contacts))
    J_C = torch.cat([st.J_pts[:, 0], st.J_pts[:, 1]], dim=-2)
    consts = [dyn.contact_constraint_block(c.contact_type, c.plane_x, c.plane_y,
                                           c.friction_ratio, c.friction_ratio_z)
              for c in cfg.contacts]
    A_const, A_rot = contact_constraint_blocks(
        consts, [dyn.contact_rotation_block(c.contact_type, st.R[:, c.link]) for c in cfg.contacts])
    y0 = torch.cat([-torch.linalg.solve(st.A, st.B[..., None])[..., 0],
                    torch.zeros(B, J_C.shape[-2], dtype=torch.float64)], dim=-1)
    np_ = lambda t: t.numpy().copy()     # noqa: E731
    return dict(A=np_(st.A), Bv=np_(st.B), J_C=np_(J_C), cc=np_(-(A_const @ A_rot)),
                tasks=[np_(st.J[:, 0]), np_(st.J[:, 15, 3:6])], fs=[fs[0], fs[1]],
                y0=np_(y0))


def _args(p, conv):
    return (conv(p["A"]), conv(p["Bv"]), conv(p["J_C"]), conv(p["cc"]),
            [conv(t) for t in p["tasks"]], [conv(f) for f in p["fs"]])


@pytest.fixture(scope="module")
def jax_ref(problem):
    from libdwbc_tpu.wbc import lqp as jl

    @jax.jit
    def run(A, Bv, J_C, cc, tasks, fs, y0):
        levels = jl.build_lqp_levels(A, Bv, J_C, cc, tasks, fs)
        res = jl.solve_cascade(levels, y0, qp_iters=ITERS)
        res1 = jl.solve_cascade(levels, y0, solve_level0=True, qp_iters=ITERS)
        return res, res1, jl.lqp_torque_from_solution(res.y, A, Bv, J_C)

    args = _args(problem, jnp.asarray)
    res, res1, tau = run(*args, jnp.asarray(problem["y0"]))
    return dict(res=res, res1=res1, tau=np.asarray(tau), levels=jl.build_lqp_levels(*args))


@pytest.fixture(scope="module")
def port(problem):
    from libdwbc_tpu_torch.wbc import lqp

    levels = lqp.build_lqp_levels(*_args(problem, torch.as_tensor))
    y0 = torch.as_tensor(problem["y0"])
    res = lqp.solve_cascade(levels, y0, qp_iters=ITERS)
    res1 = lqp.solve_cascade(levels, y0, solve_level0=True, qp_iters=ITERS)
    tau = lqp.lqp_torque_from_solution(res.y, *_args(problem, torch.as_tensor)[:3])
    return dict(res=res, res1=res1, tau=tau.numpy(), levels=levels)


@pytest.mark.parametrize("field", ["A", "a", "B", "b", "H"])
def test_build_lqp_levels_matches_jax(jax_ref, port, field):
    assert len(port["levels"]) == len(jax_ref["levels"]) == 4
    for lp, lj in zip(port["levels"], jax_ref["levels"]):
        assert lp.rank == lj.rank and lp.normalize == lj.normalize
        vp, vj = getattr(lp, field), getattr(lj, field)
        assert (vp is None) == (vj is None)
        if vp is not None:
            assert np.abs(vp.numpy() - np.asarray(vj)).max() <= 1e-12


@pytest.mark.parametrize("which", ["res", "res1"])
def test_solve_cascade_matches_jax(jax_ref, port, which):
    """y within 1e-6 with level 0 skipped (the reference's default) and
    solved; the slacks and diagnostics alike."""
    got, want = port[which], jax_ref[which]
    err = float(np.abs(got.y.numpy() - np.asarray(want.y)).max())
    print(f"{which} y: {err:.3e}")
    assert err <= 1e-6
    for vg, vw in zip(got.v_slacks, want.v_slacks):
        assert vg.shape == vw.shape
        assert np.abs(vg.numpy() - np.asarray(vw)).max(initial=0.0) <= 1e-6
    assert np.abs(got.gap.numpy() - np.asarray(want.gap)).max() <= 1e-6
    assert np.abs(got.primal_res.numpy() - np.asarray(want.primal_res)).max() <= 1e-6


def test_lqp_torque_matches_jax(jax_ref, port):
    err = float(np.abs(port["tau"] - jax_ref["tau"]).max())
    print(f"τ: {err:.3e}")
    assert port["tau"].shape == (B, 33) and err <= 1e-6


def test_null_space_chain_matches_jax(problem, jax_ref, port):
    """Z_0 = null(B_0), Z_i = Z_{i−1}·null(B_i Z_{i−1}) of the normalized
    equality rows: Z·Zᵀ within 1e-10 and B_i·Z_i ≈ 0 in both packages."""
    from libdwbc_tpu.wbc import lqp as jl
    from libdwbc_tpu_torch.wbc import lqp

    Zp = Zj = None
    for lp, lj in zip(port["levels"], jax_ref["levels"]):
        Bp, _ = lqp._row_normalize(lp.B, lp.b)
        Bj, _ = jl._row_normalize(lj.B, lj.b)
        Zp = lqp._null_basis(Bp, lp.rank) if Zp is None else Zp @ lqp._null_basis(Bp @ Zp, lp.rank)
        Zj = jl._null_basis(Bj, lj.rank) if Zj is None else Zj @ jl._null_basis(Bj @ Zj, lj.rank)
        Pp, Pj = (Zp @ Zp.transpose(-1, -2)).numpy(), np.asarray(Zj @ jnp.swapaxes(Zj, -1, -2))
        assert np.abs(Pp - Pj).max() <= 1e-10
        assert float((Bp @ Zp).abs().max()) <= 1e-10


def test_solve_cascade_timers():
    """timers=list: one entry per solved level with host wall times, and the
    same y as without."""
    from libdwbc_tpu_torch.wbc import lqp

    rng = np.random.default_rng(1)
    nv = 8
    levels = [lqp.LQPLevel(A=torch.as_tensor(rng.standard_normal((3, nv))),
                           a=torch.as_tensor(-np.ones(3)),
                           B=torch.as_tensor(rng.standard_normal((2, nv))),
                           b=torch.as_tensor(rng.standard_normal(2)), rank=2),
              lqp.LQPLevel(A=None, a=None, B=torch.as_tensor(rng.standard_normal((3, nv))),
                           b=torch.as_tensor(rng.standard_normal(3)), rank=3)]
    y0 = torch.zeros(nv, dtype=torch.float64)
    timers = []
    a = lqp.solve_cascade(levels, y0, solve_level0=True, timers=timers)
    b = lqp.solve_cascade(levels, y0, solve_level0=True)
    assert [t["level"] for t in timers] == [0, 1]
    assert all(t["update_us"] >= 0 and t["solve_us"] >= 0 for t in timers)
    assert torch.equal(a.y, b.y)
