"""The port's bridge to the native host runtime (``libdwbc_tpu_torch/native.py``,
the library built with g++ from ``native/``) on the CPU.

The natively compiled models load into the port's ``RobotModel`` equal to
the JAX loader's and to the Python compilers' (the tolerances of
``tests/test_native.py:33-40``): the inline URDF of
``tests/test_torch_model.py``, and the Tocabi at full width from a URDF
written out of ``models/tocabi.npz``.  The golden I/O, the real-time loop
with Python callbacks (no torn read), a 50-tick loop serving the plain
float64 FusedTick (each τ_cmd equal to the same warm chain called directly
on the consumed states), and an exception raised in a callback coming out
of ``run_rt_loop``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_model import URDF, assert_models_equal

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
# tests/test_native.py:33-40
ATOL = {"X_T_rot": 1e-15, "X_T_trans": 1e-15, "axis": 1e-15, "mass": 1e-12, "com": 1e-14,
        "inertia": 1e-13}


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native runtime")
    from libdwbc_tpu_torch import native as nat

    nat.get_lib()
    return nat


def assert_native_equal(got, want):
    """test_native.py:33-40's comparison, and every other field exactly — but
    a limit the URDF leaves out, which the native compiler writes as ±1e308
    where the Python compilers write ±inf."""
    assert got.body_names == want.body_names and got.joint_names == want.joint_names
    assert (got.name, got.floating, got.nbody, got.ndof, got.nq, got.model_dof) == (
        want.name, want.floating, want.nbody, want.ndof, want.nq, want.model_dof)
    for f in ("parent", "q_index", "ancestor_mask", "damping", "gravity"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("joint_limit_lower", "joint_limit_upper", "effort_limit", "velocity_limit"):
        w = getattr(want, f)
        np.testing.assert_array_equal(getattr(got, f), np.where(np.isinf(w), np.sign(w) * 1e308,
                                                                w), err_msg=f)
    for f, tol in ATOL.items():
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0, atol=tol,
                                   err_msg=f)
    assert abs(got.total_mass - want.total_mass) < 1e-10
    assert set(got.fixed_frames) == set(want.fixed_frames)
    for k, (body, R, p) in want.fixed_frames.items():
        assert got.fixed_frames[k][0] == body, k
        np.testing.assert_allclose(got.fixed_frames[k][1], R, rtol=0, atol=1e-15, err_msg=k)
        np.testing.assert_allclose(got.fixed_frames[k][2], p, rtol=0, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("floating", [True, False])
def test_inline_urdf_compiles_natively(native, tmp_path, floating):
    """The port's load_dwbcm equals the JAX load_dwbcm on the same artifact,
    and the port's Python compiler on the same URDF."""
    from libdwbc_tpu.native import load_dwbcm as jax_load
    from libdwbc_tpu_torch.model.compile import compile_urdf

    urdf, out = tmp_path / "probe.urdf", tmp_path / "probe.dwbcm"
    urdf.write_text(URDF)
    native.compile_urdf_native(str(urdf), str(out), floating=floating)
    got = native.load_dwbcm(str(out))
    assert_models_equal(jax_load(str(out)), got, tol=0.0)
    assert_native_equal(got, compile_urdf(URDF, floating=floating))


def _num(x):
    return repr(float(x))


def _vec(v):
    return " ".join(_num(x) for x in v)


def tocabi_urdf(model):
    """A URDF of the compiled model: one link per body (its lumped mass, COM
    and inertia), a revolute joint above each with the body's joint frame
    (origin from X_T_trans and X_T_rot), axis and limits, and a massless
    link on a fixed joint for each frame that lumping merged away."""
    from libdwbc_tpu_torch.model.rotations_np import matrix_to_rpy

    def inertial(i):
        I = model.inertia[i]
        return (f'<inertial><origin xyz="{_vec(model.com[i])}" rpy="0 0 0"/>'
                f'<mass value="{_num(model.mass[i])}"/>'
                f'<inertia ixx="{_num(I[0, 0])}" ixy="{_num(I[0, 1])}" ixz="{_num(I[0, 2])}" '
                f'iyy="{_num(I[1, 1])}" iyz="{_num(I[1, 2])}" izz="{_num(I[2, 2])}"/></inertial>')

    parts = [f'<?xml version="1.0"?>\n<robot name="{model.name}">']
    for i, name in enumerate(model.body_names):
        parts.append(f'<link name="{name}">{inertial(i)}</link>')
    for i in range(1, model.nbody):
        j = i - 1
        parts.append(
            f'<joint name="{model.joint_names[i]}" type="revolute">'
            f'<parent link="{model.body_names[model.parent[i]]}"/>'
            f'<child link="{model.body_names[i]}"/>'
            f'<origin xyz="{_vec(model.X_T_trans[i])}" '
            f'rpy="{_vec(matrix_to_rpy(model.X_T_rot[i]))}"/>'
            f'<axis xyz="{_vec(model.axis[i])}"/>'
            f'<limit lower="{_num(model.joint_limit_lower[j])}" '
            f'upper="{_num(model.joint_limit_upper[j])}" effort="{_num(model.effort_limit[j])}" '
            f'velocity="{_num(model.velocity_limit[j])}"/>'
            f'<dynamics damping="{_num(model.damping[j])}"/></joint>')
    for name, (body, R, p) in model.fixed_frames.items():
        parts.append(f'<link name="{name}"/>')
        parts.append(f'<joint name="{name}_fixed" type="fixed">'
                     f'<parent link="{model.body_names[body]}"/><child link="{name}"/>'
                     f'<origin xyz="{_vec(p)}" rpy="{_vec(matrix_to_rpy(R))}"/></joint>')
    return "\n".join(parts) + "\n</robot>\n"


def test_tocabi_compiles_natively_at_full_width(native, tmp_path):
    """The 33-DoF Tocabi, written as a URDF from models/tocabi.npz, compiled
    natively: every field of the npz back."""
    from libdwbc_tpu_torch.model.compile import RobotModel

    model = RobotModel.load(MODEL)
    urdf, out = tmp_path / "tocabi.urdf", tmp_path / "tocabi.dwbcm"
    urdf.write_text(tocabi_urdf(model))
    native.compile_urdf_native(str(urdf), str(out))
    got = native.load_dwbcm(str(out))
    assert (got.nbody, got.ndof, got.model_dof) == (34, 39, 33)
    assert_native_equal(got, model)


def test_load_dwbcm_refuses_other_files(native, tmp_path):
    bad = tmp_path / "bad.dwbcm"
    bad.write_bytes(b"NOTDWBCM" + bytes(64))
    with pytest.raises(ValueError, match="magic"):
        native.load_dwbcm(str(bad))
    with pytest.raises(RuntimeError, match="native compile failed"):
        native.compile_urdf_native(str(tmp_path / "missing.urdf"), str(tmp_path / "x.dwbcm"))


def test_native_golden_io(native, tmp_path):
    """tests/test_native.py:60-71: the native reader agrees with the port's
    Python writer."""
    from libdwbc_tpu_torch.utils.golden import read_golden, write_golden

    rng = np.random.default_rng(0)
    M = rng.standard_normal((7, 5))
    p = str(tmp_path / "mat.bin")
    write_golden(p, M)
    assert native.golden_diff_native(p, M) < 1e-15
    assert native.golden_diff_native(p, M + 1e-3) == pytest.approx(np.sqrt(M.size) * 1e-3,
                                                                    rel=1e-6)
    np.testing.assert_array_equal(read_golden(p), M)


def test_rt_loop_hands_whole_states(native):
    """Every consumed state is one the producer wrote whole: all its entries
    carry the same tick number."""
    got = []

    def producer(state, tick):
        state[:] = tick

    def consumer(state, out):
        assert (state == state[0]).all(), state
        out[0] = state[0] * 2
        got.append(int(state[0]))

    stats = native.run_rt_loop(period_us=2000, ticks=50, state_dim=64, out_dim=1,
                               producer=producer, consumer=consumer)
    assert stats["ticks"] == len(got) > 0
    assert got == sorted(set(got)) and 0 <= got[0] and got[-1] < 50
    assert stats["min_us"] <= stats["avg_us"] <= stats["max_us"]


def test_rt_loop_raises_a_consumer_exception(native):
    calls = []

    def consumer(state, out):
        calls.append(state[0])
        if len(calls) == 3:
            raise ValueError("consumer failed on its third state")

    def producer(state, tick):
        state[:] = tick

    with pytest.raises(ValueError, match="third state"):
        native.run_rt_loop(period_us=1000, ticks=200, state_dim=4, out_dim=1,
                           producer=producer, consumer=consumer)
    assert len(calls) == 3


def test_rt_loop_raises_a_producer_exception(native):
    def producer(state, tick):
        if tick == 5:
            raise KeyError("producer")
        state[:] = tick

    with pytest.raises(KeyError):
        native.run_rt_loop(period_us=500, ticks=20, state_dim=4, out_dim=1,
                           producer=producer, consumer=lambda s, o: None)


def test_rt_loop_serves_the_fused_tick(native):
    """50 producer ticks of a moving standing state served by the plain
    float64 FusedTick through TickConsumer (cold at the tick's 12 iterations,
    then warm at 7): each τ_cmd written out equals the same warm chain called
    directly on the consumed states."""
    from libdwbc_tpu_torch import entry

    model, tick = entry._model_and_tick("cpu", torch.float64, backend="torch")
    q0, qd0, fs0 = entry._example_inputs(model, np.float64)
    cons = native.TickConsumer(tick)
    assert tick.cfg.qp_iters == 12 and native.WARM_ITERS == 7
    assert cons.state_dim == 40 + 39 + 9 + 1 and cons.out_dim == 33
    outs = []

    def producer(state, t):
        q = q0.copy()
        q[6:39] += 0.01 * np.sin(0.3 * t + np.arange(33))
        state[:] = np.concatenate([q, qd0 + 0.01 * np.cos(0.3 * t), fs0[0], fs0[1], [t]])

    def consumer(state, out):
        cons(state, out)
        outs.append(out.copy())

    stats = native.run_rt_loop(period_us=60000, ticks=50, state_dim=cons.state_dim,
                               out_dim=cons.out_dim, producer=producer, consumer=consumer)
    n = stats["ticks"]
    print(f"consumed {n} of 50 states, latency avg {stats['avg_us']:.0f} us")
    assert n == len(cons.states) == len(outs) >= 3
    warm = tick.init_warm()
    for k, state in enumerate(cons.states):
        q, qd, fs = cons.split(state)
        res, warm = tick._tick_impl(q, qd, fs, warm=warm, qp_iters=12 if k == 0 else 7)
        assert np.abs(res.torque_cmd.numpy() - outs[k]).max() <= 1e-12, k
    assert not any(cons.qp_error)
