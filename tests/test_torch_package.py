"""Package boundaries of the port: no JAX, the CUDA backend refuses to run
without a card, and the kernel wrappers route CPU tensors to the plain
version."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "models", "tocabi.npz")
MODULES = ("libdwbc_tpu_torch", "libdwbc_tpu_torch.convert", "libdwbc_tpu_torch.entry",
           "libdwbc_tpu_torch.model.compile", "libdwbc_tpu_torch.ops.elemlin",
           "libdwbc_tpu_torch.ops.tick_kernel", "libdwbc_tpu_torch.ops.tick_cuda",
           "libdwbc_tpu_torch.ops._build", "libdwbc_tpu_torch.wbc.fused",
           "libdwbc_tpu_torch.wbc.pipeline", "libdwbc_tpu_torch.wbc.types")


def test_port_imports_no_jax():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            f"import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "from libdwbc_tpu_torch import entry\n"
            "model, tick = entry._model_and_tick('cpu', backend='torch')\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
            "assert not any(k.startswith('libdwbc_tpu.') or k == 'libdwbc_tpu' for k in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.fixture(scope="module")
def flagship():
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    return m, standard_tocabi_config(m, qp_iters=12)


def test_cuda_backend_raises_without_a_card(flagship):
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m, cfg = flagship
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedTick(m, cfg, device="cpu", backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedTick(m, cfg, device="cuda", backend="cuda")


def test_unknown_backend_raises(flagship):
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m, cfg = flagship
    with pytest.raises(ValueError):
        FusedTick(m, cfg, device="cpu", backend="pallas")


@pytest.mark.parametrize("stage", ["prestage", "qpchain", "tick"])
def test_wrapper_routes_cpu_tensors_to_plain_version(flagship, stage):
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.ops.tick_cuda import TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m, cfg = flagship
    prog = TickProgram(m, cfg, "cpu", torch.float32)
    kern = TickKernels(prog)
    q, _, fs = _example_inputs(m)
    q_el = torch.as_tensor(np.tile(q, (3, 1)).T.copy())
    fs_el = [torch.as_tensor(np.tile(f, (3, 1)).T.copy()) for f in fs]
    if stage == "prestage":
        got, want = kern.prestage(q_el), prog.prestage(q_el)
        keys = ["torque_grav", "Atemp", "health"]
    elif stage == "qpchain":
        pre = prog.prestage(q_el)
        got, want = kern.qpchain(pre, fs_el, None, 12), prog.qpchain(pre, fs_el, None, 12)
        keys = ["torque_cmd", "qp_gap"]
    else:
        got, want = kern.tick(q_el, fs_el, None, 12), prog.tick(q_el, fs_el, None, 12)
        keys = ["torque_cmd", "contact_force"]
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    assert kern.launches == {"tick_prestage": 0, "tick_qpchain": 0}


def test_pack_unpack_round_trip(flagship):
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m, cfg = flagship
    prog = TickProgram(m, cfg, "cpu", torch.float32)
    kern = tc.TickKernels(prog)
    q, _, _ = _example_inputs(m)
    pre = prog.prestage(torch.as_tensor(np.tile(q, (2, 1)).T.copy()))
    buf = kern.pack_pre(pre)
    assert buf.shape == (tc._elems(tc.pre_layout(prog.plan)), 2)
    back = kern.unpack_pre(buf)
    for k, v in pre.items():
        if k == "Ntorques":
            assert all(torch.equal(a, b) for a, b in zip(back[k], v))
        else:
            assert torch.equal(back[k], v), k


def test_unbatched_tick_is_lane_zero(flagship):
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m, cfg = flagship
    tick = FusedTick(m, cfg, "cpu", torch.float64, backend="torch")
    q, qd, fs = _example_inputs(m, np.float64)
    r1 = tick._tick_impl(q, qd, fs)
    rb = tick._tick_impl(np.tile(q, (2, 1)), np.tile(qd, (2, 1)),
                         tuple(np.tile(f, (2, 1)) for f in fs))
    assert r1.torque_cmd.shape == (33,) and rb.torque_cmd.shape == (2, 33)
    assert torch.allclose(r1.torque_cmd, rb.torque_cmd[0], atol=1e-10)
    w = tick.init_warm()
    r2, w2 = tick._tick_impl(q, qd, fs, warm=w, qp_iters=7)
    assert [(x.shape, l.shape) for x, l in w2] == [(x.shape, l.shape) for x, l in w]


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from libdwbc_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
