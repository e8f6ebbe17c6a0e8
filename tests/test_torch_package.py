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
           "libdwbc_tpu_torch.model.compile", "libdwbc_tpu_torch.kin.engine",
           "libdwbc_tpu_torch.kin.rotations", "libdwbc_tpu_torch.ops.elemlin",
           "libdwbc_tpu_torch.ops.smallmat", "libdwbc_tpu_torch.ops.linalg",
           "libdwbc_tpu_torch.ops.linalg_cuda", "libdwbc_tpu_torch.ops.qp",
           "libdwbc_tpu_torch.ops.qp_cuda", "libdwbc_tpu_torch.ops.tick_kernel",
           "libdwbc_tpu_torch.ops.tick_cuda", "libdwbc_tpu_torch.ops._build",
           "libdwbc_tpu_torch.wbc.dynamics", "libdwbc_tpu_torch.wbc.hqp",
           "libdwbc_tpu_torch.wbc.fused", "libdwbc_tpu_torch.wbc.pipeline",
           "libdwbc_tpu_torch.wbc.types", "libdwbc_tpu_torch.wbc.masked",
           "libdwbc_tpu_torch.wbc.loop")


def test_port_imports_no_jax():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            f"import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "from libdwbc_tpu_torch import entry\n"
            "model, tick = entry._model_and_tick('cpu', backend='torch')\n"
            "model, tick = entry._model_and_tick('cpu', backend='torch', fused=False)\n"
            "q, qd, fs = entry._example_inputs(model)\n"
            "tick._tick_impl(q, qd, fs)\n"
            "from libdwbc_tpu_torch.wbc.loop import make_control_loop\n"
            "model, tick = entry._model_and_tick('cpu', backend='torch', masked=True)\n"
            "q, qd, fs, m = entry._masked_inputs(model, 3)\n"
            "make_control_loop(tick, K=2, warm_start=True, gap_fallback=1e-3)(q, qd, fs, m)\n"
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
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedTick(m, cfg, device="cpu", backend="cuda", masked=True)


def test_masked_kernels_refuse_point_candidates(flagship):
    """The CUDA tick takes the flagship's two 6D candidates only: a POINT
    candidate is refused when the kernel table is built (FusedTick(masked,
    backend="cuda") builds it), never sent to the plain version."""
    import dataclasses

    from libdwbc_tpu_torch.ops.tick_cuda import kernel_table
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan
    from libdwbc_tpu_torch.wbc import types as T

    m, cfg = flagship
    assert kernel_table(TickPlan(m, cfg, masked=True))[12] == 1.0
    point = dataclasses.replace(cfg.contacts[1], contact_type=T.CONTACT_POINT)
    with pytest.raises(NotImplementedError, match="6D candidate"):
        kernel_table(TickPlan(m, dataclasses.replace(cfg, contacts=(cfg.contacts[0], point)),
                              masked=True))


def test_unknown_backend_raises(flagship):
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m, cfg = flagship
    with pytest.raises(ValueError):
        FusedTick(m, cfg, device="cpu", backend="pallas")


@pytest.mark.parametrize("stage", ["prestage", "qpchain", "tick", "masked_tick"])
def test_wrapper_routes_cpu_tensors_to_plain_version(flagship, stage):
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.ops.tick_cuda import TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m, cfg = flagship
    prog = TickProgram(m, cfg, "cpu", torch.float32, masked=stage == "masked_tick")
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
    elif stage == "tick":
        got, want = kern.tick(q_el, fs_el, None, 12), prog.tick(q_el, fs_el, None, 12)
        keys = ["torque_cmd", "contact_force"]
    else:
        cm = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
        got, want = (kern.tick(q_el, fs_el, None, 12, cmask=cm),
                     prog.tick(q_el, fs_el, None, 12, cmask=cm))
        keys = ["torque_cmd", "qp_gap"]
        with pytest.raises(ValueError):
            kern.tick(q_el, fs_el, None, 12)
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    assert kern.launches == {"tick_prestage": 0, "tick_qpchain": 0}


def test_pack_unpack_round_trip(flagship):
    _round_trip(flagship, masked=False)


def test_masked_pack_unpack_round_trip(flagship):
    _round_trip(flagship, masked=True)


def _round_trip(flagship, masked):
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m, cfg = flagship
    prog = TickProgram(m, cfg, "cpu", torch.float32, masked=masked)
    kern = tc.TickKernels(prog)
    q, _, _ = _example_inputs(m)
    pre = prog.prestage(torch.as_tensor(np.tile(q, (2, 1)).T.copy()),
                        torch.tensor([[1.0, 0.0], [1.0, 1.0]]) if masked else None)
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
