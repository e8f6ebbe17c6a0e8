"""The CUDA tick kernels on the card against their plain versions.

Marked ``gpu``: every test skips where no CUDA device is present.  On a
machine with a card (and without JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from libdwbc_tpu_torch.ops.tick_cuda import PRE_TOL, QP_TOL

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "models", "tocabi.npz")
B = 64


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def case(dev):
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_cuda import TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=12)
    q, _, fs = _example_inputs(m)
    rng = np.random.default_rng(5)
    qs = np.tile(q, (B, 1))
    qs[:, 6:39] += 0.02 * rng.standard_normal((B, 33)).astype(np.float32)
    fss = [np.tile(f, (B, 1)) + 0.05 * rng.standard_normal((B, f.shape[0])).astype(np.float32)
           for f in fs]
    return dict(
        model=m, cfg=cfg,
        kern=TickKernels(TickProgram(m, cfg, dev, torch.float32)),
        plain64=TickProgram(m, cfg, "cpu", torch.float64),
        plain32=TickProgram(m, cfg, "cpu", torch.float32),
        q_el=torch.as_tensor(np.ascontiguousarray(qs.T)),
        fs_el=[torch.as_tensor(np.ascontiguousarray(f.T)) for f in fss],
    )


def test_prestage_kernel_matches_plain_float64(case, dev):
    kern = case["kern"]
    n0 = kern.launches["tick_prestage"]
    got = kern.prestage(case["q_el"].to(dev))
    torch.cuda.synchronize()
    assert kern.launches["tick_prestage"] == n0 + 1
    ref = case["plain64"].prestage(case["q_el"].double())
    for k, tol in PRE_TOL.items():
        pairs = zip(got[k], ref[k]) if k == "Ntorques" else [(got[k], ref[k])]
        for g, r in pairs:
            assert torch.isfinite(g).all(), k
            err = float((g.cpu().double() - r).abs().max())
            assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("warm", [False, True])
def test_qpchain_kernel_matches_plain_float32(case, dev, warm):
    kern, plain = case["kern"], case["plain32"]
    pre = plain.prestage(case["q_el"])
    w_cpu = plain.qpchain(pre, case["fs_el"], None, 12)["warm_out"] if warm else None
    iters = 7 if warm else 12
    ref = plain.qpchain(pre, case["fs_el"], w_cpu, iters)
    n0 = kern.launches["tick_qpchain"]
    got = kern.qpchain({k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
                        for k, v in pre.items()},
                       [f.to(dev) for f in case["fs_el"]],
                       None if w_cpu is None else [(x.to(dev), l.to(dev)) for x, l in w_cpu],
                       iters)
    torch.cuda.synchronize()
    assert kern.launches["tick_qpchain"] == n0 + 1
    for k, tol in QP_TOL.items():
        err = float((got[k].cpu() - ref[k]).abs().max())
        assert err <= tol, (k, err, tol)
    assert float(got["qp_gap"].max()) <= 1e-3 and float(got["qp_primal_res"].max()) <= 1e-3


def test_wrapper_raises_on_bad_inputs(case, dev):
    kern = case["kern"]
    q = case["q_el"].to(dev)
    with pytest.raises(TypeError):
        kern.prestage(q.double())
    with pytest.raises(ValueError):
        kern.prestage(q[:-1].contiguous())
    with pytest.raises(ValueError):
        kern.prestage(torch.cat([q, q], 1)[:, ::2])


def test_fused_tick_cuda_serving(case, dev):
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    tick = FusedTick(case["model"], case["cfg"], dev, backend="cuda")
    q = case["q_el"].T.to(dev)
    fs = tuple(f.T.to(dev) for f in case["fs_el"])
    qd = torch.zeros((B, 39), device=dev)
    r0, w = tick._tick_impl(q, qd, fs, warm=tick.init_warm((B,)), qp_iters=12)
    r1, w = tick._tick_impl(q, qd, fs, warm=w, qp_iters=7)
    r2 = tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs))
    torch.cuda.synchronize()
    assert tick.kernels.launches == {"tick_prestage": 3, "tick_qpchain": 3}
    assert r1.torque_cmd.shape == (B, 33) and r2.torque_cmd.shape == (33,)
    assert not bool(r1.qp_error.any()) and not bool(r2.qp_error)
    assert [tuple(x.shape) for x, _ in w] == [(B, 12), (B, 9), (B, 6)]
