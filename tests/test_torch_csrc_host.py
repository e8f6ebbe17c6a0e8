"""The CUDA tick kernels' lane code, compiled for the host, against the plain
tick at float64.

The per-scenario functions of csrc/tick_prestage.cu and csrc/tick_qpchain.cu
are __host__ __device__ templates; here a host C++ compiler builds their
float64 instances (the CUDA kernels and launchers are nvcc-only and left
out) and they run lane by lane over element-leading buffers.  This checks
the kernels' arithmetic, layouts and buffer sizes on the CPU; the kernels
themselves run only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from conftest import CASE_FSTAR, CASE_Q, full_q

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "libdwbc_tpu_torch", "csrc")
MODEL = os.path.join(ROOT, "models", "tocabi.npz")
B = 3

SHIM = r"""
#include "tick_prestage.cu"
#include "tick_qpchain.cu"
extern "C" {
void pre64(const double* t, const double* q, double* p, double* w, int B) {
  for (int b = 0; b < B; ++b) dwbc::prestage_lane<double>(t, q + b, p + b, w + b, B);
}
void qp64(const double* t, const double* p, const double* f, const double* wi,
          double* o, double* wo, double* w, int B, int iters) {
  for (int b = 0; b < B; ++b)
    dwbc::qpchain_lane<double>(t, p + b, f + b, wi ? wi + b : nullptr, o + b,
                               wo + b, w + b, B, iters);
}
void sizes64(const double* t, long long* out) {
  out[0] = dwbc::prestage_ws_elems(t); out[1] = dwbc::pre_elems(t);
  out[2] = dwbc::qpchain_ws_elems(t); out[3] = dwbc::out_elems(t);
  out[4] = dwbc::warm_elems(t);
}
}
"""


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "liblanes.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    str(d / "shim.cpp"), "-o", str(so)], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


def _rot_q(q, axis, angle):
    """q with its base turned by ``angle`` about ``axis`` (x, y, z at
    q[3:6], w at q[39]) and moved off the origin."""
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    q = q.copy()
    q[0:2] = (0.3, -0.2)
    q[3:6] = np.sin(angle / 2) * a
    q[39] = np.cos(angle / 2)
    return q


@pytest.fixture(scope="module", params=["cases", "serving", "turned_base"])
def setup(request):
    """Three lanes of the flagship configuration per input set: the test
    cases of conftest.py; the serving inputs (a standing q, joints +
    0.02·N(0,1), f* + 0.05·N(0,1)); and a turned, moved base with larger
    joint offsets."""
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_cuda import kernel_table
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    prog = TickProgram(m, standard_tocabi_config(m), "cpu", torch.float64)
    rng = np.random.default_rng(11)
    if request.param == "cases":
        q = np.stack([full_q(CASE_Q[1]), full_q(CASE_Q[2]),
                      full_q(CASE_Q[1] + 0.02 * rng.standard_normal(33))])
        fs = [np.stack([CASE_FSTAR[1][h], CASE_FSTAR[2][h], CASE_FSTAR[1][h]
                        + 0.05 * rng.standard_normal(CASE_FSTAR[1][h].shape[0])])
              for h in range(2)]
    else:
        q0, _, f0 = _example_inputs(m, np.float64)
        q = np.tile(q0, (B, 1))
        if request.param == "serving":
            q[:, 6:39] += 0.02 * rng.standard_normal((B, 33))
        else:
            q[:, 6:39] += 0.1 * rng.standard_normal((B, 33))
            q = np.stack([_rot_q(qb, ax, ang) for qb, ax, ang in
                          zip(q, ([0, 0, 1], [1, 0, 0], [1, 1, 1]), (0.7, 0.2, -0.3))])
        fs = [np.tile(f, (B, 1)) + 0.05 * rng.standard_normal((B, f.shape[0])) for f in f0]
    return (prog, np.ascontiguousarray(kernel_table(prog.plan)),
            np.ascontiguousarray(q.T), [np.ascontiguousarray(f.T) for f in fs])


@pytest.fixture(scope="module")
def run(lanes, setup):
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    prog, tab, q_el, fs_el = setup
    plan = prog.plan
    sz = (ctypes.c_longlong * 5)()
    lanes.sizes64(_ptr(tab), sz)
    ws_pre, n_pre, ws_qp, n_out, n_warm = list(sz)
    pre = np.zeros((n_pre, B))
    lanes.pre64(_ptr(tab), _ptr(q_el), _ptr(pre), _ptr(np.full((ws_pre, B), np.nan)), B)
    fsb = np.ascontiguousarray(np.concatenate(fs_el, 0))

    def qp(iters, warm_buf):
        out, wout = np.zeros((n_out, B)), np.zeros((n_warm, B))
        lanes.qp64(_ptr(tab), _ptr(pre), _ptr(fsb), _ptr(warm_buf), _ptr(out),
                   _ptr(wout), _ptr(np.full((ws_qp, B), np.nan)), B, iters)
        return out, wout

    out_cold, wout_cold = qp(25, None)
    out_warm, _ = qp(7, wout_cold)
    k = tc.TickKernels(prog)
    return dict(
        sizes=dict(pre=n_pre, out=n_out, warm=n_warm),
        pre=k.unpack_pre(torch.as_tensor(pre)),
        cold=k.unpack_result(torch.as_tensor(out_cold), torch.as_tensor(wout_cold)),
        warm=tc._unpack(torch.as_tensor(out_warm), tc.out_layout(plan)),
        ref_pre=prog.prestage(torch.as_tensor(q_el)),
        fs=[torch.as_tensor(f) for f in fs_el],
    )


def test_buffer_sizes_match_wrapper_layouts(run, setup):
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    plan = setup[0].plan
    assert run["sizes"] == dict(pre=tc._elems(tc.pre_layout(plan)),
                                out=tc._elems(tc.out_layout(plan)),
                                warm=tc._elems(tc.warm_layout(plan)))


@pytest.mark.parametrize("field", ["torque_grav", "P_C", "Jbar_act", "NwJw", "Ntorques",
                                   "Atemp", "bA0", "health"])
def test_prestage_lanes_match_plain(run, field):
    got, want = run["pre"][field], run["ref_pre"][field]
    if field == "Ntorques":
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    else:
        err = float((got - want).abs().max())
    assert err <= 1e-9, f"{field}: {err:.3e}"


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_qpchain_lanes_match_plain(run, setup, mode):
    prog = setup[0]
    if mode == "cold":
        ref = prog.qpchain(run["ref_pre"], run["fs"], None, 25)
    else:
        cold = prog.qpchain(run["ref_pre"], run["fs"], None, 25)
        ref = prog.qpchain(run["ref_pre"], run["fs"], cold["warm_out"], 7)
    got = run[mode]
    for name in ("torque_grav", "torque_task", "torque_contact", "torque_cmd",
                 "contact_force", "qp_gap", "qp_primal_res", "health"):
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 1e-8, f"{mode}.{name}: {err:.3e}"
    if mode == "cold":
        for (x, lam), (rx, rlam) in zip(got["warm_out"], ref["warm_out"]):
            assert float((x - rx).abs().max()) <= 1e-8
            assert float((lam - rlam).abs().max()) <= 1e-6 * (1 + float(rlam.abs().max()))
