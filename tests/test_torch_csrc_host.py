"""The CUDA kernels' lane code, compiled for the host, against the plain
versions at float64.

The per-scenario functions of csrc/tick_prestage.cu, csrc/tick_qpchain.cu,
csrc/psd_inverse.cu and csrc/qp_solve.cu are __host__ __device__
templates; here a host C++ compiler builds their float64 instances (the
CUDA kernels and launchers are nvcc-only and left out) and they run lane by
lane over the kernels' buffers.  This checks the kernels' arithmetic,
layouts and buffer sizes on the CPU; the kernels themselves run only on the
card (tests/test_torch_gpu.py, chip_smoke.py).
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
#include "psd_inverse.cu"
#include "qp_solve.cu"
extern "C" {
void psdinv64(const double* A, double* out, double* w, int B, int n) {
  for (int b = 0; b < B; ++b)
    dwbc::psd_inverse_lane<double>(A + (long long)b * n * n, out + (long long)b * n * n,
                                   w + b, B, n);
}
long long qpws64(int n, int m, int mr) { return dwbc::qp_solve_ws_elems<double>(n, m, mr); }
void qpsolve64(const double* H, const double* g, const double* C, const double* d,
               const double* x0, const double* l0, double* x, double* s, double* l,
               double* w, int B, int n, int m, int mr, int iters, double ridge) {
  for (int b = 0; b < B; ++b) {
    long long bn = (long long)b * n, bm = (long long)b * m;
    dwbc::qp_solve_lane<double>(H + bn * n, g + bn, C + bm * n, d + bm,
                                x0 ? x0 + bn : nullptr, l0 ? l0 + bm : nullptr, x + bn,
                                s + bm, l + bm, w + b, B, n, m, mr, iters, ridge);
  }
}
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
    k = tc.TickKernels(prog)
    ref_pre = prog.prestage(torch.as_tensor(q_el))
    # the QP chain's lanes take the plain prestage, the same input as the
    # plain QP chain they are held against: the two prestages differ by
    # ~1e-12, and 25 IPM iterations turn that into ~1e-6 on the dual of a
    # weakly active cone row, which would measure the prestage's roundoff,
    # not the QP chain
    pre_in = np.ascontiguousarray(k.pack_pre(ref_pre).numpy())

    def qp(iters, warm_buf):
        out, wout = np.zeros((n_out, B)), np.zeros((n_warm, B))
        lanes.qp64(_ptr(tab), _ptr(pre_in), _ptr(fsb), _ptr(warm_buf), _ptr(out),
                   _ptr(wout), _ptr(np.full((ws_qp, B), np.nan)), B, iters)
        return out, wout

    out_cold, wout_cold = qp(25, None)
    out_warm, _ = qp(7, wout_cold)
    return dict(
        sizes=dict(pre=n_pre, out=n_out, warm=n_warm),
        pre=k.unpack_pre(torch.as_tensor(pre)),
        cold=k.unpack_result(torch.as_tensor(out_cold), torch.as_tensor(wout_cold)),
        warm=tc._unpack(torch.as_tensor(out_warm), tc.out_layout(plan)),
        ref_pre=ref_pre,
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


# ------------------------------------------------ psd_inverse and qp_solve
def test_psd_inverse_lanes_match_plain(lanes):
    """The kernel's lane code at the tick's sizes (A at n = 39, W + V2ᵀV2 at
    n = 33), exact symmetry included."""
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_plain

    lanes.psdinv64.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    rng = np.random.default_rng(2)
    for n in (33, 39):
        U, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
        A = np.ascontiguousarray((U * np.logspace(0, 5, n)[None, None, :])
                                 @ np.swapaxes(U, -1, -2))
        A_junk = A + np.triu(np.full((n, n), 3.0), 1)     # only the lower triangle is read
        out = np.zeros_like(A)
        lanes.psdinv64(_ptr(A_junk), _ptr(out), _ptr(np.full((2 * n * n + n, B), np.nan)), B, n)
        ref = psd_inverse_plain(torch.as_tensor(A)).numpy()
        assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-10
        assert np.array_equal(out, np.swapaxes(out, -1, -2))


def _qp_problems(rng, n, k, extra):
    m = 2 * k + extra
    Q = rng.standard_normal((B, n, n))
    H = Q @ np.swapaxes(Q, -1, -2) * 0.1 + np.eye(n)
    g = rng.standard_normal((B, n))
    Bm = rng.standard_normal((B, k, n))
    C = np.concatenate([Bm, -Bm, rng.standard_normal((B, extra, n))], axis=1)
    d = np.einsum("bmn,bn->bm", C, rng.standard_normal((B, n))) + rng.uniform(0.05, 2.0, (B, m))
    return [np.ascontiguousarray(a) for a in (H, g, C, d)]


@pytest.mark.parametrize("mode", ["cold", "warm", "mirror"])
def test_qp_solve_lanes_match_plain(lanes, mode):
    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_plain

    p, i = ctypes.c_void_p, ctypes.c_int
    lanes.qpws64.argtypes = [i, i, i]
    lanes.qpws64.restype = ctypes.c_longlong
    lanes.qpsolve64.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_double]
    rng = np.random.default_rng(6)
    mr = 33 if mode == "mirror" else 0
    H, g, C, d = _qp_problems(rng, 12, 33 if mode == "mirror" else 20, 20)
    n, m = g.shape[1], d.shape[1]
    x0 = l0 = None
    if mode == "warm":
        x0, _, l0 = (t.numpy() for t in qp_solve_plain(*map(torch.as_tensor, (H, g, C, d)),
                                                         iters=6))
        g = np.ascontiguousarray(g + 0.01 * rng.standard_normal(g.shape))
    # stop while μ ≳ 1e-11: past that the float64 KKT system's conditioning
    # amplifies summation-order roundoff in λ (1e-6 relative by μ ≈ 1e-13),
    # and the comparison would measure roundoff, not the recurrence
    iters = 4 if mode == "warm" else 8
    x, s, lam = np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m))
    ws = np.full((lanes.qpws64(n, m, mr), B), np.nan)
    lanes.qpsolve64(_ptr(H), _ptr(g), _ptr(C), _ptr(d), _ptr(x0), _ptr(l0), _ptr(x), _ptr(s),
                    _ptr(lam), _ptr(ws), B, n, m, mr, iters, 1e-6)
    ref = qp_solve_plain(*map(torch.as_tensor, (H, g, C, d)),
                         *(None if a is None else torch.as_tensor(a) for a in (x0, l0)),
                         iters=iters, ridge=1e-6, mirror=mr)
    for name, got, want in zip(("x", "s", "lam"), (x, s, lam), ref):
        want = want.numpy()
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err <= 1e-10, f"{mode}.{name}: {err:.3e}"
