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

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "libdwbc_tpu_torch", "csrc")
MODEL = os.path.join(ROOT, "models", "tocabi.npz")
B = 3

SHIM = r"""
#include "tick_prestage.cu"
#include "tick_qpchain.cu"
#include "psd_inverse.cu"
#include "qp_solve.cu"
#include <algorithm>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

// nl > 1 lanes as threads: HostWarp's barrier on a mutex and a generation
// count, so the lanes run each phase concurrently between their syncs
struct Emu : dwbc::HostWarp {
  std::mutex mu;
  std::condition_variable cv;
  int n = 0, waiting = 0;
  long gen = 0;
};
static void emu_barrier(dwbc::HostWarp* h) {
  Emu* e = static_cast<Emu*>(h);
  std::unique_lock<std::mutex> lk(e->mu);
  const long g = e->gen;
  if (++e->waiting == e->n) {
    e->waiting = 0;
    ++e->gen;
    e->cv.notify_all();
  } else {
    e->cv.wait(lk, [&] { return e->gen != g; });
  }
}
template <class F> static void run_lanes(int nl, F f) {
  if (nl == 1) return f(dwbc::one_lane());
  Emu e;
  e.barrier = emu_barrier;
  e.n = nl;
  std::vector<std::thread> th;
  for (int l = 0; l < nl; ++l) th.emplace_back([&, l] { f(dwbc::Lanes{l, nl, &e}); });
  for (auto& t : th) t.join();
}

// The QP chain of B scenarios, one at a time: staged into a scratch copy
// of its shared working set (NaN-filled), run by nl lanes, staged out.
template <typename T>
static void qpchain(const T* t, const T* p, const T* f, const T* wi, T* o, T* wo, int B,
                    int iters, int nl) {
  const dwbc::Tab<T> tb(t);
  const long long S = dwbc::qpchain_smem_elems(tb);
  std::vector<T> sm(S);
  for (int b = 0; b < B; ++b) {
    std::fill(sm.begin(), sm.end(), (T)NAN);
    dwbc::qpchain_stage_in(tb, p, f, wi, sm.data(), S, B, b, 1, 1, 0, 1);
    dwbc::Arena<T> pa{const_cast<T*>(p) + b, B, 0};
    const dwbc::Pre<T> pg(pa, tb, f == nullptr);
    dwbc::Arena<T> sa{sm.data(), 1, 0};
    const dwbc::QPShared<T> sh(sa, tb);
    run_lanes(nl, [&](dwbc::Lanes wp) { dwbc::qpchain_warp(tb, sh, pg, iters, wi != nullptr, wp); });
    dwbc::qpchain_stage_out(tb, o, wo, sm.data(), S, B, b, 1, 1, 0, 1);
  }
}

extern "C" {
void psdinv64(const double* A, double* out, int B, int n, int nl) {
  std::vector<double> sm(dwbc::psd_inverse_smem_elems(n));
  for (int b = 0; b < B; ++b) {
    std::fill(sm.begin(), sm.end(), (double)NAN);
    const long long off = (long long)b * n * n;
    run_lanes(nl, [&](dwbc::Lanes wp) {
      dwbc::psd_inverse_warp<double>(A + off, out + off, sm.data(), n, wp);
    });
  }
}
// Per entry of an n×n grid, how many of nl lanes' strided walks visit it:
// kind 0 the trailing triangle below column j (chol_factor), 1 the upper
// triangle (ltl_sym), 2 the lower triangle (the IPM's Gram).
void walks(int kind, int n, int j, int nl, int* cnt) {
  for (int l = 0; l < nl; ++l) {
    if (kind == 0) {
      int i = j + 1, k = j + 1;
      for (dwbc::walk_trailing(i, k, j, l); i < n; dwbc::walk_trailing(i, k, j, nl)) ++cnt[i * n + k];
    } else if (kind == 1) {
      int i = 0, k = 0;
      for (dwbc::walk_upper(i, k, n, l); i < n; dwbc::walk_upper(i, k, n, nl)) ++cnt[i * n + k];
    } else {
      int i = 0, k = 0;
      for (dwbc::walk_lower(i, k, l); i < n; dwbc::walk_lower(i, k, nl)) ++cnt[i * n + k];
    }
  }
}
// A routine of elemlin.cuh by nl lanes, on 64×64 row-major buffers: A and
// Bm the inputs, C the result, S1, S2 (64×64) and D (64) scratch, all
// NaN-filled by the caller but the inputs.  kind: the index in ELEM_KINDS
// of the test; shapes (m, k, n) as the routine names them.
void elem64(int kind, int m, int k, int n, const double* A, const double* Bm, double* C,
            double* S1, double* S2, double* D, int nl) {
  using Mt = dwbc::M<double>;
  const Mt a{const_cast<double*>(A), 1, 64}, bm{const_cast<double*>(Bm), 1, 64}, c{C, 1, 64},
      s1{S1, 1, 64}, s2{S2, 1, 64};
  const dwbc::V<double> d{D, 1};
  run_lanes(nl, [&](dwbc::Lanes wp) {
    switch (kind) {
      case 0: dwbc::mm(c, a, bm, m, k, n, wp); break;
      case 1: dwbc::mmT(c, a, bm, m, k, n, wp); break;
      case 2: dwbc::mTm(c, a, bm, k, m, n, wp); break;
      case 3: dwbc::mmT_sym(c, a, bm, m, k, wp); break;
      case 4: dwbc::mTm_sym(c, a, bm, k, m, wp); break;
      case 5: dwbc::mm_sym(c, a, bm, m, k, wp); break;
      case 6: dwbc::copy_mat(c, a, m, n, wp); break;
      case 7:
        dwbc::copy_mat(s1, a, m, m, wp);
        dwbc::chol_factor(s1, d, m, wp);
        dwbc::cho_solve(c, s1, d, bm, m, n, wp);
        break;
      case 8: dwbc::qr_thin(c, a, m, k, 0.0, wp); break;
      case 9:
        dwbc::copy_mat(c, a, m, k, wp);
        dwbc::orthonormalize_drop(c, m, k, 1e-8, wp);
        break;
      case 10:
        dwbc::copy_mat(c, a, m, k, wp);
        dwbc::compact_columns(c, m, k, 1e-10, wp);
        break;
      case 11: dwbc::complete_basis_tail(c, a, s1, s2, m, k, wp); break;
      case 12: dwbc::qr_pinv(c, a, s1, s2, m, 1e-6, wp); break;
      case 13: dwbc::psd_inverse(c, a, s1, s2, d, m, wp); break;
      case 14: {
        const double h = dwbc::chol_health(a, s1, d, m, wp);
        if (wp.lane == 0) C[0] = h;
        wp.sync();
        break;
      }
    }
  });
}
long long qpsm64(int n, int m, int mr) { return dwbc::qp_solve_smem_elems<double>(n, m, mr); }
// B problems, one at a time, each run by nl lanes on a NaN-filled scratch
// copy of its shared working set.
void qpsolve64(const double* H, const double* g, const double* C, const double* d,
               const double* x0, const double* l0, double* x, double* s, double* l, int B,
               int n, int m, int mr, int iters, double ridge, int nl) {
  std::vector<double> sm(dwbc::qp_solve_smem_elems<double>(n, m, mr));
  for (int b = 0; b < B; ++b) {
    std::fill(sm.begin(), sm.end(), (double)NAN);
    const long long bn = (long long)b * n, bm = (long long)b * m;
    run_lanes(nl, [&](dwbc::Lanes wp) {
      dwbc::qp_solve_warp<double>(H + bn * n, g + bn, C + bm * n, d + bm,
                                  x0 ? x0 + bn : nullptr, l0 ? l0 + bm : nullptr, x + bn,
                                  s + bm, l + bm, sm.data(), n, m, mr, iters, ridge, wp);
    });
  }
}
// The prestage of B scenarios, one at a time, run by nl lanes: w is the
// scenario-major workspace (B × prestage_ws_elems), the shared part a
// NaN-filled scratch per scenario.
void pre64(const double* t, const double* q, const double* cm, const double* qd,
           const double* fs, const double* sv, int smask, double* p, double* w, int B,
           int nl) {
  const long long wse = dwbc::prestage_ws_elems(t);
  std::vector<double> sm(dwbc::prestage_smem_elems(t));
  for (int b = 0; b < B; ++b) {
    std::fill(sm.begin(), sm.end(), (double)NAN);
    run_lanes(nl, [&](dwbc::Lanes wp) {
      dwbc::prestage_lane<double>(t, q + b, cm ? cm + b : nullptr, qd ? qd + b : nullptr,
                                  fs ? fs + b : nullptr, sv ? sv + b : nullptr, smask, p + b,
                                  w + b * wse, sm.data(), B, wp);
    });
  }
}
void qp64(const double* t, const double* p, const double* f, const double* wi,
          double* o, double* wo, int B, int iters, int nl) {
  qpchain<double>(t, p, f, wi, o, wo, B, iters, nl);
}
void qp32(const float* t, const float* p, const float* f, const float* wi,
          float* o, float* wo, int B, int iters) {
  qpchain<float>(t, p, f, wi, o, wo, B, iters, 1);
}
void sizes64(const double* t, long long* out) {
  const dwbc::Tab<double> tb(t);
  out[0] = dwbc::prestage_ws_elems(t); out[1] = dwbc::pre_elems(t, false);
  out[2] = dwbc::qpchain_smem_elems(tb); out[3] = dwbc::out_elems(tb);
  out[4] = dwbc::warm_elems(tb); out[5] = dwbc::pre_elems(t, true);
  out[6] = dwbc::prestage_smem_elems(t); out[7] = dwbc::kPreSmemMax;
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
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", "-I", CSRC,
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


def _sizes(lanes, tab):
    """(prestage workspace, pre, QP chain's shared working set, out, warm,
    servo'd pre, prestage's shared part, the kernel's shared floats per
    scenario) elements per lane."""
    sz = (ctypes.c_longlong * 8)()
    lanes.sizes64(_ptr(tab), sz)
    return list(sz)


def _lane_run(lanes, prog, tab, q_el, fs_el, cm_el=None):
    """The prestage lanes on q (and the contact mask), and the QP chain
    (one lane per scenario), cold at 25 iterations then warm at 7, on the
    plain prestage."""
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    plan = prog.plan
    ws_pre, n_pre, _, n_out, n_warm, _, smem_pre, smem_cap = _sizes(lanes, tab)
    assert smem_pre <= smem_cap
    pre = np.zeros((n_pre, B))
    lanes.pre64(_ptr(tab), _ptr(q_el), _ptr(cm_el), None, None, None, 0, _ptr(pre),
                _ptr(np.full((B, ws_pre), np.nan)), B, 1)
    fsb = np.ascontiguousarray(np.concatenate(fs_el, 0))
    k = tc.TickKernels(prog)
    ref_pre = prog.prestage(torch.as_tensor(q_el),
                            None if cm_el is None else torch.as_tensor(cm_el))
    # the QP chain's lanes take the plain prestage, the same input as the
    # plain QP chain they are held against: the two prestages differ by
    # ~1e-12, and 25 IPM iterations turn that into ~1e-6 on the dual of a
    # weakly active cone row, which would measure the prestage's roundoff,
    # not the QP chain
    pre_in = np.ascontiguousarray(k.pack_pre(ref_pre).buf.numpy())

    def qp(iters, warm_buf, nl=1):
        out, wout = np.zeros((n_out, B)), np.zeros((n_warm, B))
        lanes.qp64(_ptr(tab), _ptr(pre_in), _ptr(fsb), _ptr(warm_buf), _ptr(out),
                   _ptr(wout), B, iters, nl)
        return out, wout

    out_cold, wout_cold = qp(25, None)
    out_warm, _ = qp(7, wout_cold)
    return dict(
        qp=qp, raw=dict(cold=(out_cold, wout_cold), warm=out_warm),
        sizes=dict(pre=n_pre, out=n_out, warm=n_warm),
        pre=k.unpack_pre(tc.PackedPre(torch.as_tensor(pre), False)),
        cold=k.unpack_result(torch.as_tensor(out_cold), torch.as_tensor(wout_cold)),
        warm=tc._unpack(torch.as_tensor(out_warm), tc.out_layout(plan)),
        ref_pre=ref_pre,
        fs=[torch.as_tensor(f) for f in fs_el],
        cm=None if cm_el is None else torch.as_tensor(cm_el),
    )


@pytest.fixture(scope="module")
def run(lanes, setup):
    return _lane_run(lanes, *setup)


def _warp_lanes_match_one_lane(r):
    """The QP chain run by 32 lanes as threads (the kernel's warp, each
    phase concurrent between syncs) gives the one-lane results bit for bit,
    cold and then warm from the cold warm state: every output and warm
    state element is computed, once, by the same operations in the same
    order."""
    out, wout = r["qp"](25, None, 32)
    assert np.array_equal(out, r["raw"]["cold"][0]) and np.array_equal(wout, r["raw"]["cold"][1])
    out, _ = r["qp"](7, r["raw"]["cold"][1], 32)
    assert np.array_equal(out, r["raw"]["warm"])


def test_qpchain_warp_lanes_match_one_lane(run):
    _warp_lanes_match_one_lane(run)


def _prestage_buffers(lanes, tab, q_el, nl, cm_el=None, servo=None):
    """The prestage lanes on every scenario, run by nl lanes as threads (a
    NaN-filled workspace and shared part): (prestage buffer, workspace)."""
    n_ws, n_pre, n_pre_servo = (_sizes(lanes, tab)[i] for i in (0, 1, 5))
    nb = q_el.shape[1]
    pre = np.full((n_pre_servo if servo else n_pre, nb), np.nan)
    ws = np.full((nb, n_ws), np.nan)
    qd, fs, sv, smask = servo if servo else (None, None, None, 0)
    lanes.pre64(_ptr(tab), _ptr(q_el), _ptr(cm_el), _ptr(qd), _ptr(fs), _ptr(sv), smask,
                _ptr(pre), _ptr(ws), nb, nl)
    return pre, ws


def _prestage_warp_lanes_match_one_lane(lanes, tab, q_el, cm_el=None, servo=None):
    """The prestage run by 32 and by 5 lanes as threads (the kernel's warp,
    each phase concurrent between syncs) gives the one-lane prestage buffer
    and workspace bit for bit: every element is computed, once, by the same
    operations in the same order."""
    pre1, ws1 = _prestage_buffers(lanes, tab, q_el, 1, cm_el, servo)
    assert np.isfinite(pre1).all()
    for nl in (32, 5):
        pre, ws = _prestage_buffers(lanes, tab, q_el, nl, cm_el, servo)
        assert np.array_equal(pre, pre1), nl
        assert np.array_equal(ws, ws1, equal_nan=True), nl


def test_prestage_warp_lanes_match_one_lane(lanes, setup):
    _prestage_warp_lanes_match_one_lane(lanes, setup[1], setup[2])


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


# ---------------------------------------------------- masked mode
HYPOTHESES = ("both feet", "left foot", "right foot")   # lanes 0, 1, 2


@pytest.fixture(scope="module", params=["sweep", "turned_base"])
def msetup(request):
    """The masked flagship (the two feet as candidates) on three lanes, one
    per support hypothesis: the masked sweep's inputs, and a turned, moved
    base with larger joint offsets."""
    from libdwbc_tpu_torch.entry import _masked_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_cuda import kernel_table
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    prog = TickProgram(m, standard_tocabi_config(m), "cpu", torch.float64, masked=True)
    q, _, fs, masks = (np.asarray(a, np.float64) if not isinstance(a, tuple)
                       else tuple(np.asarray(f, np.float64) for f in a)
                       for a in _masked_inputs(m, B, seed=4))
    if request.param == "turned_base":
        q[:, 6:39] += 0.1 * np.random.default_rng(12).standard_normal((B, 33))
        q = np.stack([_rot_q(qb, ax, ang) for qb, ax, ang in
                      zip(q, ([0, 0, 1], [1, 0, 0], [1, 1, 1]), (0.7, 0.2, -0.3))])
    return (prog, np.ascontiguousarray(kernel_table(prog.plan)), np.ascontiguousarray(q.T),
            [np.ascontiguousarray(f.T) for f in fs], np.ascontiguousarray(masks.T))


@pytest.fixture(scope="module")
def mrun(lanes, msetup):
    return _lane_run(lanes, *msetup)


def test_masked_qpchain_warp_lanes_match_one_lane(mrun):
    _warp_lanes_match_one_lane(mrun)


def test_masked_prestage_warp_lanes_match_one_lane(lanes, msetup):
    """As test_prestage_warp_lanes_match_one_lane, one lane per support
    hypothesis (both feet, left, right)."""
    _prestage_warp_lanes_match_one_lane(lanes, msetup[1], msetup[2], msetup[4])


def test_masked_buffer_sizes_match_wrapper_layouts(mrun, msetup):
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    plan = msetup[0].plan
    assert mrun["sizes"] == dict(pre=tc._elems(tc.pre_layout(plan)),
                                 out=tc._elems(tc.out_layout(plan)),
                                 warm=tc._elems(tc.warm_layout(plan)))
    assert tc.pre_layout(plan)[-2:] == [("crow_mask", (20,)), ("active_cdof", ())]


@pytest.mark.parametrize("field", ["torque_grav", "P_C", "Jbar_act", "NwJw", "Ntorques",
                                   "Atemp", "bA0", "health", "crow_mask", "active_cdof"])
def test_masked_prestage_lanes_match_plain(mrun, field):
    """Per hypothesis within 1e-10; the masks exactly; in a single-support
    lane NwJw and the dead foot's rows of J̄ᵀ exactly zero."""
    got, want = mrun["pre"][field], mrun["ref_pre"][field]
    if field == "Ntorques":
        got, want = (torch.cat([t.flatten(0, -2) for t in x], 0) for x in (got, want))
    got, want = got.movedim(-1, 0), want.movedim(-1, 0)
    for b, hyp in enumerate(HYPOTHESES):
        err = float((got[b] - want[b]).abs().max())
        if field in ("crow_mask", "active_cdof"):
            assert torch.equal(got[b], want[b]), (hyp, field)
        assert err <= 1e-10, f"{hyp}: {field} {err:.3e}"
    if field == "NwJw":
        assert not got[1].any() and not got[2].any()
    if field == "Jbar_act":
        assert not got[1][6:].any() and not got[2][:6].any()


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_masked_qpchain_lanes_match_plain(mrun, msetup, mode):
    """Per hypothesis within 1e-10; the warm state out as in the static test
    (the duals of weakly active rows carry the prestage roundoff, ~1e-9)."""
    prog = msetup[0]
    cold = prog.qpchain(mrun["ref_pre"], mrun["fs"], None, 25)
    ref = cold if mode == "cold" else prog.qpchain(mrun["ref_pre"], mrun["fs"],
                                                   cold["warm_out"], 7)
    got = mrun[mode]
    for name in ("torque_grav", "torque_task", "torque_contact", "torque_cmd",
                 "contact_force", "qp_gap", "qp_primal_res", "health"):
        for b, hyp in enumerate(HYPOTHESES):
            err = float((got[name][..., b] - ref[name][..., b]).abs().max())
            assert err <= 1e-10, f"{mode} {hyp}: {name} {err:.3e}"
    if mode == "cold":
        for (x, lam), (rx, rlam) in zip(got["warm_out"], ref["warm_out"]):
            assert float((x - rx).abs().max()) <= 1e-10
            assert float((lam - rlam).abs().max()) <= 1e-6 * (1 + float(rlam.abs().max()))


def test_float32_masked_warm_lanes_stay_near_float64(lanes):
    """The QP chain's lanes in float32 (as the kernel runs them, built by
    the host compiler) on 1024 lanes of the masked sweep, cold at 12
    iterations then warm at 7, against the plain float64 QP chain from the
    same prestage and warm state: every lane within 1e-3 Nm in τ_cmd.  A
    step from the clamped factor of a Gram that lost a pivot would move a
    warm single-support lane's δf* far from its optimum at a tiny gap."""
    from libdwbc_tpu_torch.entry import _masked_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    n = 1024
    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=12)
    p32 = TickProgram(m, cfg, "cpu", torch.float32, masked=True)
    p64 = TickProgram(m, cfg, "cpu", torch.float64, masked=True)
    q, _, fs, masks = _masked_inputs(m, n, seed=0)
    fs_el = [torch.as_tensor(np.ascontiguousarray(f.T)) for f in fs]
    pre = p32.prestage(torch.as_tensor(np.ascontiguousarray(q.T)),
                       torch.as_tensor(np.ascontiguousarray(masks.T)))
    k = tc.TickKernels(p32)
    tab = np.ascontiguousarray(tc.kernel_table(p32.plan).astype(np.float32))
    pre_in = np.ascontiguousarray(k.pack_pre(pre).buf.numpy())
    fsb = np.ascontiguousarray(np.concatenate([f.numpy() for f in fs_el], 0))
    n_out, n_warm = tc._elems(tc.out_layout(p32.plan)), tc._elems(tc.warm_layout(p32.plan))

    def qp(iters, warm_buf):
        out, wout = np.zeros((n_out, n), np.float32), np.zeros((n_warm, n), np.float32)
        lanes.qp32(_ptr(tab), _ptr(pre_in), _ptr(fsb), _ptr(warm_buf), _ptr(out),
                   _ptr(wout), n, iters)
        return out, wout

    _, wout = qp(12, None)
    out, _ = qp(7, wout)
    warm_in = k.unpack_result(torch.as_tensor(np.zeros((n_out, n), np.float32)),
                              torch.as_tensor(wout))["warm_out"]
    ref = p64.qpchain({key: ([t.double() for t in v] if isinstance(v, list) else v.double())
                       for key, v in pre.items()}, [f.double() for f in fs_el],
                      [(x.double(), lam.double()) for x, lam in warm_in], 7)
    got = tc._unpack(torch.as_tensor(out), tc.out_layout(p32.plan))
    err = (got["torque_cmd"].double() - ref["torque_cmd"]).abs().amax(0)
    assert float(err.max()) <= 1e-3, f"{int((err > 1e-3).sum())} lanes, max {float(err.max()):.3e}"


# ------------------------------------------------------ the servo branch
@pytest.fixture(scope="module", params=["static", "masked"])
def srun(lanes, request):
    """The servo'd prestage lanes (entry._servo_inputs: moving states, a
    pelvis 6D and a link-15 rotation servo on per-lane clocks; masked: one
    support hypothesis per lane) and the QP chain's lanes reading their f*
    from a servo'd prestage buffer, against the plain versions at float64."""
    from libdwbc_tpu_torch.entry import _servo_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    masked = request.param == "masked"
    tick = FusedTick(m, standard_tocabi_config(m), "cpu", torch.float64, backend="torch",
                     masked=masked)
    prog = tick.prog
    q, qd, fs, servos = _servo_inputs(m, B, seed=7, dtype=np.float64)
    q_el, qd_el = (torch.as_tensor(np.ascontiguousarray(a.T)) for a in (q, qd))
    fs_el = [torch.as_tensor(np.ascontiguousarray(f.T)) for f in fs]
    cm_el = (torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]], dtype=torch.float64) if masked
             else None)
    sv_el = tick._servos_el(servos, B)
    k = tc.TickKernels(prog)
    tab = np.ascontiguousarray(tc.kernel_table(prog.plan))
    ws_pre, _, _, n_out, n_warm, n_pre, _, _ = _sizes(lanes, tab)
    pre = np.zeros((n_pre, B))
    smask = tc.servo_mask(sv_el, prog.plan)
    lanes.pre64(_ptr(tab), _ptr(q_el.numpy()), _ptr(None if cm_el is None else cm_el.numpy()),
                _ptr(qd_el.numpy()), _ptr(np.ascontiguousarray(torch.cat(fs_el).numpy())),
                _ptr(tc.pack_servos(sv_el, prog.plan, B).numpy()), smask, _ptr(pre),
                _ptr(np.full((B, ws_pre), np.nan)), B, 1)
    ref_pre = k.prestage(q_el, cm_el, qd_el, fs_el, sv_el)
    # the QP chain's lanes on the plain servo'd prestage (see _lane_run)
    buf = np.ascontiguousarray(k.pack_pre(ref_pre).buf.numpy())

    def qp(nl):
        out, wout = np.zeros((n_out, B)), np.zeros((n_warm, B))
        lanes.qp64(_ptr(tab), _ptr(buf), None, None, _ptr(out), _ptr(wout), B, 25, nl)
        return out, wout

    out, wout = qp(1)
    servo = (np.ascontiguousarray(qd_el.numpy()), np.ascontiguousarray(torch.cat(fs_el).numpy()),
             np.ascontiguousarray(tc.pack_servos(sv_el, prog.plan, B).numpy()), smask)
    return dict(smask=smask, n_pre=n_pre, plan=prog.plan, qp=qp, raw=(out, wout), tab=tab,
                q_el=np.ascontiguousarray(q_el.numpy()), servo=servo,
                cm_el=None if cm_el is None else np.ascontiguousarray(cm_el.numpy()),
                pre=k.unpack_pre(tc.PackedPre(torch.as_tensor(pre), True)),
                ref_pre=ref_pre, out=tc._unpack(torch.as_tensor(out), tc.out_layout(prog.plan)),
                ref_out=prog.qpchain(ref_pre, ref_pre["fstars"], None, 25))


def test_servo_qpchain_warp_lanes_match_one_lane(srun):
    """As test_qpchain_warp_lanes_match_one_lane, f* read from the servo
    section: 32 lanes as threads give the one-lane results bit for bit."""
    out, wout = srun["qp"](32)
    assert np.array_equal(out, srun["raw"][0]) and np.array_equal(wout, srun["raw"][1])


def test_servo_prestage_warp_lanes_match_one_lane(lanes, srun):
    """As test_prestage_warp_lanes_match_one_lane on a servo'd call (the
    servo on lane 0), static and masked."""
    _prestage_warp_lanes_match_one_lane(lanes, srun["tab"], srun["q_el"], srun["cm_el"],
                                        srun["servo"])


def test_servo_lanes_match_plain(srun):
    """Every prestage field, each level's blended f* and the servo'd task
    links' states within 1e-10 of the plain servo'd prestage, lane by lane;
    the QP chain reading that f* from the buffer within 1e-8."""
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    assert srun["smask"] == 0b11
    assert srun["n_pre"] == tc._elems(tc.pre_layout(srun["plan"], servo=True))
    got, want = srun["pre"], srun["ref_pre"]
    for name in ("torque_grav", "P_C", "Jbar_act", "NwJw", "Atemp", "bA0", "health"):
        err = float((got[name] - want[name]).abs().max())
        assert err <= 1e-10, f"{name}: {err:.3e}"
    for h in range(2):
        err = float((got["Ntorques"][h] - want["Ntorques"][h]).abs().max())
        assert err <= 1e-10, f"Ntorques.{h}: {err:.3e}"
        err = float((got["fstars"][h] - want["fstars"][h]).abs().max())
        assert err <= 1e-10, f"fstars.{h}: {err:.3e}"
        for name, g, w in zip(("pos", "vel", "rot", "w"), got["task_states"][(h, 0)],
                              want["task_states"][(h, 0)]):
            err = float((g - w).abs().max())
            assert err <= 1e-10, f"task state {h} {name}: {err:.3e}"
    for name in ("torque_grav", "torque_task", "torque_contact", "torque_cmd",
                 "contact_force", "qp_gap", "qp_primal_res"):
        err = float((srun["out"][name] - srun["ref_out"][name]).abs().max())
        assert err <= 1e-8, f"{name}: {err:.3e}"


@pytest.fixture(scope="module")
def s32():
    """512 lanes of chip_smoke.py phase 12's servo'd inputs: the plain
    float64 servo'd prestage cast to float32, its packed buffer, and the
    plain float32 QP chain cold at 12 iterations."""
    from libdwbc_tpu_torch.entry import _servo_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    n = 512
    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=12)
    t64, t32 = (FusedTick(m, cfg, "cpu", dt, backend="torch") for dt in (torch.float64,
                                                                         torch.float32))
    q, qd, fs, servos = _servo_inputs(m, n, seed=0, dtype=np.float64)
    el = (lambda a: torch.as_tensor(np.ascontiguousarray(a.T)))
    pre64 = t64.prog.prestage_servo(el(q), None, el(qd), [el(f) for f in fs],
                                    t64._servos_el(servos, n))
    pre32 = {k: ([t.float() for t in v] if isinstance(v, list) else
                 {key: tuple(t.float() for t in x) for key, x in v.items()}
                 if isinstance(v, dict) else v.float()) for k, v in pre64.items()}
    k = tc.TickKernels(t32.prog)
    cold = t32.prog.qpchain(pre32, pre32["fstars"], None, 12)
    return dict(n=n, p32=t32.prog, p64=t64.prog, pre32=pre32, k=k, cold=cold,
                buf=np.ascontiguousarray(k.pack_pre(pre32).buf.numpy()),
                tab=np.ascontiguousarray(tc.kernel_table(t32.prog.plan).astype(np.float32)))


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_float32_servo_qpchain_lanes_within_servo_bars(lanes, s32, mode):
    """The QP chain's lanes in float32 (as the kernel runs them, built by
    the host compiler) reading their f* from a servo'd buffer, against the
    plain float32 QP chain, cold at 12 iterations and warm at 7 from its
    cold solution: phase 12's per-lane rule of chip_smoke.py, each lane
    within the larger of QP_TOL and SERVO_OWN × its float32 distance from
    float64, at most SERVO_LANES_OVER of the lanes beyond.  A QP chain that
    read its f* one element off the servo section puts almost every lane
    beyond."""
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    c, n = s32, s32["n"]
    pre, p32 = c["pre32"], c["p32"]
    warm = None if mode == "cold" else c["cold"]["warm_out"]
    iters = 12 if mode == "cold" else 7
    ref = c["cold"] if mode == "cold" else p32.qpchain(pre, pre["fstars"], warm, iters)
    pre64 = {k: ([t.double() for t in v] if isinstance(v, list) else
                 {key: tuple(t.double() for t in x) for key, x in v.items()}
                 if isinstance(v, dict) else v.double()) for k, v in pre.items()}
    ref64 = c["p64"].qpchain(pre64, pre64["fstars"], None if warm is None else
                             [(x.double(), lam.double()) for x, lam in warm], iters)
    n_out, n_warm = tc._elems(tc.out_layout(p32.plan)), tc._elems(tc.warm_layout(p32.plan))
    out, wout = np.zeros((n_out, n), np.float32), np.zeros((n_warm, n), np.float32)
    w_in = None if warm is None else np.ascontiguousarray(
        torch.cat([t for xl in warm for t in xl], 0).numpy())
    lanes.qp32(_ptr(c["tab"]), _ptr(c["buf"]), None, _ptr(w_in), _ptr(out), _ptr(wout),
               n, iters)
    got = tc._unpack(torch.as_tensor(out), tc.out_layout(p32.plan))
    for name, tol in tc.QP_TOL.items():
        over, allowed = tc.servo_lanes_over(tc.lane_err(got[name], ref[name]),
                                            tc.lane_err(ref[name], ref64[name]), tol)
        print(f"{mode} {name}: {over} of {n} lanes beyond their bar (allowed {allowed})")
        assert over <= allowed, (mode, name, over, allowed)


# ------------------------------------------ general plans (not the flagship)
def _general_cfg(model, name):
    """BASELINE's config 3 (single support, a swing-foot third level); the
    mixed task set (entry._mixed_tasks_config: a whole-body COM 6D level, a
    custom-frame position and a rotation task in one level, a COM-frame
    position level) on the flagship's two 6D feet; the hands-and-feet
    fixture (entry._hands_feet_config: 6D feet, POINT hands on links 23 and
    31); the flagship's tasks on LINE feet (edge stance, plane_y 0); the
    flagship without a torque limit; one foot under a level of 9 task rows
    (a 6D pelvis task and a position task on the right hand, link 31) over
    a rotation level on link 15; or the flagship's tasks on one POINT foot
    (3 contact dof: no kernel basis, the 6×6 health of a rank-3 block)."""
    import dataclasses

    from libdwbc_tpu_torch.entry import _hands_feet_config, _mixed_tasks_config
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    base = standard_tocabi_config(model)
    if name == "config3":
        return standard_tocabi_config(model, both_feet=False, swing_task=True)
    if name == "hands":
        return _hands_feet_config(model)
    if name == "line_feet":
        return dataclasses.replace(base, contacts=tuple(
            dataclasses.replace(c, contact_type=T.CONTACT_LINE, plane_y=0.0)
            for c in base.contacts))
    if name == "no_limit":
        return dataclasses.replace(base, torque_limit=None)
    if name == "one_point":
        single = standard_tocabi_config(model, both_feet=False)
        return dataclasses.replace(single, contacts=(dataclasses.replace(
            single.contacts[0], contact_type=T.CONTACT_POINT),))
    if name == "wide_level":
        return dataclasses.replace(standard_tocabi_config(model, both_feet=False), task_specs=(
            ((T.TASK_LINK_6D, 0), (T.TASK_LINK_POSITION, 31)), ((T.TASK_LINK_ROTATION, 15),)))
    return _mixed_tasks_config(model, base)


# per masked plan, the candidates' 0/1 masks of the three lanes (nc, B):
# the two feet both, left, right; the four hands-and-feet candidates all,
# feet and the left hand, the left foot and the right hand
GENERAL_MASKS = {"mixed": [[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]],
                 "hands": [[1.0, 1.0, 1.0], [1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [1.0, 0.0, 1.0]]}


@pytest.fixture(scope="module", params=["config3", "mixed", "mixed_masked", "hands",
                                        "hands_masked", "line_feet", "no_limit", "wide_level",
                                        "one_point"])
def gsetup(request):
    """Three lanes of a general plan: the standing q with 0.02·N(0,1) on the
    joints, the last lane's base turned and moved, f* 0.1·N(0,1); masked:
    the plan's contacts as candidates, one hypothesis per lane
    (GENERAL_MASKS)."""
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_cuda import kernel_table
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m = RobotModel.load(MODEL)
    name = request.param.removesuffix("_masked")
    masked = name != request.param
    prog = TickProgram(m, _general_cfg(m, name), "cpu", torch.float64, masked=masked)
    rng = np.random.default_rng(13)
    q = np.stack([full_q(CASE_Q[1] + 0.02 * rng.standard_normal(33)) for _ in range(B)])
    q[-1] = _rot_q(q[-1], [1, 1, 1], -0.3)
    fs = [0.1 * rng.standard_normal((B, t)) for t in prog.plan.level_tdofs]
    cm = np.array(GENERAL_MASKS[name]) if masked else None
    return (prog, np.ascontiguousarray(kernel_table(prog.plan)), np.ascontiguousarray(q.T),
            [np.ascontiguousarray(f.T) for f in fs], cm)


@pytest.fixture(scope="module")
def grun(lanes, gsetup):
    return _lane_run(lanes, *gsetup)


def test_general_qpchain_warp_lanes_match_one_lane(grun):
    _warp_lanes_match_one_lane(grun)


def test_general_prestage_warp_lanes_match_one_lane(lanes, gsetup):
    """As test_prestage_warp_lanes_match_one_lane: the whole-body COM
    jacobian, the gathered task rows and the third level's null space
    too."""
    _prestage_warp_lanes_match_one_lane(lanes, gsetup[1], gsetup[2], gsetup[4])


def test_general_buffer_sizes_match_wrapper_layouts(grun, gsetup):
    """The kernels' buffers against the wrapper's layouts; with one contact
    the warm state has no redistribution QP (cfree = 0, config 3: QPs (6,
    76), (3, 76), (6, 76)); without a torque limit every QP has the k_rows
    constraint rows alone."""
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    plan = gsetup[0].plan
    assert grun["sizes"] == dict(pre=tc._elems(tc.pre_layout(plan)),
                                 out=tc._elems(tc.out_layout(plan)),
                                 warm=tc._elems(tc.warm_layout(plan)))
    m = plan.k_rows + (0 if plan.tlim is None else 2 * plan.mdof)
    nv = [t + plan.cfree for t in plan.level_tdofs] + ([plan.cfree] if plan.cfree else [])
    assert [shape for _, shape in tc.warm_layout(plan)] == [
        s for n in nv for s in ((n,), (m,))]
    if plan.cfree == 0 and plan.level_tdofs == [6, 3, 6]:
        assert nv == [6, 3, 6] and m == 76


@pytest.mark.parametrize("field", ["torque_grav", "P_C", "Jbar_act", "NwJw", "Ntorques",
                                   "Atemp", "bA0", "health"])
def test_general_prestage_lanes_match_plain(grun, gsetup, field):
    """Every prestage field within 1e-9 of the plain float64 prestage; with
    one contact NwJw is absent, as in the plain version.  NwJw = V2·M⁺,
    M = J̄ᵀ's first (active contact dof − 6) active rows times the kernel
    basis V2: with more than two contacts M can be singular (the hands'
    rows), and then which column its thresholded QR drops, and so NwJw,
    follows the basis that a near-tie of complete_basis picks; what is
    determined is M·M⁺ = J̄ᵀ[rows]·NwJw, held on every plan, NwJw itself on
    plans of at most two contacts (on the hands plan the lanes' NwJw and
    the plain version's part by up to 1.56)."""
    plan = gsetup[0].plan
    got, want = grun["pre"][field], grun["ref_pre"][field]
    if field == "NwJw" and plan.cfree == 0:
        assert got is None and want is None
        return
    if field == "NwJw":
        from libdwbc_tpu_torch.ops.tick_cuda import nwjw_determined

        prod = [nwjw_determined(grun[k], plan, grun["cm"]) for k in ("pre", "ref_pre")]
        err = float((prod[0] - prod[1]).abs().max())
        assert err <= 1e-9, f"J̄ᵀ·NwJw: {err:.3e}"
        if len(plan.cfg.contacts) > 2:
            return
    if field == "Ntorques":
        assert len(got) == len(want) == len(gsetup[0].plan.level_tdofs)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    else:
        err = float((got - want).abs().max())
    assert err <= 1e-9, f"{field}: {err:.3e}"


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_general_qpchain_lanes_match_plain(grun, gsetup, mode):
    """As test_qpchain_lanes_match_plain: every output within 1e-8, cold at
    25 iterations and warm at 7 from each side's own warm state; with one
    contact τ_contact exactly zero.  The warm state out is held at 6 cold
    iterations, while μ ≳ 1e-12 on every lane: past that summation-order
    roundoff moves duals that the solution leaves ill-determined (the
    mixed set's turned-base lane: eight cone and ZMP rows active against
    a zero-Hessian contact block, λ moved by O(1) by iteration 15 while x
    stays within 1e-12; its masked left-foot lane: a ZMP row's dual moved
    by 6e-4 in the two steps before μ reaches 1e-13), as
    test_qp_solve_lanes_match_plain stops early for the same reason; the
    warm tick from each side's own duals is held above."""
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    prog = gsetup[0]
    cold = prog.qpchain(grun["ref_pre"], grun["fs"], None, 25)
    ref = cold if mode == "cold" else prog.qpchain(grun["ref_pre"], grun["fs"],
                                                   cold["warm_out"], 7)
    got = grun[mode]
    for name in ("torque_grav", "torque_task", "torque_contact", "torque_cmd",
                 "contact_force", "qp_gap", "qp_primal_res", "health"):
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 1e-8, f"{mode}.{name}: {err:.3e}"
    if prog.plan.cfree == 0:
        assert not got["torque_contact"].any()
    if mode == "cold":
        # with more than two contacts the contact block of a level's x sits
        # on the flat face of a rank-deficient contact space (its Hessian is
        # zero), where roundoff moves it (the hands plan's turned-base lane:
        # 3.7e-8 at 25 iterations and 2.5e-7 at 6, with every torque within
        # 1e-12): there the task block and the redistribution QP's x are held
        flat = len(prog.plan.cfg.contacts) > 2
        assert len(got["warm_out"]) == len(prog.plan.qp_dims)
        for h, ((x, _), (rx, _)) in enumerate(zip(got["warm_out"], ref["warm_out"])):
            n = (prog.plan.level_tdofs[h] if flat and h < len(prog.plan.level_tdofs)
                 else x.shape[0])
            assert float((x[:n] - rx[:n]).abs().max()) <= 1e-8
        ref6 = prog.qpchain(grun["ref_pre"], grun["fs"], None, 6)
        got6 = tc.TickKernels(prog).unpack_result(
            *(torch.as_tensor(a) for a in grun["qp"](6, None)))
        for h, ((x, lam), (rx, rlam)) in enumerate(zip(got6["warm_out"], ref6["warm_out"])):
            n = (prog.plan.level_tdofs[h] if flat and h < len(prog.plan.level_tdofs)
                 else x.shape[0])
            assert float((x[:n] - rx[:n]).abs().max()) <= 1e-8
            assert float((lam - rlam).abs().max()) <= 1e-6 * (1 + float(rlam.abs().max()))


def _general_servos(model, name, B, rng):
    """Per-lane servos of a general plan, element-leading (elem..., B),
    float64, on clocks in U[−0.05, 0.25] over [0, 0.2]: config 3's every
    level (entry._swing_servo_inputs); on the mixed task set the whole-body
    COM (position and rotation halves), level 1's rotation task but not its
    position task, and level 2's COM-frame point."""
    from libdwbc_tpu_torch.entry import _swing_servo_inputs
    from libdwbc_tpu_torch.wbc.pipeline import make_servo

    t = torch.as_tensor(rng.uniform(-0.05, 0.25, B))
    if name == "config3":
        _, _, _, servos, _, _ = _swing_servo_inputs(model, B, seed=5, noise=0.02,
                                                    dtype=np.float64)
        return tuple(tuple(sp._replace(t=t, tf=torch.tensor(0.2)) for sp in lvl)
                     for lvl in servos)

    def rot(ang):
        c, s_ = np.cos(ang), np.sin(ang)
        return torch.as_tensor(np.stack([np.stack([c, -s_, 0 * c], -1),
                                         np.stack([s_, c, 0 * c], -1),
                                         np.stack([0 * c, 0 * c, 1 + 0 * c], -1)], -2))

    def pts(base):
        return torch.as_tensor(np.asarray(base) + 0.02 * rng.standard_normal((B, 3)))

    kw = dict(t=t, t0=0.0, tf=0.2, dtype=torch.float64)
    def turn(a):
        return rot(rng.uniform(-a, a, B))

    com = make_servo(pos_init=pts([0.0, 0.0, 0.8]), pos_des=pts([0.02, 0.0, 0.8]),
                     rot_init=turn(0.1), rot_des=turn(0.1), max_p_err=0.05, **kw)
    wrist = make_servo(rot_init=turn(0.2), rot_des=turn(0.2), rot_p=200.0, rot_d=20.0, **kw)
    arm = make_servo(pos_init=pts([0.1, 0.3, 1.1]), pos_des=pts([0.1, 0.3, 1.2]), **kw)
    return ((com,), (None, wrist), (arm,))


@pytest.fixture(scope="module", params=["config3", "mixed"])
def gsrun(lanes, request):
    """The servo'd prestage lanes on a general plan (moving states, per-lane
    servos on some of its tasks, _general_servos) and the QP chain's lanes
    reading their f* from the servo section, against the plain versions at
    float64."""
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m = RobotModel.load(MODEL)
    tick = FusedTick(m, _general_cfg(m, request.param), "cpu", torch.float64, backend="torch")
    prog = tick.prog
    rng = np.random.default_rng(17)
    q = np.stack([full_q(CASE_Q[1] + 0.02 * rng.standard_normal(33)) for _ in range(B)])
    q_el = torch.as_tensor(np.ascontiguousarray(q.T))
    qd_el = 0.05 * torch.as_tensor(rng.standard_normal((m.ndof, B)))
    fs_el = [0.1 * torch.as_tensor(rng.standard_normal((t, B))) for t in prog.plan.level_tdofs]
    servos = _general_servos(m, request.param, B, rng)
    sv_el = tuple(None if lvl is None else tuple(
        None if sp is None else {f: getattr(sp, f).movedim(0, -1).contiguous()
                                 if getattr(sp, f).ndim > len(tc.SERVO_ELEM_SHAPES[f])
                                 else getattr(sp, f)[..., None].expand(
                                     tc.SERVO_ELEM_SHAPES[f] + (B,)).contiguous()
                                 for f in sp._fields}
        for sp in lvl) for lvl in servos)
    k = tc.TickKernels(prog)
    tab = np.ascontiguousarray(tc.kernel_table(prog.plan))
    smask = tc.servo_mask(sv_el, prog.plan)
    servo = (np.ascontiguousarray(qd_el.numpy()), np.ascontiguousarray(torch.cat(fs_el).numpy()),
             np.ascontiguousarray(tc.pack_servos(sv_el, prog.plan, B).numpy()), smask)
    pre, _ = _prestage_buffers(lanes, tab, np.ascontiguousarray(q_el.numpy()), 1, None, servo)
    ref_pre = k.prestage(q_el, None, qd_el, fs_el, sv_el)
    buf = np.ascontiguousarray(k.pack_pre(ref_pre).buf.numpy())
    ws_pre, _, _, n_out, n_warm, n_pre, _, _ = _sizes(lanes, tab)

    def qp(nl):
        out, wout = np.zeros((n_out, B)), np.zeros((n_warm, B))
        lanes.qp64(_ptr(tab), _ptr(buf), None, None, _ptr(out), _ptr(wout), B, 25, nl)
        return out, wout

    out, wout = qp(1)
    return dict(name=request.param, smask=smask, n_pre=n_pre, plan=prog.plan, qp=qp,
                raw=(out, wout), tab=tab, q_el=np.ascontiguousarray(q_el.numpy()), servo=servo,
                pre=k.unpack_pre(tc.PackedPre(torch.as_tensor(pre), True)), ref_pre=ref_pre,
                out=tc._unpack(torch.as_tensor(out), tc.out_layout(prog.plan)),
                ref_out=prog.qpchain(ref_pre, ref_pre["fstars"], None, 25))


def test_general_servo_warp_lanes_match_one_lane(lanes, gsrun):
    """The servo'd prestage and the QP chain on its buffer, 32 (and 5)
    lanes as threads against one lane, bit for bit."""
    _prestage_warp_lanes_match_one_lane(lanes, gsrun["tab"], gsrun["q_el"], None,
                                        gsrun["servo"])
    out, wout = gsrun["qp"](32)
    assert np.array_equal(out, gsrun["raw"][0]) and np.array_equal(wout, gsrun["raw"][1])


def test_general_servo_lanes_match_plain(gsrun):
    """The servo'd prestage's fields within 1e-9 and each level's blended f*
    and every servo'd task's state (the whole-body COM's included) within
    1e-10 of the plain servo'd prestage; the task mask has a bit per task,
    levels in order; the QP chain reading that f* within 1e-8."""
    from libdwbc_tpu_torch.ops import tick_cuda as tc

    assert gsrun["smask"] == (0b111 if gsrun["name"] == "config3" else 0b1101)
    assert gsrun["n_pre"] == tc._elems(tc.pre_layout(gsrun["plan"], servo=True))
    got, want = gsrun["pre"], gsrun["ref_pre"]
    for name in ("torque_grav", "P_C", "Jbar_act", "Atemp", "bA0", "health"):
        err = float((got[name] - want[name]).abs().max())
        assert err <= 1e-9, f"{name}: {err:.3e}"
    for h in range(len(gsrun["plan"].level_tdofs)):
        err = float((got["Ntorques"][h] - want["Ntorques"][h]).abs().max())
        assert err <= 1e-9, f"Ntorques.{h}: {err:.3e}"
        err = float((got["fstars"][h] - want["fstars"][h]).abs().max())
        assert err <= 1e-10, f"fstars.{h}: {err:.3e}"
    assert set(want["task_states"]) <= set(got["task_states"])
    for key, st in want["task_states"].items():
        for name, g, w in zip(("pos", "vel", "rot", "w"), got["task_states"][key], st):
            err = float((g - w).abs().max())
            assert err <= 1e-10, f"task state {key} {name}: {err:.3e}"
    for name in ("torque_grav", "torque_task", "torque_contact", "torque_cmd",
                 "contact_force", "qp_gap", "qp_primal_res"):
        err = float((gsrun["out"][name] - gsrun["ref_out"][name]).abs().max())
        assert err <= 1e-8, f"{name}: {err:.3e}"


def test_prestage_x_fit_matches_kernel_layout(lanes, monkeypatch):
    """The wrapper's shared-fit rule (tick_cuda.prestage_smem, with X's
    buffer prestage_x_fit) against the prestage's own layout (PreWS::smem)
    on plans of one to four contacts, static and masked, with levels of 6
    to 24 task rows: the same floats per scenario, and kernel_unsupported
    refuses exactly those beyond the kernel's cap (a level of four 6D tasks
    over two contacts); X's buffer grows past nd² with three or more
    contacts and with a level of 9 rows over two contacts, 12 over one."""
    import dataclasses

    from libdwbc_tpu_torch.entry import _hands_feet_config
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    six = [(T.TASK_LINK_6D, link) for link in (0, 15, 31, 23)]
    level = {6: tuple(six[:1]), 9: (six[0], (T.TASK_LINK_POSITION, 15)),
             12: tuple(six[:2]), 18: tuple(six[:3]), 24: tuple(six)}
    hands = _hands_feet_config(m)
    seen = {}
    for contacts, base in (("one", standard_tocabi_config(m, both_feet=False)),
                           ("two", standard_tocabi_config(m)), ("four", hands)):
        for rows, lv in level.items():
            cfg = dataclasses.replace(base, task_specs=(lv, ((T.TASK_LINK_ROTATION, 15),)))
            for masked in (False, True):
                plan = TickPlan(m, cfg, masked=masked)
                with monkeypatch.context() as mp:
                    mp.setattr(tc, "kernel_unsupported", lambda p: None)
                    smem, cap = _sizes(lanes, np.ascontiguousarray(tc.kernel_table(plan)))[6:8]
                why = tc.kernel_unsupported(plan)
                assert smem == tc.prestage_smem(plan), (contacts, rows, masked, smem)
                assert cap == tc.PRE_SMEM_MAX
                assert (why is None) == (smem <= cap), (contacts, rows, masked, why)
                need, room = tc.prestage_x_fit(plan)
                seen[(contacts, rows, masked)] = (why is None, need > room)
    assert seen[("two", 6, False)] == (True, False) and seen[("one", 9, False)] == (True, False)
    assert seen[("two", 9, False)] == (True, True) and seen[("one", 12, False)] == (True, True)
    assert seen[("four", 6, False)] == (True, True) and seen[("four", 6, True)] == (True, True)
    assert not seen[("two", 24, False)][0] and not seen[("four", 18, True)][0]
    assert "shared memory" in tc.kernel_unsupported(TickPlan(m, dataclasses.replace(
        hands, task_specs=(level[24],))))


def test_kernel_unsupported_reasons():
    """Config 3, the mixed task set (static and masked), the hands-and-feet
    fixture (static and masked), LINE feet, no torque limit and one foot
    under a 9-row level are taken; no contacts, five contacts, five levels,
    seventeen tasks and a plan beyond the prestage's shared fit are
    refused, each with its reason."""
    import dataclasses

    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_cuda import kernel_unsupported
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan
    from libdwbc_tpu_torch.wbc import types as T

    m = RobotModel.load(MODEL)
    for name, masked in (("config3", False), ("mixed", False), ("mixed", True), ("hands", False),
                         ("hands", True), ("line_feet", False), ("line_feet", True),
                         ("no_limit", False), ("wide_level", False)):
        assert kernel_unsupported(TickPlan(m, _general_cfg(m, name), masked=masked)) is None
    mixed = _general_cfg(m, "mixed")
    hands = _general_cfg(m, "hands")
    rot = ((T.TASK_LINK_ROTATION, 31),)
    refused = {
        "one to 4 contacts, the plan has 0": dataclasses.replace(mixed, contacts=()),
        "one to 4 contacts, the plan has 5": dataclasses.replace(
            hands, contacts=hands.contacts + (dataclasses.replace(hands.contacts[2], link=27),)),
        "at most 4 task levels": dataclasses.replace(
            mixed, task_specs=mixed.task_specs + (rot,) * 2),
        "at most 16 tasks": dataclasses.replace(mixed, task_specs=(rot * 9, rot * 8)),
        "shared memory": dataclasses.replace(mixed, task_specs=(
            tuple((T.TASK_LINK_6D, link) for link in (0, 15, 31, 23)),)),
    }
    for reason, cfg in refused.items():
        why = kernel_unsupported(TickPlan(m, cfg))
        assert why is not None and reason in why, (reason, why)


# ------------------------------------------------ psd_inverse and qp_solve
# the routines of elemlin.cuh in elem64's order, each with the region of C
# it writes, for shapes (m, k, n)
ELEM_KINDS = (
    ("mm", lambda m, k, n: (m, n)), ("mmT", lambda m, k, n: (m, n)),
    ("mTm", lambda m, k, n: (m, n)), ("mmT_sym", lambda m, k, n: (m, m)),
    ("mTm_sym", lambda m, k, n: (m, m)), ("mm_sym", lambda m, k, n: (m, m)),
    ("copy_mat", lambda m, k, n: (m, n)), ("cho_solve", lambda m, k, n: (m, n)),
    ("qr_thin", lambda m, k, n: (m, k)), ("orthonormalize_drop", lambda m, k, n: (m, k)),
    ("compact_columns", lambda m, k, n: (m, k)),
    ("complete_basis_tail", lambda m, k, n: (m, m - k)),
    ("qr_pinv", lambda m, k, n: (m, m)), ("psd_inverse", lambda m, k, n: (m, m)),
    ("chol_health", lambda m, k, n: (1, 1)))


def _elem_lanes_match_one_lane(lanes, n):
    """Every routine of elemlin.cuh, run by 32 and by 5 lanes as threads on
    NaN-filled outputs and scratch, writes every element of its result and
    nothing else of it, and gives the one-lane result bit for bit."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lanes.elem64.argtypes = [i] * 4 + [p] * 6 + [i]
    rng = np.random.default_rng(100 + n)
    m, k, nn = n, max(1, min(7, n - 1)), 5
    U, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    spd = np.ascontiguousarray((U * np.logspace(0, 3, 64)) @ U.T)
    gen = np.ascontiguousarray(rng.standard_normal((64, 64)))
    gen_drop = gen.copy()
    gen_drop[:, 1] = 0.0                          # dropped and compacted away
    gen_drop[:, min(3, k - 1)] *= 1e-12
    bm = np.ascontiguousarray(rng.standard_normal((64, 64)))
    for kind, (name, region) in enumerate(ELEM_KINDS):
        a = spd if name in ("cho_solve", "psd_inverse", "chol_health") else (
            gen_drop if name in ("orthonormalize_drop", "compact_columns") else gen)
        outs = {}
        for nl in (1, 32, 5):
            c, s1, s2, d = (np.full(sh, np.nan) for sh in ((64, 64), (64, 64), (64, 64), 64))
            lanes.elem64(kind, m, k, nn, _ptr(a), _ptr(bm), _ptr(c), _ptr(s1), _ptr(s2),
                         _ptr(d), nl)
            outs[nl] = c
        r, cc = region(m, k, nn)
        want = np.zeros((64, 64), bool)
        want[:r, :cc] = True
        assert np.array_equal(np.isfinite(outs[1]), want), (name, n)
        for nl in (32, 5):
            assert np.array_equal(outs[nl], outs[1], equal_nan=True), (name, n, nl)


@pytest.mark.parametrize("n", [6, 9, 12, 33, 39, 64])
def test_lane_routines_cover_every_element_once(lanes, n):
    """The lane-strided walks of warp_linalg.cuh visit every entry of their
    triangle exactly once and nothing else, for 32, 5 and 1 lanes: the
    trailing triangle of every Cholesky column, the upper triangle of
    L⁻ᵀL⁻¹ and the lower triangle of the IPM's Gram.  And psd_inverse's
    warp code (Cholesky, L⁻¹, L⁻ᵀL⁻¹ on a NaN-filled scratch) run by 32
    and by 5 lanes as threads, each phase concurrent between syncs, gives
    the one-lane inverse bit for bit.  And so does every routine of
    elemlin.cuh, tick_prestage's lane walks over entries, triangles,
    columns and rows (_elem_lanes_match_one_lane)."""
    lanes.walks.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lanes.psdinv64.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    ii, kk = np.indices((n, n))
    for nl in (32, 5, 1):
        for kind, j, want in [(0, j, (kk > j) & (kk <= ii)) for j in range(n)] + [
                (1, 0, kk >= ii), (2, 0, kk <= ii)]:
            cnt = np.zeros((n, n), np.int32)
            lanes.walks(kind, n, j, nl, _ptr(cnt))
            assert np.array_equal(cnt, want.astype(np.int32)), (nl, kind, j)
    rng = np.random.default_rng(n)
    U, _ = np.linalg.qr(rng.standard_normal((2, n, n)))
    A = np.ascontiguousarray((U * np.logspace(0, 3, n)[None, None, :]) @ np.swapaxes(U, -1, -2))
    outs = {}
    for nl in (1, 32, 5):
        outs[nl] = np.full_like(A, np.nan)
        lanes.psdinv64(_ptr(A), _ptr(outs[nl]), 2, n, nl)
    assert np.isfinite(outs[1]).all()
    assert np.array_equal(outs[32], outs[1]) and np.array_equal(outs[5], outs[1])
    _elem_lanes_match_one_lane(lanes, n)


def test_psd_inverse_lanes_match_plain(lanes):
    """The kernel's lane code at the tick's sizes (A at n = 39, W + V2ᵀV2 at
    n = 33), exact symmetry included."""
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_plain

    lanes.psdinv64.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    rng = np.random.default_rng(2)
    for n in (33, 39):
        U, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
        A = np.ascontiguousarray((U * np.logspace(0, 5, n)[None, None, :])
                                 @ np.swapaxes(U, -1, -2))
        A_junk = A + np.triu(np.full((n, n), 3.0), 1)     # only the lower triangle is read
        out = np.zeros_like(A)
        lanes.psdinv64(_ptr(A_junk), _ptr(out), B, n, 1)
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


# (n, mirrored pairs k, other rows): the tick's level 0 with its ± pairs
# unfolded (cold, warm) and folded (mirror); the largest routed shape, n =
# 24 and m = 512, without and with 33 folded pairs
QP_MODES = {"cold": (12, 20, 20, 0), "warm": (12, 20, 20, 0), "mirror": (12, 33, 20, 33),
            "largest": (24, 33, 446, 0), "largest_mirror": (24, 33, 446, 33)}


@pytest.mark.parametrize("mode", list(QP_MODES))
def test_qp_solve_lanes_match_plain(lanes, mode):
    """qp_solve's warp code, each problem on a NaN-filled shared scratch:
    one lane against qp_solve_plain within 1e-10, and 5 and 32 lanes as
    threads equal to one lane bit for bit."""
    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_plain

    p, i = ctypes.c_void_p, ctypes.c_int
    lanes.qpsm64.argtypes = [i, i, i]
    lanes.qpsm64.restype = ctypes.c_longlong
    lanes.qpsolve64.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_double, i]
    rng = np.random.default_rng(6)
    nv, k, extra, mr = QP_MODES[mode]
    H, g, C, d = _qp_problems(rng, nv, k, extra)
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
    outs = {}
    for nl in (1, 5, 32):
        x, s, lam = np.full((B, n), np.nan), np.full((B, m), np.nan), np.full((B, m), np.nan)
        lanes.qpsolve64(_ptr(H), _ptr(g), _ptr(C), _ptr(d), _ptr(x0), _ptr(l0), _ptr(x), _ptr(s),
                        _ptr(lam), B, n, m, mr, iters, 1e-6, nl)
        outs[nl] = (x, s, lam)
    ref = qp_solve_plain(*map(torch.as_tensor, (H, g, C, d)),
                         *(None if a is None else torch.as_tensor(a) for a in (x0, l0)),
                         iters=iters, ridge=1e-6, mirror=mr)
    for name, got, want in zip(("x", "s", "lam"), outs[1], ref):
        want = want.numpy()
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err <= 1e-10, f"{mode}.{name}: {err:.3e}"
    for nl in (5, 32):
        for name, got, want in zip(("x", "s", "lam"), outs[nl], outs[1]):
            assert np.array_equal(got, want), f"{mode}.{name}: {nl} lanes"
