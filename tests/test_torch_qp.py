"""The port's QP solvers against the JAX package, float64, problems from a
seed:

* ``ops/qp.py::solve_qp`` against JAX ``solve_qp`` (its XLA loop):
  one-sided, two-sided with infinite bounds, equality rows, a warm start,
  and the polish with its objective gate; x, λ, gap and primal residual;
* the plain ``qp_solve`` (``ops/qp_cuda.py``) against ``pallas_qp_solve``
  in interpret mode: cold, warm and with mirrored rows, x to 1e-9.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X_TOL = 1e-9
# The polish solves the penalty system H + ρCᵀDC with ρ = 1/ridge = 1e9 at
# float64: its conditioning turns summation-order roundoff (1e-16) into
# ~1e-7 relative on polished lanes, whichever framework sums.
POLISH_TOL = 2e-6
# λ and s of the plain qp_solve against the interpreted kernel: the duals
# are more sensitive to roundoff than x near convergence.
DUAL_TOL = 1e-8


def _problems(rng, B, n, m):
    """Strictly feasible one-sided problems: H = QQᵀ/10 + I, C x0 + margin."""
    Q = rng.standard_normal((B, n, n))
    H = Q @ np.swapaxes(Q, -1, -2) * 0.1 + np.eye(n)
    g = rng.standard_normal((B, n))
    C = rng.standard_normal((B, m, n))
    x0 = rng.standard_normal((B, n))
    d = np.einsum("bmn,bn->bm", C, x0) + rng.uniform(0.05, 2.0, (B, m))
    return H, g, C, d, x0


def _t(*xs):
    return [None if x is None else torch.as_tensor(np.array(x)) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _close(got, ref, tol, name):
    got, ref = got.numpy(), np.asarray(ref)
    err = float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))
    assert err <= tol, f"{name}: {err:.3e}"


def _cases():
    rng = np.random.default_rng(0)
    B, n, m = 3, 6, 10
    H, g, C, d, x0 = _problems(rng, B, n, m)
    cases = {"one_sided": dict(H=H, g=g, A=C, lb=None, ub=d)}
    lb = np.einsum("bmn,bn->bm", C, x0) - rng.uniform(0.05, 2.0, (B, m))
    lb[:, ::3] = -np.inf
    ub = d.copy()
    ub[:, 1::4] = np.inf
    cases["two_sided"] = dict(H=H, g=g, A=C, lb=lb, ub=ub)
    Aeq = rng.standard_normal((B, 2, n))
    cases["equality"] = dict(H=H, g=g, A=C, lb=None, ub=d, Aeq=Aeq,
                             beq=np.einsum("bpn,bn->bp", Aeq, x0))
    # a semidefinite H (the task QPs' zero f_c block) with active rows
    Hs = np.zeros((n, n))
    Hs[:3, :3] = np.eye(3)
    cases["semidefinite"] = dict(H=Hs, g=np.zeros(n), A=C, lb=None, ub=d - 0.5)
    return cases


CASES = _cases()


@pytest.fixture(scope="module", params=sorted(CASES) + ["warm"])
def solved(request):
    from libdwbc_tpu.ops.qp import solve_qp as jax_solve
    from libdwbc_tpu_torch.convert import result_to_numpy, warm_from_numpy, warm_to_numpy
    from libdwbc_tpu_torch.ops.qp import solve_qp

    name = request.param
    kw = dict(CASES["one_sided" if name == "warm" else name])
    warm = None
    if name == "warm":
        # the JAX solve's (x, λ) carried across as numpy
        first = jax_solve(*_j(kw["H"], kw["g"], kw["A"], None, kw["ub"]), iters=8)
        warm = warm_to_numpy([(first.x, first.lam)])[0]
        kw["g"] = kw["g"] + 0.01 * np.random.default_rng(1).standard_normal(kw["g"].shape)
    args = [kw[k] for k in ("H", "g", "A", "lb", "ub")]
    extra = [kw.get("Aeq"), kw.get("beq")]
    ref = jax_solve(*_j(*args), *_j(*extra), iters=20,
                    warm=None if warm is None else tuple(_j(*warm)))
    got = solve_qp(*_t(*args), *_t(*extra), iters=20,
                   warm=None if warm is None else warm_from_numpy([warm], "cpu",
                                                                 torch.float64)[0])
    return result_to_numpy(ref), result_to_numpy(got)


@pytest.mark.parametrize("field", ["x", "lam", "gap", "primal_res", "polished"])
def test_solve_qp_matches_jax(solved, field):
    ref, got = solved
    r, g = ref[field], got[field]
    if field == "polished":
        assert np.array_equal(r, g)
    elif field in ("gap", "primal_res"):
        assert float(np.abs(g - r).max()) <= 1e-10
    else:
        _close(torch.as_tensor(g), r, POLISH_TOL, field)


def test_solve_qp_polish_is_taken_at_float64_only():
    """The polish is accepted on some lanes at float64, never at float32."""
    from libdwbc_tpu_torch.ops.qp import solve_qp

    kw = CASES["one_sided"]
    sol = solve_qp(*_t(kw["H"], kw["g"], kw["A"], None, kw["ub"]), iters=20)
    assert bool(sol.polished.any())
    sol32 = solve_qp(*[t.float() for t in _t(kw["H"], kw["g"], kw["A"])], None,
                     torch.as_tensor(kw["ub"], dtype=torch.float32), iters=20)
    assert not bool(sol32.polished.any())


# ------------------------------------------ plain qp_solve vs Pallas interpret
def _mirrored(rng, B, n, k, extra):
    H, g, _, _, _ = _problems(rng, B, n, 2 * k + extra)
    Bm = rng.standard_normal((B, k, n))
    C = np.concatenate([Bm, -Bm, rng.standard_normal((B, extra, n))], axis=1)
    d = np.einsum("bmn,bn->bm", C, rng.standard_normal((B, n))) + rng.uniform(
        0.05, 2.0, (B, 2 * k + extra))
    return H, g, C, d


@pytest.mark.parametrize("mode", ["cold", "warm", "mirror"])
def test_plain_qp_solve_matches_interpreted_pallas(mode):
    from libdwbc_tpu.ops.pallas_qp import pallas_qp_solve
    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_plain

    rng = np.random.default_rng(4)
    if mode == "mirror":
        H, g, C, d = _mirrored(rng, 4, 6, 4, 5)
        kw = dict(mirror=4)
    else:
        H, g, C, d, _ = _problems(rng, 4, 6, 12)
        kw = {}
    x0 = lam0 = None
    if mode == "warm":
        x0, _, lam0 = pallas_qp_solve(*_j(H, g, C, d), iters=10, interpret=True)
        x0, lam0 = np.asarray(x0), np.asarray(lam0)
        g = g + 0.01 * rng.standard_normal(g.shape)
    ref = pallas_qp_solve(*_j(H, g, C, d), iters=12, interpret=True,
                          x0=None if x0 is None else jnp.asarray(x0),
                          lam0=None if lam0 is None else jnp.asarray(lam0), **kw)
    got = qp_solve_plain(*_t(H, g, C, d, x0, lam0), iters=12, **kw)
    for name, r, o, tol in zip(("x", "s", "lam"), ref, got, (X_TOL, DUAL_TOL, DUAL_TOL)):
        _close(o, r, tol, name)


def test_qp_solve_wrapper_on_cpu_is_the_plain_version():
    from libdwbc_tpu_torch.ops import qp_cuda

    H, g, C, d, _ = _problems(np.random.default_rng(5), 3, 5, 8)
    args = [t.float() for t in _t(H, g, C, d)]
    n0 = qp_cuda.launches["qp_solve"]
    for a, b in zip(qp_cuda.qp_solve(*args, iters=9), qp_cuda.qp_solve_plain(*args, iters=9)):
        assert torch.equal(a, b)
    assert qp_cuda.launches["qp_solve"] == n0


def test_cuda_backend_on_cpu_takes_the_loop():
    """Routing is by device and dtype: CPU tensors under backend="cuda"
    take the solve_qp loop, polish included."""
    from libdwbc_tpu_torch.ops import qp_cuda
    from libdwbc_tpu_torch.ops.qp import solve_qp

    kw = CASES["one_sided"]
    args = _t(kw["H"], kw["g"], kw["A"], None, kw["ub"])
    n0 = qp_cuda.launches["qp_solve"]
    a = solve_qp(*args, iters=15, backend="cuda")
    b = solve_qp(*args, iters=15)
    assert torch.equal(a.x, b.x) and torch.equal(a.polished, b.polished)
    assert bool(a.polished.any())
    assert qp_cuda.launches["qp_solve"] == n0


@pytest.mark.parametrize("shape", [(12, 86, 33, 7), (9, 86, 33, 12), (6, 10, 0, 12)])
def test_qp_solve_flops_match_the_benchmark_count(shape):
    """The port's operation count of the qp_solve recurrence (chip_smoke.py's
    bound) is benchmarks/sol_qp.py's analytic count of the Pallas kernel."""
    import importlib.util
    import os

    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_flops

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "sol_qp.py")
    spec = importlib.util.spec_from_file_location("sol_qp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert qp_solve_flops(*shape) == mod.kernel_flops(*shape)["flops_per_solve"]


def test_float32_masked_tick_qps_stay_near_float64(monkeypatch):
    """MaskedTick in float32 on 96 lanes of the masked sweep (seed 0; both
    feet, left, right cycled), four ticks of make_control_loop (cold, then
    warm at 7 iterations, gap_fallback 1e-3), every QP through qp_cuda.
    qp_solve (on the CPU its plain version, the kernel's recurrence): each
    solution moves the torque (C[:mirror]·x, the QP's torque-limit block)
    within 1e-3 Nm of a float64 solve of the same QP from the same warm
    start, on every lane of every call.  Without the float32 lost-pivot
    rule a warm single-support lane lands 0.47 Nm away."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import qp, qp_cuda
    from libdwbc_tpu_torch.wbc.loop import make_control_loop
    from libdwbc_tpu_torch.wbc.masked import MaskedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    monkeypatch.setattr(qp, "_use_kernel", lambda H, A, lb, Aeq, backend, mirror=0: (
        backend == "cuda" and lb is None and Aeq is None and H.dtype == torch.float32
        and qp_cuda.kernel_takes(H.shape[-1], A.shape[-2], mirror)))
    real, dtau = qp_cuda.qp_solve, []

    def beside_float64(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6, mirror=0):
        out = real(H, g, C, d, x0, lam0, iters=iters, ridge=ridge, mirror=mirror)
        dbl = [None if t is None else t.double() for t in (H, g, C, d, x0, lam0)]
        ref = qp_cuda.qp_solve_plain(*dbl, iters=iters, ridge=ridge, mirror=mirror)
        dtau.append((dbl[2][:, :mirror] @ (out[0].double() - ref[0])[..., None])[..., 0]
                    .abs().amax(-1))
        return out

    monkeypatch.setattr(qp_cuda, "qp_solve", beside_float64)
    m = RobotModel.load(os.path.join(ROOT, "models", "tocabi.npz"))
    tick = MaskedTick(m, standard_tocabi_config(m, qp_iters=12), "cpu", torch.float32,
                      backend="torch")
    tick.backend = "cuda"                 # route the QPs as on the card
    md = m.model_dof

    def advance(q, qd, res, dt):
        q = q.clone()
        q[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd)
        return q, qd

    q, qd, fs, masks = entry._masked_inputs(m, 96, seed=0)
    loop = make_control_loop(tick, transition=advance, K=4, warm_start=True, warm_iters=7,
                             gap_fallback=1e-3)
    res = loop(torch.as_tensor(q), torch.as_tensor(qd), tuple(torch.as_tensor(f) for f in fs),
               torch.as_tensor(masks))
    assert torch.isfinite(res.torques).all()
    err = torch.stack(dtau)
    assert len(dtau) == 3 * (4 + res.refined_ticks)
    assert float(err.max()) <= 1e-3, (float(err.max()), (err > 1e-3).nonzero().tolist())


def _smem_lib(tmp_path):
    """csrc/qp_solve.cu built by the host C++ compiler (its C interface
    outside the CUDA launchers), or None without one."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    so = tmp_path / "libqpsmem.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    os.path.join(ROOT, "libdwbc_tpu_torch", "csrc", "qp_solve.cu"), "-o",
                    str(so)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.dwbc_qp_solve_smem_elems.argtypes = [ctypes.c_int] * 3
    lib.dwbc_qp_solve_smem_elems.restype = ctypes.c_longlong
    return lib


def test_kernel_takes_is_the_routing_rule(tmp_path, monkeypatch):
    """qp_cuda.kernel_takes, the one rule of the qp_solve kernel's shapes,
    and the router on it, without a card: every (n, m, mirror) that the
    port's float32 ticks hand solve_qp under backend="cuda" (CompiledTick
    on the flagship and on the hands-and-feet plan, MaskedTick on the
    flagship's two feet) is taken; n = 25 and m = 513 are refused, as by
    the JAX router (libdwbc_tpu/ops/qp.py:76), and solve_qp then routes a
    CUDA problem to its loop; the per-problem shared float count here is
    csrc/qp_solve.cu's, built by the host compiler."""
    from types import SimpleNamespace

    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import qp, qp_cuda
    from libdwbc_tpu_torch.wbc.masked import MaskedTick
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, standard_tocabi_config

    seen = set()

    def record(H, A, lb, Aeq, backend, mirror=0):
        if backend == "cuda" and lb is None and Aeq is None and H.dtype == torch.float32:
            seen.add((H.shape[-1], A.shape[-2], mirror))
        return False

    monkeypatch.setattr(qp, "_use_kernel", record)
    m = RobotModel.load(os.path.join(ROOT, "models", "tocabi.npz"))
    cfg = standard_tocabi_config(m, qp_iters=12)
    hcfg = entry._hands_feet_config(m)
    q, qd, fs = entry._example_inputs(m)
    hq, hqd, hfs = entry._hands_feet_inputs(m, 2, seed=0)
    mq, mqd, mfs, masks = entry._masked_inputs(m, 3, seed=0)
    T = (lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32))
    for tick, args in (
            (CompiledTick(m, cfg, "cpu", torch.float32, backend="torch"),
             (T(q), T(qd), tuple(T(f) for f in fs))),
            (CompiledTick(m, hcfg, "cpu", torch.float32, backend="torch"),
             (T(hq), T(hqd), tuple(T(f) for f in hfs))),
            (MaskedTick(m, cfg, "cpu", torch.float32, backend="torch"),
             (T(mq), T(mqd), tuple(T(f) for f in mfs), T(masks)))):
        tick.backend = "cuda"                 # route the QPs as on the card
        tick._tick_impl(*args, warm=tick.init_warm(args[0].shape[:-1]), qp_iters=2)
    routed = {(n, 86, 33) for n in (12, 9, 6)} | {(n, 98, 33) for n in (18, 15, 12)}
    assert seen == routed, seen
    assert all(qp_cuda.kernel_takes(*s) for s in routed)
    for shape in ((24, 512, 0), (24, 512, 33), (24, 512, 256), (1, 1, 0)):
        assert qp_cuda.kernel_takes(*shape), shape
    for shape in ((25, 86, 33), (12, 513, 0), (12, 513, 33), (12, 86, 44), (12, 86, -1),
                  (0, 86, 0)):
        assert not qp_cuda.kernel_takes(*shape), shape

    # the router asks kernel_takes: a CUDA float32 problem of m = 513 or
    # n = 25 goes to the loop
    monkeypatch.undo()
    H = SimpleNamespace(dtype=torch.float32, shape=(4, 12, 12))
    for n, rows, take in ((12, 512, True), (12, 513, False), (25, 86, False)):
        H.shape = (4, n, n)
        A = SimpleNamespace(is_cuda=True, shape=(4, rows, n))
        assert qp._use_kernel(H, A, None, None, "cuda", 33) is take, (n, rows)
        assert not qp._use_kernel(H, A, None, None, "torch", 33)

    lib = _smem_lib(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    want = {(12, 86, 33): 2007, (18, 98, 33): 3087, (24, 512, 0): 19752}
    for shape in sorted(routed | set(want) | {(24, 512, 33), (7, 40, 20), (1, 1, 0)}):
        assert qp_cuda.smem_elems(*shape) == lib.dwbc_qp_solve_smem_elems(*shape), shape
        assert want.get(shape, qp_cuda.smem_elems(*shape)) == qp_cuda.smem_elems(*shape)
