"""The CUDA kernels on the card against their plain versions, and the two
CUDA ticks (FusedTick, CompiledTick) on their serving path.

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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nb", [1, 5, 1024])
def test_qpchain_kernel_partial_blocks(case, dev, nb, masked):
    """tick_qpchain at batches that fill one block partly (1, 5: a warp per
    scenario, four per block) and many blocks (1024), cold at 12 iterations
    then warm at 7, against the plain float32 qpchain at QP_TOL (masked:
    QP_TOL_MASKED, the sweep's inputs)."""
    from libdwbc_tpu_torch.entry import _example_inputs, _masked_inputs
    from libdwbc_tpu_torch.ops.tick_cuda import QP_TOL_MASKED, TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m, cfg = case["model"], case["cfg"]
    rng = np.random.default_rng(nb)
    if masked:
        q, _, fs, masks = _masked_inputs(m, nb, seed=nb)
        cm = torch.as_tensor(np.ascontiguousarray(masks.T))
    else:
        q0, _, f0 = _example_inputs(m)
        q = np.tile(q0, (nb, 1))
        q[:, 6:39] += 0.02 * rng.standard_normal((nb, 33)).astype(np.float32)
        fs = [np.tile(f, (nb, 1)) + 0.05 * rng.standard_normal((nb, f.shape[0])).astype(np.float32)
              for f in f0]
        cm = None
    plain = TickProgram(m, cfg, "cpu", torch.float32, masked=masked)
    kern = TickKernels(TickProgram(m, cfg, dev, torch.float32, masked=masked))
    fs_el = [torch.as_tensor(np.ascontiguousarray(f.T)) for f in fs]
    pre = plain.prestage(torch.as_tensor(np.ascontiguousarray(q.T)), cm)
    pre_d = {k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
             for k, v in pre.items()}
    fs_d = [f.to(dev) for f in fs_el]
    tol = QP_TOL_MASKED if masked else QP_TOL
    ref = plain.qpchain(pre, fs_el, None, 12)
    got = kern.qpchain(pre_d, fs_d, None, 12)
    ref_w = plain.qpchain(pre, fs_el, ref["warm_out"], 7)
    got_w = kern.qpchain(pre_d, fs_d, [(x.to(dev), l.to(dev)) for x, l in ref["warm_out"]], 7)
    torch.cuda.synchronize()
    assert kern.launches["tick_qpchain"] == 2
    for tag, g_, r_ in (("cold", got, ref), ("warm", got_w, ref_w)):
        for k, t in tol.items():
            assert torch.isfinite(g_[k]).all(), (tag, k)
            err = float((g_[k].cpu() - r_[k]).abs().max())
            print(f"qpchain {'masked' if masked else 'static'} B {nb} {tag} {k}: {err:.3e}")
            assert err <= t, (tag, k, err, t)
        assert float(g_["qp_primal_res"].max()) <= 1e-3


@pytest.mark.parametrize("mode", ["static", "masked", "servo"])
@pytest.mark.parametrize("nb", [1, 5, 1024, 4097])
def test_prestage_kernel_partial_blocks(case, dev, nb, mode):
    """tick_prestage (a warp per scenario, four per block) at batches that
    fill one block partly (1, 5), whole blocks (1024) and one warp of a
    last block (4097), against the plain prestage in float64: every field
    within PRE_TOL (masked: PRE_TOL_MASKED, the sweep's inputs; servo'd:
    entry._servo_inputs, the f* and task-link states within SERVO_TOL)."""
    from libdwbc_tpu_torch.entry import _example_inputs, _masked_inputs, _servo_inputs
    from libdwbc_tpu_torch.ops.tick_cuda import PRE_TOL_MASKED, SERVO_TOL
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m, cfg = case["model"], case["cfg"]
    masked = mode == "masked"
    fused = FusedTick(m, cfg, dev, backend="cuda", masked=masked)
    plain = FusedTick(m, cfg, "cpu", torch.float64, backend="torch", masked=masked)
    kern = fused.kernels

    def el(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a.T)).to(dtype)

    if mode == "servo":
        q, qd, fs, servos = _servo_inputs(m, nb, seed=nb)
        sv = fused._servos_el(servos, nb)
        sv = tuple(tuple({k: v.to(dev) for k, v in d.items()} for d in lvl) for lvl in sv)
        got = kern.prestage(el(q).to(dev), None, el(qd).to(dev), [el(f).to(dev) for f in fs],
                            sv)
        ref = plain.prog.prestage_servo(el(q, torch.float64), None, el(qd, torch.float64),
                                        [el(f, torch.float64) for f in fs],
                                        plain._servos_el(servos, nb))
    else:
        if masked:
            q, _, _, masks = _masked_inputs(m, nb, seed=nb)
            cm = el(masks)
        else:
            q0, _, _ = _example_inputs(m)
            q = np.tile(q0, (nb, 1))
            q[:, 6:39] += 0.02 * np.random.default_rng(nb).standard_normal((nb, 33))
            cm = None
        got = kern.prestage(el(q).to(dev), None if cm is None else cm.to(dev))
        ref = plain.prog.prestage(el(q, torch.float64), None if cm is None else cm.double())
    torch.cuda.synchronize()
    assert kern.launches["tick_prestage"] == 1
    for k, tol in (PRE_TOL_MASKED if masked else PRE_TOL).items():
        pairs = zip(got[k], ref[k]) if k == "Ntorques" else [(got[k], ref[k])]
        for g, r in pairs:
            assert torch.isfinite(g).all(), k
            err = float((g.cpu().double() - r).abs().max())
            print(f"prestage {mode} B {nb} {k}: {err:.3e}")
            assert err <= tol, (k, err, tol)
    if mode == "servo":
        for h in range(2):
            err = float((got["fstars"][h].cpu().double() - ref["fstars"][h]).abs().max())
            assert err <= SERVO_TOL["fstars"], (h, err)
            for name, g, r in zip(("task_pos", "task_vel", "task_rot", "task_w"),
                                  got["task_states"][(h, 0)], ref["task_states"][(h, 0)]):
                err = float((g.cpu().double() - r).abs().max())
                assert err <= SERVO_TOL[name], (h, name, err)


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


# ------------------------------------------------ psd_inverse and qp_solve
def _spd(rng, B, n, cond=1e3):
    U, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    return (U * np.logspace(0, np.log10(cond), n)[None, None, :]) @ np.swapaxes(U, -1, -2)


@pytest.mark.parametrize("n,B_", [(39, 64), (33, 64), (64, 3)] + [
    (n, b) for n in (16, 33, 39, 64) for b in (1, 5, 1024, 4097)])
def test_psd_inverse_kernel_matches_plain(dev, n, B_):
    """Within ten times the plain float32 version's own error from float64,
    relative to max |A⁻¹|, and exactly symmetric; batches that leave the
    last block of four warps partly empty (1, 5, 4097) included."""
    from libdwbc_tpu_torch.ops import linalg_cuda

    A = torch.as_tensor(_spd(np.random.default_rng(n + B_), B_, n), dtype=torch.float32)
    n0 = linalg_cuda.launches["psd_inverse"]
    out = linalg_cuda.psd_inverse(A.to(dev))
    torch.cuda.synchronize()
    assert linalg_cuda.launches["psd_inverse"] == n0 + 1
    assert torch.equal(out, out.transpose(-1, -2))
    ref = linalg_cuda.psd_inverse_plain(A.double())
    scale = float(ref.abs().max())
    err = float((out.cpu().double() - ref).abs().max()) / scale
    own = float((linalg_cuda.psd_inverse_plain(A).double() - ref).abs().max()) / scale
    print(f"psd_inverse n {n} B {B_}: kernel {err:.3e}, plain float32 {own:.3e}")
    assert err <= 10 * own


def test_psd_inverse_kernel_raises_on_bad_inputs(dev):
    from libdwbc_tpu_torch.ops import linalg_cuda

    A = torch.as_tensor(_spd(np.random.default_rng(0), 4, 20), dtype=torch.float32).to(dev)
    with pytest.raises(TypeError):
        linalg_cuda.psd_inverse(A.double())
    with pytest.raises(ValueError):
        linalg_cuda.psd_inverse(A[:, :12, :12].contiguous())
    with pytest.raises(ValueError):
        linalg_cuda.psd_inverse(A.transpose(-1, -2))


def _qp(rng, B_, n, k, extra):
    """One-sided problems with a ± mirrored block of k rows, strictly
    feasible."""
    m = 2 * k + extra
    Q = rng.standard_normal((B_, n, n))
    H = Q @ np.swapaxes(Q, -1, -2) * 0.1 + np.eye(n)
    Bm = rng.standard_normal((B_, k, n))
    C = np.concatenate([Bm, -Bm, rng.standard_normal((B_, extra, n))], axis=1)
    d = np.einsum("bmn,bn->bm", C, rng.standard_normal((B_, n))) + rng.uniform(0.05, 2.0, (B_, m))
    return [torch.as_tensor(a, dtype=torch.float32)
            for a in (H, rng.standard_normal((B_, n)), C, d)]


@pytest.fixture(scope="module")
def tick_qps(case, dev):
    """The three QPs (inputs of qp_solve) of one cold CompiledTick(cuda)
    tick at the case's states."""
    from libdwbc_tpu_torch.ops import qp_cuda
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick

    seen = []
    solve = qp_cuda.qp_solve

    def record(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6, mirror=0):
        seen.append((H.clone(), g.clone(), C.clone(), d.clone(), ridge, mirror))
        return solve(H, g, C, d, x0, lam0, iters=iters, ridge=ridge, mirror=mirror)

    tick = CompiledTick(case["model"], case["cfg"], dev, backend="cuda")
    mp = pytest.MonkeyPatch()
    mp.setattr(qp_cuda, "qp_solve", record)
    try:
        tick._tick_impl(case["q_el"].T.contiguous().to(dev), torch.zeros((B, 39), device=dev),
                        tuple(f.T.contiguous().to(dev) for f in case["fs_el"]),
                        warm=tick.init_warm((B,)), qp_iters=12)
    finally:
        mp.undo()
    assert [(tuple(C.shape), mr) for _, _, C, _, _, mr in seen] == [
        ((B, 86, n), 33) for n in (12, 9, 6)]
    return seen


def _largest(H, g, C, d):
    """A tick QP grown to the largest shape the kernel takes, n = 24 and
    m = 512: its rows repeated in turn after the 86 (the mirrored pairs
    stay the first rows), and 12 more variables with an identity Hessian
    that no row reads (they stay 0)."""
    nb, m0, n0 = C.shape
    idx = torch.arange(512, device=C.device) % m0
    H2 = torch.zeros((nb, 24, 24), device=H.device)
    H2[:, :n0, :n0] = H
    H2[:, n0:, n0:] = torch.eye(24 - n0, device=H.device)
    g2 = torch.zeros((nb, 24), device=g.device)
    g2[:, :n0] = g
    C2 = torch.zeros((nb, 512, 24), device=C.device)
    C2[:, :, :n0] = C[:, idx]
    return H2, g2, C2, d[:, idx].contiguous()


@pytest.mark.parametrize("shape,nb", [("tick", None), ("tick", 1), ("tick", 5), ("tick", 4097),
                                      ("largest", None), ("largest", 5)])
@pytest.mark.parametrize("mode", ["cold", "warm", "unfolded"])
def test_qp_solve_kernel_matches_plain(tick_qps, dev, mode, shape, nb):
    """The tick's three QPs (n = 12, 9, 6; m = 86) against the plain float32
    version on the CPU, within qp_cuda.QP_SOLVE_TOL: cold at 12 iterations
    with the 33 mirrored rows folded, warm at 7, and cold with the mirror
    unfolded (mirror = 0, all rows stored); at the fixture's batch and at
    batches that leave the last block partly empty (its lanes tiled to 1, 5
    and 4097 problems), and grown to n = 24, m = 512 (_largest: 3 problems
    per block folded, 2 unfolded)."""
    from libdwbc_tpu_torch.ops import qp_cuda
    from libdwbc_tpu_torch.ops.qp import _comp_gap

    for H, g, C, d, ridge, mirror in tick_qps:
        if nb is not None:
            H, g, C, d = (t.repeat((-(-nb // t.shape[0]),) + (1,) * (t.ndim - 1))[:nb]
                          .contiguous() for t in (H, g, C, d))
        if shape == "largest":
            H, g, C, d = _largest(H, g, C, d)
        cpu = [t.cpu() for t in (H, g, C, d)]
        kw = dict(ridge=ridge, mirror=0 if mode == "unfolded" else mirror)
        warm, iters = (), 12
        if mode == "warm":
            x0, _, lam0 = qp_cuda.qp_solve_plain(*cpu, iters=12, **kw)
            warm, iters = (x0, lam0), 7
        ref = qp_cuda.qp_solve_plain(*cpu, *warm, iters=iters, **kw)
        n0 = qp_cuda.launches["qp_solve"]
        got = [t.cpu() for t in qp_cuda.qp_solve(H, g, C, d, *[w.to(dev) for w in warm],
                                                 iters=iters, **kw)]
        assert qp_cuda.launches["qp_solve"] == n0 + 1
        err = dict(x=float((got[0] - ref[0]).abs().max()),
                   lam=float(((got[2] - ref[2]).abs() / (1.0 + ref[2].abs())).max()))
        m = C.shape[1]
        slack_k = cpu[3] - (cpu[2] @ got[0][..., None])[..., 0]
        slack_r = cpu[3] - (cpu[2] @ ref[0][..., None])[..., 0]
        err["gap"] = float((_comp_gap(slack_k, got[2], m) - _comp_gap(slack_r, ref[2], m))
                           .abs().max())
        err["pres"] = float((torch.clamp_min(-slack_k, 0).max(-1).values
                             - torch.clamp_min(-slack_r, 0).max(-1).values).abs().max())
        print(f"qp_solve {mode} {shape} B {C.shape[0]} n {g.shape[-1]}: "
              + " ".join(f"{k} {v:.3e}" for k, v in err.items()))
        for k, v in err.items():
            assert v <= qp_cuda.QP_SOLVE_TOL[k], (mode, shape, nb, k, v)


def test_qp_solve_kernel_raises_on_bad_inputs(dev):
    from libdwbc_tpu_torch.ops import qp_cuda

    H, g, C, d = [a.to(dev) for a in _qp(np.random.default_rng(4), 4, 6, 3, 4)]
    with pytest.raises(TypeError):
        qp_cuda.qp_solve(H.double(), g.double(), C.double(), d.double())
    with pytest.raises(ValueError):
        qp_cuda.qp_solve(H, g, C, d, mirror=6)
    with pytest.raises(ValueError):
        qp_cuda.qp_solve(H, g, C, d, x0=torch.zeros_like(g))
    with pytest.raises(ValueError):
        qp_cuda.qp_solve(H, g, C[:, :, :5].contiguous(), d)
    # shapes kernel_takes refuses: n = 25, m = 513
    for n, k, extra in ((25, 3, 4), (6, 3, 507)):
        H, g, C, d = [a.to(dev) for a in _qp(np.random.default_rng(5), 2, n, k, extra)]
        assert not qp_cuda.kernel_takes(n, C.shape[1], 3)
        n0 = qp_cuda.launches["qp_solve"]
        with pytest.raises(ValueError, match="does not take"):
            qp_cuda.qp_solve(H, g, C, d, mirror=3)
        assert qp_cuda.launches["qp_solve"] == n0


def test_compiled_tick_cuda_serving(case, dev):
    """Two psd_inverse and three qp_solve launches per tick, warm carry,
    the unbatched tick, and the truth guard's bars against the port's
    CompiledTick in float64 on the CPU."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick

    tick = CompiledTick(case["model"], case["cfg"], dev, backend="cuda")
    q = case["q_el"].T.contiguous().to(dev)
    fs = tuple(f.T.contiguous().to(dev) for f in case["fs_el"])
    qd = torch.zeros((B, 39), device=dev)
    n0 = (linalg_cuda.launches["psd_inverse"], qp_cuda.launches["qp_solve"])
    r0, w = tick._tick_impl(q, qd, fs, warm=tick.init_warm((B,)), qp_iters=12)
    r1, w = tick._tick_impl(q, qd, fs, warm=w, qp_iters=7)
    r2 = tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs))
    torch.cuda.synchronize()
    assert (linalg_cuda.launches["psd_inverse"] - n0[0], qp_cuda.launches["qp_solve"] - n0[1]) \
        == (6, 9)
    assert r1.torque_cmd.shape == (B, 33) and r2.torque_cmd.shape == (33,)
    assert not bool(r0.qp_error.any()) and not bool(r1.qp_error.any()) and not bool(r2.qp_error)
    assert [tuple(x.shape) for x, _ in w] == [(B, 12), (B, 9), (B, 6)]
    ref = CompiledTick(case["model"], case["cfg"], "cpu", torch.float64, backend="torch")
    r64, _ = ref._tick_impl(case["q_el"].T[:4].double(), torch.zeros((4, 39), dtype=torch.float64),
                            tuple(f.T[:4].double() for f in case["fs_el"]),
                            warm=ref.init_warm((4,)))
    for name in ("torque_grav", "torque_cmd"):
        err = float((getattr(r0, name)[:4].cpu().double() - getattr(r64, name)).abs().max())
        print(f"CompiledTick(cuda) vs float64 {name}: {err:.3e}")
        assert err <= 0.05


# ------------------------------------------------------------ masked mode
HYPOTHESES = ("both feet", "left foot", "right foot")


@pytest.fixture(scope="module")
def mcase(dev):
    """The masked sweep's first 96 lanes: the three support hypotheses cycle
    over the lanes."""
    from libdwbc_tpu_torch.entry import _masked_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_cuda import TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=12)
    q, qd, fs, masks = _masked_inputs(m, 96, seed=5)
    return dict(
        model=m, cfg=cfg, q=q, qd=qd, fs=fs, masks=masks,
        kern=TickKernels(TickProgram(m, cfg, dev, torch.float32, masked=True)),
        plain64=TickProgram(m, cfg, "cpu", torch.float64, masked=True),
        plain32=TickProgram(m, cfg, "cpu", torch.float32, masked=True),
        q_el=torch.as_tensor(np.ascontiguousarray(q.T)),
        cm_el=torch.as_tensor(np.ascontiguousarray(masks.T)),
        fs_el=[torch.as_tensor(np.ascontiguousarray(f.T)) for f in fs],
    )


def test_masked_prestage_kernel_matches_plain_float64(mcase, dev):
    """Every field per hypothesis within PRE_TOL_MASKED; the masks exactly;
    in every single-support lane NwJw and the dead foot's rows of J̄ᵀ exactly
    zero."""
    from libdwbc_tpu_torch.ops.tick_cuda import PRE_TOL_MASKED

    kern = mcase["kern"]
    n0 = kern.launches["tick_prestage"]
    got = kern.prestage(mcase["q_el"].to(dev), mcase["cm_el"].to(dev))
    torch.cuda.synchronize()
    assert kern.launches["tick_prestage"] == n0 + 1
    ref = mcase["plain64"].prestage(mcase["q_el"].double(), mcase["cm_el"].double())
    lane = np.arange(mcase["q"].shape[0]) % 3
    for k, tol in PRE_TOL_MASKED.items():
        pairs = zip(got[k], ref[k]) if k == "Ntorques" else [(got[k], ref[k])]
        for g, r in pairs:
            assert torch.isfinite(g).all(), k
            d = (g.cpu().double() - r).abs().flatten(0, -2) if g.ndim > 1 else \
                (g.cpu().double() - r).abs()[None]
            for h, hyp in enumerate(HYPOTHESES):
                err = float(d[:, lane == h].max())
                print(f"masked prestage {hyp} {k}: {err:.3e}")
                assert err <= tol, (hyp, k, err, tol)
    for k in ("crow_mask", "active_cdof"):
        assert torch.equal(got[k].cpu().double(), ref[k]), k
    nw, jb = got["NwJw"].cpu(), got["Jbar_act"].cpu()
    assert not nw[..., lane != 0].any()
    assert not jb[6:, :, lane == 1].any() and not jb[:6, :, lane == 2].any()


@pytest.mark.parametrize("warm", [False, True])
def test_masked_qpchain_kernel_matches_plain_float32(mcase, dev, warm):
    from libdwbc_tpu_torch.ops.tick_cuda import QP_TOL_MASKED

    kern, plain = mcase["kern"], mcase["plain32"]
    pre = plain.prestage(mcase["q_el"], mcase["cm_el"])
    w_cpu = plain.qpchain(pre, mcase["fs_el"], None, 12)["warm_out"] if warm else None
    iters = 7 if warm else 12
    ref = plain.qpchain(pre, mcase["fs_el"], w_cpu, iters)
    n0 = kern.launches["tick_qpchain"]
    got = kern.qpchain({k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
                        for k, v in pre.items()},
                       [f.to(dev) for f in mcase["fs_el"]],
                       None if w_cpu is None else [(x.to(dev), l.to(dev)) for x, l in w_cpu],
                       iters)
    torch.cuda.synchronize()
    assert kern.launches["tick_qpchain"] == n0 + 1
    for k, tol in QP_TOL_MASKED.items():
        err = float((got[k].cpu() - ref[k]).abs().max())
        print(f"masked qpchain {'warm' if warm else 'cold'} {k}: {err:.3e}")
        assert err <= tol, (k, err, tol)
    assert float(got["qp_primal_res"].max()) <= 1e-3


def test_masked_fused_tick_cuda_serving(mcase, dev):
    """Two launches per tick, warm carry at the padded shapes, an unbatched
    tick with a 1-D mask, and the loop's launch count: a QP chain per tick
    and re-solve, and a prestage for tick 0 alone (the held state hands
    every later call tick 0's very q and mask, which take its prestage)."""
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    tick = FusedTick(mcase["model"], mcase["cfg"], dev, backend="cuda", masked=True)
    q, qd, m = (torch.as_tensor(mcase[k], device=dev) for k in ("q", "qd", "masks"))
    fs = tuple(torch.as_tensor(f, device=dev) for f in mcase["fs"])
    r0, w = tick._tick_impl(q, qd, fs, m, warm=tick.init_warm((q.shape[0],)), qp_iters=12)
    r1 = tick._tick_impl(q[1], qd[1], tuple(f[1] for f in fs), m[1])
    torch.cuda.synchronize()
    assert tick.kernels.launches == {"tick_prestage": 2, "tick_qpchain": 2}
    assert not bool(r0.qp_error.any()) and not bool(r1.qp_error)
    assert float((r1.torque_cmd - r0.torque_cmd[1]).abs().max()) <= 1e-3
    assert [tuple(x.shape) for x, _ in w] == [(q.shape[0], n) for n in (12, 9, 6)]
    with pytest.raises(ValueError):
        tick._tick_impl(q, qd, fs)
    loop = make_control_loop(tick, K=4, warm_start=True, warm_iters=7, gap_fallback=1e-3)
    for k in tick.kernels.launches:
        tick.kernels.launches[k] = 0
    tick.prestage_reuses = 0
    lr = loop(q, qd, fs, m)
    torch.cuda.synchronize()
    n = 4 + lr.refined_ticks
    assert tick.prestage_reuses == n - 1
    assert tick.kernels.launches == {"tick_prestage": 1, "tick_qpchain": n}
    assert not bool(lr.qp_error.any()) and float(lr.qp_primal_res.max()) <= 1e-3


def test_masked_fused_cuda_takes_point_candidates(mcase, dev):
    """A masked plan with a POINT candidate builds its kernels and ticks:
    one launch of each, finite torques, the POINT candidate's moment rows
    of J̄ᵀ exact zeros on every lane."""
    import dataclasses

    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    cfg = mcase["cfg"]
    point = dataclasses.replace(cfg.contacts[1], contact_type=T.CONTACT_POINT)
    tick = FusedTick(mcase["model"], dataclasses.replace(cfg, contacts=(cfg.contacts[0], point)),
                     dev, backend="cuda", masked=True)
    mask = torch.ones((2, 8), device=dev)
    pre = tick.kernels.prestage(mcase["q_el"][:, :8].contiguous().to(dev), mask)
    res = tick.kernels.qpchain(pre, [f[:, :8].contiguous().to(dev) for f in mcase["fs_el"]],
                               None, 12)
    torch.cuda.synchronize()
    assert tick.kernels.launches == {"tick_prestage": 1, "tick_qpchain": 1}
    assert torch.isfinite(res["torque_cmd"]).all()
    assert not pre["Jbar_act"][9:12].any()


# ------------------------------------------------------------- the servo
@pytest.fixture(scope="module", params=["static", "masked"])
def scase(request, dev):
    """The servo'd flagship on 64 lanes (entry._servo_inputs: moving
    states, a pelvis 6D and a link-15 rotation servo on per-lane clocks);
    masked: the three support hypotheses cycled over the lanes."""
    from libdwbc_tpu_torch.entry import _servo_inputs
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_cuda import TickKernels
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(m, qp_iters=12)
    masked = request.param == "masked"
    q, qd, fs, servos = _servo_inputs(m, B, seed=5)
    masks = np.array([[1, 1], [1, 0], [0, 1]], np.float32)[np.arange(B) % 3]
    ticks = {k: FusedTick(m, cfg, d, dt, backend="torch", masked=masked)
             for k, d, dt in (("64", "cpu", torch.float64), ("32", "cpu", torch.float32))}
    fused = FusedTick(m, cfg, dev, backend="cuda", masked=masked)

    def el(a):
        return torch.as_tensor(np.ascontiguousarray(a.T))

    return dict(model=m, cfg=cfg, masked=masked, q=q, qd=qd, fs=fs, servos=servos,
                masks=masks, fused=fused, kern=fused.kernels, plain64=ticks["64"].prog,
                plain32=ticks["32"].prog, q_el=el(q), qd_el=el(qd), fs_el=[el(f) for f in fs],
                cm_el=el(masks) if masked else None,
                sv64=ticks["64"]._servos_el(servos, B), sv32=ticks["32"]._servos_el(servos, B))


def _plain_servo_pre(prog, c, sv, dtype):
    cm = None if c["cm_el"] is None else c["cm_el"].to(dtype)
    return prog.prestage_servo(c["q_el"].to(dtype), cm, c["qd_el"].to(dtype),
                               [f.to(dtype) for f in c["fs_el"]], sv)


def test_servo_prestage_kernel_matches_plain_float64(scase, dev):
    """The servo'd tick_prestage: every field within PRE_TOL(_MASKED), the
    f* and the task-link states within SERVO_TOL, one launch."""
    from libdwbc_tpu_torch.ops.tick_cuda import PRE_TOL_MASKED, SERVO_TOL

    c, kern = scase, scase["kern"]
    n0 = kern.launches["tick_prestage"]
    sv_dev = tuple(tuple({k: v.to(dev) for k, v in d.items()} for d in lvl)
                   for lvl in c["sv32"])
    got = kern.prestage(c["q_el"].to(dev), None if c["cm_el"] is None else c["cm_el"].to(dev),
                        c["qd_el"].to(dev), [f.to(dev) for f in c["fs_el"]], sv_dev)
    torch.cuda.synchronize()
    assert kern.launches["tick_prestage"] == n0 + 1
    ref = _plain_servo_pre(c["plain64"], c, c["sv64"], torch.float64)
    tol = dict(PRE_TOL_MASKED if c["masked"] else PRE_TOL)
    for k, t in tol.items():
        pairs = zip(got[k], ref[k]) if k == "Ntorques" else [(got[k], ref[k])]
        for g, r in pairs:
            assert torch.isfinite(g).all(), k
            err = float((g.cpu().double() - r).abs().max())
            assert err <= t, (k, err, t)
    for h in range(2):
        err = float((got["fstars"][h].cpu().double() - ref["fstars"][h]).abs().max())
        print(f"servo prestage f* level {h}: {err:.3e}")
        assert err <= SERVO_TOL["fstars"], (h, err)
        for name, g, r in zip(("task_pos", "task_vel", "task_rot", "task_w"),
                              got["task_states"][(h, 0)], ref["task_states"][(h, 0)]):
            err = float((g.cpu().double() - r).abs().max())
            print(f"servo prestage {name} level {h}: {err:.3e}")
            assert err <= SERVO_TOL[name], (h, name, err)


@pytest.mark.parametrize("warm", [False, True])
def test_servo_qpchain_kernel_matches_plain_float32(scase, dev, warm):
    """tick_qpchain reading its f* from a servo'd prestage buffer against
    the plain float32 qpchain on the same f*: each lane within the larger
    of QP_TOL and SERVO_OWN × its float32 distance from float64 on the same
    prestage, at most SERVO_LANES_OVER of the lanes beyond (the servo's f*
    put the QPs on active constraints, where two float32 solves part by
    roundoff on a few lanes)."""
    from libdwbc_tpu_torch.ops.tick_cuda import QP_TOL, QP_TOL_MASKED, lane_err, servo_lanes_over

    c, kern, plain = scase, scase["kern"], scase["plain32"]
    pre = _plain_servo_pre(plain, c, c["sv32"], torch.float32)
    w_cpu = plain.qpchain(pre, pre["fstars"], None, 12)["warm_out"] if warm else None
    iters = 7 if warm else 12
    ref = plain.qpchain(pre, pre["fstars"], w_cpu, iters)
    pre64 = {k: ([t.double() for t in v] if isinstance(v, list) else
                 {key: tuple(t.double() for t in x) for key, x in v.items()}
                 if isinstance(v, dict) else v.double()) for k, v in pre.items()}
    ref64 = c["plain64"].qpchain(pre64, pre64["fstars"],
                                 None if w_cpu is None else
                                 [(x.double(), l.double()) for x, l in w_cpu], iters)

    def to(v):
        if isinstance(v, dict):
            return {k: tuple(t.to(dev) for t in x) for k, x in v.items()}
        return [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)

    n0 = kern.launches["tick_qpchain"]
    got = kern.qpchain({k: to(v) for k, v in pre.items()}, None,
                       None if w_cpu is None else [(x.to(dev), l.to(dev)) for x, l in w_cpu],
                       iters)
    torch.cuda.synchronize()
    assert kern.launches["tick_qpchain"] == n0 + 1
    for k, tol in (QP_TOL_MASKED if c["masked"] else QP_TOL).items():
        err, own = lane_err(got[k], ref[k]), lane_err(ref[k], ref64[k])
        over, allowed = servo_lanes_over(err, own, tol)
        print(f"servo qpchain {'warm' if warm else 'cold'} {k}: max {float(err.max()):.3e} "
              f"[float32's own max {float(own.max()):.3e}], {over} lanes beyond their bar "
              f"(allowed {allowed})")
        assert over <= allowed, (k, over, allowed)
    assert torch.isfinite(got["qp_primal_res"]).all()


def test_servo_loop_cuda_launches(scase, dev):
    """The servo'd closed loop on the card: two tick launches per tick and
    re-solve, one psd_inverse per forward-dynamics step, finite outputs.
    qp_error and the primal residual are printed: on these 64 lanes'
    per-lane clocks float32 leaves a few QPs unsolved."""
    from libdwbc_tpu_torch.ops import linalg_cuda
    from libdwbc_tpu_torch.wbc.loop import forward_dynamics_transition, make_control_loop
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick

    c, tick = scase, scase["fused"]
    ct = CompiledTick(c["model"], c["cfg"], dev, backend="cuda")
    loop = make_control_loop(tick, transition=forward_dynamics_transition(ct), K=4,
                             warm_start=True, warm_iters=7, gap_fallback=1e-3)
    args = [torch.as_tensor(c[k], device=dev) for k in ("q", "qd")]
    args.append(tuple(torch.as_tensor(f, device=dev) for f in c["fs"]))
    if c["masked"]:
        args.append(torch.as_tensor(c["masks"], device=dev))
    for k in tick.kernels.launches:
        tick.kernels.launches[k] = 0
    n_inv = linalg_cuda.launches["psd_inverse"]
    lr = loop(*args, servos=c["servos"])
    torch.cuda.synchronize()
    n = 4 + lr.refined_ticks
    assert tick.kernels.launches == {"tick_prestage": n, "tick_qpchain": n}
    assert linalg_cuda.launches["psd_inverse"] - n_inv == 4
    assert torch.isfinite(lr.torques).all() and torch.isfinite(lr.q_final).all()
    print(f"servo'd loop: qp_error ticks×lanes {int(lr.qp_error.sum())}, primal residual "
          f"max {float(lr.qp_primal_res.max()):.3e}")


# ------------------------------------------- general plans (not the flagship)
def _general(model, name):
    """(plan config, masked) of a general plan: BASELINE's config 3 (single
    support, a swing-foot third level); the mixed task set (a whole-body
    COM level, a custom-frame position and a rotation task in one level, a
    COM-frame position level) on the two 6D feet, static or masked; the
    hands-and-feet fixture (6D feet, POINT hands), static or masked; the
    flagship on LINE feet; or the flagship without a torque limit."""
    import dataclasses

    from libdwbc_tpu_torch.entry import _hands_feet_config, _mixed_tasks_config
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    base = standard_tocabi_config(model, qp_iters=12)
    if name == "config 3":
        return standard_tocabi_config(model, both_feet=False, swing_task=True, qp_iters=12), False
    if name.startswith("hands"):
        return _hands_feet_config(model), name == "hands masked"
    if name == "line feet":
        return dataclasses.replace(base, contacts=tuple(
            dataclasses.replace(c, contact_type=T.CONTACT_LINE, plane_y=0.0)
            for c in base.contacts)), False
    if name == "no limit":
        return dataclasses.replace(base, torque_limit=None), False
    return _mixed_tasks_config(model, base), name == "mixed masked"


def _general_inputs(model, name, nb, seed):
    """q, f* (numpy, float32) and the contact mask of nb lanes: config 3's
    serving inputs (entry._swing_inputs), the hands-and-feet ones (entry.
    _hands_feet_inputs; masked: entry._hands_masked_inputs), the
    flagship's standing q with joint noise and f* 0.05·N(0,1), or the
    masked sweep's lanes."""
    from libdwbc_tpu_torch.entry import (_example_inputs, _hands_feet_inputs,
                                         _hands_masked_inputs, _masked_inputs, _swing_inputs)

    rng = np.random.default_rng(seed)
    if name == "config 3":
        q, _, fs = _swing_inputs(model, nb, seed=seed)
        return q, fs, None
    if name in ("hands", "line feet"):
        q, _, fs = _hands_feet_inputs(model, nb, seed=seed)
        return q, fs, None
    if name == "hands masked":
        q, _, fs, masks = _hands_masked_inputs(model, nb, seed=seed)
        return q, fs, masks
    fs = [0.05 * rng.standard_normal((nb, t)).astype(np.float32)
          for t in ((6, 3) if name == "no limit" else (6, 6, 3))]
    if name == "mixed masked":
        q, _, _, masks = _masked_inputs(model, nb, seed=seed)
        return q, fs, masks
    q0, _, _ = _example_inputs(model)
    q = np.tile(q0, (nb, 1))
    q[:, 6:39] += 0.02 * rng.standard_normal((nb, 33)).astype(np.float32)
    return q, fs, None


@pytest.mark.parametrize("name", ["config 3", "mixed", "mixed masked", "hands", "hands masked",
                                  "line feet", "no limit"])
@pytest.mark.parametrize("nb", [1, 5, 4097])
def test_general_kernels_partial_blocks(case, dev, name, nb):
    """The general-plan kernels at batches that fill one block partly (1, 5)
    and one warp of a last block (4097): tick_prestage against the plain
    float64 prestage, and tick_qpchain (cold at 12 iterations, warm at 7)
    against the plain float32 qpchain, both on the plain float32 prestage,
    each within tick_cuda.GENERAL_TOL[name] ("pre", "qp32"; masked: per
    hypothesis, lane % 3, the hands' lane % 4; NwJw through
    nwjw_determined where its basis follows roundoff)."""
    from libdwbc_tpu_torch.ops.tick_cuda import GENERAL_TOL, TickKernels, nwjw_determined
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m = case["model"]
    cfg, masked = _general(m, name)
    q, fs, masks = _general_inputs(m, name, nb, seed=nb)
    tol = GENERAL_TOL[name]

    def el(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a.T)).to(dtype)

    nh = 4 if name == "hands masked" else 3

    def errs(got, want):
        d = (got.detach().cpu().double() - want.detach().cpu().double()).abs().reshape(-1, nb)
        if not masked:
            return [float(d.max())]
        lane = torch.arange(nb) % nh
        return [float(d[:, lane == h].max()) if (lane == h).any() else 0.0 for h in range(nh)]

    p64 = TickProgram(m, cfg, "cpu", torch.float64, masked=masked)
    p32 = TickProgram(m, cfg, "cpu", torch.float32, masked=masked)
    kern = TickKernels(TickProgram(m, cfg, dev, torch.float32, masked=masked))
    cm = None if masks is None else el(masks)
    got = kern.prestage(el(q).to(dev), None if cm is None else cm.to(dev))
    ref = p64.prestage(el(q, torch.float64), None if cm is None else cm.double())
    torch.cuda.synchronize()
    basis_free = len(cfg.contacts) > 2 or any(c.contact_type != 0 for c in cfg.contacts)
    for k, t in tol["pre"].items():
        pairs = zip(got[k], ref[k]) if k == "Ntorques" else [(got[k], ref[k])]
        if k == "NwJw" and basis_free:
            pairs = [tuple(nwjw_determined(x, p64.plan, None if cm is None else cm.to(
                x["NwJw"].device)) for x in (got, ref))]
        for g, r in pairs:
            assert torch.isfinite(g).all(), k
            e = errs(g, r)
            print(f"prestage {name} B {nb} {k}: {e}")
            assert all(a <= b for a, b in zip(e, t)), (k, e, t)
    if p64.plan.cfree == 0:
        assert got["NwJw"] is None
    pre32 = p32.prestage(el(q), cm)
    pre_d = {k: (None if v is None else [x.to(dev) for x in v] if isinstance(v, list)
                 else v.to(dev)) for k, v in pre32.items()}
    fs_el = [el(f) for f in fs]
    fs_d = [f.to(dev) for f in fs_el]
    ref_c = p32.qpchain(pre32, fs_el, None, 12)
    got_c = kern.qpchain(pre_d, fs_d, None, 12)
    ref_w = p32.qpchain(pre32, fs_el, ref_c["warm_out"], 7)
    got_w = kern.qpchain(pre_d, fs_d, [(x.to(dev), l.to(dev)) for x, l in ref_c["warm_out"]], 7)
    torch.cuda.synchronize()
    assert kern.launches == {"tick_prestage": 1, "tick_qpchain": 2}
    for mode, g_, r_ in (("cold", got_c, ref_c), ("warm", got_w, ref_w)):
        for k in ("torque_task", "torque_contact", "torque_cmd", "contact_force"):
            assert torch.isfinite(g_[k]).all(), (mode, k)
            e, t = errs(g_[k], r_[k]), tol["qp32"][f"{mode}.{k}"]
            print(f"qpchain {name} B {nb} {mode} {k}: {e}")
            assert all(a <= b for a, b in zip(e, t)), (mode, k, e, t)


def test_general_fused_tick_cuda_serving(case, dev):
    """FusedTick(backend="cuda") on config 3: a cold tick, a warm tick and
    an unbatched tick, one launch of each kernel per tick, no qp_error, the
    warm state without a redistribution QP; and a servo'd tick (every level
    servo'd, entry._swing_servo_inputs) with its f* and task states
    within SERVO_TOL of the plain float64 servo'd prestage."""
    from libdwbc_tpu_torch.entry import _swing_inputs, _swing_servo_inputs
    from libdwbc_tpu_torch.ops.tick_cuda import SERVO_TOL
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m = case["model"]
    cfg, _ = _general(m, "config 3")
    tick = FusedTick(m, cfg, dev, backend="cuda")
    q, qd, fs = (torch.as_tensor(a, device=dev) if not isinstance(a, tuple) else
                 tuple(torch.as_tensor(f, device=dev) for f in a) for a in _swing_inputs(m, B))
    r0, w = tick._tick_impl(q, qd, fs, warm=tick.init_warm((B,)), qp_iters=12)
    r1, w = tick._tick_impl(q, qd, fs, warm=w, qp_iters=7)
    r2 = tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs))
    torch.cuda.synchronize()
    assert tick.kernels.launches == {"tick_prestage": 3, "tick_qpchain": 3}
    assert r1.torque_cmd.shape == (B, 33) and r2.torque_cmd.shape == (33,)
    assert not bool(r0.qp_error.any()) and not bool(r1.qp_error.any())
    assert not bool(r2.qp_error) and not r1.torque_contact.any()
    assert [tuple(x.shape) + tuple(lam.shape) for x, lam in w] == [
        (B, 6, B, 76), (B, 3, B, 76), (B, 6, B, 76)]

    sq, sqd, sfs, servos, _, _ = _swing_servo_inputs(m, B, seed=3, noise=0.02)
    plain = {dt: FusedTick(m, cfg, "cpu", dt, backend="torch")
             for dt in (torch.float64, torch.float32)}

    def el(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a.T)).to(dtype)

    sv = tuple(tuple({k: v.to(dev) for k, v in d.items()} for d in lvl)
               for lvl in tick._servos_el(servos, B))
    got = tick.kernels.prestage(el(sq).to(dev), None, el(sqd).to(dev),
                                [el(f).to(dev) for f in sfs], sv)
    ref, own = (t.prog.prestage_servo(el(sq, dt), None, el(sqd, dt), [el(f, dt) for f in sfs],
                                      t._servos_el(servos, B)) for dt, t in plain.items())
    torch.cuda.synchronize()

    def err(a, b):
        return float((a.cpu().double() - b.double()).abs().max())

    # each within the flagship's SERVO_TOL or four times the plain float32
    # prestage's own error, the larger (the swing foot's point ends a longer
    # chain than the pelvis's)
    for h in range(3):
        e, o = err(got["fstars"][h], ref["fstars"][h]), err(own["fstars"][h], ref["fstars"][h])
        print(f"config 3 servo'd f* level {h}: {e:.3e} [plain float32's own {o:.3e}]")
        assert e <= max(SERVO_TOL["fstars"], 4 * o), (h, e, o)
        for name, g, r, o_ in zip(("task_pos", "task_vel", "task_rot", "task_w"),
                                  got["task_states"][(h, 0)], ref["task_states"][(h, 0)],
                                  own["task_states"][(h, 0)]):
            e, o = err(g, r), err(o_, r)
            print(f"config 3 servo'd {name} level {h}: {e:.3e} [plain float32's own {o:.3e}]")
            assert e <= max(SERVO_TOL[name], 4 * o), (h, name, e, o)


def test_hands_fused_tick_cuda_serving(case, dev):
    """FusedTick(backend="cuda") serving the hands-and-feet chain: through
    make_control_loop (tick 0 cold at the configuration's 25 iterations,
    then warm at 7, gap_fallback 1e-3) exactly one QP chain per tick and
    re-solve and one prestage less each call that took the previous call's
    (the held state repeats q), and one unbatched tick; no lane flagged,
    the contacts carrying the weight."""
    from libdwbc_tpu_torch.entry import _hands_feet_inputs
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    m = case["model"]
    cfg, _ = _general(m, "hands")
    tick = FusedTick(m, cfg, dev, backend="cuda")
    q, qd, fs = (torch.as_tensor(a, device=dev) if not isinstance(a, tuple) else
                 tuple(torch.as_tensor(f, device=dev) for f in a)
                 for a in _hands_feet_inputs(m, B))
    lr = make_control_loop(tick, K=4, warm_start=True, warm_iters=7, gap_fallback=1e-3)(q, qd, fs)
    r1 = tick._tick_impl(q[0], qd[0], tuple(f[0] for f in fs))
    torch.cuda.synchronize()
    n = 4 + lr.refined_ticks + 1
    assert tick.prestage_reuses >= 1
    assert tick.kernels.launches == {"tick_prestage": n - tick.prestage_reuses,
                                     "tick_qpchain": n}
    assert not bool(lr.qp_error.any()) and float(lr.qp_primal_res.max()) <= 1e-3
    assert not bool(r1.qp_error) and r1.contact_force.shape == (18,)
    assert float(r1.contact_force[[2, 8, 14, 17]].sum()) < -400.0


def test_general_refusals_raise(case, dev):
    """FusedTick(backend="cuda") refuses what the kernels do not take, with
    its reason: no contacts, five contacts, five levels, a plan beyond
    tick_prestage's shared memory."""
    import dataclasses

    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m = case["model"]
    cfg, _ = _general(m, "mixed")
    hands, _ = _general(m, "hands")
    for reason, bad in (
            ("the plan has 0", dataclasses.replace(cfg, contacts=())),
            ("the plan has 5", dataclasses.replace(hands, contacts=hands.contacts + (
                dataclasses.replace(hands.contacts[2], link=27),))),
            ("at most 4 task levels", dataclasses.replace(
                cfg, task_specs=cfg.task_specs + (((T.TASK_LINK_ROTATION, 31),),) * 2)),
            ("shared memory", dataclasses.replace(cfg, task_specs=(
                tuple((T.TASK_LINK_6D, link) for link in (0, 15, 31, 23)),)))):
        with pytest.raises(NotImplementedError, match=reason):
            FusedTick(m, bad, dev, backend="cuda")


# ------------------------------------------------------ the reduced tick
# ReducedTick(cuda) against its plain float32 version on the card, per field:
# the chained kernels' limits of chip_smoke.py (CHAIN_TOL: about four times
# the plain float32 tick's own error from float64), the diagnostics at the
# failure bars' scale
REDUCED_TOL = {"torque_grav": 1e-2, "torque_task": 1e-2, "torque_contact": 1e-2,
               "torque_cmd": 1e-2, "contact_force": 7e-2, "qp_gap": 1e-4,
               "qp_primal_res": 1e-4, "contact_rank_health": 1e-5}


def _reduced(m, dev, backend="cuda", swing=False):
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config
    from libdwbc_tpu_torch.wbc.reduced_tick import ReducedTick

    cfg = standard_tocabi_config(m, qp_iters=12, both_feet=not swing, swing_task=swing)
    return ReducedTick(m, cfg, dev, backend=backend)


@pytest.mark.parametrize("nb", [1, 5, 1024])
def test_reduced_tick_cuda_matches_plain(case, dev, nb):
    """ReducedTick(cuda) on the flagship, cold and warm, against the plain
    float32 ReducedTick on the card, per field; 3 psd_inverse and 3 qp_solve
    launches per tick, nothing routed to a plain version."""
    from libdwbc_tpu_torch.entry import _swing_inputs
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda

    m = case["model"]
    tick, plain = _reduced(m, dev), _reduced(m, dev, backend="torch")
    q, qd, fs = _swing_inputs(m, nb, seed=5)
    q, qd = torch.as_tensor(q, device=dev), torch.as_tensor(qd, device=dev)
    fs = tuple(torch.as_tensor(f, device=dev) for f in fs[:2])
    n0 = (linalg_cuda.launches["psd_inverse"], qp_cuda.launches["qp_solve"])
    rk, wk = tick._tick_impl(q, qd, fs, warm=tick.init_warm((nb,)), qp_iters=12)
    rk2, _ = tick._tick_impl(q, qd, fs, warm=wk, qp_iters=7)
    torch.cuda.synchronize()
    assert (linalg_cuda.launches["psd_inverse"] - n0[0],
            qp_cuda.launches["qp_solve"] - n0[1]) == (6, 6)
    n1 = (linalg_cuda.launches["psd_inverse"], qp_cuda.launches["qp_solve"])
    rp, wp = plain._tick_impl(q, qd, fs, warm=plain.init_warm((nb,)), qp_iters=12)
    rp2, _ = plain._tick_impl(q, qd, fs, warm=wp, qp_iters=7)
    assert (linalg_cuda.launches["psd_inverse"], qp_cuda.launches["qp_solve"]) == n1
    for got, want in ((rk, rp), (rk2, rp2)):
        assert not bool(got.qp_error.any()) and not bool(want.qp_error.any())
        for name, tol in REDUCED_TOL.items():
            err = float((getattr(got, name) - getattr(want, name)).abs().max())
            print(f"ReducedTick(cuda) vs plain float32, batch {nb}, {name}: {err:.3e}")
            assert err <= tol, (name, err)


@pytest.mark.parametrize("swing", [False, True])
def test_reduced_tick_routes_every_qp_and_inverse(case, dev, swing):
    """Every QP of ReducedTick is one kernel_takes accepts (mirror co_dof) and
    every inverse of 16 ≤ n ≤ 64 goes to psd_inverse: flagship 3 + 3 per
    tick, config 3 2 + 2, at B = 1 too."""
    from libdwbc_tpu_torch.entry import _swing_inputs
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda

    m = case["model"]
    tick = _reduced(m, dev, swing=swing)
    for nv, rows in tick._dims:
        assert qp_cuda.kernel_takes(nv, rows, tick.ridx.co_dof)
    q, qd, fs = _swing_inputs(m, 1, seed=5)
    fs = fs if swing else fs[:2]
    n0 = (linalg_cuda.launches["psd_inverse"], qp_cuda.launches["qp_solve"])
    r = tick._tick_impl(torch.as_tensor(q[0], device=dev), torch.as_tensor(qd[0], device=dev),
                        tuple(torch.as_tensor(f[0], device=dev) for f in fs))
    torch.cuda.synchronize()
    want = (2, 2) if swing else (3, 3)
    assert (linalg_cuda.launches["psd_inverse"] - n0[0],
            qp_cuda.launches["qp_solve"] - n0[1]) == want
    assert r.torque_cmd.shape == (33,) and bool(torch.isfinite(r.torque_cmd).all())


def test_reduced_tick_cuda_refuses_a_cpu_device_and_float64(case, dev):
    from libdwbc_tpu_torch.wbc.reduced_tick import ReducedTick

    m = case["model"]
    with pytest.raises(RuntimeError, match="CUDA"):
        ReducedTick(m, case["cfg"], "cpu", backend="cuda")
    with pytest.raises(TypeError, match="float32"):
        ReducedTick(m, case["cfg"], dev, torch.float64, backend="cuda")


def _facade_tick(rd, flags, q, qd, fs):
    """One OSF-HQP tick through the facade: its torques and each QP's x."""
    from libdwbc_tpu_torch import entry

    entry._facade_set(rd, flags, q, qd, fs)
    assert rd.CalcContactConstraint() == 1
    rd.CalcGravCompensation()
    assert rd.CalcTaskControlTorque() == 1 and rd.CalcContactRedistribute() == 1
    out = {"torque_grav": rd.torque_grav_, "torque_task": rd.torque_task_,
           "torque_contact": rd.torque_contact_,
           "torque_cmd": torch.as_tensor(rd.GetControlTorque())}
    out.update({f"x{h}": r.x for h, r in enumerate(rd.qp_results)})
    out["x_redist"] = rd.cf_redis_qp_
    return {k: v.detach().cpu().double() for k, v in out.items()}


@pytest.mark.parametrize("case_id", [1, 2])
def test_facade_cuda_matches_plain_float32(dev, case_id):
    """RobotData() on the card (the kernels) against the same facade's plain
    float32 on the CPU, per field: each within 4× the plain float32
    facade's own distance from float64 (at least 1e-4; τ_grav 1e-3)."""
    from libdwbc_tpu_torch import entry

    q, qd, fs = entry._facade_cases()[case_id]
    card, flags = entry._facade()
    out = {tag: _facade_tick(rd, flags, q, qd, fs) for tag, rd in (
        ("card", card), ("f32", entry._facade(torch.float32, "cpu", "torch")[0]),
        ("f64", entry._facade(torch.float64, "cpu", "torch")[0]))}
    assert card.qp_error_ == 0
    for k, v in out["card"].items():
        assert torch.isfinite(v).all(), k
        err = float((v - out["f32"][k]).abs().max())
        own = float((out["f32"][k] - out["f64"][k]).abs().max())
        lim = 1e-3 if k == "torque_grav" else max(4.0 * own, 1e-4)
        print(f"facade case {case_id} {k}: card vs plain float32 {err:.3e} <= {lim:.3e}")
        assert err <= lim, (k, err, lim)


def test_facade_cuda_launch_counters(dev):
    """2 psd_inverse + 3 qp_solve per OSF-HQP tick (A in UpdateKinematics
    included), 3 + 3 per Reduced* chain after it: nothing routed to a plain
    version."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda

    rd, flags = entry._facade()
    q, qd, fs = entry._facade_cases()[1]

    def counted(fn):
        n0 = (linalg_cuda.launches["psd_inverse"], qp_cuda.launches["qp_solve"])
        fn()
        torch.cuda.synchronize()
        return (linalg_cuda.launches["psd_inverse"] - n0[0],
                qp_cuda.launches["qp_solve"] - n0[1])

    assert counted(lambda: _facade_tick(rd, flags, q, qd, fs)) == (2, 3)

    def reduced():
        rd.ReducedDynamicsCalculate()
        rd.ReducedCalcContactConstraint()
        rd.ReducedCalcGravCompensation()
        rd.ReducedCalcTaskControlTorque()
        rd.ReducedCalcContactRedistribute()

    assert counted(reduced) == (3, 3)
    assert bool(torch.isfinite(rd.torque_task_).all())


def test_facade_and_bridges_refuse_a_cpu_device_and_float64(dev):
    from libdwbc_tpu_torch import bridge
    from libdwbc_tpu_torch.wbc.robot import RobotData

    assert RobotData().device.type == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        RobotData(torch.float32, "cpu", "cuda")
    with pytest.raises(TypeError, match="float32"):
        RobotData(torch.float64, dev, "cuda")
    with pytest.raises(TypeError, match="float32"):
        bridge.RlWBCBridge(dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        bridge.BatchedRlWBCBridge(2, dtype=torch.float64)


def test_batched_bridge_cuda_matches_float64_bridge(dev):
    """BatchedRlWBCBridge on CompiledTick(cuda) against the port's float64
    bridge on the CPU: τ_cmd within 0.05 Nm on every env (phase 6's truth
    guard), the launches 2 + 3 per solve."""
    from libdwbc_tpu_torch import bridge, entry
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda

    n = 64
    br = bridge.BatchedRlWBCBridge(n)
    ref = bridge.BatchedRlWBCBridge(n, dtype=torch.float64, device="cpu", backend="torch")
    q, _, fs = entry._example_inputs(br.model, np.float64)
    rng = np.random.default_rng(3)
    qpos = np.tile(np.concatenate([q[0:3], [q[39]], q[3:6], q[6:39]]), (n, 1))
    qpos[:, 7:] += 0.02 * rng.standard_normal((n, 33))
    qvel = 0.05 * rng.standard_normal((n, 39))
    f = [np.tile(x, (n, 1)) + 0.05 * rng.standard_normal((n, x.shape[0])) for x in fs]
    n0 = (linalg_cuda.launches["psd_inverse"], qp_cuda.launches["qp_solve"])
    got = br.solve(qpos, qvel, qvel, f[0], f[1])
    torch.cuda.synchronize()
    assert (linalg_cuda.launches["psd_inverse"] - n0[0],
            qp_cuda.launches["qp_solve"] - n0[1]) == (2, 3)
    want = ref.solve(qpos, qvel, qvel, f[0], f[1])
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.05


# ------------------------------------------------- the tick's CUDA graphs
class _Uncaptured:
    """A FusedTick each of whose calls runs with ``KEYS_MAX`` monkeypatched
    to 0: in a transient entry, the body uncaptured."""

    def __init__(self, tick):
        self.tick = tick

    def __getattr__(self, name):
        return getattr(self.tick, name)

    def _tick_impl(self, *args, **kw):
        from libdwbc_tpu_torch.wbc import tick_graph

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tick_graph, "KEYS_MAX", 0)
            return self.tick._tick_impl(*args, **kw)


def _graph_and_eager(m, cfg, dev, masked=False):
    """(a FusedTick served from its CUDA graphs, one that runs every call
    eagerly: ``KEYS_MAX`` 0 while it runs)."""
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    graph = FusedTick(m, cfg, dev, backend="cuda", masked=masked)
    eager = _Uncaptured(FusedTick(m, cfg, dev, backend="cuda", masked=masked))
    return graph, eager


def _assert_bits(a, b):
    """Two results (tensors, or tuples of them, nested) equal bit for bit."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bits(x, y)
        return
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    assert torch.equal(a, b)


def _batch_inputs(m, B, seed):
    """B standing states (device float32) and f* per level."""
    from libdwbc_tpu_torch.entry import _example_inputs

    rng = np.random.default_rng(seed)
    q, _, fs = _example_inputs(m)
    qs = np.tile(q, (B, 1))
    qs[:, 6:39] += 0.02 * rng.standard_normal((B, 33)).astype(np.float32)
    fss = tuple(np.tile(f, (B, 1)) + 0.05 * rng.standard_normal((B, f.shape[0])).astype(
        np.float32) for f in fs)
    return (torch.as_tensor(qs, device="cuda"),
            tuple(torch.as_tensor(f, device="cuda") for f in fss))


def _moved(q, d):
    """q with every joint moved by d."""
    q = q.clone()
    q[..., 6:39] += d
    return q


def test_graph_lane_tick_matches_eager(case, dev):
    """The unbatched lane tick, its q and f* float64 numpy as
    ``native.TickConsumer`` hands them: cold at 12 iterations, then warm at
    7, bit for bit the eager tick's, the warm state carried; one capture a
    budget, replays after."""
    from libdwbc_tpu_torch.entry import _example_inputs

    g, e = _graph_and_eager(case["model"], case["cfg"], dev)
    q0, qd, fs0 = _example_inputs(case["model"], np.float64)
    rng = np.random.default_rng(17)
    wg, we = g.init_warm(), e.init_warm()
    for k in range(6):
        q = q0.copy()
        q[6:39] += 0.02 * rng.standard_normal(33)
        fs = tuple(f + 0.05 * rng.standard_normal(f.shape) for f in fs0)
        iters = None if k == 0 else 7
        rg, wg = g._tick_impl(q, qd, fs, warm=wg, qp_iters=iters)
        re, we = e._tick_impl(q, qd, fs, warm=we, qp_iters=iters)
        _assert_bits((tuple(rg), wg), (tuple(re), we))
        assert rg.torque_cmd.shape == (33,) and rg.qp_error.shape == ()
    assert not bool(rg.qp_error)
    assert g.graph_counts == {"captures": 2, "replays": 4, "eager": 0}
    assert e.graph_counts["eager"] == 6


@pytest.mark.parametrize("mask", [None, "1d", "2d"])
def test_graph_batch_tick_matches_eager(case, dev, mask):
    """B = 1024 on the card, cold at 12 then warm at 7 twice (masked: a 1-D
    mask for every lane, or the sweep's per-lane 2-D mask): bit for bit the
    eager tick's."""
    from libdwbc_tpu_torch.entry import _masked_inputs

    B = 1024
    m = case["model"]
    if mask is None:
        q, fs = _batch_inputs(m, B, 23)
        args = ()
    else:
        qn, _, fsn, masks = _masked_inputs(m, B, seed=23)
        q = torch.as_tensor(qn, device=dev)
        fs = tuple(torch.as_tensor(f, device=dev) for f in fsn)
        args = (torch.tensor([1.0, 0.0], device=dev) if mask == "1d"
                else torch.as_tensor(masks, device=dev),)
    g, e = _graph_and_eager(m, case["cfg"], dev, masked=mask is not None)
    qd = torch.zeros((B, 39), device=dev)
    wg, we = g.init_warm((B,)), e.init_warm((B,))
    for k, iters in enumerate((12, 7, 7)):
        qk = _moved(q, 1e-3 * k)
        rg, wg = g._tick_impl(qk, qd, fs, *args, warm=wg, qp_iters=iters)
        re, we = e._tick_impl(qk, qd, fs, *args, warm=we, qp_iters=iters)
        _assert_bits((tuple(rg), wg), (tuple(re), we))
    assert g.graph_counts == {"captures": 2, "replays": 1, "eager": 0}


def test_graph_results_are_not_overwritten(case, dev):
    """Two consecutive replays of one key: the first call's results and
    warm state stay as they were."""
    g, _ = _graph_and_eager(case["model"], case["cfg"], dev)
    q, fs = _batch_inputs(case["model"], 64, 29)
    qd = torch.zeros((64, 39), device=dev)
    w = g.init_warm((64,))
    outs = [g._tick_impl(_moved(q, 1e-3 * k), qd, fs, warm=w, qp_iters=7) for k in range(3)]
    kept = [(tuple(t.clone() for t in r), tuple((x.clone(), l.clone()) for x, l in ww))
            for r, ww in outs]
    later = g._tick_impl(_moved(q, -1e-3), qd, fs, warm=w, qp_iters=7)
    torch.cuda.synchronize()
    for (r, ww), k in zip(outs, kept):
        _assert_bits((tuple(r), ww), k)
    assert not torch.equal(outs[1][0].torque_cmd, outs[2][0].torque_cmd)
    assert not torch.equal(later[0].torque_cmd, outs[2][0].torque_cmd)
    assert g.graph_counts["replays"] == 3


def test_graph_control_loop_matches_eager(case, dev):
    """``make_control_loop(..., gap_fallback=1e-3)`` on a moving state: the
    same LoopResult from the graphs as from the eager tick."""
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    g, e = _graph_and_eager(case["model"], case["cfg"], dev)
    q, fs = _batch_inputs(case["model"], 256, 31)
    qd = torch.zeros((256, 39), device=dev)

    def transition(q, qdot, res, dt):
        return _moved(q, 1e-3 * torch.tanh(res.torque_cmd / 100.0)), qdot

    got, want = (make_control_loop(t, transition, K=8, warm_start=True, warm_iters=7,
                                   gap_fallback=1e-3)(q, qd, fs) for t in (g, e))
    assert got.refined_ticks == want.refined_ticks
    _assert_bits(tuple(got[:5]), tuple(want[:5]))
    # a re-solve takes its warm tick's prestage, except right after the warm
    # key's capture (tick 1); the first that takes it captures the QP chain
    n, reused = got.refined_ticks, g.prestage_reuses
    assert n - 1 <= reused <= n and e.prestage_reuses == 0
    assert g.graph_counts["captures"] == 2 + (reused > 0)
    assert g.graph_counts["replays"] == 6 + n - (reused > 0)
    assert g.kernels.launches == {"tick_prestage": 8 + n - reused, "tick_qpchain": 8 + n}


def test_graph_launch_counts_and_keys(case, dev, monkeypatch):
    """A capture adds no launch and a replay two (one a kernel), as the
    eager tick; a new B captures a new key; past ``KEYS_MAX`` keys a call
    runs eagerly, with the eager tick's results."""
    from libdwbc_tpu_torch.wbc import tick_graph

    g, e = _graph_and_eager(case["model"], case["cfg"], dev)
    q, fs = _batch_inputs(case["model"], 8, 37)
    qd = torch.zeros((8, 39), device=dev)
    # each call its own q: a repeated q would take the previous call's prestage
    g._tick_impl(q.clone(), qd, fs)     # the key's first call: eager, then the capture
    assert g.kernels.launches == {"tick_prestage": 1, "tick_qpchain": 1}
    assert g.graph_counts == {"captures": 1, "replays": 0, "eager": 0}
    for n in (2, 3):
        g._tick_impl(q.clone(), qd, fs)
        assert g.kernels.launches == {"tick_prestage": n, "tick_qpchain": n}
    assert g.graph_counts == {"captures": 1, "replays": 2, "eager": 0}
    g._tick_impl(q[:5], qd[:5], tuple(f[:5] for f in fs))
    assert g.graph_counts["captures"] == 2
    monkeypatch.setattr(tick_graph, "KEYS_MAX", 3)
    g._tick_impl(q[:6], qd[:6], tuple(f[:6] for f in fs))
    assert g.graph_counts["captures"] == 3
    got = g._tick_impl(q[:7], qd[:7], tuple(f[:7] for f in fs))
    assert g.graph_counts == {"captures": 3, "replays": 2, "eager": 1}
    _assert_bits(tuple(got), tuple(e._tick_impl(q[:7], qd[:7], tuple(f[:7] for f in fs))))
    torch.cuda.synchronize()
    assert g.kernels.launches == {"tick_prestage": 6, "tick_qpchain": 6}


@pytest.mark.parametrize("plan,nb", [("stand", 1024), ("hands", 1024), ("masked", 4096),
                                     ("stand", None)])
def test_graph_resolve_takes_the_warm_ticks_prestage(case, dev, plan, nb):
    """The control loop's call sequence on the graphs (nb None: unbatched):
    cold at the full budget, warm at 7, the re-solve at the full budget on
    the warm tick's q (and mask) from its warm output, three times.  Every
    call equals bit for bit the eager tick (the body uncaptured on the
    same staged inputs).  The first re-solve follows the warm key's
    capturing call, which executed nothing: it runs the whole tick again.
    The next two take the warm tick's prestage, the first of them capturing
    the graph of the QP chain alone: ``tick_prestage`` launches once per
    tick and per whole re-solve, ``tick_qpchain`` once per call."""
    from libdwbc_tpu_torch.entry import _hands_feet_config, _hands_feet_inputs, _masked_inputs

    m = case["model"]
    B_ = 1 if nb is None else nb
    args = ()
    if plan == "stand":
        q, fs = _batch_inputs(m, B_, 41)
        cfg = case["cfg"]
    elif plan == "hands":
        cfg = _hands_feet_config(m)
        qn, _, fsn = _hands_feet_inputs(m, B_, seed=41)
        q, fs = torch.as_tensor(qn, device=dev), tuple(torch.as_tensor(f, device=dev)
                                                        for f in fsn)
    else:
        cfg = case["cfg"]
        qn, _, fsn, masks = _masked_inputs(m, B_, seed=41)
        q, fs = torch.as_tensor(qn, device=dev), tuple(torch.as_tensor(f, device=dev)
                                                        for f in fsn)
        args = (torch.as_tensor(masks, device=dev),)
    if nb is None:
        q, fs = q[0].clone(), tuple(f[0].clone() for f in fs)
    lead = () if nb is None else (B_,)
    qd = torch.zeros(lead + (39,), device=dev)
    g, e = _graph_and_eager(m, cfg, dev, masked=plan == "masked")
    full = cfg.qp_iters
    wg, we = g.init_warm(lead), e.init_warm(lead)
    rg, wg = g._tick_impl(q.clone(), qd, fs, *args, warm=wg, qp_iters=full)
    re, we = e._tick_impl(q.clone(), qd, fs, *args, warm=we, qp_iters=full)
    _assert_bits((tuple(rg), wg), (tuple(re), we))
    for k in range(3):
        qk = _moved(q, 1e-3 * (k + 1))
        rg, wg = g._tick_impl(qk, qd, fs, *args, warm=wg, qp_iters=7)
        re, we = e._tick_impl(qk, qd, fs, *args, warm=we, qp_iters=7)
        _assert_bits((tuple(rg), wg), (tuple(re), we))
        rg, wg = g._tick_impl(qk, qd, fs, *args, warm=wg, qp_iters=full)
        re, we = e._tick_impl(qk, qd, fs, *args, warm=we, qp_iters=full)
        _assert_bits((tuple(rg), wg), (tuple(re), we))
        assert g.prestage_reuses == k
    torch.cuda.synchronize()
    assert e.prestage_reuses == 0
    assert g.graph_counts == {"captures": 3, "replays": 4, "eager": 0}
    assert g.kernels.launches == {"tick_prestage": 5, "tick_qpchain": 7}
    assert e.kernels.launches == {"tick_prestage": 7, "tick_qpchain": 7}


def test_hands_feet_lane487_lands_within_limits(dev):
    """Lane 487 of draw 3 of the benchmark's rollout pool on the hands-and-
    feet plan (tests/data/hands_feet_lane487.npz: its float32 q, q̇ and f*,
    drawn on the card), served unbatched by FusedTick(backend="cuda") cold at
    the plan's 25 iterations (the kernels repeat the lane's B = 1024 result
    bit for bit at B = 1), against the plain float64 tick: τ_task within
    1.0 Nm and the task variables within 0.5, the configuration's limits.
    With qr_pinv's float64 rcond in the float32 prestage, tick_prestage kept
    the singular inner system's roundoff pivot and the τ_task assertion
    failed, 5.93 Nm off, the lane unflagged (tests/test_torch_hands_feet.py
    puts the same roundoff into the plain path on the CPU)."""
    from libdwbc_tpu_torch.entry import _hands_feet_config
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m = RobotModel.load(MODEL)
    hcfg = _hands_feet_config(m)
    assert hcfg.qp_iters == 25
    z = np.load(os.path.join(ROOT, "tests", "data", "hands_feet_lane487.npz"))
    fs = (z["f0"], z["f1"])
    tick = FusedTick(m, hcfg, dev, backend="cuda")
    res, warm = tick._tick_impl(z["q"], z["qd"], fs, warm=tick.init_warm(), qp_iters=25)
    plain = TickProgram(m, hcfg, "cpu", torch.float64)
    want = plain.tick(torch.as_tensor(z["q"], dtype=torch.float64)[:, None],
                      [torch.as_tensor(f, dtype=torch.float64)[:, None] for f in fs], iters=25)
    assert not bool(res.qp_error)
    tau_err = float((res.torque_task.cpu().double() - want["torque_task"][:, 0]).abs().max())
    assert tau_err <= 1.0, tau_err
    for (x, _), (wx, _), t in zip(warm, want["warm_out"], plain.plan.level_tdofs):
        assert float((x.cpu().double()[:t] - wx[:t, 0]).abs().max()) <= 0.5
