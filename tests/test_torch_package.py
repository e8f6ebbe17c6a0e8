"""Package boundaries of the port: no JAX, the CUDA backend refuses to run
without a card, and the kernel wrappers route CPU tensors to the plain
version."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

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
           "libdwbc_tpu_torch.wbc.fused", "libdwbc_tpu_torch.wbc.tick_graph",
           "libdwbc_tpu_torch.wbc.pipeline",
           "libdwbc_tpu_torch.wbc.types", "libdwbc_tpu_torch.wbc.masked",
           "libdwbc_tpu_torch.wbc.loop", "libdwbc_tpu_torch.utils.traj",
           "libdwbc_tpu_torch.model.urdf", "libdwbc_tpu_torch.model.rotations_np",
           "libdwbc_tpu_torch.model.surgery", "libdwbc_tpu_torch.kin.centroidal",
           "libdwbc_tpu_torch.wbc.reduced", "libdwbc_tpu_torch.wbc.reduced_tick",
           "libdwbc_tpu_torch.wbc.lqp", "libdwbc_tpu_torch.wbc.robot",
           "libdwbc_tpu_torch.bridge", "libdwbc_tpu_torch.utils.golden",
           "libdwbc_tpu_torch.parallel.hypotheses", "libdwbc_tpu_torch.parallel.mesh",
           "libdwbc_tpu_torch.native", "libdwbc_tpu_torch.tracing")


def test_port_imports_no_jax():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import numpy as np\n"
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
            "model, tick = entry._model_and_tick('cpu', backend='torch')\n"
            "q, qd, fs, sv = entry._servo_inputs(model, 2)\n"
            "tick._tick_impl(q, qd, fs, servos=sv)\n"
            "from libdwbc_tpu_torch.wbc.fused import FusedTick\n"
            "from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config\n"
            "cfg3 = standard_tocabi_config(model, both_feet=False, swing_task=True)\n"
            "q, qd, fs = entry._swing_inputs(model, 2)\n"
            "FusedTick(model, cfg3, 'cpu', backend='torch')._tick_impl(q, qd, fs)\n"
            "model, tick = entry._model_and_tick('cpu', backend='torch', reduced=True, swing=True)\n"
            "tick._tick_impl(q, qd, fs, warm=tick.init_warm((2,)))\n"
            "import torch\n"
            "from libdwbc_tpu_torch import bridge\n"
            "rl = bridge.RlWBCBridge(dtype=torch.float64, device='cpu', backend='torch')\n"
            "q, qd, fs = entry._example_inputs(model, np.float64)\n"
            "qpos = np.concatenate([q[0:3], [q[39]], q[3:6], q[6:39]])\n"
            "rl.UpdateKinematics(qpos, qd, qd)\n"
            "rl.SetContact(True, True)\n"
            "rl.SetTaskSpace(0, fs[0]); rl.SetTaskSpace(1, fs[1])\n"
            "rl.CalcTorque(); assert len(rl.getTorqueCommand()) == 33\n"
            "br = bridge.BatchedRlWBCBridge(2, device='cpu', backend='torch')\n"
            "t2 = br.solve(np.tile(qpos, (2, 1)), np.tile(qd, (2, 1)), np.tile(qd, (2, 1)),\n"
            "              np.tile(fs[0], (2, 1)), np.tile(fs[1], (2, 1)))\n"
            "assert t2.shape == (2, 33) and np.isfinite(t2).all()\n"
            "from libdwbc_tpu_torch.parallel import hypotheses as H\n"
            "cfg = standard_tocabi_config(model, qp_iters=12)\n"
            "modes, ticks = H.contact_mode_ticks(model, cfg.contacts, cfg.task_specs,\n"
            "    cfg.torque_limit, device='cpu', backend='torch')\n"
            "q3, qd3, fs3 = entry._swing_inputs(model, 3)\n"
            "tau, cost, best = H.hypothesis_sweep(model, modes, ticks, np.arange(3), q3, qd3,\n"
            "                                     fs3[:2])\n"
            "assert tau.shape == (3, 33) and torch.isfinite(cost).all()\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
            "assert not any(k.startswith('libdwbc_tpu.') or k == 'libdwbc_tpu' for k in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
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
    """The CUDA tick's masked table carries a POINT candidate's type and its
    live jacobian and constraint rows (the translation rows, the cone), so
    the kernels take it; what they still refuse — here five candidates — is
    refused when the kernel table is built (FusedTick(masked,
    backend="cuda") builds it), never sent to the plain version."""
    import dataclasses

    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan
    from libdwbc_tpu_torch.wbc import types as T

    m, cfg = flagship
    assert tc.kernel_table(TickPlan(m, cfg, masked=True))[tc.H_MASKED] == 1.0
    point = dataclasses.replace(cfg.contacts[1], contact_type=T.CONTACT_POINT)
    plan = TickPlan(m, dataclasses.replace(cfg, contacts=(cfg.contacts[0], point)), masked=True)
    tab = tc.kernel_table(plan)
    c0 = len(tab) - 33 - 4 * len(tc.tasks(plan)) - (7 + 6 + 10 + 60) * 2
    assert tab[c0 + 7:c0 + 14].tolist() == [1, 12, T.CONTACT_POINT, 6, 6, 10, 10]
    assert tab[c0 + 14 + 6:c0 + 14 + 12].tolist() == [1, 1, 1, 0, 0, 0]
    assert tab[c0 + 26 + 10:c0 + 26 + 20].tolist() == [0] * 4 + [1] * 6
    five = dataclasses.replace(cfg, contacts=cfg.contacts + tuple(
        dataclasses.replace(point, link=link) for link in (23, 31, 27)))
    with pytest.raises(NotImplementedError, match="the plan has 5"):
        tc.kernel_table(TickPlan(m, five, masked=True))


def test_unknown_backend_raises(flagship):
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m, cfg = flagship
    with pytest.raises(ValueError):
        FusedTick(m, cfg, device="cpu", backend="pallas")


@pytest.mark.parametrize("stage", ["tick", "masked_tick", "servo_tick", "past_keys_max",
                                   "reuse_past_keys_max"])
def test_plain_fused_tick_is_the_plain_program(flagship, stage, monkeypatch):
    """``FusedTick(backend="torch")`` through its one host path (key,
    entry, staging, body) gives bit for bit ``TickProgram.tick`` on
    element-leading inputs built here: a call, a masked call, a servo'd
    call, a call past ``KEYS_MAX`` (a transient entry) and a reuse of a
    held prestage past ``KEYS_MAX`` (the QP chain's transient entry)."""
    from libdwbc_tpu_torch.entry import _example_inputs, _servo_inputs
    from libdwbc_tpu_torch.wbc import tick_graph
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m, cfg = flagship
    masked = stage == "masked_tick"
    tick = FusedTick(m, cfg, "cpu", torch.float32, backend="torch", masked=masked)
    q, qd, fs = _example_inputs(m)
    rng = np.random.default_rng(5)
    q = np.tile(q, (3, 1))
    q[:, 6:39] += 0.02 * rng.standard_normal((3, 33)).astype(np.float32)
    qd = np.tile(qd, (3, 1))
    fs = [np.tile(f, (3, 1)) + 0.05 * rng.standard_normal((3, f.shape[0])).astype(np.float32)
          for f in fs]

    def el(x):
        return torch.as_tensor(x).T.contiguous()

    args, kw, servos = (), {}, None
    if masked:
        cm = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
        args, kw["cmask"] = (torch.as_tensor(cm),), el(cm)
    if stage == "servo_tick":
        _, qd, _, servos = _servo_inputs(m, 3)
        kw.update(qdot=el(qd), servos=tick._servos_el(servos, 3))
    want = tick.prog.tick(el(q), [el(f) for f in fs], None, 12, **kw)
    if "past_keys_max" in stage:
        monkeypatch.setattr(tick_graph, "KEYS_MAX", 1)
    if stage == "past_keys_max":
        tick._tick_impl(q[:2], qd[:2], [f[:2] for f in fs], qp_iters=12)   # the kept key
    qt = torch.as_tensor(q)
    if stage == "reuse_past_keys_max":
        tick._tick_impl(qt, qd, fs, qp_iters=12)          # the kept key; holds its prestage
    got = tick._tick_impl(qt, qd, fs, *args, qp_iters=12, servos=servos)
    assert tick.prestage_reuses == (stage == "reuse_past_keys_max")
    if "past_keys_max" in stage:
        assert len(tick.entries.kept) == 1
    for f, k in (("torque_grav", "torque_grav"), ("torque_task", "torque_task"),
                 ("torque_contact", "torque_contact"), ("torque_cmd", "torque_cmd"),
                 ("contact_force", "contact_force"), ("qp_gap", "qp_gap"),
                 ("qp_primal_res", "qp_primal_res"), ("contact_rank_health", "health")):
        w = want[k]
        assert torch.equal(getattr(got, f), w.movedim(-1, 0) if w.ndim == 2 else w), f


@pytest.mark.parametrize("launch", ["prestage_staged", "prestage_packed", "prestage",
                                    "qpchain_staged", "qpchain_packed", "qpchain"])
def test_kernels_refuse_cpu_tensors(flagship, launch):
    """``TickKernels`` routes nothing to the plain version: a CPU tensor
    raises at every launch, before any build, as one on a wrong device
    does, and nothing is counted."""
    from libdwbc_tpu_torch.entry import _example_inputs
    from libdwbc_tpu_torch.ops.tick_cuda import TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    m, cfg = flagship
    prog = TickProgram(m, cfg, "cpu", torch.float32)
    kern = TickKernels(prog)
    q, _, fs = _example_inputs(m)
    q_el = torch.as_tensor(np.tile(q, (3, 1)).T.copy())
    fs_el = [torch.as_tensor(np.tile(f, (3, 1)).T.copy()) for f in fs]
    pre = prog.prestage(q_el)
    calls = {"prestage_staged": lambda: kern.prestage_staged(q_el, None),
             "prestage_packed": lambda: kern.prestage_packed(q_el),
             "prestage": lambda: kern.prestage(q_el),
             "qpchain_staged": lambda: kern.qpchain_staged(kern.pack_pre(pre),
                                                           torch.cat(fs_el), None, 12),
             "qpchain_packed": lambda: kern.qpchain_packed(kern.pack_pre(pre), fs_el, None, 12),
             "qpchain": lambda: kern.qpchain(pre, fs_el, None, 12)}
    with pytest.raises(ValueError, match="CUDA device"):
        calls[launch]()
    assert kern.launches == {"tick_prestage": 0, "tick_qpchain": 0}
    assert not hasattr(kern, "tick")


def test_pack_unpack_round_trip(flagship):
    _round_trip(flagship, masked=False)


def test_masked_pack_unpack_round_trip(flagship):
    _round_trip(flagship, masked=True)


def test_servo_pack_unpack_round_trip(flagship):
    """A servo'd prestage dict (its f* and task states too) through the
    servo'd buffer layout and back."""
    _round_trip(flagship, masked=True, servo=True)


def _round_trip(flagship, masked, servo=False):
    from libdwbc_tpu_torch.entry import _example_inputs, _servo_inputs
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    m, cfg = flagship
    tick = FusedTick(m, cfg, "cpu", torch.float32, backend="torch", masked=masked)
    prog = tick.prog
    kern = tc.TickKernels(prog)
    q, _, _ = _example_inputs(m)
    q_el = torch.as_tensor(np.tile(q, (2, 1)).T.copy())
    cm = torch.tensor([[1.0, 0.0], [1.0, 1.0]]) if masked else None
    if servo:
        _, qd, fs, servos = _servo_inputs(m, 2)
        pre = prog.prestage_servo(q_el, cm, torch.as_tensor(qd.T.copy()),
                                  [torch.as_tensor(f.T.copy()) for f in fs],
                                  tick._servos_el(servos, 2))
    else:
        pre = prog.prestage(q_el, cm)
    packed = kern.pack_pre(pre)
    assert packed.servo == servo
    assert packed.buf.shape == (tc._elems(tc.pre_layout(prog.plan, servo)), 2)
    back = kern.unpack_pre(packed)
    assert back.keys() == pre.keys()
    for k, v in pre.items():
        if k in ("Ntorques", "fstars"):
            assert all(torch.equal(a, b) for a, b in zip(back[k], v))
        elif k == "task_states":
            assert all(torch.equal(a, b) for key in v for a, b in zip(back[k][key], v[key]))
        else:
            assert torch.equal(back[k], v), k


def test_servo_packing_keeps_infinite_clamps(flagship):
    """make_servo's default clamps (+inf, off) reach the kernels' float32
    servo buffer as +inf, and every other field as given."""
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import make_servo

    m, cfg = flagship
    tick = FusedTick(m, cfg, "cpu", torch.float32, backend="torch")
    servos = ((make_servo(pos_des=[0.1, 0.2, 0.3], t=torch.tensor([0.1, 0.2, 0.3])),),
              (make_servo(rot_des=torch.eye(3), max_d_err=2.0),))
    sv_el = tick._servos_el(servos, 3)
    assert tc.servo_mask(sv_el, tick.prog.plan) == 0b11
    buf = tc.pack_servos(sv_el, tick.prog.plan, 3)
    assert buf.dtype == torch.float32 and buf.shape == (2 * tc.SERVO_ELEMS, 3)
    rows, off = {}, 0
    for h in range(2):
        for f in tc.SERVO_FIELDS:
            n = int(np.prod(tc.SERVO_ELEM_SHAPES[f]))
            rows[(h, f)] = buf[off:off + n]
            off += n
    assert tc.SERVO_FIELDS[:2] == ("max_d_err", "max_p_err")
    assert torch.isposinf(rows[(0, "max_p_err")]).all()
    assert torch.isposinf(rows[(0, "max_d_err")]).all()
    assert torch.isposinf(rows[(1, "max_p_err")]).all()
    assert (rows[(1, "max_d_err")] == 2.0).all()
    assert torch.equal(rows[(0, "t")][0], torch.tensor([0.1, 0.2, 0.3]))
    assert torch.equal(rows[(1, "rot_des")], torch.eye(3).reshape(9, 1).expand(9, 3))
    assert (rows[(0, "use_rot")] == 0).all() and (rows[(1, "use_rot")] == 1).all()


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
