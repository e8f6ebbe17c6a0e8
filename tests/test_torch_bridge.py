"""The port's RL bridges (``bridge.py``), golden-matrix I/O
(``utils/golden.py``), top-level exports and contact-mode hypothesis sweep
(``parallel/hypotheses.py``) against the JAX package's, on the CPU.

* ``mujoco_to_dwbc_q``: exact.
* ``BatchedRlWBCBridge(3)`` at float32 (both packages' default) on the same
  perturbed standing states: τ_grav within 1e-3 Nm, τ_cmd within the
  flat-face 5e-2 (two float32 IPMs); the JAX tick jitted once.
* the port's float64 ``BatchedRlWBCBridge`` against its ``RlWBCBridge``
  env by env (CompiledTick against the facade, at the same IPM budget):
  τ_cmd within 1e-6.
* the golden format written by one package and read by the other.
* the sweep at B = 3, float64, one lane per mode in shuffled order, against
  each lane's JAX ``CompiledTick._tick_impl`` of its mode run eagerly (the
  JAX vmapped ``lax.switch`` sweep compiles for about 90 s here): τ_cmd and
  the padded contact force 1e-8, the cost 1e-6 relative, the same argmin.
"""

import os

import numpy as np
import pytest
import torch

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "models", "tocabi.npz")
N = 3


def mujoco_inputs(n, seed, dtype=np.float64):
    """MuJoCo-layout qpos (x y z, qw qx qy qz, joints), qvel, qacc and f*
    of n perturbed standing robots."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel

    m = RobotModel.load(MODEL)
    q, _, fs = entry._example_inputs(m, np.float64)
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.concatenate([q[0:3], [q[39]], q[3:6], q[6:39]]), (n, 1))
    qpos[:, 7:] += 0.02 * rng.standard_normal((n, 33))
    qvel = 0.05 * rng.standard_normal((n, 39))
    fstars = [np.tile(f, (n, 1)) + 0.05 * rng.standard_normal((n, f.shape[0])) for f in fs]
    return (qpos.astype(dtype), qvel.astype(dtype), np.zeros((n, 39), dtype),
            *(f.astype(dtype) for f in fstars))


def test_mujoco_to_dwbc_q_matches_jax():
    from libdwbc_tpu import bridge as jb
    from libdwbc_tpu_torch import bridge as pb

    qpos = mujoco_inputs(2, 0)[0]
    for row in qpos:
        got = pb.mujoco_to_dwbc_q(row, 39, 33)
        assert np.array_equal(got, jb.mujoco_to_dwbc_q(row, 39, 33))
        assert got[39] == row[3] and np.array_equal(got[3:6], row[4:7])


def _reordered(qpos, m, dtype):
    qs = np.zeros((qpos.shape[0], m.nq), dtype)
    qs[:, 0:3], qs[:, 3:6], qs[:, m.ndof] = qpos[:, 0:3], qpos[:, 4:7], qpos[:, 3]
    qs[:, 6:6 + m.model_dof] = qpos[:, 7:7 + m.model_dof]
    return qs


def test_batched_bridge_float32_matches_jax():
    import jax.numpy as jnp

    from libdwbc_tpu import bridge as jb
    from libdwbc_tpu_torch import bridge as pb

    qpos, qvel, qacc, f0, f1 = mujoco_inputs(N, 1, np.float32)
    jbr = jb.BatchedRlWBCBridge(N)
    pbr = pb.BatchedRlWBCBridge(N, device="cpu", backend="torch")
    assert pbr.tick.dtype == torch.float32 and pbr.n_envs == N
    tau_j = jbr.solve(qpos, qvel, qacc, f0, f1)
    tau_p = pbr.solve(qpos, qvel, qacc, f0, f1)
    assert tau_p.dtype == np.float32 and tau_p.shape == (N, 33)
    # τ_grav through each bridge's tick on the same reordered state
    qs = _reordered(qpos, pbr.model, np.float32)
    rj = jbr._batched(jnp.asarray(qs), jnp.asarray(qvel), (jnp.asarray(f0), jnp.asarray(f1)))
    rp = pbr.tick._tick_impl(qs, qvel, (f0, f1))
    assert np.array_equal(rp.torque_cmd.numpy(), tau_p)
    assert np.abs(rp.torque_grav.numpy() - np.asarray(rj.torque_grav)).max() <= 1e-3
    assert np.abs(tau_p - tau_j).max() <= 5e-2
    assert not rp.qp_error.any() and not np.asarray(rj.qp_error).any()


def test_float64_batched_bridge_matches_rl_bridge_per_env():
    """solve casts its inputs to the tick's dtype: a float64 bridge is a
    float64 reference (the JAX bridge casts to float32 whatever its tick,
    and its float64 tick then fails, ROADMAP §3)."""
    from libdwbc_tpu_torch import bridge as pb

    qpos, qvel, qacc, f0, f1 = mujoco_inputs(N, 2)
    pbr = pb.BatchedRlWBCBridge(N, dtype=torch.float64, device="cpu", backend="torch")
    tau = pbr.solve(qpos, qvel, qacc, f0, f1)
    assert tau.dtype == np.float64
    rl = pb.RlWBCBridge(dtype=torch.float64, device="cpu", backend="torch")
    rl.rd_.qp_iters = 12          # the batched tick's budget
    for i in range(N):
        rl.UpdateKinematics(qpos[i], qvel[i], qacc[i])
        rl.SetContact(True, True)
        rl.SetTaskSpace(0, f0[i])
        rl.SetTaskSpace(1, f1[i])
        rl.CalcTorque()
        assert np.abs(rl.rd_.GetControlTorque() - tau[i]).max() <= 1e-6
        assert np.abs(np.asarray(rl.getTorqueCommand()) - tau[i]).max() <= 1e-4


@pytest.mark.parametrize("shape", [(4, 3), (1, 7), (5,)])
def test_golden_round_trip(tmp_path, shape):
    from libdwbc_tpu.utils import golden as jg
    from libdwbc_tpu_torch.utils import golden as pg

    mat = np.random.default_rng(7).standard_normal(shape)
    want = np.atleast_2d(mat)
    pg.write_golden(str(tmp_path / "port.bin"), mat)
    jg.write_golden(str(tmp_path / "jax.bin"), mat)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    for reader in (pg.read_golden, jg.read_golden):
        got = reader(str(tmp_path / "port.bin"))
        assert got.shape == want.shape and np.array_equal(got, want)
    raw = (tmp_path / "port.bin").read_bytes()
    # int64 rows, int64 cols, then column-major float64
    assert np.frombuffer(raw[:16], np.int64).tolist() == list(want.shape)
    assert np.array_equal(np.frombuffer(raw[16:], np.float64), want.T.ravel())


def test_top_level_exports_match_jax():
    import libdwbc_tpu
    import libdwbc_tpu_torch

    assert libdwbc_tpu_torch.__all__ == libdwbc_tpu.__all__
    for name in libdwbc_tpu.__all__:
        obj = getattr(libdwbc_tpu_torch, name)
        mod = obj.__name__ if name == "types" else obj.__module__
        assert mod.startswith("libdwbc_tpu_torch."), (name, mod)
    assert libdwbc_tpu_torch.types.CONTACT_6D == libdwbc_tpu.types.CONTACT_6D


@pytest.fixture(scope="module")
def sweep():
    """The flagship's three contact modes (both feet, left, right) in both
    packages at float64, and the port's sweep over B = 3 lanes."""
    import jax.numpy as jnp

    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu.parallel import hypotheses as JH
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config as jcfg
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.parallel import hypotheses as H
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    jm, pm = JModel.load(MODEL), RobotModel.load(MODEL)
    jc, pc = jcfg(jm, qp_iters=12), standard_tocabi_config(pm, qp_iters=12)
    jmodes, jticks = JH.contact_mode_ticks(jm, jc.contacts, jc.task_specs, jc.torque_limit,
                                           qp_iters=12, dtype=jnp.float64)
    modes, ticks = H.contact_mode_ticks(pm, pc.contacts, pc.task_specs, pc.torque_limit,
                                        qp_iters=12, dtype=torch.float64, device="cpu",
                                        backend="torch")
    q, qd, fs = entry._swing_inputs(pm, N, seed=4, dtype=np.float64)
    fs = fs[:2]
    mode_idx = np.array([2, 0, 1])
    tau, cost, best = H.hypothesis_sweep(pm, modes, ticks, mode_idx, q, qd, fs)
    outs = H.make_hypothesis_tick(pm, modes, ticks)(mode_idx, q, qd, fs)
    # each lane through the JAX tick of its mode, eagerly
    ref = []
    for i, mi in enumerate(mode_idx):
        r = jticks[mi]._tick_impl(jnp.asarray(q[i]), jnp.asarray(qd[i]),
                                  tuple(jnp.asarray(f[i]) for f in fs))
        cf = np.zeros(12)
        cf[:np.asarray(r.contact_force).shape[-1]] = np.asarray(r.contact_force)
        ref.append(dict(tau=np.asarray(r.torque_cmd), grav=np.asarray(r.torque_grav), cf=cf,
                        pres=float(r.qp_primal_res)))
    return dict(jmodes=jmodes, modes=modes, tau=tau, cost=cost, best=best, outs=outs, ref=ref)


def test_contact_modes_match_jax(sweep):
    assert sweep["modes"] == sweep["jmodes"] == [(True, True), (True, False), (False, True)]


def test_hypothesis_sweep_matches_jax(sweep):
    ref = sweep["ref"]
    tau_ref = np.stack([r["tau"] for r in ref])
    cost_ref = (tau_ref ** 2).sum(-1) + 1e6 * np.array([r["pres"] for r in ref])
    assert np.abs(sweep["tau"].numpy() - tau_ref).max() <= 1e-8
    assert np.abs(sweep["cost"].numpy() - cost_ref).max() <= 1e-6 * np.abs(cost_ref).max()
    assert int(sweep["best"]) == int(np.argmin(cost_ref))


def test_hypothesis_tick_outputs_match_jax(sweep):
    tau, grav, task, contact, cf, gap, pres = (t.numpy() for t in sweep["outs"])
    ref = sweep["ref"]
    assert cf.shape == (N, 12) and gap.shape == (N,)
    assert np.abs(cf - np.stack([r["cf"] for r in ref])).max() <= 1e-8
    assert np.abs(grav - np.stack([r["grav"] for r in ref])).max() <= 1e-8
    assert np.allclose(tau, grav + task + contact, atol=1e-10)
    # single-support lanes pad the absent foot's wrench with zeros
    assert (cf[[0, 2], 6:] == 0).all() and np.abs(cf[1, 6:]).max() > 1.0


def test_hypothesis_tick_routes_lanes_by_mode(sweep):
    """Lanes sharing a mode, and a mode no lane chose: each mode's lanes
    equal its tick on those lanes alone, bit for bit."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.parallel import hypotheses as H
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    pm = RobotModel.load(MODEL)
    cfg = standard_tocabi_config(pm, qp_iters=12)
    modes, ticks = H.contact_mode_ticks(pm, cfg.contacts, cfg.task_specs, cfg.torque_limit,
                                        qp_iters=12, dtype=torch.float64, device="cpu",
                                        backend="torch", min_active=2)
    assert modes == [(True, True)] and len(ticks) == 1
    modes, ticks = sweep["modes"], H.contact_mode_ticks(
        pm, cfg.contacts, cfg.task_specs, cfg.torque_limit, dtype=torch.float64,
        device="cpu", backend="torch")[1]
    q, qd, fs = entry._swing_inputs(pm, 4, seed=8, dtype=np.float64)
    mode_idx = torch.tensor([1, 1, 0, 1])
    tau = H.make_hypothesis_tick(pm, modes, ticks)(mode_idx, q, qd, fs[:2])[0]
    for mi in (0, 1):
        lanes = (mode_idx == mi).numpy()
        alone = ticks[mi]._tick_impl(q[lanes], qd[lanes], tuple(f[lanes] for f in fs[:2]))
        assert torch.equal(tau[lanes], alone.torque_cmd)
