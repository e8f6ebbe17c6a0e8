"""The port's scenario mesh (``parallel/mesh.py`` on ``torch.distributed``)
and its multi-rank dry run (``entry.dryrun_multichip``) against the JAX
package's ``parallel/mesh.py`` on the CPU.

The mesh layouts and the blocks each rank holds equal JAX's on its eight
virtual CPU devices (conftest).  Eight gloo ranks solve a 4 × 8 grid of the
flagship's CompiledTick in float64 (the ranks are spawned processes that
import only the port): the gathered τ_cmd equals one unsharded port call
(1e-12), and τ_cmd, the best scenario and its cost equal the JAX
``sharded_batch_solver`` on the same grid (τ_cmd at
``tests/test_torch_compiled.py``'s 5e-2, the same best, the cost within
1e-9 relative).  The JAX step is compiled once, in a module fixture.
"""

import os

import jax
import numpy as np
import pytest
import torch

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
H, R = 4, 8
ITERS = 12
TAU_CMD_TOL = 5e-2     # test_torch_compiled.py's τ_cmd limit (the flat-face policy)


def _jax_mesh(n):
    from libdwbc_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=jax.devices()[:n])


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax(n):
    """The squarest factorisation, each rank at its device's position, and
    each rank's block of a (2·n_hyp) × (2·n_roll) grid as the JAX sharding
    cuts it."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libdwbc_tpu_torch.parallel.mesh import make_mesh

    jm, pm = _jax_mesh(n), make_mesh(world_size=n)
    assert pm.shape == dict(jm.shape)
    assert pm.device_mesh is None
    np.testing.assert_array_equal(pm.ranks, np.vectorize(lambda d: d.id)(jm.devices))
    grid = (2 * jm.shape["hyp"], 2 * jm.shape["roll"])
    idx = NamedSharding(jm, P("hyp", "roll")).devices_indices_map(grid)
    for d in jm.devices.flat:
        want = tuple(s.indices(g) for s, g in zip(idx[d], grid))
        got = tuple(s.indices(g) for s, g in zip(pm.block(grid, d.id), grid))
        assert got == want, (n, d.id)
        assert pm.position(d.id) == tuple(int(i) for i in np.argwhere(jm.devices == d)[0])


def test_make_mesh_takes_a_given_shape():
    from libdwbc_tpu_torch.parallel.mesh import make_mesh

    assert make_mesh(4, 2, world_size=8).shape == {"hyp": 4, "roll": 2}
    with pytest.raises(ValueError):
        make_mesh(3, 2, world_size=8)
    with pytest.raises(ValueError):
        make_mesh(world_size=8).block((3, 8))


def test_best_is_the_first_least_in_row_major_order():
    """jnp.argmin's choice on one rank: the first of tied least costs, a NaN
    before any number; the index is the grid's, the block's offset added."""
    from libdwbc_tpu_torch.parallel.mesh import _global_argmin, make_mesh

    mesh = make_mesh(world_size=1, device="cpu")
    index = torch.arange(100, 116, dtype=torch.float64)
    cost = torch.tensor([3.0, 1.0, 2.0, 1.0] * 4, dtype=torch.float32)
    best, best_cost = _global_argmin(mesh, cost, index)
    assert (int(best), float(best_cost), best_cost.dtype) == (101, 1.0, torch.float32)
    cost[9] = float("nan")
    best, best_cost = _global_argmin(mesh, cost, index)
    assert int(best) == 109 and torch.isnan(best_cost)


def test_global_layout_keeps_hyp_within_a_node():
    """make_global_mesh's layout across nodes: every 'hyp' column lies in one
    node, each node owns whole columns, every rank appears once."""
    from libdwbc_tpu_torch.parallel.mesh import _global_layout

    for world, local, n_hyp in ((8, 4, None), (8, 4, 2), (16, 8, 4), (6, 3, 1)):
        ranks = _global_layout(world, local, n_hyp)
        assert ranks.shape[0] == (local if n_hyp is None else n_hyp)
        assert sorted(ranks.flat) == list(range(world))
        nodes = ranks // local
        assert (nodes == nodes[0]).all()
        assert (np.diff(nodes[0]) >= 0).all()
    with pytest.raises(ValueError):
        _global_layout(8, 4, 3)


def test_init_distributed_is_a_no_op_without_environment(monkeypatch):
    import torch.distributed as dist

    from libdwbc_tpu_torch.parallel.mesh import _LAUNCH_ENV, init_distributed

    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized()


def test_host_local_scenarios_hands_each_rank_jax_slices(mesh_run, monkeypatch):
    """The mesh slices each gloo rank's ``make_local`` was handed are those the
    JAX ``host_local_scenarios`` hands a process that holds that rank's
    device alone."""
    from libdwbc_tpu.parallel import mesh as jmesh

    class Handed(Exception):
        pass

    jm = _jax_mesh(8)
    for d in jm.devices.flat:
        handed = []

        def make_local(h_sl, r_sl):
            handed.append((h_sl.start, h_sl.stop, r_sl.start, r_sl.stop))
            raise Handed

        monkeypatch.setattr(jax, "local_devices", lambda d=d: [d])
        with pytest.raises(Handed):
            jmesh.host_local_scenarios(jm, make_local)
        assert mesh_run["port"]["slices"][d.id] == handed[0], d.id


@pytest.fixture(scope="module")
def mesh_run():
    """The 4 × 8 grid (float64) solved three ways: eight gloo ranks of the
    port, one unsharded port call, and the JAX sharded_batch_solver over its
    2 × 4 mesh of virtual CPU devices."""
    import jax.numpy as jnp

    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu.parallel.mesh import shard_scenarios, sharded_batch_solver
    from libdwbc_tpu.wbc.pipeline import CompiledTick as JTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config as jcfg
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.parallel.mesh import run_ranks

    model = entry.RobotModel.load(MODEL)
    grid = entry._grid_inputs(model, H, R, dtype=np.float64)
    port = run_ranks(entry._grid_solve, 8, "cpu", args=(grid, torch.float64, ITERS))
    _, tick = entry._model_and_tick("cpu", torch.float64, qp_iters=ITERS, backend="torch",
                                    fused=False)
    q, qd, fs = grid
    one = tick._tick_impl(q.reshape(H * R, -1), qd.reshape(H * R, -1),
                          tuple(f.reshape(H * R, -1) for f in fs))
    cost = (one.torque_cmd ** 2).sum(-1) + 1e6 * one.qp_primal_res

    jmodel = JModel.load(MODEL)
    jt = JTick(jmodel, jcfg(jmodel, qp_iters=ITERS), dtype=jnp.float64)
    jm = _jax_mesh(8)
    step, _ = sharded_batch_solver(jt._tick_impl, jm)
    jq, jqd, jfs = shard_scenarios(jm, q, qd, fs)
    res, best, best_cost = step(jq, jqd, jfs)
    ref = dict(tau=np.asarray(res.torque_cmd), best=int(best), best_cost=float(best_cost))
    return dict(port=port, one=one.torque_cmd.reshape(H, R, -1), one_cost=cost, ref=ref)


def test_gloo_solver_equals_one_unsharded_call(mesh_run):
    port = mesh_run["port"]
    assert port["mesh"] == {"hyp": 2, "roll": 4}
    assert port["tau"].shape == (H, R, 33)
    assert float((port["tau"] - mesh_run["one"]).abs().max()) <= 1e-12
    cost = mesh_run["one_cost"]
    assert port["best"] == int(torch.argmin(cost))
    assert abs(port["best_cost"] - float(cost.min())) <= 1e-12 * float(cost.min())


def test_gloo_solver_matches_jax(mesh_run):
    port, ref = mesh_run["port"], mesh_run["ref"]
    err = float(np.abs(port["tau"].numpy() - ref["tau"]).max())
    print(f"tau_cmd against JAX: {err:.3e}; best {port['best']} vs {ref['best']}; cost "
          f"{port['best_cost']!r} vs {ref['best_cost']!r}")
    assert err <= TAU_CMD_TOL
    assert port["best"] == ref["best"]
    assert abs(port["best_cost"] - ref["best_cost"]) <= 1e-9 * abs(ref["best_cost"])


def test_dryrun_multichip_on_eight_gloo_ranks():
    """The JAX dry run's three legs on eight gloo ranks, its 1e-2 Nm parity
    for the sharded fused and masked ticks."""
    from libdwbc_tpu_torch import entry

    out = entry.dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"hyp": 2, "roll": 4} and out["grid"] == (4, 8)
    assert out["fused"] < 1e-2 and out["masked"] < 1e-2
    assert 0 <= out["grid_best"] < 32 and 0 <= out["fused_best"] < 32
