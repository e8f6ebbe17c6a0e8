"""Multi-card scaling: scenario-batch sharding over a mesh of ranks
(counterpart of ``libdwbc_tpu/parallel/mesh.py``) on ``torch.distributed``.

The scaling axis is the scenario batch: a (H, R) grid of control problems
(contact-mode hypotheses × disturbance rollouts) cut into blocks over a 2-D
mesh of ranks

    ('hyp', 'roll')  — hypothesis axis × rollout axis

one rank per card (NCCL) or per CPU process (gloo).  Within a scenario
nothing is split; each rank runs the batched tick on its block, and the
only traffic between ranks is the best-scenario reduction: each rank's
(cost, global index) gathered from every rank of the mesh, one small
collective per step.  ``gather_grid`` collects a grid's blocks over the
DeviceMesh's 'roll' and 'hyp' groups.

Ranks sit on the mesh in row-major order, rank = h·n_roll + r, as
``mesh_utils.create_device_mesh`` lays CPU devices, and a rank's block of
an (H, R) grid is rows h·H/n_hyp … and columns r·R/n_roll …, as the JAX
``NamedSharding(mesh, P('hyp', 'roll'))`` cuts it.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import itertools
import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..wbc.pipeline import TickResult

AXES = ("hyp", "roll")
# the variables that say a launcher (torchrun, a cluster script) set the
# process group's rendezvous up for this process
_LAUNCH_ENV = ("MASTER_ADDR", "WORLD_SIZE", "TORCHELASTIC_RUN_ID")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('hyp', 'roll') mesh of ranks.  ``ranks[h, r]`` is the rank at mesh
    position (h, r); ``device_mesh`` the ``torch.distributed`` DeviceMesh over
    the same layout while the process group is up, whose per-axis groups
    carry the collectives, else None (the layout alone: one process, no
    collective)."""

    ranks: np.ndarray
    device_type: str = "cuda"
    device_mesh: object = None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.device_mesh is not None else int(self.ranks.flat[0])

    @property
    def device(self) -> torch.device:
        """Where this rank's tensors live: its card, or the CPU."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def position(self, rank: int | None = None) -> tuple[int, int]:
        """The mesh position (h, r) of ``rank`` (default: this process's)."""
        h, r = np.argwhere(self.ranks == (self.rank if rank is None else rank))[0]
        return int(h), int(r)

    @functools.cached_property
    def axis_groups(self) -> list:
        """[(axis index, process group, each group rank's mesh position along
        the axis)] of this rank's 'roll' group (its mesh row), then its 'hyp'
        group (its mesh column), from the DeviceMesh; empty without one."""
        if self.device_mesh is None:
            return []
        return [(dim, group, [self.position(g)[dim] for g in dist.get_process_group_ranks(group)])
                for dim, group in ((1, self.device_mesh.get_group("roll")),
                                   (0, self.device_mesh.get_group("hyp")))]

    def block(self, grid: tuple[int, int], rank: int | None = None) -> tuple[slice, slice]:
        """The rows and columns of an (H, R) grid that ``rank`` holds."""
        n_hyp, n_roll = self.ranks.shape
        H, R = grid
        if H % n_hyp or R % n_roll:
            raise ValueError(f"a {H}x{R} grid does not split over a {n_hyp}x{n_roll} mesh")
        h, r = self.position(rank)
        hb, rb = H // n_hyp, R // n_roll
        return slice(h * hb, (h + 1) * hb), slice(r * rb, (r + 1) * rb)


def _squarest(n: int) -> tuple[int, int]:
    n_hyp = next(f for f in range(int(np.sqrt(n)), 0, -1) if n % f == 0)
    return n_hyp, n // n_hyp


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_hyp: int | None = None, n_roll: int | None = None,
              world_size: int | None = None, device=None) -> Mesh:
    """A 2-D ('hyp', 'roll') mesh over the ranks: n_hyp × n_roll when both
    are given, else the squarest factorisation of the rank count (8 → 2 × 4).
    ``world_size`` defaults to the process group's size (1 without one).
    With the process group up it builds the DeviceMesh (a collective: every
    rank calls it) on the group's devices (NCCL: the cards, gloo: the CPU);
    without one it gives the layout alone, its tensors on the card unless
    ``device="cpu"``."""
    up = dist.is_available() and dist.is_initialized()
    n = world_size if world_size is not None else dist.get_world_size() if up else 1
    if n_hyp is None or n_roll is None:
        n_hyp, n_roll = _squarest(n)
    if n_hyp * n_roll != n:
        raise ValueError(f"a {n_hyp}x{n_roll} mesh does not hold {n} ranks")
    ranks = np.arange(n).reshape(n_hyp, n_roll)
    if not up or n != dist.get_world_size():
        return Mesh(ranks, torch.device("cuda" if device is None else device).type)
    from torch.distributed.device_mesh import init_device_mesh

    dtype = _device_type()
    return Mesh(ranks, dtype, init_device_mesh(dtype, (n_hyp, n_roll), mesh_dim_names=AXES))


def _global_argmin(mesh: Mesh, cost: torch.Tensor, index: torch.Tensor):
    """(best, best_cost): the first least cost of the grid in row-major order,
    as ``jnp.argmin`` over the flat grid picks it (a NaN counts as the
    least).  cost: this rank's block, flat; index: each of its scenarios'
    flat index into the grid (float64).  Each rank's first least (cost,
    index) is gathered from every rank in one collective over the process
    group, which the mesh spans (``make_mesh``, ``make_global_mesh``): the
    index says where each came from, so the ranks' order does not matter;
    the least cost wins, on a tie the least index.  Every step stays on the
    device: no host read."""
    i = torch.argmin(cost).view(1)
    cand = torch.stack([cost.double(), index]).index_select(1, i).view(2)
    if mesh.device_mesh is not None:
        allc = cand.new_empty(2 * dist.get_world_size())
        dist.all_gather_into_tensor(allc, cand)
        if allc.numel() > 2:        # one rank gathers its own candidate
            allc = allc.view(-1, 2)
            key = torch.nan_to_num(allc[:, 0], nan=-torch.inf)
            j = torch.where(key == key.min(), allc[:, 1], torch.inf).argmin().view(1)
            cand = allc.index_select(0, j)[0]
    return cand[1].long(), cand[0].to(cost.dtype)


def sharded_batch_solver(tick_impl, mesh: Mesh):
    """Solve a (H, R) scenario grid cut into blocks over the mesh, returning
    each rank's results and the globally best scenario.

    tick_impl: a batched tick, ``tick._tick_impl`` (q, qdot, fstars, *args,
    **kw) → TickResult, or (TickResult, warm) when ``warm=`` is given.
    Returns (step, block_of):
      step(q[h, r, nq], qdot[h, r, n], fstars tuple of [h, r, t], *args, **kw)
        → (TickResult of (h, r, ...) — with the warm state out, flat over
        the block, when ``warm=`` was given — best index into the flat
        (H, R) grid, its cost), for this rank's (h, r) block; further
        positional arrays (a contact mask) are cut like q.
      block_of((H, R)) → this rank's (rows, columns) of the grid.
    The scenario cost is command effort plus a constraint-violation
    penalty, Σ τ_cmd² + 1e6 · qp_primal_res, and the best scenario comes
    from one collective over the whole mesh (``_global_argmin``).  A step is
    the span ``dwbc.mesh.step``, its request (this solver, the step's index).
    """
    n_hyp, n_roll = mesh.ranks.shape
    indices = {}    # (h_len, r_len, device) → the block's flat grid indices
    seq, steps = tracing.sequence(), itertools.count()

    def block_index(h_len, r_len, device):
        key = (h_len, r_len, device)
        if key not in indices:
            H, R = h_len * n_hyp, r_len * n_roll
            grid = torch.arange(H * R, dtype=torch.float64).view(H, R)
            indices[key] = grid[mesh.block((H, R))].reshape(-1).to(device)
        return indices[key]

    def solve(q, qdot, fstars, *args, **kw):
        h_len, r_len = q.shape[:2]

        def flat(x):
            return x.reshape((h_len * r_len,) + tuple(x.shape[2:]))

        out = tick_impl(flat(q), flat(qdot), tuple(flat(f) for f in fstars),
                        *(flat(a) for a in args), **kw)
        warm = kw.get("warm") is not None
        res, w = out if warm else (out, None)
        cost = res.torque_cmd.square().sum(-1).add_(res.qp_primal_res, alpha=1e6)
        best, best_cost = _global_argmin(mesh, cost, block_index(h_len, r_len, cost.device))
        res = TickResult(*(x.reshape((h_len, r_len) + tuple(x.shape[1:])) for x in res))
        return ((res, w) if warm else res), best, best_cost

    def step(q, qdot, fstars, *args, **kw):
        with tracing.request(seq, next(steps)), tracing.span("dwbc.mesh.step"):
            return solve(q, qdot, fstars, *args, **kw)

    return step, mesh.block


def _on_device(a, device, rows=slice(None), cols=slice(None)):
    """a[rows, cols] as a contiguous tensor on ``device`` (a tuple leaf by leaf)."""
    if isinstance(a, (tuple, list)):
        return tuple(_on_device(x, device, rows, cols) for x in a)
    return torch.as_tensor(a)[rows, cols].to(device).contiguous()


def shard_scenarios(mesh: Mesh, *arrays):
    """This rank's (h, r) block of each full (H, R, ...) array (numpy or
    tensor; a tuple of them cut leaf by leaf), on this rank's device."""
    def cut(a):
        if isinstance(a, (tuple, list)):
            return tuple(cut(x) for x in a)
        return _on_device(a, mesh.device, *mesh.block(tuple(a.shape[:2])))

    return tuple(cut(a) for a in arrays)


def gather_grid(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """The full (H, R, ...) grid from every rank's (h, r, ...) block: the
    blocks of this rank's mesh row all-gathered and laid side by side along
    'roll', then the rows along 'hyp' (the block itself without a process
    group)."""
    out = block.contiguous()
    for dim, group, pos in mesh.axis_groups:
        parts = [torch.empty_like(out) for _ in pos]
        dist.all_gather(parts, out, group=group)
        out = torch.cat([parts[pos.index(p)] for p in range(len(pos))], dim)
    return out


# ---------------------------------------------------------------------------
# The scale-out across nodes (BASELINE's north star: ≥ 80% linear solves/s
# to 2+ hosts).  The same ('hyp', 'roll') mesh, laid out so that 'roll'
# crosses nodes while 'hyp' stays within a node: per-scenario work never
# communicates, and the only traffic between nodes is the argmin above.
# ---------------------------------------------------------------------------

def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device=None,
                     timeout: datetime.timedelta | None = None) -> bool:
    """Start the process group (idempotent): NCCL on the card (the default)
    with this rank's card made current, gloo with ``device="cpu"``; NCCL is
    never swapped for gloo.  With no arguments it relies on a launcher's
    environment (torchrun: MASTER_ADDR, WORLD_SIZE, RANK, LOCAL_RANK); with
    neither it is a no-op returning False (one process, no collective)."""
    if dist.is_initialized():
        return True
    if (init_method is None and world_size is None
            and not any(k in os.environ for k in _LAUNCH_ENV)):
        return False
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: NCCL needs a CUDA device, and none is "
                               "present; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size if world_size
                            is not None else -1, rank=rank if rank is not None else -1, **kw)
    return True


def _global_layout(world: int, local: int, n_hyp: int | None) -> np.ndarray:
    """ranks[h, g·c + j] = g·local + h·c + j: node g (ranks g·local …) owns
    columns g·c … of the mesh, c = local / n_hyp; 'hyp' stays in a node."""
    n_hyp = local if n_hyp is None else n_hyp
    if local % n_hyp:
        raise ValueError(f"n_hyp {n_hyp} does not divide the {local} ranks of a node")
    c = local // n_hyp
    ranks = np.empty((n_hyp, c * (world // local)), np.int64)
    for g in range(world // local):
        ranks[:, g * c:(g + 1) * c] = g * local + np.arange(local).reshape(n_hyp, c)
    return ranks


def make_global_mesh(n_hyp: int | None = None) -> Mesh:
    """The ('hyp', 'roll') mesh over every node's ranks: 'hyp' within a node
    (``LOCAL_WORLD_SIZE`` ranks; n_hyp defaults to all of them), 'roll'
    across nodes, so that each node owns whole hypothesis columns.  On one
    node it is ``make_mesh``."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local == world:
        return make_mesh(n_hyp=n_hyp)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = _global_layout(world, local, n_hyp)
    dtype = _device_type()
    return Mesh(ranks, dtype, DeviceMesh(dtype, torch.as_tensor(ranks), mesh_dim_names=AXES))


def host_local_scenarios(mesh: Mesh, make_local):
    """This rank's block of the scenario grid, made by this rank alone.

    make_local(h_slice, r_slice) → tuple of numpy arrays for the rank's
    block of the grid (each (h_len, r_len, ...)); the slices are the rank's
    mesh positions, (h:h+1, r:r+1), as the JAX version derives them from a
    process's devices.  Returns the block's tensors on this rank's device —
    what ``sharded_batch_solver``'s step takes: no rank ever holds the
    whole grid."""
    h, r = mesh.position()
    return tuple(_on_device(a, mesh.device) for a in make_local(slice(h, h + 1),
                                                                 slice(r, r + 1)))


# ---------------------------------------------------------------------------
# Running a function on n ranks of one machine
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n_ranks, device, port, fn, args, out_path):
    torch.set_num_threads(1)
    init_distributed(f"tcp://127.0.0.1:{port}", n_ranks, rank, device=device,
                     timeout=datetime.timedelta(seconds=600))
    try:
        out = fn(make_mesh(), *args)
        if rank == 0:
            torch.save(out, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, device=None, args=()):
    """Run ``fn(mesh, *args)`` on ``n_ranks`` spawned processes of this
    machine, one rank each, over ``make_mesh()``: NCCL with one card per
    rank (the default; raises with fewer cards than ranks), gloo with
    ``device="cpu"``.  ``fn`` must be importable (it is pickled by name);
    rank 0's return value comes back.  A failing rank raises here."""
    device = "cuda" if device is None else device
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"{n_ranks} NCCL ranks need {n_ranks} CUDA devices, "
                           f"{torch.cuda.device_count()} present")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_rank_main, args=(n_ranks, device, free_port(), fn, args, out_path),
                           nprocs=n_ranks, join=True, start_method="spawn")
        return torch.load(out_path, weights_only=False)
