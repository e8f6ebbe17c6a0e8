"""The contact-hypothesis sweep across cards: a (H, R) grid of masked
scenarios cut over a ('hyp', 'roll') mesh of ranks, one per card (NCCL;
gloo processes on the CPU in a rehearsal), each step one call of the
port's ``parallel/mesh.py::sharded_batch_solver`` over the masked fused
tick with the warm carry, the global best scenario by its one collective,
and the rollouts' transition.  Tick 0 of a rollout is cold, the rest warm;
the step has no fallback, so a lane-step with ``qp_error`` counts as failed.

The harness's process is rank 0 and prints the result; it starts the other
ranks itself and waits for each, and for the resource tracker that
multiprocessing starts beside them.  solves_per_s: every rank's lane-steps of
the window over its time on rank 0, between barriers; the window is whole
rollouts, and rank 0 says after each whether another starts.
"""

from __future__ import annotations

import datetime
import math
import socket
import time

import numpy as np
import torch

from .. import check, program, recipes, work
from ..harness import Harness, device_of, finish, gpu_state, open_card, quiet
from ..record import Recorder, Reservoir
from ..reference import plan_of
from ..trace import Tracer
from .rollout import sync


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(h: Harness) -> dict:
    import torch.multiprocessing as mp

    n_hyp, n_roll = h.traffic["mesh"]
    world = n_hyp * n_roll
    open_card(h, device_of(h))                  # the build once, before the ranks start
    port = free_port()
    spec = dict(workload=h.cell["name"], seed=h.seed, seconds=h.seconds, trace=h.trace,
                device=h.device, backend=h.backend, traffic=h.traffic,
                make_tick=h._make_tick, root=h.root)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(rank, world, port, spec), daemon=False)
             for rank in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = _rank(h, 0, world, port)
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.terminate()
                p.join()
        stop_tracker()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"mesh ranks failed with exit codes {bad}")
    return out


def stop_tracker():
    """End multiprocessing's resource tracker, which the first spawn starts
    as a process of its own, and wait for it: otherwise it outlives the run
    until it reads the end of its pipe after this process has exited."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()


def _child(rank, world, port, spec):
    torch.set_num_threads(1)
    h = Harness(spec["workload"], spec["seed"], spec["seconds"], spec["trace"],
                time.perf_counter(), device=spec["device"], backend=spec["backend"],
                traffic=spec["traffic"], make_tick=spec["make_tick"], root=spec["root"])
    _rank(h, rank, world, port)


def _rank(h: Harness, rank: int, world: int, port: int):
    import torch.distributed as dist
    from libdwbc_tpu_torch.parallel.mesh import init_distributed

    dev = device_of(h, rank)
    open_card(h, dev, build=False)
    init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                     device="cpu" if dev.type == "cpu" else None,
                     timeout=datetime.timedelta(seconds=120))
    try:
        return _serve(h, rank, world, dev)
    finally:
        dist.destroy_process_group()


def _serve(h: Harness, rank: int, world: int, dev: torch.device):
    import torch.distributed as dist
    from libdwbc_tpu_torch.parallel.mesh import make_mesh, sharded_batch_solver

    t, cfg = h.traffic, h.config
    n_hyp, n_roll = t["mesh"]
    mesh = make_mesh(n_hyp, n_roll)
    H, R = t["grid"]
    rows, cols = mesh.block((H, R))
    hb, rb = rows.stop - rows.start, cols.stop - cols.start
    tick = h.make_tick(dev)
    rec = Recorder(tick, cfg["warm_iters"])
    step, _ = sharded_batch_solver(rec._tick_impl, mesh)
    K, gain = t["rollout_ticks"], t["nudge"]
    q0, fs0 = recipes.standing(t, tick.model.nq, tick.model.ndof)
    gen = recipes.generator(dev, h.seed * 1_000_003 + rank)
    masks = recipes.hypothesis_masks(t, np.arange(H)[rows], rb, dev)
    grid_index = torch.arange(H * R).view(H, R)[rows, cols].reshape(-1)
    failed = torch.zeros((), dtype=torch.int64, device=dev)

    def rollout(keep):
        q, qd, fs = recipes.draw_batch(t, q0, fs0, (hb, rb), gen, dev)
        warm = tick.init_warm((hb * rb,))
        for k in range(K):
            with h.span("mesh_step"):
                (res, warm), best, cost = step(q, qd, fs, masks, warm=warm, qp_iters=(
                    cfg["cold_iters"] if k == 0 else cfg["warm_iters"]))
            if keep is not None:
                keep[k] = (best, cost)
            failed.add_(res.qp_error.sum())
            q = recipes.nudge(q, res.torque_cmd, gain)

    flag = torch.zeros((), dtype=torch.int64, device=dev)
    held = []                   # warm-up as the window runs, recording included
    for _ in range(t["warmup_rollouts"]):
        sink, keep = {}, {}
        rec.arm({0, 1, 2, 3}, sink)
        rollout(keep)
        held.append((sink, keep))
    sync(dev)
    del held
    failed.zero_()
    sync(dev)
    launches0 = program.launches(tick)
    reservoir = Reservoir(t["check_rollouts"], h.seed)
    pick = np.random.default_rng([h.seed % (1 << 63), 29])
    units, n = {}, 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        if rank == 0:
            h.say(f"cards: {torch.cuda.device_count()} present, this run uses {world}")
            for r in range(world):
                h.say(f"card {r} before the window: {gpu_state(r)}")
    dist.barrier()
    setup_s = time.perf_counter() - h.t_start
    with quiet(), Tracer(h.trace, dev.type == "cuda") as tracer:
        with h.span("window"):
            t0 = time.perf_counter()
            while True:
                k = int(pick.integers(1, K - 1))
                slot = reservoir.offer(n)
                sink = {} if slot is not None else None
                rec.arm({0, 1, k, k + 1}, sink)
                keep = {} if sink is not None else None
                rollout(keep)
                if sink is not None:
                    units[slot] = (sink, keep)
                n += 1
                flag.fill_(int(time.perf_counter() - t0 >= h.seconds))
                dist.broadcast(flag, 0)
                if flag.item():
                    break
            dist.barrier()
            window = time.perf_counter() - t0
    rec.arm((), None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = {k: v - launches0.get(k, 0) for k, v in program.launches(tick).items()}
    steps = n * K
    numbers, costs = _check(h, dev, units, grid_index, gain)
    mine = dict(numbers=numbers, costs=costs, peak=peak, failed=int(failed),
                busy=tracer.summary["busy_s"] if tracer.summary else 0.0, launches=launches)
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank != 0:
        return None
    numbers = {k: max(e["numbers"][k] for e in every) for k in numbers}
    numbers.update(_best_numbers([e["costs"] for e in every]))
    if dev.type == "cuda":
        for r in range(world):
            h.say(f"card {r} after the window: {gpu_state(r)}")
    h.say(f"samples: {n} rollouts of {K} steps over a {H} x {R} grid on {world} ranks: "
          f"{steps * H * R} lane-steps in {window:.4f} s")
    h.say(f"launches in the window per rank: {[e['launches'] for e in every]} ({steps} steps)")
    plan = plan_of(cfg)
    least, bound_by = work.least_seconds(plan, {cfg["cold_iters"]: n * hb * rb,
                                                 cfg["warm_iters"]: n * (K - 1) * hb * rb})
    h.say(f"work of rank 0's served lane-steps: least {least * 1e3:.4f} ms by {bound_by} "
          f"({work.PEAKS_SOURCE})")
    record = dict(trace=tracer.summary, counters=dict(
        rollouts=n, steps=steps, ticks=steps, lane_ticks=steps * hb * rb, least_s=least,
        launches=launches))
    return finish(h, dev, e2e={"solves_per_s": steps * H * R / window}, setup_s=setup_s,
                  attempted=steps * H * R, failed=sum(e["failed"] for e in every),
                  numbers=numbers, record=record, peak=max(e["peak"] for e in every),
                  busy_s=sum(e["busy"] for e in every) / world, count=world)


def _check(h, dev, units, grid_index, gain):
    """This rank's numbers over its recorded steps, and per recorded step
    the reference's cost of each of its scenarios (by grid index) beside
    the best scenario and cost the step returned."""
    costs = {}

    def on_ref(call, out):
        tau, pres = out["torque_cmd"], out["qp_primal_res"]
        cost = tau.square().sum(-1) + 1e6 * pres
        costs[call["key"]] = (grid_index.tolist(), cost.cpu().tolist())

    with h.span("check"):
        calls = []
        for slot, (sink, keep) in units.items():
            for k, cs in sink.items():
                cs[0]["key"] = (slot, k)
                calls.append(cs[0])
        numbers = check.reference_numbers(h.config, calls, dev, check.NUMBERS, on_ref=on_ref)
        served = {}
        carry = 0
        for slot, (sink, keep) in units.items():
            served = {k: cs[0]["res"].torque_cmd for k, cs in sink.items()}
            carry += check.loop_carry(sink, served, lambda q, tau: recipes.nudge(q, tau, gain),
                                      None)
        numbers["carry"] = float(carry)
        out = {key: (idx, c, *(float(x) for x in units[key[0]][1][key[1]]))
               for key, (idx, c) in costs.items()}
    return numbers, out


def _best_numbers(every_costs: list) -> dict:
    """best_disagree: ranks whose best scenario or cost differs from rank
    0's, summed over the recorded steps; best_pick_rel: the reference cost
    of the returned best over the least reference cost of the grid, less 1;
    best_cost_rel: the returned best cost against that least cost."""
    disagree, pick, cost_rel = 0, 0.0, 0.0
    for key, (_, _, best0, cost0) in every_costs[0].items():
        ref = {}
        for rc in every_costs:
            idx, c, best, cost = rc[key]
            disagree += (best, cost) != (best0, cost0) and not (
                math.isnan(cost) and math.isnan(cost0) and best == best0)
            ref.update(zip(idx, c))
        least = min(ref.values())
        got = ref.get(int(best0), math.inf)
        pick = max(pick, (got - least) / abs(least))
        cost_rel = max(cost_rel, abs(cost0 - least) / abs(least))
    return dict(best_disagree=float(disagree), best_pick_rel=pick, best_cost_rel=cost_rel)
