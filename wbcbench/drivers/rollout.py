"""Closed-loop rollouts through the port's control loop
(``wbc/loop.py::make_control_loop``) at a fixed batch: the rollouts cycle
through a fixed pool of draws in an order drawn from the seed, tick 0 cold at the configuration's budget, the rest
warm, the fallback re-solve armed, and between ticks every lane's joints
moved by its own τ_cmd (``recipes.nudge``).

solves_per_s: the window's lane-ticks over its whole time; the window is
whole rollouts and ends when the rollout running at the deadline ends.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, program, recipes, work
from ..harness import device_of, finish, gpu_state, open_card, quiet
from ..record import Recorder, Reservoir
from ..reference import plan_of
from ..trace import Tracer


def run(h) -> dict:
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    t, cfg = h.traffic, h.config
    dev = device_of(h)
    open_card(h, dev)
    tick = h.make_tick(dev)
    rec = Recorder(tick, cfg["warm_iters"])
    B, K, gain = t["batch"], t["rollout_ticks"], t["nudge"]

    def transition(q, qd, res, dt):
        return recipes.nudge(q, res.torque_cmd, gain), qd

    loop = make_control_loop(rec, transition, K=K, warm_start=True,
                             warm_iters=cfg["warm_iters"], gap_fallback=t["gap_fallback"])
    q0, fs0 = recipes.standing(t, tick.model.nq, tick.model.ndof)
    # a fixed pool of rollout draws, served in an order drawn from the seed:
    # how often the fallback fires depends on the draw, so every seed gets
    # the same work in another order
    gen = recipes.generator(dev, t["pool_seed"])
    pool = [recipes.draw_batch(t, q0, fs0, (B,), gen, dev) for _ in range(t["pool"])]
    order = np.random.default_rng([h.seed % (1 << 63), 37]).permutation(t["pool"])

    def draw(n):
        return pool[order[n % len(order)]]

    # warm-up: the window's own work, recording and counting included, with
    # as many recorded rollouts held as the window holds (so that the cache
    # allocator has grown and every kernel is loaded before the window)
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    held = []
    for n in range(t["warmup_rollouts"]):
        sink = {}
        rec.arm({0, 1, 2, 3}, sink)
        out = loop(*draw(n))
        failed += out.qp_error.sum()
        held.append((sink, out.torques))
    sync(dev)
    del held, out
    failed.zero_()
    launches0 = program.launches(tick)
    reservoir = Reservoir(t["check_rollouts"], h.seed)
    pick = np.random.default_rng([h.seed % (1 << 63), 29])
    units, n, refined = {}, 0, 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        h.say(f"card before the window ({torch.cuda.device_count()} present, this run uses "
              f"1): {gpu_state(dev.index)}")
    setup_s = time.perf_counter() - h.t_start
    with quiet(), Tracer(h.trace, dev.type == "cuda") as tracer:
        with h.span("window"):
            t0 = time.perf_counter()
            ends = []
            while True:
                k = int(pick.integers(1, K - 1))
                slot = reservoir.offer(n)
                sink = {} if slot is not None else None
                rec.arm({0, 1, k, k + 1}, sink)
                with h.span("traffic"):
                    q, qd, fs = draw(n)
                with h.span("loop"):
                    out = loop(q, qd, fs)
                failed += out.qp_error.sum()
                refined += out.refined_ticks
                if sink is not None:
                    units[slot] = (sink, out.torques)
                n += 1
                ends.append(time.perf_counter())
                if ends[-1] - t0 >= h.seconds:
                    sync(dev)
                    break
            window = time.perf_counter() - t0
    rec.arm((), None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        h.say(f"card after the window: {gpu_state(dev.index)}")
    launches = {k: v - launches0.get(k, 0) for k, v in program.launches(tick).items()}
    ticks, warm_ticks = n * K, n * (K - 1)
    h.say(f"samples: {n} rollouts of {K} ticks at batch {B}: {ticks * B} lane-ticks in "
          f"{window:.4f} s; {refined} of {warm_ticks} warm ticks re-solved")
    per = np.diff([t0] + ends) * 1e3
    h.say(f"rollout ms (host, as each loop returned): min {per.min():.3f} median "
          f"{np.median(per):.3f} max {per.max():.3f}")
    h.say(f"launches in the window: {launches} ({ticks} ticks)")
    plan = plan_of(cfg)
    least, bound_by = work.least_seconds(plan, {cfg["cold_iters"]: n * B,
                                                 cfg["warm_iters"]: warm_ticks * B})
    h.say(f"work of the window's served lane-ticks: least {least * 1e3:.4f} ms by {bound_by} "
          f"({work.PEAKS_SOURCE})")
    del loop, out
    numbers = check_rollouts(h, dev, units, gain)
    record = dict(trace=tracer.summary, counters=dict(
        rollouts=n, ticks=ticks, warm_ticks=warm_ticks, refined_ticks=refined,
        lane_ticks=ticks * B, least_s=least, launches=launches))
    return finish(h, dev, e2e={"solves_per_s": ticks * B / window}, setup_s=setup_s,
                  attempted=ticks * B, failed=int(failed), numbers=numbers, record=record,
                  peak=peak)


def check_rollouts(h, dev, units: dict, gain: float) -> dict:
    """The check over the recorded rollouts: every recorded call against the
    reference, and the loop's carry, selection and transition bit for bit."""
    with h.span("check"):
        calls = [c for sink, _ in units.values() for cs in sink.values() for c in cs]
        numbers = check.reference_numbers(h.config, calls, dev, check.NUMBERS)
        numbers["carry"] = float(sum(
            check.loop_carry(sink, served, lambda q, tau: recipes.nudge(q, tau, gain),
                             h.traffic["gap_fallback"]) for sink, served in units.values()))
    h.say(f"check: {len(calls)} recorded calls of {len(units)} rollouts")
    return numbers


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
