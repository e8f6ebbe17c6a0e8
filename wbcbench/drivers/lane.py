"""One robot's closed control loop through the port's single-lane entry,
``native.TickConsumer``: the harness hands it each state vector (host
numpy) as soon as the previous τ_cmd is back in its host buffer.  The
first tick is cold, the rest warm.

tick_p50_ms, tick_p99_ms: the median and 99th percentile, over every tick
of the window, of the time from the hand-over of the state to τ_cmd in the
host buffer.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, program, recipes
from ..harness import device_of, finish, gpu_state, open_card, quiet
from ..record import Recorder, Reservoir
from ..trace import Tracer
from .rollout import sync


def run(h) -> dict:
    from libdwbc_tpu_torch.native import TickConsumer

    t, cfg = h.traffic, h.config
    dev = device_of(h)
    open_card(h, dev)
    tick = h.make_tick(dev)
    rec = Recorder(tick, cfg["warm_iters"])
    m = tick.model
    phase = int(np.random.default_rng([h.seed % (1 << 63), 31]).integers(0, t["period_ticks"]))
    state_at = recipes.rt_state(t, m.nq, m.ndof, phase)
    out = np.zeros(m.model_dof, np.float32)
    warmup, held = TickConsumer(rec), []    # recording included, as in the window
    for k in range(t["warmup_ticks"]):
        if k % 2 == 0:
            held.append({})
            rec.arm({0, 1}, held[-1])
        warmup(state_at(k), out)
    del held
    sync(dev)
    consumer = TickConsumer(rec)
    launches0 = program.launches(tick)
    reservoir = Reservoir(t["check_pairs"], h.seed)
    units, served = {}, {}
    lat = np.zeros(int(h.seconds * 20_000) + 1024, np.int64)   # ns; ≥ 50 µs a tick
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        h.say(f"card before the window ({torch.cuda.device_count()} present, this run uses "
              f"1): {gpu_state(dev.index)}")
    setup_s = time.perf_counter() - h.t_start
    limit_ns = int(h.seconds * 1e9)
    with quiet(), Tracer(h.trace, dev.type == "cuda") as tracer:
        with h.span("window"):
            t0 = time.perf_counter_ns()
            k, sink = 0, None
            while True:
                if k % 2 == 0:
                    slot = reservoir.offer(k // 2)
                    sink = {} if slot is not None else None
                    rec.arm({0, 1}, sink)
                    if sink is not None:
                        units[slot] = (k, sink)
                state = state_at(k)
                with h.span("consumer"):
                    a = time.perf_counter_ns()
                    consumer(state, out)
                    b = time.perf_counter_ns()
                lat[k] = b - a
                if sink is not None:
                    served[k] = out.copy()
                k += 1
                if k % 2 == 0 and b - t0 >= limit_ns:
                    break
            window = (time.perf_counter_ns() - t0) * 1e-9
    rec.arm((), None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        h.say(f"card after the window: {gpu_state(dev.index)}")
    launches = {n: v - launches0.get(n, 0) for n, v in program.launches(tick).items()}
    lat_ms = lat[:k].astype(np.float64) * 1e-6
    p50, p99 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))
    h.say(f"samples: {k} ticks in {window:.4f} s, {int((lat_ms > p99).sum())} beyond the 99th "
          f"percentile; max {lat_ms.max():.4f} ms, mean {lat_ms.mean():.4f} ms")
    h.say(f"launches in the window: {launches} ({k} ticks; TickKernels.launches, 2 a tick)")
    failed = int(sum(consumer.qp_error))
    with h.span("check"):
        ticks = {base + j: calls for base, sink in units.values() for j, calls in sink.items()}
        calls = [c for cs in ticks.values() for c in cs]
        numbers = check.reference_numbers(cfg, calls, dev, check.NUMBERS)
        numbers["carry"] = float(check.lane_carry(ticks, served))
    h.say(f"check: {len(calls)} recorded ticks")
    record = dict(trace=tracer.summary, counters=dict(ticks=k, launches=launches))
    return finish(h, dev, e2e={"tick_p50_ms": p50, "tick_p99_ms": p99}, setup_s=setup_s,
                  attempted=k, failed=failed, numbers=numbers, record=record, peak=peak)
