"""Where the real-time loop's latency tail comes from: ``native.run_rt_loop``
serving ``FusedTick(backend="cuda")`` unbatched through
``native.TickConsumer``, as ``chip_smoke.py`` phase 30 runs it, once at each
of several GIL switch intervals.

    python -m libdwbc_tpu_torch.profile_rt [--switch-us 0 100]

The producer and the consumer are ctypes callbacks on the loop's two C++
threads, and both take the GIL; a thread that waits for it may wait a whole
switch interval (the interpreter's default is 5 ms, ten producer periods).
For each interval (0: the interpreter's own) prints the states consumed,
the producer's missed deadlines and the consumer's latency (avg / min / max
/ p99 by the loop's own clock), beside the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from . import entry, native

TICKS, PERIOD_US = 10_000, 500      # chip_smoke.py phase 30's loop


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--switch-us", type=float, nargs="+", default=[0.0, 100.0],
                    help="GIL switch intervals in µs (0: the interpreter's own)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_rt: no CUDA device")
    dev = torch.device("cuda", 0)
    model, tick = entry._model_and_tick(dev)
    state_at = entry._rt_state(model, PERIOD_US)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    default = sys.getswitchinterval()

    def producer(state, t):
        state[:] = state_at(t)

    for us in args.switch_us:
        interval = us * 1e-6 if us > 0 else default
        cons = native.TickConsumer(tick)
        sys.setswitchinterval(interval)
        try:
            stats = native.run_rt_loop(PERIOD_US, TICKS, cons.state_dim, cons.out_dim,
                                       producer, cons)
        finally:
            sys.setswitchinterval(default)
        print(f"GIL switch interval {interval * 1e6:.0f} us: "
              f"{TICKS} producer ticks at {PERIOD_US} us, {stats['ticks']} consumed, "
              f"{stats['missed_deadlines']} missed producer deadlines; consumer latency avg "
              f"{stats['avg_us']:.1f} min {stats['min_us']:.1f} max {stats['max_us']:.1f} p99 "
              f"{stats['p99_us']:.1f} us; qp_error on {sum(cons.qp_error)}  [{card}]")


if __name__ == "__main__":
    main()
