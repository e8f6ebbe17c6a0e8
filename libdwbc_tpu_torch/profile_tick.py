"""Where a serving tick's time goes on the card: ``torch.profiler`` over warm
ticks of ``FusedTick`` or ``CompiledTick`` (``backend="cuda"``) on the
flagship, at the serving inputs of ``chip_smoke.py`` (seed 0).

    python -m libdwbc_tpu_torch.profile_tick [--fused] [--batch 1024] [--ticks 5]

Prints the wall time per tick, the device's busy time (the union of the
device kernels' intervals) and its share of the wall, the device kernels
launched per tick, the top kernels by device time and the share of the
port's own CUDA kernels, beside the card's name and power limit.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from . import entry

OWN_KERNELS = ("tick_prestage_kernel", "tick_qpchain_kernel", "psd_inverse_kernel",
               "qp_solve_kernel")


def serving_inputs(model, batch, device):
    """chip_smoke.py's serving batch: the standing q with joints +
    0.02·N(0,1), f* + 0.05·N(0,1), seed 0, float32."""
    q, _, fstars = entry._example_inputs(model)
    rng = np.random.default_rng(0)
    qs = np.tile(q, (batch, 1)).astype(np.float32)
    qs[:, 6:39] += 0.02 * rng.standard_normal((batch, 33)).astype(np.float32)
    fs = [np.tile(f, (batch, 1)).astype(np.float32)
          + 0.05 * rng.standard_normal((batch, f.shape[0])).astype(np.float32) for f in fstars]
    return (torch.as_tensor(qs, device=device), torch.zeros((batch, model.ndof), device=device),
            tuple(torch.as_tensor(f, device=device) for f in fs))


def busy_ms(intervals):
    """Length of the union of (start, end) intervals in µs, as ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fused", action="store_true", help="FusedTick instead of CompiledTick")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: no CUDA device")
    dev = torch.device("cuda", 0)
    model, tick = entry._model_and_tick(dev, fused=args.fused)
    q, qd, fs = serving_inputs(model, args.batch, dev)
    _, warm = tick._tick_impl(q, qd, fs, warm=tick.init_warm((args.batch,)), qp_iters=12)
    for _ in range(2):
        _, warm = tick._tick_impl(q, qd, fs, warm=warm, qp_iters=7)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            _, warm = tick._tick_impl(q, qd, fs, warm=warm, qp_iters=7)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    dev_ms = sum(by_name.values())
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    own_ms = sum(v for k, v in by_name.items() if any(o in k for o in OWN_KERNELS))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    name = "FusedTick" if args.fused else "CompiledTick"
    n = args.ticks
    print(f"{name} batch {args.batch}, {n} warm ticks (7 iterations) under torch.profiler "
          f"[{card}]")
    print(f"wall {wall_ms / n:.3f} ms per tick; device kernels {dev_ms / n:.3f} ms per tick, "
          f"busy {busy / n:.3f} ms per tick, busy share {busy / wall_ms:.3f}; "
          f"{len(kernels) / n:.1f} device kernels per tick; the port's own kernels "
          f"{own_ms / n:.3f} ms per tick, {own_ms / max(dev_ms, 1e-9):.3f} of device time")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v / n:9.3f} ms per tick  {k[:110]}")


if __name__ == "__main__":
    main()
