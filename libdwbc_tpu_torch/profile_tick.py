"""Where a serving tick's time goes on the card: warm ticks of
``FusedTick``, ``CompiledTick`` or ``MaskedTick`` (``backend="cuda"``) on the
flagship, at the serving inputs of ``chip_smoke.py`` (seed 0; ``--masked``:
MaskedTick on the masked sweep's inputs, ``entry._masked_inputs``).

    python -m libdwbc_tpu_torch.profile_tick [--fused | --masked] [--batch 1024] [--ticks 5]

Prints the wall time per tick of a chain of warm ticks by CUDA events and
its solves/s; ``qp_solve``'s device time per tick by CUDA events around
each of its launches; then, under ``torch.profiler`` over one more chain,
the device's busy time (the union of the device kernels' intervals), its
share of the wall, the device kernels launched per tick, the top kernels by
device time and the share of the port's own CUDA kernels, beside the card's
name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
from collections import defaultdict

import numpy as np
import torch

from . import entry
from .ops import _build

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


def tick_split(chain, n_ticks, lib):
    """Per tick of ``chain`` (n_ticks warm ticks): ``qp_solve``'s device ms
    by CUDA events recorded around each of its launches (the library's
    launcher wrapped for one chain) and its launches; then, by
    torch.profiler over one more chain, the device's busy ms (the union of
    its kernels' intervals) and qp_solve_kernel's ms within it.  Also
    returns the profiler's device kernels."""
    launch, events = lib.dwbc_qp_solve, []

    def timed(*args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        rc = launch(*args)
        e1.record()
        events.append((e0, e1))
        return rc

    lib.dwbc_qp_solve = timed
    try:
        chain()
    finally:
        lib.dwbc_qp_solve = launch
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chain()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler saw no device kernel")
    return {"qp_events": sum(a.elapsed_time(b) for a, b in events) / n_ticks,
            "qp_launches": len(events) / n_ticks,
            "qp_prof": sum(e.time_range.end - e.time_range.start for e in kernels
                           if "qp_solve_kernel" in e.name) / 1e3 / n_ticks,
            "busy": busy_ms([(e.time_range.start, e.time_range.end) for e in kernels]) / n_ticks,
            "kernels": kernels}


def chain_ms(chain, reps=2):
    """Mean ms of ``chain`` by CUDA events, after one warm-up run."""
    chain()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        chain()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fused", action="store_true", help="FusedTick instead of CompiledTick")
    ap.add_argument("--masked", action="store_true",
                    help="MaskedTick on the masked sweep instead of CompiledTick")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: no CUDA device")
    dev = torch.device("cuda", 0)
    if args.masked:
        from .wbc.masked import MaskedTick
        from .wbc.pipeline import standard_tocabi_config

        model, _ = entry._model_and_tick(dev, fused=False)
        tick = MaskedTick(model, standard_tocabi_config(model, qp_iters=12), dev)
        mq, mqd, mfs, masks = entry._masked_inputs(model, args.batch, seed=0)
        q, qd = torch.as_tensor(mq, device=dev), torch.as_tensor(mqd, device=dev)
        extra = (tuple(torch.as_tensor(f, device=dev) for f in mfs),
                 torch.as_tensor(masks, device=dev))
    else:
        model, tick = entry._model_and_tick(dev, fused=args.fused)
        q, qd, fs = serving_inputs(model, args.batch, dev)
        extra = (fs,)
    _, warm = tick._tick_impl(q, qd, *extra, warm=tick.init_warm((args.batch,)), qp_iters=12)
    for _ in range(2):
        _, warm = tick._tick_impl(q, qd, *extra, warm=warm, qp_iters=7)
    torch.cuda.synchronize()
    w0 = warm

    def chain():
        w = w0
        for _ in range(args.ticks):
            _, w = tick._tick_impl(q, qd, *extra, warm=w, qp_iters=7)

    n = args.ticks
    wall = chain_ms(chain) / n
    split = tick_split(chain, n, _build.library())
    kernels = split["kernels"]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    dev_ms = sum(by_name.values()) / n
    own_ms = sum(v for k, v in by_name.items() if any(o in k for o in OWN_KERNELS)) / n
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    name = "FusedTick" if args.fused else "MaskedTick" if args.masked else "CompiledTick"
    print(f"{name} batch {args.batch}, {n} warm ticks (7 iterations) [{card}]")
    print(f"wall {wall:.3f} ms per tick (CUDA events, no profiler): "
          f"{args.batch / (wall / 1e3):.1f} solves/s; qp_solve {split['qp_events']:.3f} ms per "
          f"tick by CUDA events around its {split['qp_launches']:g} launches")
    print(f"under torch.profiler: device kernels {dev_ms:.3f} ms per tick, busy "
          f"{split['busy']:.3f} ms per tick (qp_solve_kernel {split['qp_prof']:.3f}, the other "
          f"kernels {split['busy'] - split['qp_prof']:.3f}), busy share of the wall "
          f"{split['busy'] / wall:.3f}, the host alone (the device idle) "
          f"{wall - split['busy']:.3f} ms per tick; {len(kernels) / n:.1f} device kernels per "
          f"tick; the port's own kernels {own_ms:.3f} ms per tick, "
          f"{own_ms / max(dev_ms, 1e-9):.3f} of device time")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v / n:9.3f} ms per tick  {k[:110]}")


if __name__ == "__main__":
    main()
