"""Where the scenario mesh step's host time goes on one NCCL rank: the
flagship's ``FusedTick(backend="cuda")`` on ``chip_smoke.py`` phase 29's
32 × 32 grid (``entry._grid_inputs``, seed 0), warm at 7 iterations.

    python -m libdwbc_tpu_torch.profile_mesh [--rounds 5]

Times, in rounds that alternate their order, the ms per call of: the
unsharded warm tick on the flat batch; the mesh step
(``sharded_batch_solver``); the best-scenario reduction alone
(``_global_argmin``); one 16-byte ``all_gather_into_tensor`` over the
process group; and the same over the DeviceMesh's 'roll' group, then its
'hyp' group (two collectives).  Each by the host clock over 30 calls,
synced before and after; prints each one's median over the rounds beside
the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from . import entry
from .parallel.mesh import (_global_argmin, free_port, init_distributed, make_mesh,
                            shard_scenarios, sharded_batch_solver)

GRID, WARM_ITERS, CALLS = 32, 7, 30


def ms_per_call(fn):
    """Host ms per call of fn over CALLS calls, synced before and after."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / CALLS * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_mesh: no CUDA device")
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = make_mesh()
        dev, nb = mesh.device, GRID * GRID
        model, tick = entry._model_and_tick(dev)
        q, qd, fs = entry._grid_inputs(model, GRID, GRID)
        step, _ = sharded_batch_solver(tick._tick_impl, mesh)
        blk = shard_scenarios(mesh, q, qd, fs)
        flat = tuple(torch.as_tensor(a.reshape(nb, -1), device=dev) for a in (q, qd))
        flat_fs = tuple(torch.as_tensor(f.reshape(nb, -1), device=dev) for f in fs)
        _, warm = tick._tick_impl(*flat, flat_fs, warm=tick.init_warm((nb,)))
        cost = torch.rand(nb, device=dev)
        index = torch.arange(nb, dtype=torch.float64, device=dev)
        cand = torch.zeros(2, dtype=torch.float64, device=dev)
        out = cand.new_empty(2 * dist.get_world_size())

        def gather_axes():
            for _, group, pos in mesh.axis_groups:
                dist.all_gather_into_tensor(cand.new_empty(2 * len(pos)), cand, group=group)

        cases = {
            "unsharded warm tick": lambda: tick._tick_impl(*flat, flat_fs, warm=warm,
                                                           qp_iters=WARM_ITERS),
            "mesh step": lambda: step(*blk, warm=warm, qp_iters=WARM_ITERS),
            "_global_argmin alone": lambda: _global_argmin(mesh, cost, index),
            "all-gather over the process group": lambda: dist.all_gather_into_tensor(out, cand),
            "all-gathers over the 'roll' then the 'hyp' group": gather_axes,
        }
        names = list(cases)
        times = {k: [] for k in names}
        for r in range(args.rounds):
            for k in names if r % 2 == 0 else names[::-1]:
                times[k].append(ms_per_call(cases[k]))
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        print(f"one {dist.get_backend()} rank, mesh {mesh.shape}, the flagship's {GRID}x{GRID} "
              f"grid, warm at {WARM_ITERS} iterations, {args.rounds} rounds of {CALLS} calls  "
              f"[{card}]")
        for k in names:
            med = float(np.median(times[k]))
            rate = f", {nb / med * 1e3:.1f} solves/s" if k in names[:2] else ""
            print(f"{k}: median {med:.4f} ms per call{rate} (rounds "
                  f"{', '.join(f'{x:.4f}' for x in times[k])})")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
