"""Readings for the limits of the check, outside the benchmark's runs.

    python3 -m wbcbench.control --workload <cell> --seconds <s> --seeds <n> ... [--control]

Runs the cell once per seed in this process, each run whole (set-up, a
short window at the cell's own load, the check), and prints per seed the
numbers the check compared.  ``--control`` puts the reference in the
port's place, computed in float32 with its matrix products in TF32: the
nearest precision below the float32 with exact products that the
configurations state.  The reference's products are batches of small
matrices, for which cuBLAS picks kernels without tensor cores whatever
``allow_tf32`` says, so the control rounds each product's float32 inputs
to TF32 (10 bits of mantissa, to nearest, ties away from zero, as the
tensor cores' conversion does) and accumulates in float32.  The control
must fail the check; the port's own runs give the lower readings.  Set the
limits between the two (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


PRODUCTS = ("mm", "mmT", "mTm", "mv", "mTv")


def round_tf32(x):
    """float32 values rounded to TF32's 10-bit mantissa; other dtypes as
    they are."""
    import torch

    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).reshape(x.shape)


def tf32_reference(config: dict, device):
    """The control tick: the reference in float32 with every matrix product
    of its linear algebra taking TF32 inputs (a float64 reference, the
    check's, is untouched)."""
    import torch

    from .reference import RefTick, elemlin

    for name in PRODUCTS:
        f = getattr(elemlin, name)
        if not getattr(f, "tf32", False):
            def g(A, B, f=f):
                return f(round_tf32(A), round_tf32(B))

            g.tf32 = True
            setattr(elemlin, name, g)
    torch.backends.cuda.matmul.allow_tf32 = True
    return RefTick(config, device, torch.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--traffic", default="{}", help="JSON keys that replace the mix's own")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from wbcbench.harness import Harness

    rows = []
    for seed in args.seeds:
        h = Harness(args.workload, seed, args.seconds, False, time.perf_counter(),
                    traffic=json.loads(args.traffic),
                    make_tick=tf32_reference if args.control else None)
        h.check_devices()
        h.config = dict(h.config, limits={})
        out = h.driver.run(h)
        nums = {line.split()[1].rstrip(":"): float(line.split()[2])
                for line in h.info if line.startswith("reading ")}
        rows.append(nums)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "attempted": out["attempted"], "failed": out["failed"],
                          "numbers": nums}), flush=True)
    for n in rows[0]:
        vals = [r[n] for r in rows]
        print(f"{args.workload} {'control' if args.control else 'program'} {n}: "
              f"min {min(vals)!r} max {max(vals)!r} over {len(vals)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
