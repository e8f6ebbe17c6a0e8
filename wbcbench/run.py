"""Run one cell of the benchmark once and print its result.

    python3 wbcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run loads, warms up, measures for
``--seconds`` on the card(s) the cell asks for, checks what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output (the numbers compared, beside their limits,
as the last lines of standard error).  It exits non-zero, with no result,
without the cards or the port.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    torch.set_num_threads(1)        # the run's host work is one thread's
    from wbcbench.harness import Harness, NoDevice, emit

    h = Harness(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    try:
        h.check_devices()
    except NoDevice as e:
        print(f"wbcbench: {e}", file=sys.stderr)
        return 3
    out = h.driver.run(h)
    return emit(h, out)


if __name__ == "__main__":
    sys.exit(main())
