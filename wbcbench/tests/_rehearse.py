"""A cell rehearsed on the CPU at a tiny size, on the port's plain path
(``backend="torch"``): the harness's look for a card is skipped, the rest
of a run is driven as on the card."""

from __future__ import annotations

import time

import torch

from wbcbench.harness import Harness, result_line

# the mixes cut to sizes a test run holds
TINY = {
    "rollout": {"batch": 6, "rollout_ticks": 5, "warmup_rollouts": 1, "check_rollouts": 2},
    "lane": {"warmup_ticks": 2, "check_pairs": 3},
    "mesh": {"grid": [4, 4], "rollout_ticks": 4, "warmup_rollouts": 1, "check_rollouts": 1},
}


def rehearse(workload: str, seed: int = 2**31 + 11, trace: bool = False, make_tick=None,
             seconds: float = 0.5, root=None, traffic=None):
    """(harness, outcome, result line) of one run on the CPU."""
    torch.set_num_threads(1)
    kw = {} if root is None else {"root": root}
    h = Harness(workload, seed, seconds, trace, time.perf_counter(), device="cpu",
                backend="torch", make_tick=make_tick, **kw)
    h.traffic.update(TINY[h.traffic["driver"]])
    h.traffic.update(traffic or {})
    out = h.driver.run(h)
    return h, out, result_line(h, out)
