"""The control on the card: the reference put in the port's place with its
products in TF32 fails the check, at a size a test run holds, where the
port's kernels at the same size pass it.  Marked ``gpu``: skips without a
CUDA device.  The control at the cells' own sizes is ``python3 -m
wbcbench.control --control`` (PERF.md gives its readings)."""

import time

import pytest
import torch

from wbcbench.control import tf32_reference
from wbcbench.harness import Harness, result_line

pytestmark = pytest.mark.gpu

SMALL = {
    "stand.batch1024": {"batch": 64, "rollout_ticks": 8, "warmup_rollouts": 1},
    "stand.lane": {"warmup_ticks": 2, "check_pairs": 4},
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def run(workload, make_tick):
    h = Harness(workload, 2**31 + 3, 1.0, False, time.perf_counter(), make_tick=make_tick)
    h.check_devices()
    h.traffic.update(SMALL[workload])
    return result_line(h, h.driver.run(h))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_and_port_passes(card, workload):
    assert run(workload, tf32_reference)["correct"] is False
    assert run(workload, None)["correct"] is True
