"""The check catches the faults each cell can have: the rest of a run on
the CPU, with the timed path broken underneath, comes out not correct.

* ``state``: the tick returns the warm state it was given, unchanged;
* ``half``: half of the batch left out, its lanes given the results of the
  other half;
* ``exchange``: the collective between ranks left out, each rank's own
  best taken as the grid's;
* ``answer``: one lane's τ_cmd altered by 0.5 Nm where the tick makes it.
"""

import functools

import pytest
import torch

from _rehearse import rehearse
from wbcbench.program import build_tick


class Faulty:
    """The port's tick with one fault planted in what it returns."""

    def __init__(self, tick, kind):
        self.tick, self.kind = tick, kind
        self.model, self.cfg, self.dtype = tick.model, tick.cfg, tick.dtype
        self.masked, self.device = tick.masked, tick.device

    def init_warm(self, batch=()):
        return self.tick.init_warm(batch)

    def _tick_impl(self, q, qdot, fstars, *args, warm=None, **kw):
        out = self.tick._tick_impl(q, qdot, fstars, *args, warm=warm, **kw)
        res, wout = out if warm is not None else (out, None)
        if self.kind == "state" and warm is not None:
            wout = tuple((torch.as_tensor(x).clone(), torch.as_tensor(lam).clone())
                         for x, lam in warm)
        elif self.kind == "half" and res.torque_cmd.ndim == 2:
            h = res.torque_cmd.shape[0] // 2

            def fold(t):
                t = t.clone()
                t[h:2 * h] = t[:h]
                return t

            res = type(res)(*(fold(t) for t in res))
            wout = None if wout is None else tuple((fold(x), fold(lam)) for x, lam in wout)
        elif self.kind == "answer":
            tau = res.torque_cmd.clone()
            tau[(0,) * tau.ndim] += 0.5
            res = res._replace(torque_cmd=tau)
        return (res, wout) if warm is not None else res


def faulty_tick(kind, config, device):
    if kind == "exchange":
        import torch.distributed as dist

        def own_only(out, inp, group=None, async_op=False):
            out.copy_(inp.repeat(out.numel() // inp.numel()))

        dist.all_gather_into_tensor = own_only
        return build_tick(config, device, backend="torch")
    return Faulty(build_tick(config, device, backend="torch"), kind)


CASES = [("stand.batch1024", k) for k in ("state", "half", "answer")] + [
    ("stand.lane", k) for k in ("state", "answer")] + [
    ("contact_sweep.mesh4", k) for k in ("state", "half", "exchange", "answer")]


@pytest.fixture
def own_collectives():
    """The test process's collective as it was (the exchange fault swaps it
    in each rank's process, this one included)."""
    import torch.distributed as dist

    keep = dist.all_gather_into_tensor
    yield
    dist.all_gather_into_tensor = keep


@pytest.mark.parametrize("workload, kind", CASES)
def test_fault_is_not_correct(workload, kind, own_collectives):
    h, out, line = rehearse(workload, make_tick=functools.partial(faulty_tick, kind))
    failed = [n for n, c in line["checks"].items() if not c["value"] <= c["limit"]]
    assert line["correct"] is False and failed, line["checks"]
