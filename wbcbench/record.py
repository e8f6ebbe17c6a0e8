"""What the timed path produced, kept for the check after the window.

``Recorder`` stands where the serving layer calls the tick: it passes every
call through and, for the calls the run armed, keeps references to the
call's inputs and outputs (no copy, no host read).  Which calls are armed is
drawn from the seed: a reservoir of units (rollouts, or pairs of
consecutive ticks) uniform over the window, and within a unit a seeded set
of tick indices.
"""

from __future__ import annotations

import numpy as np


class Reservoir:
    """Reservoir sampling of ``size`` units over a stream of unknown length:
    ``offer(n)`` says whether unit n (0, 1, …) is kept, and which slot it
    replaces."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 17])

    def offer(self, n: int) -> int | None:
        if n < self.size:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.size else None


class Recorder:
    """A tick that keeps the armed calls of its wrapped tick.

    The serving layer numbers ticks by itself; the recorder follows it: the
    first call after ``arm`` is tick 0, each call at ``warm_iters`` starts the
    next tick, and a call at another budget after tick 0 is that tick's
    re-solve (``make_control_loop``'s fallback)."""

    def __init__(self, tick, warm_iters: int):
        self.tick = tick
        self.warm_iters = warm_iters
        self.model, self.cfg, self.dtype = tick.model, tick.cfg, tick.dtype
        self.masked = getattr(tick, "masked", False)
        self._ticks = None
        self._k = -1
        self._sink = None

    @property
    def device(self):
        return self.tick.device

    def init_warm(self, batch=()):
        return self.tick.init_warm(batch)

    def arm(self, ticks, sink: dict | None):
        """Start a unit: keep the calls of tick indices ``ticks`` in
        ``sink[k]`` (a list per tick: the tick's call, then its re-solve);
        sink None keeps nothing."""
        self._ticks, self._sink, self._k = set(ticks), sink, -1

    def _tick_impl(self, q, qdot, fstars, *args, warm=None, qp_iters=None, **kw):
        if qp_iters == self.warm_iters or self._k < 0:
            self._k += 1
        out = self.tick._tick_impl(q, qdot, fstars, *args, warm=warm, qp_iters=qp_iters, **kw)
        if self._sink is not None and self._k in self._ticks:
            res, wout = out if warm is not None else (out, None)
            self._sink.setdefault(self._k, []).append(dict(
                q=q, fstars=tuple(fstars), mask=args[0] if args else None, warm_in=warm,
                iters=self.tick.cfg.qp_iters if qp_iters is None else qp_iters,
                res=res, warm_out=wout))
        return out
