"""Lanes that the serving loop took from a full-budget re-solve, as a share
of the warm lane-ticks: 100 × the port's counter ``dwbc.loop.resolve_lanes``
over the traced window's warm ticks times the batch.  A whole-batch re-solve
that serves a few lanes reads high in ``resolve_pct.batch`` and low here.
A port without the counter reads nothing."""

LAYER = "serving loop"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "solves_per_s"


def read(record):
    if not record.get("trace"):
        return None
    c = record["counters"]
    if not c.get("warm_ticks") or not c.get("ticks"):
        return None
    try:
        from libdwbc_tpu_torch import tracing
    except ImportError:
        return None
    if "dwbc.loop.resolve_lanes" not in getattr(tracing, "NAMES", ()):
        return None
    t = tracing.totals().get("dwbc.loop.resolve_lanes")
    lanes = t.count if t is not None else 0
    return 100.0 * lanes / (c["warm_ticks"] * c["lane_ticks"] / c["ticks"])
