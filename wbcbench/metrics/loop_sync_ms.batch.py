"""The serving loop's host wait in its one read per warm tick: the mean
duration of the port's span ``dwbc.loop.sync`` around ``bool(trip.any())``
(the warm tick's kernels and the trip's ops finishing), over the traced
window.  A port without the span reads nothing."""

LAYER = "serving loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "solves_per_s"


def read(record):
    if not record.get("trace"):
        return None
    try:
        from libdwbc_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("dwbc.loop.sync")
    if t is None or not t.count:
        return None
    return 1e-6 * t.total_ns / t.count
