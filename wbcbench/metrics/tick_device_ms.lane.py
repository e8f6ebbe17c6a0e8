"""Device busy time per single-lane tick: the union of the kernels' and
copies' intervals over the window, per tick."""

LAYER = "kernels"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "tick_p50_ms"


def read(record):
    t, c = record.get("trace"), record["counters"]
    if not t or not t["busy_s"] or not c.get("ticks"):
        return None
    return 1e3 * t["busy_s"] / c["ticks"]
