"""Device operations (kernels, copies, fills) launched per single-lane
tick, from the profiler's trace: what a CUDA graph or fewer small ops
would lower."""

LAYER = "tick host path"
UNIT = "ops/tick"
SOURCE = "device_trace"
MOVES = "tick_p50_ms"


def read(record):
    t, c = record.get("trace"), record["counters"]
    n = sum(t["op_counts"].values()) if t else 0
    if not n or not c.get("ticks"):
        return None
    return n / c["ticks"]
