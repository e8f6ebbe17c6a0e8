"""Rank 0's host time in a mesh step: the mean duration of the port's span
``dwbc.mesh.step`` (the tick's host path, the cost, the all-gather's
enqueue and the selection) over the traced window, in the harness's
process, which is rank 0.  A port without the span reads nothing."""

LAYER = "mesh"
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
    t = tracing.totals().get("dwbc.mesh.step")
    if t is None or not t.count:
        return None
    return 1e-6 * t.total_ns / t.count
