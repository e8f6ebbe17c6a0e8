"""The single lane's host wait on its tick's two device reads (τ_cmd to
host memory, ``qp_error``): the mean duration of the port's span
``dwbc.consumer.read`` over the traced window.  A port without the span
reads nothing."""

LAYER = "serving loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tick_p50_ms"


def read(record):
    if not record.get("trace"):
        return None
    try:
        from libdwbc_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("dwbc.consumer.read")
    if t is None or not t.count:
        return None
    return 1e-6 * t.total_ns / t.count
