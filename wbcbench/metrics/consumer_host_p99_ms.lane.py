"""The host's share of the single lane's tail: the 99th percentile over
the traced window's ticks of the port's ``dwbc.consumer`` span less its
``dwbc.consumer.read`` (the time the host works, not waits on the card).
A port without the spans reads nothing."""

LAYER = "serving loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tick_p99_ms"


def read(record):
    if not record.get("trace"):
        return None
    try:
        from libdwbc_tpu_torch import tracing
    except ImportError:
        return None
    import numpy as np

    spans = tracing.spans()
    host = {}
    for i, s in enumerate(spans):
        if s.name == "dwbc.consumer" and s.end_ns is not None:
            host[i] = s.end_ns - s.start_ns
    for s in spans:
        if s.name == "dwbc.consumer.read" and s.parent in host and s.end_ns is not None:
            host[s.parent] -= s.end_ns - s.start_ns
    if not host:
        return None
    return 1e-6 * float(np.percentile(np.fromiter(host.values(), np.float64), 99))
