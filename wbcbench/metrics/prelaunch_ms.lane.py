"""The single lane's host time before its launch: per tick, from the start
of the port's ``dwbc.consumer`` span to the start of that tick's
``dwbc.tick.run`` (nothing of the tick is queued on the card yet), the mean
over the traced window.  A port or a tick without the spans reads
nothing."""

LAYER = "tick host path"
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
    start, run = {}, {}
    for s in tracing.spans():
        if s.name == "dwbc.consumer":
            start[s.request] = s.start_ns
        elif s.name == "dwbc.tick.run":
            run.setdefault(s.request, s.start_ns)
    pre = [run[r] - t for r, t in start.items() if r in run]
    if not pre:
        return None
    return 1e-6 * sum(pre) / len(pre)
