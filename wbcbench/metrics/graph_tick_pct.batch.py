"""The batched ticks served by a captured CUDA graph (the rollouts' loop;
the mesh: rank 0's, the harness's process): 100 × the port's
``dwbc.tick.replay`` spans over its ``dwbc.tick.run`` spans in the traced
window (100: no capture and no eager tick inside it).  A port without the
replay span (no graphs) or without the tick's spans reads nothing."""

LAYER = "tick host path"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "solves_per_s"


def read(record):
    if not record.get("trace"):
        return None
    try:
        from libdwbc_tpu_torch import tracing
    except ImportError:
        return None
    if "dwbc.tick.replay" not in getattr(tracing, "NAMES", ()):
        return None
    names = [s.name for s in tracing.spans()]
    runs = names.count("dwbc.tick.run")
    if not runs:
        return None
    return 100.0 * names.count("dwbc.tick.replay") / runs
