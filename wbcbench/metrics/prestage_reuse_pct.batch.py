"""The loop's full-budget re-solves that took their warm tick's prestage
and ran the QP chain alone: 100 × the port's counter
``dwbc.tick.prestage_reused`` over the ``dwbc.loop.resolve`` spans of the
traced window.  A window without a re-solve, or a port without the
counter, reads nothing."""

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
    if "dwbc.tick.prestage_reused" not in getattr(tracing, "NAMES", ()):
        return None
    totals = tracing.totals()
    resolves = totals.get("dwbc.loop.resolve")
    if resolves is None or not resolves.count:
        return None
    reused = totals.get("dwbc.tick.prestage_reused")
    return 100.0 * (reused.count if reused is not None else 0) / resolves.count
