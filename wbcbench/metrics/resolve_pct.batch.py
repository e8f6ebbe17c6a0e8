"""Warm ticks that the serving loop re-solved at the full budget, as a
share of the warm ticks (``LoopResult.refined_ticks``, the port's count)."""

LAYER = "serving loop"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "solves_per_s"


def read(record):
    c = record["counters"]
    if not c.get("warm_ticks"):
        return None
    return 100.0 * c["refined_ticks"] / c["warm_ticks"]
