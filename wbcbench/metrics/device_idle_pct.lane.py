"""The share of the single-lane cell's traced window in which no operation
ran on the card: 1 − busy ÷ wall."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tick_p50_ms"


def read(record):
    t = record.get("trace")
    if not t or not t["busy_s"] or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
