"""The least time the card could take for the window's served lane-ticks
(the frozen work counts of ``wbcbench/work.py`` over the published peaks)
as a share of the device kernel time of the window, summed over every
kernel whatever its name.  Re-solves add kernel time and no counted work."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "solves_per_s"


def read(record):
    t, c = record.get("trace"), record["counters"]
    if not t or not t["kernel_s"] or not c.get("least_s"):
        return None
    return 100.0 * c["least_s"] / t["kernel_s"]
