"""Rank 0's device time of the NCCL kernels per mesh step (the best
scenario's all-gather), from the profiler's trace."""

LAYER = "mesh"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "solves_per_s"


def read(record):
    t, c = record.get("trace"), record["counters"]
    if not t or not t["nccl_s"] or not c.get("steps"):
        return None
    return 1e3 * t["nccl_s"] / c["steps"]
