"""The host-paced stretch between warm ticks: per warm tick, from the end
of the loop's read (``dwbc.loop.sync``) to the start of the next tick's
launch (its first ``dwbc.tick.run``) in the same loop call, the mean over
the traced window.  The card runs only the transition's and the tick
preparation's small ops then.  The last warm tick of a loop call, whose
stretch ends outside the loop, is not counted; a port or a tick without
the spans reads nothing."""

LAYER = "tick host path"
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
    sync_end, run_start = {}, {}
    for s in tracing.spans():
        if s.end_ns is None or s.request is None:
            continue
        if s.name == "dwbc.loop.sync":
            sync_end[s.request] = s.end_ns
        elif s.name == "dwbc.tick.run":
            run_start.setdefault(s.request, s.start_ns)
    stretch = [run_start[(seq, k + 1)] - end for (seq, k), end in sync_end.items()
               if (seq, k + 1) in run_start]
    if not stretch:
        return None
    return 1e-6 * sum(stretch) / len(stretch)
