"""The reader of ``resolve_lane_pct.batch`` on synthetic counters: 100 ×
the port's ``dwbc.loop.resolve_lanes`` over the window's warm lane-ticks,
0 where no lane was re-solved, and nothing where the run is untraced or
the port has no such counter."""

import pytest

from libdwbc_tpu_torch import tracing
from wbcbench.harness import ROOT, load_reader

# 2 rollouts of 5 ticks at batch 4: 8 warm ticks, 32 warm lane-ticks
TRACED = dict(trace=dict(window_s=1.0, busy_s=0.5),
              counters=dict(ticks=10, warm_ticks=8, lane_ticks=40))


def reader():
    return load_reader(ROOT / "wbcbench", "resolve_lane_pct.batch")


@pytest.mark.parametrize("counts,want", [
    ({"dwbc.loop.resolve_lanes": 4}, 12.5),
    ({"dwbc.loop.resolve_lanes": 32}, 100.0),
    ({}, 0.0),
])
def test_reads_resolved_lanes_over_warm_lane_ticks(monkeypatch, counts, want):
    monkeypatch.setattr(tracing, "totals",
                        lambda: {k: tracing.Total(n, 0, 0) for k, n in counts.items()})
    assert reader().read(TRACED) == want


def test_reads_nothing_untraced_or_without_the_counter(monkeypatch):
    monkeypatch.setattr(tracing, "totals",
                        lambda: {"dwbc.loop.resolve_lanes": tracing.Total(4, 0, 0)})
    assert reader().read(dict(TRACED, trace=None)) is None
    assert reader().read(dict(TRACED, counters=dict(ticks=0, warm_ticks=0, lane_ticks=0))) is None
    monkeypatch.setattr(tracing, "NAMES", tuple(n for n in tracing.NAMES
                                                if n != "dwbc.loop.resolve_lanes"))
    assert reader().read(TRACED) is None


def test_counter_sums_while_recording_only():
    """The port's store: ``count`` adds while an operator's session records
    and is one check otherwise; ``totals`` carries the sum as a count."""
    tracing.start()
    tracing.count("dwbc.loop.resolve_lanes", 3)
    tracing.count("dwbc.loop.resolve_lanes", 2)
    tracing.stop()
    tracing.count("dwbc.loop.resolve_lanes", 7)
    assert tracing.totals() == {"dwbc.loop.resolve_lanes": tracing.Total(5, 0, 0)}
    tracing.start()
    tracing.stop()
    assert tracing.totals() == {}
