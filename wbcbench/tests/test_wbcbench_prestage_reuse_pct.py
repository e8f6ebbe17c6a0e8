"""The reader of ``prestage_reuse_pct.batch`` on synthetic totals: 100 ×
the port's ``dwbc.tick.prestage_reused`` over the window's
``dwbc.loop.resolve`` spans, 0 where no re-solve took its prestage, and
nothing where the run is untraced, no re-solve ran, or the port has no
such counter."""

import pytest

from libdwbc_tpu_torch import tracing
from wbcbench.harness import ROOT, load_reader

TRACED = dict(trace=dict(window_s=1.0, busy_s=0.5),
              counters=dict(ticks=10, warm_ticks=8, lane_ticks=40))


def reader():
    return load_reader(ROOT / "wbcbench", "prestage_reuse_pct.batch")


def totals(counts):
    return lambda: {k: tracing.Total(n, 7 if k == "dwbc.loop.resolve" else 0, 0)
                    for k, n in counts.items()}


@pytest.mark.parametrize("counts,want", [
    ({"dwbc.loop.resolve": 8, "dwbc.tick.prestage_reused": 8}, 100.0),
    ({"dwbc.loop.resolve": 8, "dwbc.tick.prestage_reused": 6}, 75.0),
    ({"dwbc.loop.resolve": 8}, 0.0),
])
def test_reads_reuses_over_resolves(monkeypatch, counts, want):
    monkeypatch.setattr(tracing, "totals", totals(counts))
    assert reader().read(TRACED) == want


def test_reads_nothing_untraced_without_resolves_or_without_the_counter(monkeypatch):
    monkeypatch.setattr(tracing, "totals", totals({"dwbc.loop.resolve": 4,
                                                   "dwbc.tick.prestage_reused": 4}))
    assert reader().read(dict(TRACED, trace=None)) is None
    monkeypatch.setattr(tracing, "NAMES", tuple(n for n in tracing.NAMES
                                                if n != "dwbc.tick.prestage_reused"))
    assert reader().read(TRACED) is None
    monkeypatch.undo()
    monkeypatch.setattr(tracing, "totals", totals({"dwbc.tick.prestage_reused": 3}))
    assert reader().read(TRACED) is None
