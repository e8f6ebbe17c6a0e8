"""The readers of ``graph_tick_pct.lane`` and ``graph_tick_pct.batch`` on
synthetic span lists: 100 × the ``dwbc.tick.replay`` spans over the
``dwbc.tick.run`` spans, and nothing where the run is untraced, the port
has no replay span (a port without graphs) or no tick ran."""

import pytest

from libdwbc_tpu_torch import tracing
from wbcbench.harness import ROOT, load_reader

READERS = ["graph_tick_pct.lane", "graph_tick_pct.batch"]
TRACED = dict(trace=dict(window_s=1.0, busy_s=0.5), counters=dict(ticks=4))


def spans(*names):
    return [tracing.Span(n, 10 * i, 10 * i + 5, -1, (0, i)) for i, n in enumerate(names)]


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("names,want", [
    (["dwbc.tick.run", "dwbc.tick.replay"] * 4, 100.0),
    (["dwbc.tick.run", "dwbc.tick.capture"] + ["dwbc.tick.run", "dwbc.tick.replay"] * 3,
     75.0),
    (["dwbc.tick.prep", "dwbc.tick.run", "dwbc.tick.post"] * 2, 0.0),
])
def test_reads_replays_over_runs(monkeypatch, name, names, want):
    monkeypatch.setattr(tracing, "spans", lambda: spans(*names))
    assert load_reader(ROOT / "wbcbench", name).read(TRACED) == want


@pytest.mark.parametrize("name", READERS)
def test_reads_nothing_without_replays_or_runs(monkeypatch, name):
    reader = load_reader(ROOT / "wbcbench", name)
    monkeypatch.setattr(tracing, "spans", lambda: spans("dwbc.tick.run", "dwbc.tick.replay"))
    assert reader.read(dict(TRACED, trace=None)) is None
    monkeypatch.setattr(tracing, "spans", lambda: spans("dwbc.consumer"))
    assert reader.read(TRACED) is None
    monkeypatch.setattr(tracing, "spans", lambda: spans("dwbc.tick.run", "dwbc.tick.replay"))
    monkeypatch.setattr(tracing, "NAMES", tuple(n for n in tracing.NAMES
                                                if n != "dwbc.tick.replay"))
    assert reader.read(TRACED) is None
