"""The per-layer metrics that read the port's own spans
(``libdwbc_tpu_torch.tracing``): a traced rehearsal of each cell reports
every one of its cell's, finite and above 0 (the mesh over gloo ranks, the
harness's process rank 0); an untraced run reports none; the reference's
tick in the port's place, as the control puts it, leaves out those that
read the tick's spans; and a port without the tracing module (an older
checkout of the port) reads nothing and raises nothing."""

import json
import math

import pytest

from _rehearse import rehearse
from wbcbench.harness import ROOT, load_reader
from wbcbench.reference import RefTick

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPANNED = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
           if m["source"] == "program_span"}
# the metrics that read FusedTick's spans, which the reference's tick lacks
OF_THE_TICK = {"host_paced_ms.batch", "prelaunch_ms.lane"}


def mine(cell):
    return {n for n, cells in SPANNED.items() if cell in cells}


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_traced_run_reads_its_spans(cell):
    h, out, line = rehearse(cell, trace=True)
    assert line["correct"] is True
    want = mine(cell)
    assert want and want <= set(line["metrics"])
    for n in want:
        v = line["metrics"][n]["value"]
        assert math.isfinite(v) and v > 0, (n, v)
        assert line["metrics"][n]["unit"] == "ms"


def test_untraced_run_reads_no_span():
    h, out, line = rehearse("stand.lane")
    assert not set(SPANNED) & set(line["metrics"])


@pytest.mark.parametrize("cell", ["stand.batch1024", "stand.lane"])
def test_reference_tick_has_no_tick_spans(cell):
    h, out, line = rehearse(cell, trace=True, make_tick=RefTick)
    got = set(line["metrics"]) & set(SPANNED)
    assert got == mine(cell) - OF_THE_TICK


def test_port_without_tracing_reads_nothing(monkeypatch):
    import sys

    import libdwbc_tpu_torch

    monkeypatch.delattr(libdwbc_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "libdwbc_tpu_torch.tracing", None)
    record = dict(trace=dict(window_s=1.0, busy_s=0.5), counters=dict(ticks=1))
    for n in SPANNED:
        assert load_reader(ROOT / "wbcbench", n).read(record) is None
