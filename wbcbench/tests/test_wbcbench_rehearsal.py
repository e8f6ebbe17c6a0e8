"""Every cell of BENCHMARK.json rehearsed on the CPU at a tiny size: the
run's whole path (set-up, window, check, the result line), on the port's
plain tick; and nothing of JAX or the JAX package loaded after it."""

import json
import os
from multiprocessing import resource_tracker
from pathlib import Path

import pytest

from _rehearse import rehearse
from wbcbench.harness import ROOT, forbidden_modules

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearsal(workload):
    h, out, line = rehearse(workload)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in h.end_to_end()}
    assert set(line["metrics"]) == names and "setup_s" in names
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks" and line["checks"]
    assert set(line["checks"]) == set(h.config["limits"])
    json.dumps(line, allow_nan=False)
    assert forbidden_modules() == []


@pytest.mark.parametrize("workload", ["stand.batch1024", "stand.lane"])
def test_traced_rehearsal(workload):
    """A traced run reads the counters' metrics; on the CPU the device
    readers find nothing to read and leave their metrics out."""
    h, out, line = rehearse(workload, trace=True)
    assert line["correct"] is True
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    device_metrics = {m["name"] for m in h.per_layer() if m["source"] == "device_trace"}
    assert not device_metrics & set(line["metrics"])
    if workload == "stand.batch1024":
        assert line["metrics"]["resolve_pct.batch"]["value"] >= 0


def _children(pid: int) -> list:
    """The command lines of the live processes whose parent is ``pid``."""
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            cmd = (stat.parent / "cmdline").read_bytes()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(cmd.replace(b"\0", b" ").decode(errors="replace"))
    return out


def test_mesh_run_leaves_no_process():
    """The mesh's ranks and multiprocessing's resource tracker have ended,
    and been waited for, by the time the run hands back its outcome."""
    h, out, line = rehearse("contact_sweep.mesh4")
    assert line["correct"] is True
    assert resource_tracker._resource_tracker._pid is None
    assert _children(os.getpid()) == []
