"""One run of one cell: look the cell up by name, build what its files
name, hand it to the traffic's driver, and print the result.

Everything about a cell lives in data: ``BENCHMARK.json`` names its
configuration (a file under ``configs/``) and its traffic mix
(``traffic/<name>.json``), whose ``driver`` names a module under
``drivers/``; each per-layer metric is a reader ``metrics/<name>.py``.
Adding a cell, a configuration, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from . import program
from .trace import span

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that must not be loaded in the printing process:
# JAX and the JAX package (the port's name begins with it: compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "libdwbc_tpu")


class NoDevice(RuntimeError):
    """The cell's cards are not there: the run prints no result."""


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Harness:
    """The run's cell, its files and its options.

    device / backend: the card and the port's kernels for a benchmark run;
    a test passes ("cpu", "torch") to rehearse a cell on the port's plain
    path.  traffic: keys that replace the mix's own (a rehearsal's small
    sizes).  make_tick: builds the tick under test from the configuration
    (default: the port's); the control passes the reference's."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 t_start: float, device=None, backend: str = "cuda", traffic=None,
                 make_tick=None, root: Path = ROOT):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        cells = {c["name"]: c for c in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        entry = next(c for c in self.bench["configs"] if c["name"] == self.cell["config"])
        self.config = load_json(root / entry["file"])
        self.home = root / "wbcbench"
        self.traffic = load_json(self.home / "traffic" / f"{self.cell['traffic']}.json")
        self.traffic.update(traffic or {})
        self.driver = importlib.import_module(f"wbcbench.drivers.{self.traffic['driver']}")
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.t_start = t_start
        self.device, self.backend = device, backend
        self._make_tick = make_tick
        self.chips = int(self.cell["chips"])
        self.info = []              # lines printed before the result

    def check_devices(self):
        if self.device is not None:
            return
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < self.chips:
            raise NoDevice(f"the cell needs {self.chips} CUDA devices, "
                           f"{torch.cuda.device_count()} present")

    def make_tick(self, device):
        if self._make_tick is not None:
            return self._make_tick(self.config, device)
        return program.build_tick(self.config, device, self.backend)

    def span(self, name):
        return span(name, self.trace)

    def say(self, line: str):
        self.info.append(line)

    # ------------------------------------------------------------ metrics
    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.cell["name"] in m.get("workloads", [self.cell["name"]])]

    def per_layer(self) -> list:
        mine = {m["name"] for m in self.end_to_end()}

        def applies(m):
            if "workloads" in m:
                return self.cell["name"] in m["workloads"]
            return m["moves"] in mine

        return [m for m in self.bench["per_layer"] if applies(m)]

    def read_layer(self, record: dict) -> dict:
        out = {}
        for m in self.per_layer():
            value = load_reader(self.home, m["name"]).read(record)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def load_reader(home: Path, name: str):
    """The per-layer reader ``metrics/<name>.py`` (a name may hold dots)."""
    path = home / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"wbcbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gpu_state(index: int = 0) -> str:
    """The card's name, power limit, SM clock, temperature and draw, as
    nvidia-smi reads them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit,clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def result_line(h: Harness, out: dict) -> dict:
    """The result's one JSON object from a driver's outcome."""
    dev = out["device"]
    if h.trace:
        metrics = h.read_layer(out["record"])
        summ = out["record"].get("trace") or {}
        dev = dict(dev, busy_s=out["busy_s"], window_s=summ.get("window_s", 0.0))
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in h.end_to_end() if m["name"] in e2e}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if h.trace and out["record"].get("trace"):
        t = out["record"]["trace"]
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = {n: {"value": v if math.isfinite(v) else str(v),
                          "limit": out["limits"][n]} for n, v in out["numbers"].items()}
    return line


def device_of(h: Harness, index: int = 0) -> torch.device:
    return torch.device(h.device) if h.device is not None else torch.device("cuda", index)


@contextlib.contextmanager
def quiet():
    """The measured window without the collector's pauses (as ``timeit``
    times): what set-up left is collected and frozen first."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def open_card(h: Harness, dev: torch.device, build: bool = True):
    """Make ``dev`` current and, for the port's kernels, build their library
    if this checkout has none (said with its time: the cold build)."""
    if dev.type != "cuda":
        return
    torch.cuda.set_device(dev)
    if build and h.backend == "cuda" and h._make_tick is None:
        built = program.library_build_s()
        if built is not None:
            h.say(f"cold build of the port's kernel library: {built:.1f} s")


def finish(h: Harness, dev, *, e2e: dict, setup_s: float, attempted: int, failed: int,
           numbers: dict, record: dict, peak: int, busy_s: float | None = None,
           count: int | None = None) -> dict:
    """A driver's outcome: the numbers judged against the configuration's
    limits, the device record and what the readers read."""
    limits = h.config["limits"]
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"the check computed no {missing}")
    for n in sorted(set(numbers) - set(limits)):
        h.say(f"reading {n}: {numbers[n]!r} (not held to a limit)")
    numbers = {n: numbers[n] for n in limits}
    correct = all(math.isfinite(v) and v <= limits[n] for n, v in numbers.items())
    on_card = dev.type == "cuda"
    device = {"platform": "gpu" if on_card else dev.type,
              "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
              "count": count or h.chips, "memory_peak_bytes": int(peak)}
    trace = record.get("trace")
    if busy_s is None:
        busy_s = trace["busy_s"] if trace else 0.0
    return dict(e2e=e2e, setup_s=setup_s, attempted=int(attempted), failed=int(failed),
                numbers=numbers, limits=limits, correct=bool(correct and attempted > 0),
                record=record, device=device, busy_s=busy_s)


def emit(h: Harness, out: dict) -> int:
    """Print the run's lines, the checks on standard error, and the result
    as the last line of standard output; the exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"wbcbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    for line in h.info:
        print(line, flush=True)
    for n, v in out["numbers"].items():
        lim = out["limits"][n]
        ok = math.isfinite(v) and v <= lim
        print(f"check {n}: {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(f"check correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result_line(h, out)), flush=True)
    return 0
