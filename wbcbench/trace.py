"""The traced run's record: ``torch.profiler`` over the measured window,
kept in memory and reduced to what the per-layer readers and the
breakdown need.  Nothing is written to disk.

Spans are the harness's own (``record_function`` around each call into a
layer); device operations are the kernels, copies and fills the profiler
saw on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# the harness's spans, outermost first
SPANS = ("window", "traffic", "loop", "consumer", "mesh_step", "check")


def span(name: str, enabled: bool):
    """A harness span around a call into a layer (nothing when untraced)."""
    return torch.profiler.record_function(name) if enabled else contextlib.nullcontext()


def _kind(e) -> str:
    """'kernel', 'memcpy', 'memset', or '' for what is not a device op."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return ""
    act = e.activity_type() if callable(getattr(e, "activity_type", None)) else ""
    act = str(act).lower()
    name = e.name()
    if "annotation" in act or name in SPANS or (
            callable(getattr(e, "is_user_annotation", None)) and e.is_user_annotation()):
        return ""
    if "memcpy" in act or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged intervals of (n, 2) start/end rows, sorted."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], 1)


class Tracer:
    """``torch.profiler`` over a block when enabled; ``summary`` afterwards
    holds the reduced record (None when not traced)."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False


def summarize(events) -> dict:
    """The window's device operations and idle gaps from the profiler's
    events: busy seconds (the union of every device op's interval), kernel
    seconds summed, per-name sums, NCCL kernel seconds, the op count, and
    the longest idle gaps labelled by the harness span (and the host op)
    the host was in."""
    spans, cpu, dev = [], [], []
    for e in events:
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name in SPANS:
                spans.append((name, s, s + d))
            else:
                cpu.append((name, s, s + d))
            continue
        kind = _kind(e)
        if kind:
            dev.append((name, kind, s, s + d))
    win = [(s, t) for n, s, t in spans if n == "window"]
    if not win:
        return None
    w0, w1 = win[0]
    dev = [x for x in dev if x[2] >= w0 and x[3] <= w1]
    iv = np.array([[x[2], x[3]] for x in dev], np.int64).reshape(-1, 2)
    busy = _union(iv)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    by_name, kernel_ns, nccl_ns, counts = {}, 0, 0, {"kernel": 0, "memcpy": 0, "memset": 0}
    for name, kind, s, t in dev:
        by_name[name] = by_name.get(name, 0) + (t - s)
        counts[kind] += 1
        if kind == "kernel":
            kernel_ns += t - s
            if "nccl" in name.lower():
                nccl_ns += t - s
    # idle gaps inside the window, between the merged busy intervals
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    top = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:10]]
    sp = np.array([[s, t] for _, s, t in spans], np.int64).reshape(-1, 2)
    sp_names = [n for n, _, _ in spans]
    cp = np.array([[s, t] for _, s, t in cpu], np.int64).reshape(-1, 2)
    cp_names = [n for n, _, _ in cpu]
    idle = []
    for g0, g1 in top:
        mid = (g0 + g1) // 2
        label = _innermost(sp, sp_names, mid) or "window"
        op = _innermost(cp, cp_names, mid)
        idle.append([f"{label}: {op}" if op else label, (g1 - g0) * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, kernel_s=kernel_ns * 1e-9,
                nccl_s=nccl_ns * 1e-9, op_counts=counts,
                device_ops=[[n[:160], ns * 1e-9] for n, ns in ops], idle_gaps=idle)


def _innermost(iv: np.ndarray, names: list, t: int) -> str | None:
    """The name of the shortest interval that holds t."""
    if len(iv) == 0:
        return None
    hit = np.flatnonzero((iv[:, 0] <= t) & (iv[:, 1] >= t))
    if len(hit) == 0:
        return None
    return names[hit[np.argmin(iv[hit, 1] - iv[hit, 0])]]
