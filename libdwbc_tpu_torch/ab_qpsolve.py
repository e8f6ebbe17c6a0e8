"""qp_solve of this tree against another tree's, on one card in one process:
each tree's csrc/ is built into its own library, and the kernel is timed
with CUDA events on CompiledTick's three QPs (levels 0 and 1 and the
redistribution QP: (n, m) = (12, 86), (9, 86), (6, 86), 33 mirrored pairs),
captured from one cold CompiledTick(backend="cuda") tick at chip_smoke.py's
serving inputs (batch 1024, seed 0), warm at 7 iterations from this tree's
12-iteration cold solve, at B = 1024, 1 and 4096 (the batch tiled), in the
order this, other, other, this.

    python -m libdwbc_tpu_torch.ab_qpsolve OTHER_REPO_ROOT

Each tree's kernel is called with its own C signature: a tree whose
qp_solve takes a global workspace (it exports ``dwbc_qp_solve_ws_elems``)
gets one.  Prints each time, the mean of each tree's two runs, whether x, s
and λ of the two agree bit for bit (warm, and cold at 12 iterations), and
the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import entry
from .ab_prestage import build_tree, event_ms
from .model.compile import RobotModel
from .ops import _build, qp_cuda
from .profile_tick import serving_inputs
from .wbc.pipeline import CompiledTick, standard_tocabi_config

QP_NAMES = ("level 0", "level 1", "redistribution")


def capture(tick, q, qd, fs):
    """The inputs of qp_solve in one cold tick of ``tick``: (H, g, C, d,
    ridge, mirror) per call."""
    seen, solve = [], qp_cuda.qp_solve

    def record(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6, mirror=0):
        seen.append((H.clone(), g.clone(), C.clone(), d.clone(), ridge, mirror))
        return solve(H, g, C, d, x0, lam0, iters=iters, ridge=ridge, mirror=mirror)

    qp_cuda.qp_solve = record
    try:
        tick._tick_impl(q, qd, fs, warm=tick.init_warm(q.shape[:-1]), qp_iters=12)
    finally:
        qp_cuda.qp_solve = solve
    torch.cuda.synchronize()
    return seen


def qpsolve_call(lib, H, g, C, d, x0, lam0, iters, ridge, mirror):
    """A closure launching the library's qp_solve (cold where x0 is None);
    returns its (x, s, λ)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    B, m, n = C.shape
    ws = []
    if getattr(lib, "dwbc_qp_solve_ws_elems", None) is not None:
        lib.dwbc_qp_solve_ws_elems.argtypes = [i, i, i]
        lib.dwbc_qp_solve_ws_elems.restype = ctypes.c_longlong
        ws = [torch.empty((lib.dwbc_qp_solve_ws_elems(n, m, mirror), B), device=C.device)]
    lib.dwbc_qp_solve.argtypes = [p] * (9 + len(ws)) + [i] * 5 + [ctypes.c_float, p]
    lib.dwbc_qp_solve.restype = i
    x = torch.empty((B, n), device=C.device)
    s = torch.empty((B, m), device=C.device)
    lam = torch.empty((B, m), device=C.device)
    bufs = [H, g, C, d, x0, lam0, x, s, lam] + ws      # held by run: nothing freed

    def run():
        rc = lib.dwbc_qp_solve(*(None if t is None else t.data_ptr() for t in bufs), B, n, m,
                               mirror, iters, ridge,
                               torch.cuda.current_stream(C.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"qp_solve launch failed: CUDA error {rc}")
        return x, s, lam

    return run


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_qpsolve: no CUDA device")
    other = Path(sys.argv[1]).resolve() / "libdwbc_tpu_torch" / "csrc"
    dev = torch.device("cuda", 0)
    tmp = Path(tempfile.mkdtemp(prefix="ab_qpsolve_"))
    libs = {"this": _build.library(), "other": build_tree(other, tmp)}

    model = RobotModel.load(str(entry.MODEL_PATH))
    tick = CompiledTick(model, standard_tocabi_config(model, qp_iters=12), dev, backend="cuda")
    seen = capture(tick, *serving_inputs(model, 1024, dev))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for name, (H, g, C, d, ridge, mirror) in zip(QP_NAMES, seen):
        x0, _, lam0 = qp_cuda.qp_solve(H, g, C, d, iters=12, ridge=ridge, mirror=mirror)
        first = {}                 # (kind, tree) → its results at the captured batch
        for nb in (1024, 1, 4096):
            a = [t.repeat((-(-nb // t.shape[0]),) + (1,) * (t.ndim - 1))[:nb].contiguous()
                 for t in (H, g, C, d, x0, lam0)]
            warm = {tag: qpsolve_call(lib, *a, 7, ridge, mirror) for tag, lib in libs.items()}
            cold = {tag: qpsolve_call(lib, *a[:4], None, None, 12, ridge, mirror)
                    for tag, lib in libs.items()}
            t = {"this": [], "other": []}
            for tag in ("this", "other", "other", "this"):
                t[tag].append(event_ms(warm[tag], reps=20))
            same, notes = {}, []
            for kind, runs in (("warm", warm), ("cold", cold)):
                res = {tag: [r.clone() for r in run()] for tag, run in runs.items()}
                same[kind] = all(torch.equal(u, v) for u, v in zip(res["this"], res["other"]))
                for tag, rs in res.items():
                    first.setdefault((kind, tag), rs)
                    lane = torch.arange(nb, device=dev) % 1024
                    if not all(torch.equal(r, f[lane]) for r, f in zip(rs, first[kind, tag])):
                        notes.append(f"{kind} {tag}: lanes differ from its batch-1024 lanes")
                    if not all(torch.equal(r, r2) for r, r2 in zip(rs, runs[tag]())):
                        notes.append(f"{kind} {tag}: a repeated call differs")
                if not same[kind]:
                    notes.append(f"{kind}: " + ", ".join(
                        f"{k} {int((u != v).sum())} entries, max |diff| "
                        f"{float((u - v).abs().max()):.3e}"
                        for k, u, v in zip("xsλ", res["this"], res["other"])))
            print(f"qp_solve warm {name} (n {C.shape[2]}, m {C.shape[1]}) B {nb}: " + ", ".join(
                f"{tag} " + " ".join(f"{v:.3f}" for v in ts) + f" (mean {np.mean(ts):.3f}) ms"
                for tag, ts in t.items())
                + f"; x, s, λ bit for bit equal: warm {same['warm']}, cold {same['cold']}"
                + "".join(f"; {n_}" for n_ in notes) + f"  [{card}]")


if __name__ == "__main__":
    main()
