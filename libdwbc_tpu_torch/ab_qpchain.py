"""tick_qpchain of this tree against another tree's, on one card in one
process: each tree's csrc/ is built into its own library, and the kernel
is timed with CUDA events on warm QP chains (7 iterations, from a cold
12-iteration warm state) over this tree's prestage of chip_smoke.py's
serving inputs (static at B = 1024 and B = 1, masked at B = 4096, config 3
— single support, a swing-foot third level — at B = 1024), in the order
this, other, other, this; then the hands-and-feet plans (entry.
_hands_feet_config: static at B = 1024, the four candidates masked at
B = 4096) on this tree alone.

    python -m libdwbc_tpu_torch.ab_qpchain OTHER_REPO_ROOT

The other tree's tick_qpchain must take the same C arguments and read the
flagship's and config 3's prestage buffers as this one's; each tree's kernel reads the
table that its own ``kernel_table`` packs.  Prints each time, the mean of
each tree's two runs, whether the two results agree bit for bit, and the
card's name and power limit.  Needs a CUDA device.
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
from .ab_prestage import build_tree, event_ms, tree_tables
from .model.compile import RobotModel
from .ops import _build
from .ops import tick_cuda as tc
from .ops.tick_kernel import TickProgram
from .wbc.pipeline import standard_tocabi_config


def qpchain_call(lib, table_host, pre, fs, warm, nb, n_out, n_warm):
    """A closure launching the library's tick_qpchain, warm at 7 iterations;
    returns the result buffer."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dwbc_tick_qpchain.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.dwbc_qpchain_smem_elems.argtypes = [p]
    lib.dwbc_qpchain_smem_elems.restype = ctypes.c_longlong
    table_host = np.ascontiguousarray(table_host)
    S = lib.dwbc_qpchain_smem_elems(table_host.ctypes.data_as(p))
    table = torch.as_tensor(table_host, device=pre.device)
    out = torch.empty((n_out, nb), device=pre.device)
    wout = torch.empty((n_warm, nb), device=pre.device)

    def run():
        rc = lib.dwbc_tick_qpchain(table.data_ptr(), pre.data_ptr(), fs.data_ptr(),
                                   warm.data_ptr(), out.data_ptr(), wout.data_ptr(), S, nb, 7,
                                   torch.cuda.current_stream(pre.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"tick_qpchain launch failed: CUDA error {rc}")
        return out

    return run


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_qpchain: no CUDA device")
    other = Path(sys.argv[1]).resolve() / "libdwbc_tpu_torch" / "csrc"
    dev = torch.device("cuda", 0)
    tmp = Path(tempfile.mkdtemp(prefix="ab_qpchain_"))
    libs, tables = {}, {}
    for tag, csrc in (("this", _build.CSRC), ("other", other)):
        (tmp / tag).mkdir()
        libs[tag] = build_tree(csrc, tmp / tag)
        tables[tag] = tree_tables(csrc.parent.parent)

    model = RobotModel.load(str(entry.MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=12)
    cfg3 = standard_tocabi_config(model, both_feet=False, swing_task=True, qp_iters=12)
    q0, _, f0 = entry._example_inputs(model)
    rng = np.random.default_rng(0)
    qs = np.tile(q0, (1024, 1)).astype(np.float32)
    qs[:, 6:39] += 0.02 * rng.standard_normal((1024, 33)).astype(np.float32)
    fs = [np.tile(f, (1024, 1)).astype(np.float32)
          + 0.05 * rng.standard_normal((1024, f.shape[0])).astype(np.float32) for f in f0]
    mq, _, mfs, masks = entry._masked_inputs(model, 4096, seed=0)
    q3, _, fs3 = entry._swing_inputs(model, 1024, seed=0)
    hcfg = entry._hands_feet_config(model)
    hq, _, hfs = entry._hands_feet_inputs(model, 1024, seed=0)
    hmq, _, hmfs, hmasks = entry._hands_masked_inputs(model, 4096, seed=0)
    el = (lambda a: torch.as_tensor(np.ascontiguousarray(a.T), device=dev))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for label, c, masked, q, f, cm, tab in (
            ("static B 1024", cfg, False, qs, fs, None, "static"),
            ("static B 1", cfg, False, qs[:1], [x[:1] for x in fs], None, "static"),
            ("masked B 4096", cfg, True, mq, mfs, masks, "masked"),
            ("config 3 B 1024", cfg3, False, q3, fs3, None, "config 3"),
            ("hands B 1024", hcfg, False, hq, hfs, None, None),
            ("hands masked B 4096", hcfg, True, hmq, hmfs, hmasks, None)):
        k = tc.TickKernels(TickProgram(model, c, dev, torch.float32, masked=masked))
        nb = q.shape[0]
        pre = k.prestage_packed(el(q), None if cm is None else el(cm))
        fse = [el(x) for x in f]
        _, warm = k.qpchain_packed(pre, fse, None, 12)
        fsb = torch.cat(fse, 0).contiguous()
        n_out, n_warm = tc._elems(tc.out_layout(k.plan)), tc._elems(tc.warm_layout(k.plan))
        runs = {"this": qpchain_call(libs["this"], k._table_host, pre.buf, fsb, warm, nb,
                                     n_out, n_warm)}
        if tab is not None:   # a tree before the hands-and-feet plans refuses them
            runs["other"] = qpchain_call(libs["other"], tables["other"][tab], pre.buf, fsb,
                                         warm, nb, n_out, n_warm)
        t = {tag: [] for tag in runs}
        for tag in ("this", "other", "other", "this"):
            if tag in runs:
                t[tag].append(event_ms(runs[tag], reps=20))
        line = f"tick_qpchain warm {label}: " + ", ".join(
            f"{tag} " + " ".join(f"{v:.3f}" for v in ts) + f" (mean {np.mean(ts):.3f}) ms"
            for tag, ts in t.items())
        if "other" in runs:
            same = torch.equal(runs["this"]().clone(), runs["other"]().clone())
            line += f"; results bit for bit equal: {same}"
        print(f"{line}  [{card}]")


if __name__ == "__main__":
    main()
