"""tick_prestage of this tree against another tree's, on one card in one
process: each tree's csrc/ is built into its own library, and the kernel
is timed with CUDA events on the serving inputs of chip_smoke.py (static at
B = 1024 and B = 1, masked at B = 4096, servo'd at B = 1024, config 3 —
single support, a swing-foot third level — at B = 1024), in the order
this, other, other, this; then the hands-and-feet plans (entry.
_hands_feet_config: static at B = 1024, the four candidates masked at
B = 4096) on this tree alone.

    python -m libdwbc_tpu_torch.ab_prestage OTHER_REPO_ROOT

The other tree's tick_prestage must take this one's C arguments
(``dwbc_tick_prestage``, ``dwbc_pre_elems``, ``dwbc_prestage_ws_elems``),
or those of a tree without ``dwbc_prestage_stride``, whose kernel takes no
shared stride; each tree's kernels read the table that its own
``kernel_table`` packs (computed by a python run in that tree).  Prints
each time, the mean of each tree's two runs, whether the two prestage
buffers agree bit for bit, and the card's name and power limit.  Needs a
CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import entry
from .model.compile import RobotModel
from .ops import _build
from .ops.tick_cuda import kernel_table, pack_servos, servo_mask
from .ops.tick_kernel import TickProgram
from .wbc.fused import FusedTick
from .wbc.pipeline import standard_tocabi_config


def build_tree(csrc: Path, out: Path) -> ctypes.CDLL:
    """csrc/*.cu → out/libab.so with the package's nvcc flags; loaded."""
    nvcc = _build.nvcc_path()
    objs, procs = [], []
    for src in sorted(csrc.glob("*.cu")):
        obj = out / f"{src.stem}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed in {csrc}:\n{log}")
    so = out / "libab.so"
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(so),
                    *objs], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    stride = getattr(lib, "dwbc_prestage_stride", None) is not None
    for name, args in (("dwbc_pre_elems", [p, i]), ("dwbc_prestage_ws_elems", [p]),
                       ("dwbc_prestage_stride", [p])):
        if name != "dwbc_prestage_stride" or stride:
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_longlong
    lib.dwbc_tick_prestage.argtypes = [p, p, p, p, p, p, i, p, p] + [i] * (1 + stride) + [p]
    lib.dwbc_tick_prestage.restype = i
    return lib


# run in a tree: the kernel tables of the flagship, static and masked, and
# of config 3, as that tree packs them (JSON lists of float64)
_TABLES = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from libdwbc_tpu_torch import entry
from libdwbc_tpu_torch.model.compile import RobotModel
from libdwbc_tpu_torch.ops.tick_cuda import kernel_table
from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config
m = RobotModel.load(str(entry.MODEL_PATH))
cfg = standard_tocabi_config(m, qp_iters=12)
cfg3 = standard_tocabi_config(m, both_feet=False, swing_task=True, qp_iters=12)
print(json.dumps({name: kernel_table(TickProgram(m, c, "cpu", torch.float64,
                                                 masked=k).plan).tolist()
                  for name, c, k in (("static", cfg, False), ("masked", cfg, True),
                                     ("config 3", cfg3, False))}))
"""


def tree_tables(root: Path):
    """{"static", "masked", "config 3": float32 table} as the tree at root
    packs them."""
    out = subprocess.run([sys.executable, "-c", _TABLES, str(root)], capture_output=True,
                         text=True, check=True, cwd=str(root)).stdout
    return {k: np.asarray(v, np.float32) for k, v in json.loads(out).items()}


def prestage_call(lib, table_host, table, q, cmask, servo=None):
    """A closure launching the library's tick_prestage on q (nq, B) (and the
    mask; servo: (q̇, f*, servo buffer, level mask), element-leading);
    returns the prestage buffer."""
    host = table_host.ctypes.data_as(ctypes.c_void_p)
    B = q.shape[1]
    stride = ([lib.dwbc_prestage_stride(host)]
              if getattr(lib, "dwbc_prestage_stride", None) is not None else [])
    qd, fs, sv, smask = servo if servo else (None, None, None, 0)
    pre = torch.empty((lib.dwbc_pre_elems(host, int(smask != 0)), B), dtype=torch.float32,
                      device=q.device)
    # B × elements floats serve a scenario-major or an element-leading
    # workspace alike: each tree's kernel reads its own layout
    ws = torch.empty((B, lib.dwbc_prestage_ws_elems(host)), dtype=torch.float32, device=q.device)

    def run():
        rc = lib.dwbc_tick_prestage(table.data_ptr(), q.data_ptr(),
                                    None if cmask is None else cmask.data_ptr(),
                                    *(None if t is None else t.data_ptr() for t in (qd, fs, sv)),
                                    smask, pre.data_ptr(), ws.data_ptr(), *stride, B,
                                    torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"tick_prestage launch failed: CUDA error {rc}")
        return pre

    return run


def event_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_prestage: no CUDA device")
    other = Path(sys.argv[1]).resolve() / "libdwbc_tpu_torch" / "csrc"
    dev = torch.device("cuda", 0)
    tmp = Path(tempfile.mkdtemp(prefix="ab_prestage_"))
    libs, tables = {}, {}
    for tag, csrc in (("this", _build.CSRC), ("other", other)):
        (tmp / tag).mkdir()
        libs[tag] = build_tree(csrc, tmp / tag)
        tables[tag] = tree_tables(csrc.parent.parent)

    model = RobotModel.load(str(entry.MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=12)
    q0, _, _ = entry._example_inputs(model)
    rng = np.random.default_rng(0)
    qs = np.tile(q0, (1024, 1)).astype(np.float32)
    qs[:, 6:39] += 0.02 * rng.standard_normal((1024, 33)).astype(np.float32)
    mq, _, _, masks = entry._masked_inputs(model, 4096, seed=0)
    sq, sqd, sfs, servos = entry._servo_inputs(model, 1024, seed=0)
    el = (lambda a: torch.as_tensor(np.ascontiguousarray(a.T), device=dev))
    sprog = TickProgram(model, cfg, "cpu", torch.float32)
    sv_el = FusedTick(model, cfg, dev, backend="cuda")._servos_el(servos, 1024)
    servo = (el(sqd), torch.cat([el(f) for f in sfs], 0).contiguous(),
             pack_servos(sv_el, sprog.plan, 1024), servo_mask(sv_el, sprog.plan))
    q3, _, _ = entry._swing_inputs(model, 1024, seed=0)
    cases = []
    for label, tab, q, cm, sv in (("static B 1024", "static", qs, None, None),
                                  ("static B 1", "static", qs[:1], None, None),
                                  ("masked B 4096", "masked", mq, masks, None),
                                  ("servo'd B 1024", "static", sq, None, servo),
                                  ("config 3 B 1024", "config 3", q3, None, None)):
        cd = None if cm is None else el(cm)
        runs = {}
        for tag, lib in libs.items():
            th = np.ascontiguousarray(tables[tag][tab])
            runs[tag] = prestage_call(lib, th, torch.as_tensor(th, device=dev), el(q), cd, sv)
        cases.append((label, runs))
    # the hands-and-feet plans: this tree only (a tree before them refuses them)
    hcfg = entry._hands_feet_config(model)
    hq, _, _ = entry._hands_feet_inputs(model, 1024, seed=0)
    hmq, _, _, hmasks = entry._hands_masked_inputs(model, 4096, seed=0)
    for label, masked, q, cm in (("hands B 1024", False, hq, None),
                                 ("hands masked B 4096", True, hmq, hmasks)):
        th = np.ascontiguousarray(kernel_table(TickProgram(
            model, hcfg, "cpu", torch.float64, masked=masked).plan).astype(np.float32))
        cases.append((label, {"this": prestage_call(
            libs["this"], th, torch.as_tensor(th, device=dev), el(q),
            None if cm is None else el(cm))}))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for label, runs in cases:
        t = {tag: [] for tag in runs}
        if "other" not in runs:
            t["this"] = [event_ms(runs["this"]) for _ in range(2)]
            print(f"tick_prestage {label}: this " + " ".join(f"{v:.3f}" for v in t["this"])
                  + f" (mean {np.mean(t['this']):.3f}) ms  [{card}]")
            continue
        for tag in ("this", "other", "other", "this"):
            t[tag].append(event_ms(runs[tag]))
        a, b = runs["this"]().clone(), runs["other"]().clone()
        same = torch.equal(a, b)
        diff = "" if same else (f" ({int((a != b).sum())} entries differ, max abs "
                                f"{float((a - b).abs().max()):.3e})")
        print(f"tick_prestage {label}: this " + " ".join(f"{v:.3f}" for v in t["this"])
              + f" (mean {np.mean(t['this']):.3f}) ms, other "
              + " ".join(f"{v:.3f}" for v in t["other"])
              + f" (mean {np.mean(t['other']):.3f}) ms; buffers bit for bit equal: {same}"
              f"{diff}  [{card}]")


if __name__ == "__main__":
    main()
