"""Where tick_prestage's time goes on the card: the kernel built with
``-DDWBC_PRE_STOP=k`` returns at its phase marker k (csrc/tick_prestage.cu),
so timing the builds that stop at each marker, and the whole kernel, gives
the time of every phase.  Timed with CUDA events on the serving inputs of
chip_smoke.py: static at B = 1 and B = 1024, masked at B = 4096,
config 3 (single support, a swing-foot third level) at B = 1024, and the
hands-and-feet plan (entry._hands_feet_config, four contacts) at B = 1024.

    python -m libdwbc_tpu_torch.profile_prestage

Prints, per case, the time up to each marker and the phase's share, and the
card's name and power limit.  Needs a CUDA device; the builds go to a
temporary directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import entry
from .ab_prestage import event_ms, prestage_call
from .model.compile import RobotModel
from .ops import _build
from .ops.tick_cuda import kernel_table
from .ops.tick_kernel import TickProgram
from .wbc.pipeline import standard_tocabi_config

# the phase that ends at each marker of csrc/tick_prestage.cu; None: the
# whole kernel
PHASES = ((1, "FK"), (2, "dof frames, point jacobians"), (3, "CRBA: IC, S, A, G, Jcom"),
          (4, "A⁻¹ (n = ndof)"), (5, "contact space: JC, Λc, J̄, P_C, NCG, W fill"),
          (6, "kernel basis, Cholesky of W, NwJw"), (7, "τ_grav (W-apply)"),
          (8, "JKT and Ntorque per level"), (None, "constraint rows, outputs, servo"))


def build(stop, out: Path) -> ctypes.CDLL:
    """csrc/tick_prestage.cu alone → a loaded library; stop: the marker to
    return at, or None."""
    flags = [f"-DDWBC_PRE_STOP={stop}"] if stop else []
    so = out / f"libpre_{stop or 'all'}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(so),
                    str(_build.CSRC / "tick_prestage.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dwbc_pre_elems.argtypes = [p, i]
    lib.dwbc_prestage_ws_elems.argtypes = lib.dwbc_prestage_stride.argtypes = [p]
    lib.dwbc_pre_elems.restype = lib.dwbc_prestage_ws_elems.restype = ctypes.c_longlong
    lib.dwbc_prestage_stride.restype = ctypes.c_longlong
    lib.dwbc_tick_prestage.argtypes = [p, p, p, p, p, p, i, p, p, i, i, p]
    lib.dwbc_tick_prestage.restype = i
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_prestage: no CUDA device")
    dev = torch.device("cuda", 0)
    tmp = Path(tempfile.mkdtemp(prefix="profile_prestage_"))
    with ThreadPoolExecutor(len(PHASES)) as ex:
        libs = list(ex.map(lambda ph: build(ph[0], tmp), PHASES))

    model = RobotModel.load(str(entry.MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=12)
    q0, _, _ = entry._example_inputs(model)
    rng = np.random.default_rng(0)
    qs = np.tile(q0, (1024, 1)).astype(np.float32)
    qs[:, 6:39] += 0.02 * rng.standard_normal((1024, 33)).astype(np.float32)
    mq, _, _, masks = entry._masked_inputs(model, 4096, seed=0)
    el = (lambda a: torch.as_tensor(np.ascontiguousarray(a.T), device=dev))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"profile_prestage  [{card}]")
    cfg3 = standard_tocabi_config(model, both_feet=False, swing_task=True, qp_iters=12)
    q3, _, _ = entry._swing_inputs(model, 1024, seed=0)
    hq, _, _ = entry._hands_feet_inputs(model, 1024, seed=0)
    for label, c, masked, q, cm in (("static B 1", cfg, False, qs[:1], None),
                                    ("static B 1024", cfg, False, qs, None),
                                    ("masked B 4096", cfg, True, mq, masks),
                                    ("config 3 B 1024", cfg3, False, q3, None),
                                    ("hands B 1024", entry._hands_feet_config(model), False,
                                     hq, None)):
        th = kernel_table(TickProgram(model, c, "cpu", torch.float64, masked=masked).plan)
        th = np.ascontiguousarray(th.astype(np.float32))
        td = torch.as_tensor(th, device=dev)
        cd = None if cm is None else el(cm)
        cum = [event_ms(prestage_call(lib, th, td, el(q), cd), reps=20) for lib in libs]
        prev = 0.0
        for (_, name), t in zip(PHASES, cum):
            print(f"tick_prestage {label}: up to the end of {name}: {t:.4f} ms "
                  f"(phase {t - prev:+.4f} ms, {100 * (t - prev) / cum[-1]:.1f}%)")
            prev = t


if __name__ == "__main__":
    main()
