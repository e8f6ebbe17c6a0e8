"""Build of the CUDA tick kernels: ``nvcc`` for sm_90a into one shared
library with a plain C interface, loaded with ``ctypes``.

The library lands in ``libdwbc_tpu_torch/_build/`` under a name that carries
a hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernels unless a library of the same source hash exists.
    Returns (library path, compiler log); verbose adds ptxas's register and
    spill report to the log.  Raises on a failed build."""
    so = BUILD_DIR / f"libdwbc_tick_{source_hash()}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
           "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, so)
    return so, r.stdout + r.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("dwbc_prestage_ws_elems", "dwbc_pre_elems", "dwbc_qpchain_ws_elems",
                 "dwbc_out_elems", "dwbc_warm_elems"):
        fn = getattr(lib, name)
        fn.argtypes = [p]
        fn.restype = ll
    lib.dwbc_tick_prestage.argtypes = [p, p, p, p, i, p]
    lib.dwbc_tick_prestage.restype = i
    lib.dwbc_tick_qpchain.argtypes = [p, p, p, p, p, p, p, i, i, p]
    lib.dwbc_tick_qpchain.restype = i
    return lib
