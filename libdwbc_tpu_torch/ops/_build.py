"""Build of the CUDA kernels: ``nvcc`` for sm_90a into one shared library
with a plain C interface, loaded with ``ctypes``.  Each ``csrc/*.cu`` is
compiled to an object by its own ``nvcc``, all started together, and the
objects are linked into the library.

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
              "-Xcompiler", "-fPIC")


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
    """Compile the kernels unless a library of the same source hash exists;
    verbose compiles in any case and adds ptxas's register and spill report
    to the log.  Returns (library path, compiler log).  Raises on a failed
    build."""
    so = BUILD_DIR / f"libdwbc_tick_{source_hash()}.so"
    if so.exists() and not verbose:
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []), "-c",
               str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    tmp = so.with_name(f"{tag}.tmp")
    cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
           *(str(obj) for _, obj, _ in jobs)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, so)
    return so, "".join(log) + r.stdout + r.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("dwbc_prestage_ws_elems", "dwbc_prestage_smem_elems", "dwbc_prestage_stride",
                 "dwbc_qpchain_smem_elems", "dwbc_out_elems", "dwbc_warm_elems"):
        fn = getattr(lib, name)
        fn.argtypes = [p]
        fn.restype = ll
    lib.dwbc_pre_elems.argtypes = [p, i]
    lib.dwbc_pre_elems.restype = ll
    lib.dwbc_prestage_smem_cap.argtypes = []
    lib.dwbc_prestage_smem_cap.restype = ll
    lib.dwbc_tick_prestage.argtypes = [p, p, p, p, p, p, i, p, p, i, i, p]
    lib.dwbc_tick_prestage.restype = i
    for name in ("dwbc_tick_qpchain", "dwbc_tick_qpchain_nolim"):
        getattr(lib, name).argtypes = [p, p, p, p, p, p, i, i, i, p]
        getattr(lib, name).restype = i
    lib.dwbc_psd_inverse.argtypes = [p, p, i, i, p]
    lib.dwbc_psd_inverse.restype = i
    lib.dwbc_qp_solve_smem_elems.argtypes = [i, i, i]
    lib.dwbc_qp_solve_smem_elems.restype = ll
    lib.dwbc_qp_solve.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.dwbc_qp_solve.restype = i
    for name, args in (("dwbc_tick_prestage_info", [i, p]), ("dwbc_tick_qpchain_info", [i, p]),
                       ("dwbc_tick_qpchain_nolim_info", [i, p]),
                       ("dwbc_psd_inverse_info", [i, p]), ("dwbc_qp_solve_info", [i, i, i, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    return lib


INFO_KEYS = ("registers", "local_bytes", "smem_per_block", "threads_per_block",
             "blocks_per_sm")


def kernel_info(name: str, *args: int) -> dict:
    """A kernel's resources at a launch shape (``dwbc_<name>_info``):
    registers per thread, local (spilled) bytes per thread, shared bytes
    per block, threads per block and resident blocks per SM."""
    out = (ctypes.c_int * len(INFO_KEYS))()
    rc = getattr(library(), f"dwbc_{name}_info")(*args, out)
    if rc != 0:
        raise RuntimeError(f"{name} info failed: CUDA error {rc}")
    return dict(zip(INFO_KEYS, out))
