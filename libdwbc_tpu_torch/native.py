"""ctypes bridge to the repo's native host runtime, ``native/`` (counterpart
of ``libdwbc_tpu/native.py``).

The C++ library provides the URDF → model compiler, ``.dwbcm``
serialization, golden-matrix I/O and the real-time producer/consumer loop
(a seqlock over a double buffer, ``native/include/dwbc_host/rt_loop.h``).
``build_native`` compiles it with g++ into ``libdwbc_tpu_torch/_build/``
under a name that carries a hash of the sources; ``load_dwbcm`` reads a
``.dwbcm`` into the port's ``RobotModel``, so the native and Python
compilers are interchangeable; ``TickConsumer`` serves a port tick from the
loop's consumer thread.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import tracing
from .model.compile import GRAVITY, RobotModel
from .wbc import types as T

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the library's sources (native/CMakeLists.txt:13-19), without the self-test
SOURCES = ("xml", "model_compiler", "model_io", "golden_io", "rt_loop", "capi")
GXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for f in sorted((NATIVE_DIR / "include").rglob("*.h")) + sorted(
            (NATIVE_DIR / "src").glob("*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_native() -> Path:
    """Compile the library unless one of the same source hash exists: one g++
    per source, all started together, then the link.  Returns the .so path;
    raises on a failed build (there is no prebuilt library to fall back on)."""
    so = BUILD_DIR / f"libdwbc_host_{source_hash()}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}.{name}.o"
        cmd = [gxx, *GXX_FLAGS, f"-I{NATIVE_DIR / 'include'}", "-c",
               str(NATIVE_DIR / "src" / f"{name}.cpp"), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    try:
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        tmp = so.with_name(f"{tag}.tmp")
        cmd = [gxx, "-shared", "-pthread", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ link failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        for _, obj, proc in jobs:
            proc.kill()
            proc.wait()
            obj.unlink(missing_ok=True)
    return so


PROD = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
                        ctypes.c_void_p)
CONS = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double),
                        ctypes.POINTER(ctypes.c_double), ctypes.c_void_p)


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library (built on first use), argtypes declared as in the
    JAX bridge (native.py:49-64, 165-174)."""
    lib = ctypes.CDLL(str(build_native()))
    dbl_p = ctypes.POINTER(ctypes.c_double)
    lib.dwbc_compile_urdf.restype = ctypes.c_int
    lib.dwbc_compile_urdf.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.dwbc_model_info.restype = ctypes.c_int
    lib.dwbc_model_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong), dbl_p]
    lib.dwbc_golden_diff.restype = ctypes.c_double
    lib.dwbc_golden_diff.argtypes = [ctypes.c_char_p, dbl_p, ctypes.c_longlong,
                                     ctypes.c_longlong]
    lib.dwbc_golden_write.restype = ctypes.c_int
    lib.dwbc_golden_write.argtypes = lib.dwbc_golden_diff.argtypes
    lib.dwbc_run_rt_loop.restype = ctypes.c_int
    lib.dwbc_run_rt_loop.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, PROD, CONS, ctypes.c_void_p, dbl_p]
    return lib


def compile_urdf_native(urdf_path: str, out_path: str, floating: bool = True) -> str:
    """Compile a URDF file natively into a ``.dwbcm`` artifact at out_path."""
    err = ctypes.create_string_buffer(512)
    rc = get_lib().dwbc_compile_urdf(str(urdf_path).encode(), 1 if floating else 0,
                                     str(out_path).encode(), err, 512)
    if rc != 0:
        raise RuntimeError(f"native compile failed: {err.value.decode()}")
    return out_path


def load_dwbcm(path: str) -> RobotModel:
    """Deserialize a native ``.dwbcm`` artifact (native/src/model_io.cpp) into a
    RobotModel."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def take(n):
        nonlocal off
        out = raw[off:off + n]
        if len(out) != n:
            raise ValueError(f"{path}: truncated .dwbcm")
        off += n
        return out

    def ints(n):
        return np.frombuffer(take(8 * n), dtype=np.int64)

    if take(8) != b"DWBCM001":
        raise ValueError(f"{path}: not a .dwbcm artifact (bad magic)")
    floating, nbody, ndof, model_dof = (int(v) for v in ints(4))

    def take_str():
        return take(int(ints(1)[0])).decode()

    def arr(dtype, *shape):
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return np.frombuffer(take(n), dtype=dtype).reshape(shape).copy()

    name = take_str()
    body_names = tuple(take_str() for _ in range(nbody))
    joint_names = tuple(take_str() for _ in range(nbody))
    parent = arr(np.int32, nbody)
    q_index = arr(np.int32, nbody)
    X_T_rot = arr(np.float64, nbody, 3, 3)
    X_T_trans = arr(np.float64, nbody, 3)
    axis = arr(np.float64, nbody, 3)
    mass = arr(np.float64, nbody)
    com = arr(np.float64, nbody, 3)
    inertia = arr(np.float64, nbody, 3, 3)
    lower, upper, effort, velocity, damping = (arr(np.float64, model_dof) for _ in range(5))
    fixed = {}
    for _ in range(int(ints(1)[0])):
        nm = take_str()
        body = int(ints(1)[0])
        fixed[nm] = (body, arr(np.float64, 3, 3), arr(np.float64, 3))

    # dof j moves body i iff the body owning dof j is on the path base → i;
    # the base's six move every body when floating
    amask = np.zeros((nbody, ndof))
    for i in range(nbody):
        if floating:
            amask[i, 0:6] = 1.0
        k = i
        while k > 0:
            amask[i, q_index[k]] = 1.0
            k = parent[k]

    return RobotModel(
        name=name, floating=bool(floating), nbody=nbody, ndof=ndof,
        nq=ndof + 1 if floating else ndof, model_dof=model_dof,
        body_names=body_names, joint_names=joint_names,
        parent=parent, q_index=q_index, X_T_rot=X_T_rot, X_T_trans=X_T_trans,
        axis=axis, mass=mass, com=com, inertia=inertia, ancestor_mask=amask,
        joint_limit_lower=lower, joint_limit_upper=upper,
        effort_limit=effort, velocity_limit=velocity, damping=damping,
        fixed_frames=fixed, total_mass=float(mass.sum()), gravity=GRAVITY.copy(),
    )


def golden_diff_native(path: str, mat: np.ndarray) -> float:
    """Frobenius distance of ``mat`` from the golden file at path, read by the
    native reader (column-major golden format)."""
    m = np.asfortranarray(np.atleast_2d(np.asarray(mat, np.float64)))
    ptr = m.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    return get_lib().dwbc_golden_diff(str(path).encode(), ptr, m.shape[0], m.shape[1])


def run_rt_loop(period_us: int, ticks: int, state_dim: int, out_dim: int,
                producer, consumer) -> dict:
    """Run the native real-time loop with Python callbacks: a C++ thread calls
    producer(state, tick) every period_us for ``ticks`` ticks and publishes
    the state; another calls consumer(state, out) on each new state it reads.
    Returns the consumer's latency (avg / min / max / p99 µs), the ticks it
    consumed and the producer's missed deadlines.

    The callbacks run on the loop's threads, which take the GIL for them.  An
    exception in either is stored (the first one), the callbacks stop
    calling into Python code, and it is raised here once the loop returns:
    ctypes would print and swallow it, and the loop would carry on."""
    failed = []
    lock = threading.Lock()

    def guard(fn, *args):
        if failed:
            return
        try:
            fn(*args)
        except BaseException as e:  # re-raised below, after the native loop returns
            with lock:
                failed.append(e)

    def prod_cb(state_ptr, tick, _):
        guard(producer, np.ctypeslib.as_array(state_ptr, shape=(state_dim,)), int(tick))

    def cons_cb(state_ptr, out_ptr, _):
        guard(consumer, np.ctypeslib.as_array(state_ptr, shape=(state_dim,)),
              np.ctypeslib.as_array(out_ptr, shape=(out_dim,)))

    stats = (ctypes.c_double * 6)()
    prod, cons = PROD(prod_cb), CONS(cons_cb)   # referenced until the loop returns
    rc = get_lib().dwbc_run_rt_loop(state_dim, out_dim, period_us, ticks, prod, cons, None,
                                    stats)
    if failed:
        raise failed[0]
    if rc != 0:
        raise RuntimeError(f"dwbc_run_rt_loop returned {rc}")
    return dict(avg_us=stats[0], min_us=stats[1], max_us=stats[2], p99_us=stats[3],
                ticks=int(stats[4]), missed_deadlines=int(stats[5]))


# the IPM iterations of a warm-started tick (the serving chain's, as in
# chip_smoke.py and bench.py's warm loop)
WARM_ITERS = 7


class TickConsumer:
    """A ``run_rt_loop`` consumer that serves a port tick, unbatched.

    The state vector is [q (nq), q̇ (ndof), f* of each level, the producer's
    tick number]; ``out`` receives τ_cmd.  The first consumed state is
    solved cold at the tick's own IPM budget (``cfg.qp_iters``), every later
    one warm at ``WARM_ITERS`` from the previous (x, λ).  Build it — the tick
    and its warm carry — in the calling thread; the loop's consumer thread
    only calls it.  Each consumed state and its ``qp_error`` are kept for
    checking.  A call is the span ``dwbc.consumer`` and its two device reads
    (τ_cmd, ``qp_error``) ``dwbc.consumer.read``, their request (this
    consumer, the call's index)."""

    def __init__(self, tick):
        self.tick = tick
        self.nq, self.ndof = tick.model.nq, tick.model.ndof
        self.level_dofs = tuple(sum(T.TASK_DOF[spec[0]] for spec in lvl)
                                for lvl in tick.cfg.task_specs)
        self.state_dim = self.nq + self.ndof + sum(self.level_dofs) + 1
        self.out_dim = tick.model.model_dof
        self.warm = tick.init_warm()
        self.states, self.qp_error = [], []
        self._seq = tracing.sequence()

    def split(self, state):
        """(q, q̇, f* per level) of one state vector, as numpy views."""
        q, rest = state[:self.nq], state[self.nq:]
        qd, rest = rest[:self.ndof], rest[self.ndof:]
        fs, off = [], 0
        for t in self.level_dofs:
            fs.append(rest[off:off + t])
            off += t
        return q, qd, tuple(fs)

    def __call__(self, state, out):
        with tracing.request(self._seq, len(self.states)), tracing.span("dwbc.consumer"):
            q, qd, fs = self.split(state)
            res, self.warm = self.tick._tick_impl(q, qd, fs, warm=self.warm,
                                                  qp_iters=WARM_ITERS if self.states else None)
            with tracing.span("dwbc.consumer.read"):
                out[:] = res.torque_cmd.cpu().numpy()
                error = bool(res.qp_error)
            self.states.append(state.copy())
            self.qp_error.append(error)
