#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (libdwbc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. environment: versions, the card's name and power limit, TF32 off;
2. build: nvcc builds the two tick kernels from csrc/ (sm_90a);
3. each kernel against its plain version at the serving inputs (batch 1024,
   seed 0): every field of tick_prestage on the card vs the plain prestage
   in float64 on the CPU, each within its limit (tick_cuda.PRE_TOL; τ_grav
   well inside bench.py's 0.05 Nm); every output of tick_qpchain fed the
   same prestage cast to float32 vs the plain qpchain in float32 on the CPU
   (tick_cuda.QP_TOL), cold and warm; and the two kernels chained vs the
   plain float64 tick, every lane (CHAIN_TOL);
4. the serving path through entry.py's FusedTick(backend="cuda"): a cold-start
   tick at 12 IPM iterations, then warm ticks at 7 carrying (x, λ), at batch
   1024, then one unbatched tick; every output finite, no lane with
   qp_error, gap and primal residual ≤ 1e-3, τ_grav within 0.05 Nm and τ_cmd
   within 0.05 Nm of a float64 CPU tick on four lanes, and the launch counts
   of both kernels exactly one per tick;
5. times with CUDA events: each kernel against its plain version run on the
   card, at batch 1024 and batch 1, and the warm chain's solves/s.

The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B = 1024
K = 16                     # ticks of the serving chain: 1 cold-start + 15 warm
COLD_ITERS, WARM_ITERS = 12, 7
TAU_GRAV_TOL = 0.05        # bench.py's truth guard on τ_grav (Nm)
TAU_CMD_TOL = 5e-2         # the repo's bar for τ_cmd across solvers (Nm)
# the two kernels chained vs the plain float64 tick, max over the batch:
# about four times the plain float32 tick's own error on these inputs
# (2.6e-3 Nm, 2.6e-3 Nm, 1.7e-2 N against |τ_task| ≤ 9, |τ_cmd| ≤ 54,
# |contact force| ≤ 571)
CHAIN_TOL = {"torque_task": 1e-2, "torque_cmd": 1e-2, "contact_force": 7e-2}
QP_FAIL = 1e-3             # PipelineConfig.qp_fail_gap / qp_fail_pres


def maxerr(a, b):
    return float((a.detach().double().cpu() - b.detach().double().cpu()).abs().max())


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time(fn, reps):
    """Mean ms per call over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def interleaved(plain, kernel, reps_plain, reps_kernel):
    """(plain ms, kernel ms), each the mean of two runs taken in the order
    plain, kernel, kernel, plain."""
    p1 = cuda_time(plain, reps_plain)
    k1 = cuda_time(kernel, reps_kernel)
    k2 = cuda_time(kernel, reps_kernel)
    p2 = cuda_time(plain, reps_plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def main():
    # ------------------------------------------------------ 1. environment
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import _build
    from libdwbc_tpu_torch.ops.tick_cuda import PRE_TOL, QP_TOL, TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    print(f"card: {card}")
    dev = torch.device("cuda", 0)

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    so, log = _build.build(verbose=True)
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")

    # ------------------------------------ 3. each kernel vs its plain version
    model = RobotModel.load(str(entry.MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=COLD_ITERS)
    q, _, fstars = entry._example_inputs(model)
    rng = np.random.default_rng(0)
    qs = np.tile(q, (B, 1)).astype(np.float32)
    qs[:, 6:39] += 0.02 * rng.standard_normal((B, 33)).astype(np.float32)
    fs = [np.tile(f, (B, 1)).astype(np.float32)
          + 0.05 * rng.standard_normal((B, f.shape[0])).astype(np.float32)
          for f in fstars]

    plain64 = TickProgram(model, cfg, "cpu", torch.float64)
    plain32 = TickProgram(model, cfg, "cpu", torch.float32)
    kern = TickKernels(TickProgram(model, cfg, dev, torch.float32))
    q_el = torch.as_tensor(np.ascontiguousarray(qs.T))
    fs_el = [torch.as_tensor(np.ascontiguousarray(f.T)) for f in fs]

    def pre_errs(pre, ref):
        """Max abs error of every prestage field (Ntorques: over the levels)."""
        err = {}
        for name in PRE_TOL:
            got, want = pre[name], ref[name]
            pairs = zip(got, want) if name == "Ntorques" else [(got, want)]
            err[name] = 0.0
            for g, w in pairs:
                assert torch.isfinite(g).all(), f"non-finite {name}"
                err[name] = max(err[name], maxerr(g, w))
        return err

    pre64 = plain64.prestage(q_el.double())
    pre_k = kern.prestage(q_el.to(dev))
    torch.cuda.synchronize()
    pre_err = pre_errs(pre_k, pre64)
    pre32_own = plain32.prestage(q_el)
    plain32_err = pre_errs(pre32_own, pre64)
    print("tick_prestage vs plain float64 (max abs err, [plain float32's own] "
          "<= limit): " + "  ".join(f"{k} {v:.3e} [{plain32_err[k]:.3e}] <= {PRE_TOL[k]:g}"
                                   for k, v in pre_err.items()))
    for name, tol in PRE_TOL.items():
        assert pre_err[name] <= tol, (name, pre_err[name], tol)
    assert pre_err["torque_grav"] <= TAU_GRAV_TOL

    pre32 = {k: ([t.float() for t in v] if isinstance(v, list) else v.float())
             for k, v in pre64.items()}
    pre32_dev = {k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
                 for k, v in pre32.items()}
    fs_dev = [f.to(dev) for f in fs_el]
    qp_err = {}
    ref_cold = plain32.qpchain(pre32, fs_el, None, COLD_ITERS)
    ker_cold = kern.qpchain(pre32_dev, fs_dev, None, COLD_ITERS)
    warm_cpu = ref_cold["warm_out"]
    ref_warm = plain32.qpchain(pre32, fs_el, warm_cpu, WARM_ITERS)
    ker_warm = kern.qpchain(pre32_dev, fs_dev,
                            [(x.to(dev), l.to(dev)) for x, l in warm_cpu], WARM_ITERS)
    torch.cuda.synchronize()
    for tag, ref, ker in (("cold", ref_cold, ker_cold), ("warm", ref_warm, ker_warm)):
        for name in list(QP_TOL) + ["qp_gap", "qp_primal_res"]:
            assert torch.isfinite(ker[name]).all(), f"tick_qpchain: non-finite {name}"
            qp_err[f"{tag}.{name}"] = maxerr(ker[name], ref[name])
        for name in ("qp_gap", "qp_primal_res"):
            assert float(ker[name].max()) <= QP_FAIL, (tag, name, float(ker[name].max()))
    print("tick_qpchain vs plain float32 (max abs err): "
          + "  ".join(f"{k} {v:.3e}" for k, v in qp_err.items()))
    for tag in ("cold", "warm"):
        for name, tol in QP_TOL.items():
            assert qp_err[f"{tag}.{name}"] <= tol, (tag, name, qp_err[f"{tag}.{name}"], tol)

    # the two kernels chained (the kernel's prestage into the QP chain) vs
    # the plain float64 tick, every lane
    chain_k = kern.qpchain(pre_k, fs_dev, None, COLD_ITERS)
    chain64 = plain64.qpchain(pre64, [f.double() for f in fs_el], None, COLD_ITERS)
    chain32 = plain32.qpchain(pre32_own, fs_el, None, COLD_ITERS)
    chain_err = {name: maxerr(chain_k[name], chain64[name]) for name in CHAIN_TOL}
    print("tick_prestage → tick_qpchain vs plain float64 tick (max abs err, "
          "[plain float32's own] <= limit): " + "  ".join(
              f"{k} {v:.3e} [{maxerr(chain32[k], chain64[k]):.3e}] <= {CHAIN_TOL[k]:g}"
              for k, v in chain_err.items()))
    for name, tol in CHAIN_TOL.items():
        assert chain_err[name] <= tol, (name, chain_err[name], tol)

    # ------------------------------------------------ 4. the serving path
    model, tick = entry._model_and_tick(dev, qp_iters=COLD_ITERS)
    assert isinstance(tick, FusedTick) and tick.backend == "cuda"
    q_d = torch.as_tensor(qs, device=dev)
    qd_d = torch.zeros((B, model.ndof), device=dev)
    fs_d = tuple(torch.as_tensor(f, device=dev) for f in fs)
    md = model.model_dof

    def step(qq, warm, iters):
        res, warm = tick._tick_impl(qq, qd_d, fs_d, warm=warm, qp_iters=iters)
        qq = qq.clone()
        qq[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd[:, :md])
        return res, qq, warm

    for k in tick.kernels.launches:
        tick.kernels.launches[k] = 0
    qq, warm = q_d, tick.init_warm((B,))
    results = []
    for k in range(K):
        res, qq, warm = step(qq, warm, COLD_ITERS if k == 0 else WARM_ITERS)
        results.append(res)
    res1 = tick._tick_impl(q_d[0], qd_d[0], tuple(f[0] for f in fs_d))
    torch.cuda.synchronize()
    launches = dict(tick.kernels.launches)
    print(f"serving path: {K} ticks at batch {B} + 1 unbatched tick, launches {launches}")
    assert launches == {"tick_prestage": K + 1, "tick_qpchain": K + 1}, launches

    gap_max = max(float(r.qp_gap.max()) for r in results)
    pres_max = max(float(r.qp_primal_res.max()) for r in results)
    n_err = sum(int(r.qp_error.sum()) for r in results)
    for r in results + [res1]:
        for name, v in r._asdict().items():
            if v.dtype != torch.bool:
                assert torch.isfinite(v).all(), f"non-finite {name}"
    assert results[-1].torque_cmd.shape == (B, md)
    assert res1.torque_cmd.shape == (md,) and not bool(res1.qp_error)
    assert [tuple(x.shape) + tuple(l.shape) for x, l in warm] == [
        (B, nv, B, m) for nv, m in tick.prog.plan.qp_dims]
    print(f"serving path: gap max {gap_max:.3e}  pres max {pres_max:.3e}  "
          f"qp_error lanes {n_err}  unbatched τ_cmd[0:3] "
          f"{res1.torque_cmd[:3].tolist()}")
    assert n_err == 0 and gap_max <= QP_FAIL and pres_max <= QP_FAIL

    # truth guard: tick 0 on four lanes against a float64 CPU tick
    _, ref_tick = entry._model_and_tick("cpu", dtype=torch.float64,
                                        qp_iters=COLD_ITERS, backend="torch")
    r64, _ = ref_tick._tick_impl(qs[:4].astype(np.float64), np.zeros((4, model.ndof)),
                                 tuple(f[:4].astype(np.float64) for f in fs),
                                 warm=ref_tick.init_warm((4,)))
    d_grav = maxerr(results[0].torque_grav[:4], r64.torque_grav)
    d_cmd = maxerr(results[0].torque_cmd[:4], r64.torque_cmd)
    print(f"truth guard (4 lanes vs float64 CPU): τ_grav {d_grav:.3e}  τ_cmd {d_cmd:.3e}")
    assert d_grav <= TAU_GRAV_TOL and d_cmd <= TAU_CMD_TOL, (d_grav, d_cmd)

    # ------------------------------------------------------------ 5. times
    plain_dev = TickProgram(model, cfg, dev, torch.float32)
    times = {}
    for nb in (B, 1):
        qe = q_el[:, :nb].contiguous().to(dev)
        fe = [f[:, :nb].contiguous().to(dev) for f in fs_el]
        pre_buf = kern.prestage_packed(qe)
        pre_d = kern.unpack_pre(pre_buf)
        w_d = kern.unpack_result(*kern.qpchain_packed(pre_buf, fe, None, COLD_ITERS))["warm_out"]
        times[("tick_prestage", nb)] = interleaved(
            lambda: plain_dev.prestage(qe), lambda: kern.prestage_packed(qe), 2, 5)
        times[("tick_qpchain", nb)] = interleaved(
            lambda: plain_dev.qpchain(pre_d, fe, w_d, WARM_ITERS),
            lambda: kern.qpchain_packed(pre_buf, fe, w_d, WARM_ITERS), 2, 5)
        for (name, b_), (p, kt) in times.items():
            if b_ == nb:
                print(f"time {name} batch {nb}: kernel {kt:.3f} ms  plain (torch on the "
                      f"card) {p:.3f} ms  [{card}]")

    def chain():
        qq_, w_ = q_d, warm
        for _ in range(K - 1):
            _, qq_, w_ = step(qq_, w_, WARM_ITERS)

    chain_ms = cuda_time(chain, 2)
    solves = B * (K - 1) / (chain_ms / 1e3)
    single_ms = cuda_time(lambda: tick._tick_impl(q_d[0], qd_d[0],
                                                  tuple(f[0] for f in fs_d)), 10)
    print(f"warm chain: {K - 1} ticks at batch {B} in {chain_ms:.3f} ms -> "
          f"{solves:.1f} solves/s; unbatched cold tick {single_ms:.3f} ms  [{card}]")

    record = {"kernels": [
        {"name": "tick_prestage", "route": "cuda",
         "source": "libdwbc_tpu_torch/csrc/tick_prestage.cu",
         "replaces": "libdwbc_tpu/wbc/fused.py:364",
         "launches": launches["tick_prestage"],
         "max_abs_err": pre_err["torque_grav"],
         "ms": times[("tick_prestage", B)][1],
         "plain_ms": times[("tick_prestage", B)][0]},
        {"name": "tick_qpchain", "route": "cuda",
         "source": "libdwbc_tpu_torch/csrc/tick_qpchain.cu",
         "replaces": "libdwbc_tpu/wbc/fused.py:364",
         "launches": launches["tick_qpchain"],
         "max_abs_err": max(qp_err["cold.torque_cmd"], qp_err["warm.torque_cmd"]),
         "ms": times[("tick_qpchain", B)][1],
         "plain_ms": times[("tick_qpchain", B)][0]},
    ]}
    print(json.dumps(record))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
