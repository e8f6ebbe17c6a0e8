#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (libdwbc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. environment: versions, the card's name and power limit, TF32 off;
2. build: nvcc builds the four kernels from csrc/ (sm_90a), one nvcc per
   source, all started together, with ptxas's register and spill report;
3. the fused tick's kernels against their plain versions at the serving
   inputs (batch 1024, seed 0): every field of tick_prestage on the card vs
   the plain prestage in float64 on the CPU, each within its limit
   (tick_cuda.PRE_TOL; τ_grav well inside bench.py's 0.05 Nm); every output
   of tick_qpchain fed the same prestage cast to float32 vs the plain
   qpchain in float32 on the CPU (tick_cuda.QP_TOL), cold and warm; and the
   two kernels chained vs the plain float64 tick, every lane (CHAIN_TOL);
4. the compiled tick's kernels against their plain versions, on the inputs
   one CompiledTick(backend="cuda") tick gives them at batch 1024:
   psd_inverse on A (n = 39) and W + V2ᵀV2 (n = 33) vs the plain version in
   float64 on the CPU (relative, linalg_cuda.PSD_INV_RTOL; the output
   exactly symmetric), and qp_solve on the tick's three QPs (n = 12, 9, 6;
   m = 86, 33 mirrored rows) vs the plain version in float32 on the CPU,
   cold at 12 iterations and warm at 7 (qp_cuda.QP_SOLVE_TOL on x, λ, gap
   and primal residual);
5. the serving paths through entry.py, each with its launch counts set to 0
   just before it and read just after: FusedTick(backend="cuda") and
   CompiledTick(backend="cuda"), each a cold-start tick at 12 IPM iterations,
   then warm ticks at 7 carrying (x, λ), at batch 1024, then one unbatched
   tick; every output finite, no lane with qp_error, gap and primal residual
   ≤ 1e-3; per tick exactly one launch of each fused kernel, and exactly two
   of psd_inverse and three of qp_solve;
6. the truth guard on four lanes: FusedTick(cuda) against the plain fused
   tick in float64 on the CPU, and both CUDA ticks against the port's
   CompiledTick in float64 on the CPU, the independent formulation; τ_grav
   and τ_cmd within 0.05 Nm;
7. times with CUDA events at batch 1024 and batch 1 (qp_solve also at
   4096, the tick's batch tiled): each kernel against its plain version
   run on the card (and replayed from a captured CUDA graph, without the
   wrapper's host time), psd_inverse against torch.linalg.inv, and the
   warm chains' solves/s of both ticks; CompiledTick's warm tick split
   into qp_solve's device time (CUDA events around its launches), the
   device's other kernels and the host alone (the device's busy time by
   torch.profiler);
8. the masked kernels against their plain versions, on the first 1024
   lanes of the masked sweep (entry._masked_inputs: the two feet as
   candidates, the hypotheses both / left / right cycled over the lanes),
   each error per hypothesis: every field of tick_prestage (masked) vs the
   plain masked prestage in float64 on the CPU (tick_cuda.PRE_TOL_MASKED;
   crow_mask and active_cdof exactly; in every single-support lane NwJw and
   the dead foot's rows of J̄ᵀ exact zeros), tick_qpchain (masked) fed that
   prestage as float32 vs the plain float32 qpchain, cold and warm
   (QP_TOL_MASKED), and the two chained vs the plain float64 tick
   (CHAIN_TOL_MASKED);
9. the masked serving path at its full width, its launch counts set to 0
   just before it and read just after: make_control_loop(FusedTick(
   masked=True, backend="cuda"), gap_fallback=1e-3) over B = 4096
   scenarios and K = 32 ticks (tick 0 cold at 12 iterations, then warm at
   7, q[:, 6:39] += 1e-6·tanh(τ_cmd) between ticks): every output finite,
   no qp_error, primal residual ≤ 1e-3, launches exactly K + refined ticks
   of tick_qpchain and as many of tick_prestage less the re-solves that took
   their warm tick's prestage, peak device memory; then the same chain without the fallback,
   whose qp_gap_max is printed, not asserted;
10. the masked truth guard on 6 lanes, 2 per hypothesis: tick 0 of
   FusedTick(masked, cuda) vs the plain masked fused tick and vs the port's
   MaskedTick (the independent formulation), both in float64 on the CPU;
   τ_grav and τ_cmd within 0.05 Nm;
11. times of the masked kernels at B = 4096 and B = 1 against their plain
   versions on the card, and the solves/s of the fallback loop and of the
   plain warm chain at B = 4096;
12. the servo'd kernels against their plain versions on the servo'd inputs
   (entry._servo_inputs: batch 1024, seed 0, moving states, a pelvis 6D and
   a link-15 rotation servo on per-lane clocks before, inside and after
   their trajectories): tick_prestage (servo) vs the plain servo'd prestage
   in float64 on the CPU (every field within PRE_TOL, the servo'd f* and
   the task-link states within tick_cuda.SERVO_TOL), tick_qpchain reading
   its f* from a servo'd prestage buffer vs the plain float32 qpchain, cold
   and warm, and the two chained vs the plain float64 servo'd tick, each
   lane within the larger of QP_TOL (CHAIN_TOL) and tick_cuda.SERVO_OWN ×
   its own float32 distance from float64, at most tick_cuda.
   SERVO_LANES_OVER of the lanes beyond; then the same on the masked
   sweep's first 1024 lanes with the same servos (the *_MASKED limits);
13. the servo'd serving path at full width, its launch counts set to 0
   just before each run and read just after: make_control_loop(FusedTick(
   backend="cuda"), transition=forward_dynamics_transition(CompiledTick(
   backend="cuda")), K = 150, dt = 1 ms, warm, 7 warm iterations,
   gap_fallback 1e-3) over B = 1024 standing robots, each lane's pelvis
   stepping 1 cm in its own horizontal direction over 0.12 s with the torso
   held, then one unbatched robot (the 1 kHz lane): every output finite,
   launches exactly 2 × (K + refined ticks) of the tick kernels and K of
   psd_inverse, on every lane the final pelvis error below half the initial
   one; over its first K_CMP ticks, the lane-ticks flagged with qp_error no
   more than those of the same loop run for K_CMP ticks through the plain
   float32 tick on the card (within the spread of two rollouts) and no
   more, at no larger primal residual, than through the plain float32 tick
   on the JAX package's IPM recurrence (beside them the same K_CMP ticks in
   float64 on the card, recorded); the peak device memory and the per-tick
   split into ticks and transition;
14. the truth guard on 4 servo'd lanes: FusedTick(cuda) tick 0 vs the plain
   servo'd fused tick and vs CompiledTick(servos=), both float64 on the CPU;
   τ_grav within 0.05 Nm, τ_cmd per lane within 0.05 Nm, or twice the plain
   float32 tick's own error where that exceeds 0.05 Nm;
15. times of the servo'd kernels at B = 1024 and B = 1 against their plain
   versions on the card, and their bounds (servo_extra_flops);
16. MaskedTick(backend="cuda") in float32 through phase 9's sweep
   (make_control_loop, B = 4096, K = 32, gap_fallback 1e-3), its launch
   counts set to 0 just before and read just after: every output finite;
   each qp_solve call of the loop also solved in float64 on the card from
   the same inputs and warm start (the dense-H IPM's plain version), and
   the torque that the float32 kernel's solution moves against that
   solve's, C[:33]·Δx (the torque-limit block is the QP's torque map),
   within MASKED_QP_TAU_TOL on every lane of every call, per hypothesis; the
   same loop in float64 on the card beside it, τ_cmd per hypothesis
   recorded;
17. the general-plan kernels against their plain versions at batch 1024
   (general_kernels): BASELINE's config 3 (single support, a swing-foot
   third level; entry._swing_inputs), and the mixed task set
   (entry._mixed_tasks_config: a
   whole-body COM level, a custom-frame position and a rotation task in
   one level, a COM-frame position level) on the two 6D feet, static on
   phase 3's states and masked on the masked sweep's first 1024 lanes (per
   hypothesis); each within tick_cuda.GENERAL_TOL;
18. config 3's serving path (swing_serving), its launch counts set to 0
   just before and read just after: FusedTick(backend="cuda"), a cold tick
   at 12 iterations, 15 warm ticks at 7, one unbatched tick; every output
   finite, no qp_error, gap and primal residual ≤ 1e-3, exactly one launch
   of each tick kernel per tick; the truth guard on 4 lanes against the
   plain fused tick and CompiledTick in float64 on the CPU; the kernels'
   times at B = 1024 and 1, the warm chain's solves/s, the unbatched warm
   tick against the 1 ms bar;
19. config 3's servo'd closed loop (swing_loop), the counterpart of
   tests/test_servo.py::test_on_device_swing_tracking_rollout: B = 1024
   robots, the pelvis and torso held and the swing foot lifted 1.5 cm over
   K = 150 ticks of 1 ms, through make_control_loop(FusedTick(cuda),
   forward_dynamics_transition(CompiledTick(cuda)), warm, 7 iterations,
   gap_fallback 1e-3), its launch counts set to 0 just before and read
   just after; on every lane swing progress > 0.5, the foot's |Δx|, |Δy| <
   0.05 m and the pelvis height within 0.03 m; launches exactly 2 × (K +
   refined ticks) of the tick kernels and K of psd_inverse; over its first
   K_CMP ticks, flagged lane-ticks no more than through the plain float32
   tick on the card for K_CMP ticks (its foot and pelvis held the same
   way), the float64 loop beside it; the time per tick split into ticks and
   transition;
20. the kernels of the plans taken last against their plain versions at
   batch 1024 (new_plan_kernels, general_kernels' checks): the
   hands-and-feet fixture (6D feet, POINT hands on links 23 and 31;
   entry._hands_feet_config) static and masked (its four contacts as
   candidates, per hypothesis of entry.HANDS_HYPOTHESES), LINE feet, and
   the flagship without a torque limit; each within tick_cuda.GENERAL_TOL,
   NwJw through tick_cuda.nwjw_determined where its basis follows roundoff,
   the hands' τ_cmd and contact force against float64 printed, not held
   (the contact block's flat face);
21. the hands-and-feet serving path (hands_serving): make_control_loop(
   FusedTick(cuda), warm, gap_fallback 1e-3) at batch 1024, tick 0 cold at
   the configuration's 25 iterations, 15 warm ticks at 7, then one
   unbatched tick, its launch counts set to 0 just before and read just
   after (two per tick and re-solve, less the tick_prestage of each
   re-solve that took its warm tick's prestage); on every lane and tick no qp_error,
   gap and primal residual ≤ 1e-3, |τ_cmd| ≤ 300 Nm + 1e-3, the normal
   forces summing below −400 N; the truth guard on 4 lanes against the
   plain float64 tick on the CPU (τ_grav); times, the warm chain's
   solves/s and the unbatched warm tick;
22. the masked four-candidate sweep (hands_masked_loop): make_control_loop(
   FusedTick(masked, cuda), gap_fallback 1e-3) over B = 4096 scenarios of
   entry._hands_masked_inputs and K = 32 ticks, its launch counts set to 0
   just before and read just after: no qp_error, primal residual ≤ 1e-3,
   the normal forces below −400 N; times and solves/s;
23. the kernels at ReducedTick's shapes against their plain versions
   (reduced_kernels), on the inputs one ReducedTick(backend="cuda") tick
   gives them at batch 1024 — the flagship's serving inputs (psd_inverse
   on A at 39, A_R at 24 and the reduced W + V2ᵀV2 at 18; qp_solve on
   (n, m) = (12, 44), (12, 44), (6, 44), 12 mirrored rows) and config 3's
   (A at 39, A_R at 18; (6, 22) twice, 6 mirrored): psd_inverse vs the
   plain version in float64 on the CPU (PSD_INV_RTOL), qp_solve vs the
   plain version in float32 on the CPU, cold at 12 iterations and warm at
   7, within QP_SOLVE_TOL or, where larger, REDUCED_QP_OWN × the plain
   float32 version's own error against a float64 solve (the primal
   residual within float32 roundoff of the rows' scale), on every lane the
   plain float32 version solves; on the others the kernel may leave no
   more unsolved, within phase 13's spread;
24. the reduced serving path (reduced_serving): ReducedTick(backend="cuda")
   through entry._model_and_tick(reduced=True) on the flagship and on
   config 3 (swing=True), a cold tick at 12 iterations, 15 warm ticks at 7
   carrying (x, λ) at batch 1024, one unbatched tick, its launch counts set
   to 0 just before and read just after: every output finite, exactly 3
   psd_inverse and 3 qp_solve launches per tick on the flagship (2 and 2
   on config 3); the flagship with no qp_error and gap and primal residual
   ≤ 1e-3; config 3, whose nc resultant QP float32 assembles from noise,
   with no more flagged lane-ticks than the plain float32 tick on the card
   (phase 13's spread) and none in float64 on the card; the truth guard on
   4 lanes (τ_grav and τ_cmd within 0.05 Nm of ReducedTick in float64 on
   the CPU, τ_grav of CompiledTick in float64 too; the cross-formulation
   τ_cmd printed);
25. the reduced path's times: its warm chain's solves/s at batch 1024
   beside CompiledTick(cuda)'s on the same inputs, the unbatched warm tick
   against the 1 ms bar, the warm tick's device time by torch.profiler
   split into qp_solve, psd_inverse, the other kernels and the host alone,
   and each kernel at the reduced shapes at batch 1024 and 1 against its
   plain version on the card (psd_inverse also against torch.linalg.inv).
26. the controller facade on the card (facade_phase): RobotData() — the
   card, float32, backend cuda — on the flagship (entry._facade) and the
   reference unit tests' standing cases 1 and 2 (entry._facade_cases),
   each run's launch counts set to 0 just before it and read just after:
   the OSF-HQP tick (CalcContactConstraint returns 1, qp_error_ 0, every
   output finite; exactly 2 psd_inverse — A at n = 39, W + V2ᵀV2 at 33 —
   and 3 qp_solve launches), the Reduced* chain (3 + 3: A_R, both
   W + V2ᵀV2; the pelvis level, the nc resultant, the redistribution), the
   LQP, JACC, _R and _R_NC methods (3 psd_inverse from the reduced
   dynamics; each of their QPs printed with its (n, m) and equality rows,
   and qp_solve launched for exactly those the routing rule takes: the
   reduced cascade's (18, 92) level, whose launch is held against the
   plain version on the same inputs by phase 23's rule, and the cascade's
   y against the same facade with the plain version in the kernel's
   place; the rest have equality rows or more than 24 variables); then
   ChangeLinkToFixedJoint on the right wrist (link 33) and a tick
   (psd_inverse at n = 38 and 32), and config 3 (2 + 3: A and W at 33, the
   three level QPs, no redistribution QP); the truth guard — τ_grav within
   0.05 Nm of the port's facade in float64 on the CPU, τ_cmd within 0.05
   Nm or twice the plain float32 facade's own error (phase 14's rule) — and
   τ_task, each QP's x and each acceleration method's torque within
   FACADE_OWN × the plain float32 facade's own distance from float64 on
   the CPU (phase 23's rule);
27. the facade's times (facade_times): ms per method and per OSF-HQP tick
   on the flagship and config 3, median of FACADE_REPS synced calls after
   a warm-up (the LQP and JACC methods one synced call each), the tick
   against the 1 ms bar (printed, not held), its device-busy share by
   torch.profiler with qp_solve's and psd_inverse's shares, and each
   kernel's launches at the facade's shapes at batch 1 held against its
   plain version (psd_inverse within PSD_INV_RTOL, qp_solve by phase 23's
   rule) and timed against it on the card (psd_inverse also against
   torch.linalg.inv);
28. the bridges and the sweep (bridges_phase): RlWBCBridge() on the card
   for K_RL ticks from MuJoCo-layout states (2 + 3 launches a tick, finite,
   no qp_error_), BatchedRlWBCBridge(B_BRIDGE) on CompiledTick(cuda) (2 + 3
   per solve, no lane with qp_error, the truth guard on 4 lanes against the
   port's RlWBCBridge in float64 on the CPU, solves/s), and
   hypothesis_sweep at B_BRIDGE over the two feet's three modes (6 + 7
   launches: each mode's CompiledTick(cuda); 2 lanes per mode against the
   port's sweep in float64 on the CPU, τ within 0.05 Nm and the same
   argmin over those lanes; solves/s);
29. the scenario mesh on the card (mesh_phase): an NCCL process group of
   one rank (tcp://127.0.0.1, a free port), a 1 × 1 ('hyp', 'roll') mesh,
   and parallel/mesh.py::sharded_batch_solver over FusedTick(backend="cuda")
   on a 32 × 32 grid of the flagship (entry._grid_inputs: the standing
   state with 0.01·N(0,1) on the joints, seed 0), static and then masked
   (both feet, left, right cycled over the lanes): a cold step at 12
   iterations and 15 warm steps at 7, the launch counts set to 0 just
   before and read just after (exactly 2 per step); every lane's τ_cmd bit
   for bit one unsharded _tick_impl of the same chain on the flattened
   batch and each step's best its argmin, the cold step within TAU_CMD_TOL
   of the plain float32 tick; the warm steps' solves/s beside the
   unsharded chain's;
30. the native host runtime (native_phase): the library built with g++
   from native/, a golden round trip (< 1e-15), and native.run_rt_loop for
   10,000 producer ticks at 500 µs, its consumer serving
   FusedTick(backend="cuda") unbatched through native.TickConsumer (cold
   at 12 iterations, then warm at 7, (x, λ) carried), the launch counts
   set to 0 just before and read just after (exactly 2 per consumed tick):
   no torn read, every τ finite, no qp_error, no exception stored by a
   callback, every τ_cmd bit for bit the same chain called directly on
   the consumed states, the first within TAU_CMD_TOL of the plain float32
   tick; consumed ticks, missed deadlines and the consumer's latency
   against the 1 ms bar printed;
31. the benchmark's hands-and-feet rollout pool (hands_pool): the
   configuration wbcbench/configs/tocabi_hands_feet.json through the
   benchmark's FusedTick(backend="cuda") and make_control_loop (gap_fallback
   1e-3, warm at 7), on the eight draws of wbcbench/traffic/rollouts_b1024.json
   (pool_seed 0, 1024 lanes each): one K = 64 rollout a draw, every call
   (tick 0, each warm tick, each re-solve) against the benchmark's float64
   reference on the card (wbcbench/reference), 4096 lanes a block, from the
   call's own inputs; then tick 0 of eight fresh pools (pool_seed 1-8,
   65,536 cold lane-solves).  Prints the largest τ_grav, τ_task, force_tau and
   task_x deviations of the unflagged lanes and the flagged lanes; holds
   every unflagged lane within the configuration's limits and, in pool 0,
   no served lane-tick flagged.  ``python3 chip_smoke.py hands_pool`` runs
   this phase alone.

Each phase's time is printed as it ends.

Then each kernel's resources (registers and local bytes per thread, shared
bytes and threads per block, resident blocks per SM, ptxas's spill bytes;
qp_solve's problems per block and shared bytes at each of the tick's three
QP shapes).
The last lines are the kernels' JSON record (with each kernel's bound: the
larger of its bytes over the card's memory rate and its operations over the
float32 rate, a tick kernel's operations counted by tick_flops on the plan
as run; its graph-replay time and its resources; the flagship's static and
masked rows also carry the launches of phase 29's mesh steps as
launches_mesh, the static rows phase 30's as launches_rt), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B = 1024
K = 16                     # ticks of the fused serving chain: 1 cold-start + 15 warm
K_C = 6                    # ticks of the compiled serving chain: 1 cold-start + 5 warm
K_SPLIT = 5                # warm ticks per chain profiled by torch.profiler (phases 25, 27)
COLD_ITERS, WARM_ITERS = 12, 7
TAU_GRAV_TOL = 0.05        # bench.py's truth guard on τ_grav (Nm)
TAU_CMD_TOL = 5e-2         # the repo's bar for τ_cmd across solvers (Nm)
# the two kernels chained vs the plain float64 tick, max over the batch:
# about four times the plain float32 tick's own error on these inputs
# (2.6e-3 Nm, 2.6e-3 Nm, 1.7e-2 N against |τ_task| ≤ 9, |τ_cmd| ≤ 54,
# |contact force| ≤ 571)
CHAIN_TOL = {"torque_task": 1e-2, "torque_cmd": 1e-2, "contact_force": 7e-2}
QP_FAIL = 1e-3             # PipelineConfig.qp_fail_gap / qp_fail_pres
# ticks of the host-paced comparison loops of phases 13 and 19 (the plain
# float32 tick, the JAX recurrence, float64), held against the same first
# K_CMP ticks of the kernels' own K = 150 loop
K_CMP = 40
# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the float32 rate outside the tensor cores
# (H100 SXM, NVIDIA's data sheet, at the full 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# operations per solve of the flagship's two stages at a warm tick of 7 IPM
# iterations by XLA's cost analysis of the JAX program
# (benchmarks/sol_tick_r05.json): printed beside tick_flops, which every
# bound takes
SOL_TICK_R05 = (337112.0, 107561.8)
QP_NAMES = ("level 0", "level 1", "redistribution")
B_M, K_M, N_M = 4096, 32, 1024  # masked sweep: scenarios, ticks, lanes held vs plain
GAP_FALLBACK = 1e-3
HYPOTHESES = ("both feet", "left foot", "right foot")   # lane % 3
# MaskedTick's float32 qp_solve against a float64 solve of the same QP from
# the same warm start: the torque its solution moves (Nm), as the warm
# masked lanes of the fused tick's IPM are held (test_torch_csrc_host.py)
MASKED_QP_TAU_TOL = 1e-3
# the masked kernels chained vs the plain float64 tick, per hypothesis:
# about four times the plain float32 tick's own error on these inputs
# (9.4e-3 Nm, 8.7e-3 Nm, 1.4e-2 N at most, single support the worst)
CHAIN_TOL_MASKED = {"torque_task": 4e-2, "torque_cmd": 4e-2, "contact_force": 6e-2}


def maxerr(a, b):
    return float((a.detach().double().cpu() - b.detach().double().cpu()).abs().max())


KERNELS = ("tick_prestage", "tick_qpchain", "psd_inverse", "qp_solve")


def kernel_source(name):
    """The csrc/ kernel of a record's name (tick_prestage_hands_masked →
    tick_prestage)."""
    return next(k for k in KERNELS if name.startswith(k))


def ptxas_spills(log):
    """{kernel: (spill store bytes, spill load bytes)} from nvcc's
    -Xptxas=-v log (a templated kernel: its instance that spills most)."""
    out, cur = {}, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            cur = line.split("Function properties for")[-1].strip()
        elif "spill stores" in line:
            words = line.replace(",", " ").split()
            st, ld = (int(words[i - 2]) for i, w in enumerate(words) if w == "spill")
            for name in KERNELS:     # the larger over a kernel's instances
                if f"{name}_kernel" in cur:
                    out[name] = max(out.get(name, (0, 0)), (st, ld))
    return out


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


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_kernel_inputs(tick, q, qd, fs, iters):
    """One cold tick of a CompiledTick, with the psd_inverse and qp_solve
    wrappers wrapped for that tick to keep a copy of each call's inputs."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda

    seen = {"psd_inverse": [], "qp_solve": []}
    inv, solve = linalg_cuda.psd_inverse, qp_cuda.qp_solve

    def inv_rec(A):
        seen["psd_inverse"].append(A.clone())
        return inv(A)

    def solve_rec(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6, mirror=0):
        seen["qp_solve"].append(dict(H=H.clone(), g=g.clone(), C=C.clone(), d=d.clone(),
                                     ridge=ridge, mirror=mirror))
        return solve(H, g, C, d, x0, lam0, iters=iters, ridge=ridge, mirror=mirror)

    linalg_cuda.psd_inverse, qp_cuda.qp_solve = inv_rec, solve_rec
    try:
        tick._tick_impl(q, qd, fs, warm=tick.init_warm(q.shape[:-1]), qp_iters=iters)
    finally:
        linalg_cuda.psd_inverse, qp_cuda.qp_solve = inv, solve
    torch.cuda.synchronize()
    return seen


def gap_pres(C, d, x, lam):
    """The normalized gap and primal residual solve_qp reports, from the
    unmirrored C."""
    from libdwbc_tpu_torch.ops.qp import _comp_gap

    slack = d - (C @ x[..., None])[..., 0]
    return _comp_gap(slack, lam, C.shape[-2]), torch.clamp_min(-slack, 0.0).max(-1).values


def graph_time(fn, reps):
    """Device ms per call of fn replayed from a captured CUDA graph: the
    launches of one call (the wrapper's copies included) without the host
    time of the Python wrapper between them."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_time(g.replay, reps)


def interleaved(plain, kernel, reps_plain, reps_kernel):
    """(plain ms, kernel ms, kernel ms replayed from a graph), the first two
    each the mean of two runs taken in the order plain, kernel, kernel,
    plain."""
    p1 = cuda_time(plain, reps_plain)
    k1 = cuda_time(kernel, reps_kernel)
    k2 = cuda_time(kernel, reps_kernel)
    p2 = cuda_time(plain, reps_plain)
    return (p1 + p2) / 2, (k1 + k2) / 2, graph_time(kernel, reps_kernel)


def masked_extra_flops(plan):
    """Operations per solve that the masked branches add to the static
    counts (a multiply-add is 2), read off csrc/tick_prestage.cu and
    csrc/tick_qpchain.cu for the masked plan: (prestage, qpchain)."""
    nd, md, cd, cf, kr = plan.ndof, plan.mdof, plan.cdof, plan.cfree, plan.k_rows
    pre = (cd * nd                  # J_C rows × mask
           + 2 * cd                 # Mc += 1 − mask on the diagonal
           + 2 * cd * cd            # Λc re-masked
           - 2 * md * cf * cf       # orthonormalize_drop is one MGS pass, qr_thin two
           + 2 * md * cf            # compact_columns' column norms
           + 2 * cd * md * cf - 2 * cf * md * cf  # J̄ᵀ·V2 over all cd rows, not cf
           + 2 * cd + 3 * cf * cf   # c_act (twice), the inner system's live masks
           + md * cf)               # NwJw × live
    qp = kr * sum(nv for nv, _ in plan.qp_dims) + 2   # cone rows × crow; the gate
    return pre, qp


def servo_extra_flops(plan):
    """Operations per solve that the servo branch adds to the static
    prestage count with every level servo'd (a multiply-add is 2), read off
    csrc/tick_prestage.cu::servo_lane and csrc/servo.cuh; tick_qpchain only
    reads its f* from elsewhere and adds none."""
    vel = 15 + 21 * (plan.nbody - 1)   # ω₀ = R₀·q̇[3:6]; per body ω and v += ω×Δp
    state = 30                          # per level: R·offset, the point and its velocity
    quintic = 61                        # powers, coefficients, pos/vel/acc, the clamps
    servo = (4 * quintic                # three position axes and the time scaling
             + 33                       # position errors, their clamps, f*_pos
             + 2 * 18 + 48 + 33         # two matrix→quaternion, slerp, quaternion→matrix
             + 45 + 17 + 36             # R_des·R_initᵀ, its log, GetPhi
             + 36)                      # w_traj, rotation errors, clamps, f*_rot
    blend = sum(4 * t for t in plan.level_tdofs)
    nlev = len(plan.level_tdofs)
    return vel + nlev * (state + servo) + blend


def tick_flops(plan, iters):
    """Operations per solve of the two tick kernels on a plan (a
    multiply-add is 2), read off csrc/tick_prestage.cu and
    csrc/tick_qpchain.cu routine by routine: (prestage, qpchain); a masked
    plan's with masked_extra_flops.  Every tick kernel's bound takes it
    (benchmarks/sol_tick_r05.json's count of the flagship is printed
    beside it)."""
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_flops as inv
    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_flops

    nb, nd, md, cd, cf, kr = (plan.nbody, plan.ndof, plan.mdof, plan.cdof, plan.cfree,
                              plan.k_rows)

    def chol(n):                           # chol_factor: scalings, rsqrt, trailing updates
        return sum(2 * (n - j - 1) * (n - j) // 2 + (n - j) for j in range(n))

    def w_apply(r):                        # V2ᵀB, the two triangular solves, −V2(V2ᵀB)
        return 2 * md * md * r + (4 * md * cf * r if cf else 0)

    pre = 40 + (nb - 1) * 180              # FK: base, then per body Rj, X·Rj, R, p, axis, COM
    pre += len(plan.points) * nd * 12      # point jacobians: a cross product per column
    pre += nb * 140 + (nb - 1) * 36        # composite inertias and their accumulation
    pre += nd * 72 + 12 * int(plan.anc_pairs.sum()) + 6 * nd   # A's columns, G
    if plan.uses_tot:                      # the whole-body COM jacobian
        pre += 250 + nd * 50
    pre += inv(nd)                         # A⁻¹
    pre += (2 * cd * nd * nd + cd * (cd + 1) * nd + 42 * cd + chol(cd) + chol(6) + inv(cd)
            + 2 * cd * cd * nd + 4 * cd * nd + md * (md + 1) * cd)   # contact space, Wfree
    if cf:                                 # kernel basis, Wfree + V2V2ᵀ, NwJw
        pre += (4 * cd ** 3 + 2 * cd * md * cf + 2 * (3 * md * cf + 2 * md * cf * (cf - 1))
                + md * (md + 1) * cf + 2 * cf * cf * md + 4 * cf ** 3 + 2 * md * cf * cf)
    pre += chol(md) + 2 * md * nd + w_apply(1)                     # W's factor, τ_grav
    nlev = len(plan.level_tdofs)
    for h, t in enumerate(plan.level_tdofs):                      # JKT and Ntorque
        pre += (2 * t * nd * nd + 4 * t * nd * cd + t * (t + 1) * nd + 2 * inv(t)
                + 2 * t * t * md + w_apply(t) + t * (t + 1) * md + 4 * md * t * t)
        pre += 2 * md * md * t if h else 0                        # Nt = Pn·JktLam
        if h + 1 < nlev:
            pre += 2 * md * md * t * (2 if h else 1)              # the null space
    pre += kr * (36 + 12 * md)                                    # constraint rows
    pre += sum(5 * (c.contact_dof - 3 if not plan.masked else 3) * nd     # LINE's local rows
               for c in plan.cfg.contacts if c.contact_type == 2)
    qp = 2 * cd * md
    mirror = md if plan.tlim is not None else 0
    for nv, m in plan.qp_dims:                                    # QPs, rows, torque sums
        qp += (qp_solve_flops(nv, m, mirror, iters) + 2 * kr * md * nv + 2 * kr * md
               + 4 * md * nv)
    if plan.masked:
        x_pre, x_qp = masked_extra_flops(plan)
        pre, qp = pre + x_pre, qp + x_qp
    return pre, qp


def per_hyp(got, want, n, nh=3):
    """Max abs error of (elem..., n) tensors per hypothesis (lane % nh)."""
    d = (got.detach().cpu().double() - want.detach().cpu().double()).abs().reshape(-1, n)
    lane = torch.arange(n) % nh
    return [float(d[:, lane == h].max()) for h in range(nh)]


def cast(x, fn):
    """fn on every tensor of a (nested) prestage dict; None stays None."""
    if isinstance(x, dict):
        return {k: cast(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cast(v, fn) for v in x)
    return None if x is None else fn(x)


def general_kernels(dev, model, tag, cfg, masked, q_el, fs_el, cm_el, limits, split):
    """Phases 17 and 20 on one plan, every lane: "pre", tick_prestage vs
    the plain float64 prestage; "qp", tick_qpchain vs the plain float32
    qpchain on that prestage cast to float32, cold at COLD_ITERS and warm at
    WARM_ITERS from the plain cold warm state; "qp32", the same on the plain
    float32 prestage, the QPs that float32 serving solves (its task-space
    inverses carry the float32 ridge, the float64 prestage's do not); and
    "chain", the two kernels chained vs the plain float64 tick.  Each max
    abs error (split: a list, per hypothesis in masked mode) beside the
    plain float32 tick's own error against float64 on the same inputs and
    its limit (limits: tick_cuda.GENERAL_TOL[tag]).  With more than two
    contacts or a POINT or LINE one, the field held for NwJw is
    tick_cuda.nwjw_determined's product (NwJw's basis follows roundoff there, in
    float32 and float64 alike); with more than two contacts the chain holds
    τ_task only: τ_cmd and the contact force sit on the flat face of the
    contact block, where float32 and float64 pick different points, the
    plain version and the kernels alike; their errors are printed as max
    and median beside plain float32's own.
    The QP chain may leave no more lanes with a primal residual above
    QP_FAIL than the plain float32 QP chain, within phase 13's spread of two
    rollouts.  Returns (τ_grav error, QP chain τ_cmd error, max over the
    split; the errors and plain float32's own, by part and field)."""
    from libdwbc_tpu_torch.ops.tick_cuda import TickKernels, nwjw_determined
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram

    p64 = TickProgram(model, cfg, "cpu", torch.float64, masked=masked)
    p32 = TickProgram(model, cfg, "cpu", torch.float32, masked=masked)
    kern = TickKernels(TickProgram(model, cfg, dev, torch.float32, masked=masked))
    d = (lambda t: t.to(dev))
    nb = q_el.shape[1]
    cm64 = None if cm_el is None else cm_el.double()
    pre64 = p64.prestage(q_el.double(), cm64)
    pre_k = kern.prestage(d(q_el), None if cm_el is None else d(cm_el))
    torch.cuda.synchronize()
    own = p32.prestage(q_el, cm_el)
    fields = ["torque_grav", "P_C", "Jbar_act", "NwJw", "Ntorques", "Atemp", "bA0", "health"]
    flat = len(cfg.contacts) > 2
    basis_free = flat or any(c.contact_type != 0 for c in cfg.contacts)
    if p64.plan.cfree == 0:                 # one contact: no NwJw, as the plain prestage
        assert pre_k["NwJw"] is None and pre64["NwJw"] is None
        fields.remove("NwJw")
    err = {"pre": {}, "qp": {}, "qp32": {}, "chain": {}}
    own_err = {k: {} for k in err}
    for name in fields:
        got, o, want = pre_k[name], own[name], pre64[name]
        if name == "NwJw" and basis_free:
            got, o, want = (nwjw_determined(x, p64.plan, None if cm_el is None else cm_el.to(
                x["NwJw"].device)) for x in (pre_k, own, pre64))
        if name == "Ntorques":
            got, o, want = (torch.cat([t.reshape(-1, nb) for t in x], 0) for x in (got, o, want))
        assert torch.isfinite(got).all(), f"tick_prestage ({tag}): non-finite {name}"
        err["pre"][name], own_err["pre"][name] = split(got, want), split(o, want)
    fs_d = [d(f) for f in fs_el]
    fs64 = [f.double() for f in fs_el]
    outs = ("torque_task", "torque_contact", "torque_cmd", "contact_force")
    unsolved = []
    for part, pre32 in (("qp", cast(pre64, lambda t: t.float())), ("qp32", own)):
        ref_c = p32.qpchain(pre32, fs_el, None, COLD_ITERS)
        ker_c = kern.qpchain(cast(pre32, d), fs_d, None, COLD_ITERS)
        w_cpu = ref_c["warm_out"]
        ref_w = p32.qpchain(pre32, fs_el, w_cpu, WARM_ITERS)
        ker_w = kern.qpchain(cast(pre32, d), fs_d, [(d(x), d(l)) for x, l in w_cpu],
                             WARM_ITERS)
        pre32_64 = cast(pre32, lambda t: t.double())
        r64_c = p64.qpchain(pre32_64, fs64, None, COLD_ITERS)
        r64_w = p64.qpchain(pre32_64, fs64, [(x.double(), l.double()) for x, l in w_cpu],
                            WARM_ITERS)
        torch.cuda.synchronize()
        for mode, ref, ker, r64 in (("cold", ref_c, ker_c, r64_c),
                                    ("warm", ref_w, ker_w, r64_w)):
            for name in outs + ("qp_gap", "qp_primal_res"):
                assert torch.isfinite(ker[name]).all(), f"tick_qpchain ({tag}): non-finite {name}"
            for name in outs:
                err[part][f"{mode}.{name}"] = split(ker[name], ref[name])
                own_err[part][f"{mode}.{name}"] = split(ref[name], r64[name])
            n_k, n_p = (int((r["qp_primal_res"] > QP_FAIL).sum()) for r in (ker, ref))
            unsolved.append((f"{part}.{mode}", n_k, n_p))
            if p64.plan.cfree == 0:
                assert not ker["torque_contact"].any(), (tag, part, mode)
    ch_k = kern.qpchain(pre_k, fs_d, None, COLD_ITERS)
    ch64 = p64.qpchain(pre64, fs64, None, COLD_ITERS)
    ch32 = p32.qpchain(own, fs_el, None, COLD_ITERS)
    for name in ("torque_task",) if flat else ("torque_task", "torque_cmd", "contact_force"):
        err["chain"][name] = split(ch_k[name], ch64[name])
        own_err["chain"][name] = split(ch32[name], ch64[name])
    if flat:
        from libdwbc_tpu_torch.ops.tick_cuda import lane_err
        print(f"tick_prestage → tick_qpchain vs plain float64 tick ({tag}, on the flat face, "
              f"not held; max / median over the lanes [plain float32's own]): " + "  ".join(
                  f"{n} {float(e.max()):.3e} / {float(e.median()):.3e} [{float(o.max()):.3e} / "
                  f"{float(o.median()):.3e}]" for n in ("torque_cmd", "contact_force")
                  for e, o in [(lane_err(ch_k[n], ch64[n]), lane_err(ch32[n], ch64[n]))]))

    def fmt(v):
        return "/".join(f"{e:.3e}" for e in v)

    for part, label in (("pre", "tick_prestage vs plain float64"),
                        ("qp", "tick_qpchain on the float64 prestage vs plain float32 [plain "
                               "float32's own vs float64 on the same prestage]"),
                        ("qp32", "tick_qpchain on the plain float32 prestage vs plain float32 "
                                 "[plain float32's own vs float64 on the same prestage]"),
                        ("chain", "tick_prestage → tick_qpchain vs plain float64 tick")):
        print(f"{label} ({tag}, max abs err [plain float32's own] <= limit): " + "  ".join(
            f"{k} {fmt(v)} [{fmt(own_err[part][k])}] <= {fmt(limits[part][k])}"
            for k, v in err[part].items()))
    print(f"tick_qpchain ({tag}): lanes with a primal residual above {QP_FAIL:g}, kernel "
          f"[plain float32]: " + "  ".join(f"{m_} {k_} [{p_}]" for m_, k_, p_ in unsolved))
    for mode, n_k, n_p in unsolved:
        assert n_k <= 1.25 * n_p + 1e-3 * nb, (tag, mode, n_k, n_p)
    for part in err:
        for k, v in err[part].items():
            assert all(e <= t for e, t in zip(v, limits[part][k])), (tag, part, k, v)
    return (max(err["pre"]["torque_grav"]),
            max(err["qp"]["cold.torque_cmd"] + err["qp"]["warm.torque_cmd"]), (err, own_err))


def swing_serving(dev, model, cfg3, card, times):
    """Phase 18: config 3's serving path at batch B — a cold tick at
    COLD_ITERS, then K − 1 warm ticks at WARM_ITERS (q[:, 6:39] += 1e-6·
    tanh(τ_cmd) between ticks), then one unbatched tick — its launch counts
    set to 0 just before and read just after; the truth guard on 4 lanes;
    the kernels' times at B and 1 against their plain versions on the card
    (into times), the warm chain's solves/s and the unbatched warm tick.
    Returns (launches, the tick's TickKernels)."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick

    md = model.model_dof
    q, qd, fs = entry._swing_inputs(model, B, seed=0)
    q_d, qd_d = torch.as_tensor(q, device=dev), torch.as_tensor(qd, device=dev)
    fs_d = tuple(torch.as_tensor(f, device=dev) for f in fs)
    tick = FusedTick(model, cfg3, dev, backend="cuda")
    assert tick.prog.plan.qp_dims == [(6, 76), (3, 76), (6, 76)], tick.prog.plan.qp_dims

    def step(qq, warm, iters):
        res, warm = tick._tick_impl(qq, qd_d, fs_d, warm=warm, qp_iters=iters)
        qq = qq.clone()
        qq[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd)
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
    print(f"config 3 serving path: {K} ticks at batch {B} + 1 unbatched tick, "
          f"launches {launches}")
    assert launches == {"tick_prestage": K + 1, "tick_qpchain": K + 1}, launches
    for r in results + [res1]:
        for name, v in r._asdict().items():
            if v.dtype != torch.bool:
                assert torch.isfinite(v).all(), f"config 3: non-finite {name}"
    assert res1.torque_cmd.shape == (md,) and not bool(res1.qp_error)
    assert [tuple(x.shape) + tuple(l.shape) for x, l in warm] == [
        (B, 6, B, 76), (B, 3, B, 76), (B, 6, B, 76)]
    gap_max = max(float(r.qp_gap.max()) for r in results)
    pres_max = max(float(r.qp_primal_res.max()) for r in results)
    n_err = sum(int(r.qp_error.sum()) for r in results)
    print(f"config 3 serving path: gap max {gap_max:.3e}  pres max {pres_max:.3e}  "
          f"qp_error lanes {n_err}  unbatched τ_cmd[0:3] {res1.torque_cmd[:3].tolist()}")
    assert n_err == 0 and gap_max <= QP_FAIL and pres_max <= QP_FAIL

    # the truth guard: tick 0 on four lanes against float64 CPU ticks, the
    # plain fused tick and CompiledTick (the independent formulation)
    lanes = (q[:4].astype(np.float64), qd[:4].astype(np.float64),
             tuple(f[:4].astype(np.float64) for f in fs))
    f64 = FusedTick(model, cfg3, "cpu", torch.float64, backend="torch")
    r64, _ = f64._tick_impl(*lanes, warm=f64.init_warm((4,)), qp_iters=COLD_ITERS)
    c64 = CompiledTick(model, cfg3, "cpu", torch.float64, backend="torch")
    rc64, _ = c64._tick_impl(*lanes, warm=c64.init_warm((4,)), qp_iters=COLD_ITERS)
    for label, want in (("plain fused float64", r64), ("CompiledTick float64", rc64)):
        d_grav = maxerr(results[0].torque_grav[:4], want.torque_grav)
        d_cmd = maxerr(results[0].torque_cmd[:4], want.torque_cmd)
        print(f"config 3 truth guard, FusedTick(cuda) vs {label} (4 lanes): τ_grav "
              f"{d_grav:.3e}  τ_cmd {d_cmd:.3e}")
        assert d_grav <= TAU_GRAV_TOL and d_cmd <= TAU_CMD_TOL, (label, d_grav, d_cmd)

    # times: each kernel against its plain version on the card
    kern = tick.kernels
    plain_dev = TickProgram(model, cfg3, dev, torch.float32)
    q_el = q_d.T.contiguous()
    fs_el = [f.T.contiguous() for f in fs_d]
    for nb in (B, 1):
        qe = q_el[:, :nb].contiguous()
        fe = [f[:, :nb].contiguous() for f in fs_el]
        pre_buf = kern.prestage_packed(qe)
        pre_d = kern.unpack_pre(pre_buf)
        w_d = kern.unpack_result(*kern.qpchain_packed(pre_buf, fe, None, COLD_ITERS))["warm_out"]
        times[("tick_prestage_swing", nb)] = interleaved(
            lambda: plain_dev.prestage(qe), lambda: kern.prestage_packed(qe), 2, 5)
        times[("tick_qpchain_swing", nb)] = interleaved(
            lambda: plain_dev.qpchain(pre_d, fe, w_d, WARM_ITERS),
            lambda: kern.qpchain_packed(pre_buf, fe, w_d, WARM_ITERS), 2, 5)
        for name in ("tick_prestage_swing", "tick_qpchain_swing"):
            p, kt, gk = times[(name, nb)]
            print(f"time {name} batch {nb}: kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  "
                  f"plain (torch on the card) {p:.3f} ms  [{card}]")

    def chain():
        qq_, w_ = q_d, warm
        for _ in range(K - 1):
            _, qq_, w_ = step(qq_, w_, WARM_ITERS)

    chain_ms = cuda_time(chain, 2)
    q1, qd1, fs1 = q_d[0], qd_d[0], tuple(f[0] for f in fs_d)
    _, warm1 = tick._tick_impl(q1, qd1, fs1, warm=tick.init_warm(()), qp_iters=COLD_ITERS)
    single_warm_ms = cuda_time(lambda: tick._tick_impl(q1, qd1, fs1, warm=warm1,
                                                       qp_iters=WARM_ITERS), 10)
    print(f"config 3 warm chain: {K - 1} ticks at batch {B} in {chain_ms:.3f} ms -> "
          f"{B * (K - 1) / (chain_ms / 1e3):.1f} solves/s; unbatched warm tick ({WARM_ITERS} "
          f"iterations) {single_warm_ms:.3f} ms, against the single-lane bar of 1 ms  [{card}]")
    return launches, kern


def swing_loop(dev, model, cfg3, card):
    """Phase 19: config 3's servo'd closed loop at batch B (every level
    servo'd: pelvis and torso held, the right foot lifted 1.5 cm over
    K_SWING ticks of 1 ms), through the kernels with the launch counts set
    to 0 just before and read just after, then through the plain float32
    tick and in float64 (tick and transition), both on the card; the split
    of the kernels' loop per tick into ticks and transition.  Returns the
    kernels' launches."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.kin.engine import Kinematics
    from libdwbc_tpu_torch.ops import linalg_cuda
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import forward_dynamics_transition, make_control_loop
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, servos_to

    K_SWING, DT, LIFT = 150, 1e-3, 0.015
    q, qd, fs, servos, foot0, pelvis0 = entry._swing_servo_inputs(
        model, B, seed=0, lift=LIFT, tf=K_SWING * DT)
    trans32 = forward_dynamics_transition(CompiledTick(model, cfg3, dev, backend="cuda"))
    trans64 = forward_dynamics_transition(CompiledTick(model, cfg3, dev, torch.float64,
                                                       backend="torch"))
    kin = Kinematics(model)

    def run(tk, label, trans, count=False, ev=None, K_SWING=K_SWING):
        dt_ = tk.dtype
        args = (torch.as_tensor(q, device=dev, dtype=dt_),
                torch.as_tensor(qd, device=dev, dtype=dt_),
                tuple(torch.as_tensor(f, device=dev, dtype=dt_) for f in fs))
        if ev is not None:              # CUDA events around every tick and transition
            def timed(name, fn):
                def f(*a, **k):
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    out = fn(*a, **k)
                    e1.record()
                    ev[name].append((e0, e1))
                    return out
                return f
            tk._tick_impl = timed("tick", tk._tick_impl)
            trans = timed("transition", trans)
        loop = make_control_loop(tk, transition=trans, K=K_SWING, dt=DT, warm_start=True,
                                 warm_iters=WARM_ITERS, gap_fallback=GAP_FALLBACK)
        torch.cuda.synchronize()
        if count:
            for k in tk.kernels.launches:
                tk.kernels.launches[k] = 0
            linalg_cuda.launches["psd_inverse"] = 0
        t0_ = time.perf_counter()
        try:
            lr = loop(*args, servos=servos_to(servos, dt_, dev))
            torch.cuda.synchronize()
        finally:
            if ev is not None:
                del tk._tick_impl
        wall = time.perf_counter() - t0_
        for name, v in lr._asdict().items():
            if isinstance(v, torch.Tensor) and v.dtype != torch.bool:
                assert torch.isfinite(v).all(), f"config 3 loop ({label}): non-finite {name}"
        fk = kin.fk(lr.q_final.detach().cpu().double())
        foot, pelvis = fk.p[:, 12].numpy(), fk.p[:, 0].numpy()
        out = dict(wall=wall, progress=(foot[:, 2] - foot0[:, 2]) / LIFT,
                   dxy=np.abs(foot[:, :2] - foot0[:, :2]).max(1),
                   dz=np.abs(pelvis[:, 2] - pelvis0[:, 2]),
                   n_err=int(lr.qp_error.sum()), pres=float(lr.qp_primal_res.max()),
                   n_err_cmp=int(lr.qp_error.reshape(K_SWING, -1)[:K_CMP].sum()))
        print(f"config 3 servo'd loop ({label}): {K_SWING} ticks at batch {B}, refined ticks "
              f"{lr.refined_ticks}, {wall * 1e3:.3f} ms; swing progress min "
              f"{out['progress'].min():.4f} mean {out['progress'].mean():.4f}, foot |Δx|,|Δy| "
              f"max {out['dxy'].max():.4e} m, pelvis |Δz| max {out['dz'].max():.4e} m; "
              f"qp_error ticks×lanes {out['n_err']}, qp_primal_res max {out['pres']:.3e}")
        if count:
            n_solve = K_SWING + lr.refined_ticks
            out["launches"] = dict(tk.kernels.launches)
            out["psd"] = linalg_cuda.launches["psd_inverse"]
            print(f"config 3 servo'd loop ({label}): launches {out['launches']}, psd_inverse "
                  f"{out['psd']}")
            assert out["launches"] == {"tick_prestage": n_solve, "tick_qpchain": n_solve}, \
                out["launches"]
            assert out["psd"] == K_SWING, out["psd"]
        return out

    tick = FusedTick(model, cfg3, dev, backend="cuda")
    kern = run(tick, "kernels", trans32, count=True)
    # the comparison loops run the kernels' first K_CMP ticks (phase 13)
    plain = run(FusedTick(model, cfg3, dev, torch.float32, backend="torch"),
                "plain float32 tick on the card", trans32, K_SWING=K_CMP)
    f64 = run(FusedTick(model, cfg3, dev, torch.float64, backend="torch"),
              "plain float64 tick and transition on the card", trans64, K_SWING=K_CMP)
    assert (kern["progress"] > 0.5).all(), float(kern["progress"].min())
    for r in (kern, plain, f64):
        assert (r["dxy"] < 0.05).all() and (r["dz"] < 0.03).all()
    # flagged lane-ticks over the same K_CMP ticks and lanes: no more than
    # through the plain float32 tick, within the spread of two rollouts that
    # part on roundoff (phase 13's rule)
    print(f"config 3 servo'd loop: the kernels' first {K_CMP} ticks flag {kern['n_err_cmp']} "
          f"lane-ticks, the plain float32 tick {plain['n_err']}, float64 {f64['n_err']}")
    assert kern["n_err_cmp"] <= 1.25 * plain["n_err"] + 1e-3 * K_CMP * B, (kern["n_err_cmp"],
                                                                            plain["n_err"])
    ev = {"tick": [], "transition": []}
    split = run(tick, "kernels, timed per call", trans32, ev=ev)
    t_tick, t_tr = (sum(a.elapsed_time(b) for a, b in ev[k]) / K_SWING
                    for k in ("tick", "transition"))
    t_wall = split["wall"] * 1e3 / K_SWING
    print(f"config 3 servo'd loop per tick at batch {B}: wall {t_wall:.3f} ms, of which ticks "
          f"{t_tick:.3f} ms and transition {t_tr:.3f} ms (CUDA events), the rest "
          f"{t_wall - t_tick - t_tr:.3f} ms  [{card}]")
    return kern["launches"]

def normal_force(res, plan):
    """Σ over the contacts of the normal (world z) force, per lane."""
    from libdwbc_tpu_torch.ops.tick_cuda import contact_rows

    return sum(res.contact_force[..., j0 + 2] for j0, *_ in contact_rows(plan))


def new_plan_kernels(dev, model, q_el, fs_el):
    """Phase 20: general_kernels on the plans this port took last — the
    hands-and-feet fixture (POINT hands; entry._hands_feet_config) static
    on entry._hands_feet_inputs and masked on the first N_M lanes of
    entry._hands_masked_inputs (per hypothesis of entry.HANDS_HYPOTHESES),
    LINE feet on the same states, and the flagship without a torque limit
    on phase 3's states — each within tick_cuda.GENERAL_TOL.  Returns
    {tag: (τ_grav error, QP chain τ_cmd error)}."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops.tick_cuda import GENERAL_TOL
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    el = (lambda a: torch.as_tensor(np.ascontiguousarray(np.asarray(a).T)))
    base = standard_tocabi_config(model, qp_iters=COLD_ITERS)
    hcfg = entry._hands_feet_config(model)
    lcfg = dataclasses.replace(base, contacts=tuple(
        dataclasses.replace(c, contact_type=T.CONTACT_LINE, plane_y=0.0) for c in base.contacts))
    hq, _, hfs = entry._hands_feet_inputs(model, B, seed=0)
    mq, _, mfs, mm = entry._hands_masked_inputs(model, N_M, seed=0)
    nh = len(entry.HANDS_HYPOTHESES)
    one = (lambda g, w: [maxerr(g, w)])
    out = {}
    for tag, cfg, masked, q, fs, cm, split in (
            ("hands", hcfg, False, el(hq), [el(f) for f in hfs], None, one),
            ("hands masked", hcfg, True, el(mq), [el(f) for f in mfs], el(mm),
             lambda g, w: per_hyp(g, w, N_M, nh)),
            ("line feet", lcfg, False, el(hq), [el(f) for f in hfs], None, one),
            ("no limit", dataclasses.replace(base, torque_limit=None), False, q_el, fs_el, None,
             one)):
        out[tag] = general_kernels(dev, model, tag, cfg, masked, q, fs, cm, GENERAL_TOL[tag],
                                   split)
    return out


def hands_serving(dev, model, card, times):
    """Phase 21: the hands-and-feet serving path at batch B through
    make_control_loop(FusedTick(cuda), warm, gap_fallback) — tick 0 cold
    at the configuration's qp_iters (25, the reference fixture's), then
    K − 1 warm ticks at WARM_ITERS, q[:, 6:39] += 1e-6·tanh(τ_cmd) between
    ticks — and one unbatched tick, the launch counts set to 0 just before
    and read just after; on every lane and tick: every output finite, no
    qp_error, gap and primal residual ≤ QP_FAIL, |τ_cmd| ≤ 300 Nm + 1e-3,
    the contacts' normal forces summing below −400 N; the truth guard on 4
    lanes against the plain float64 tick on the CPU (τ_grav held, τ_task
    and τ_cmd printed beside plain float32's own); the kernels' times at B
    and 1 against their plain versions on the card (into times), the warm
    chain's solves/s and the unbatched warm tick.  Returns (launches, the
    tick's TickKernels)."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    md = model.model_dof
    hcfg = entry._hands_feet_config(model)
    q, qd, fs = entry._hands_feet_inputs(model, B, seed=0)
    q_d, qd_d = torch.as_tensor(q, device=dev), torch.as_tensor(qd, device=dev)
    fs_d = tuple(torch.as_tensor(f, device=dev) for f in fs)
    tick = FusedTick(model, hcfg, dev, backend="cuda")
    plan = tick.prog.plan
    assert plan.qp_dims == [(18, 98), (15, 98), (12, 98)], plan.qp_dims
    seen = []

    def advance(qq, qd_, res, dt):
        seen.append(res)
        qq = qq.clone()
        qq[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd)
        return qq, qd_

    loop = make_control_loop(tick, transition=advance, K=K, warm_start=True,
                             warm_iters=WARM_ITERS, gap_fallback=GAP_FALLBACK)
    torch.cuda.synchronize()
    for k in tick.kernels.launches:
        tick.kernels.launches[k] = 0
    tick.prestage_reuses = 0
    lr = loop(q_d, qd_d, fs_d)
    res1 = tick._tick_impl(q_d[0], qd_d[0], tuple(f[0] for f in fs_d))
    torch.cuda.synchronize()
    launches = dict(tick.kernels.launches)
    n_solve = K + lr.refined_ticks + 1
    print(f"hands-and-feet serving path (make_control_loop, gap_fallback {GAP_FALLBACK:g}): "
          f"{K} ticks at batch {B} (tick 0 at {hcfg.qp_iters} iterations) + 1 unbatched tick, "
          f"refined ticks {lr.refined_ticks} ({tick.prestage_reuses} on their warm tick's "
          f"prestage), launches {launches}")
    assert launches == {"tick_prestage": n_solve - tick.prestage_reuses,
                        "tick_qpchain": n_solve}, launches
    for r in seen + [res1]:
        for name, v in r._asdict().items():
            if v.dtype != torch.bool:
                assert torch.isfinite(v).all(), f"hands-and-feet: non-finite {name}"
    assert res1.torque_cmd.shape == (md,) and not bool(res1.qp_error)
    n_err = sum(int(r.qp_error.sum()) for r in seen)
    gap_max = max(float(r.qp_gap.max()) for r in seen)
    pres_max = max(float(r.qp_primal_res.max()) for r in seen)
    tau_max = max(float(r.torque_cmd.abs().max()) for r in seen + [res1])
    fz_max = max(float(normal_force(r, plan).max()) for r in seen + [res1])
    print(f"hands-and-feet serving path: qp_error ticks×lanes {n_err}  gap max {gap_max:.3e}  "
          f"pres max {pres_max:.3e}  |τ_cmd| max {tau_max:.3f} Nm  Σ normal force max "
          f"{fz_max:.1f} N")
    assert n_err == 0 and gap_max <= QP_FAIL and pres_max <= QP_FAIL
    assert tau_max <= 300.0 + 1e-3 and fz_max < -400.0

    # the truth guard: tick 0 on four lanes against the plain float64 tick
    lanes = (q[:4].astype(np.float64), qd[:4].astype(np.float64),
             tuple(f[:4].astype(np.float64) for f in fs))
    f64 = FusedTick(model, hcfg, "cpu", torch.float64, backend="torch")
    r64, _ = f64._tick_impl(*lanes, warm=f64.init_warm((4,)), qp_iters=hcfg.qp_iters)
    f32 = FusedTick(model, hcfg, "cpu", torch.float32, backend="torch")
    r32, _ = f32._tick_impl(q[:4], qd[:4], tuple(f[:4] for f in fs), warm=f32.init_warm((4,)),
                            qp_iters=hcfg.qp_iters)
    d = {n: (maxerr(getattr(seen[0], n)[:4], getattr(r64, n)),
             maxerr(getattr(r32, n), getattr(r64, n)))
         for n in ("torque_grav", "torque_task", "torque_cmd")}
    print("hands-and-feet truth guard, FusedTick(cuda) vs plain fused float64 (4 lanes, "
          "[plain float32's own]): " + "  ".join(f"{n} {a:.3e} [{b:.3e}]" for n, (a, b) in d.items())
          + f"; τ_grav held at {TAU_GRAV_TOL:g}, τ_cmd on the flat face not held")
    assert d["torque_grav"][0] <= TAU_GRAV_TOL, d

    # times: each kernel against its plain version on the card
    kern = tick.kernels
    plain_dev = TickProgram(model, hcfg, dev, torch.float32)
    q_el = q_d.T.contiguous()
    fs_el = [f.T.contiguous() for f in fs_d]
    for nb in (B, 1):
        qe = q_el[:, :nb].contiguous()
        fe = [f[:, :nb].contiguous() for f in fs_el]
        pre_buf = kern.prestage_packed(qe)
        pre_d = kern.unpack_pre(pre_buf)
        w_d = kern.unpack_result(*kern.qpchain_packed(pre_buf, fe, None, COLD_ITERS))["warm_out"]
        times[("tick_prestage_hands", nb)] = interleaved(
            lambda: plain_dev.prestage(qe), lambda: kern.prestage_packed(qe), 2, 5)
        times[("tick_qpchain_hands", nb)] = interleaved(
            lambda: plain_dev.qpchain(pre_d, fe, w_d, WARM_ITERS),
            lambda: kern.qpchain_packed(pre_buf, fe, w_d, WARM_ITERS), 2, 5)
        for name in ("tick_prestage_hands", "tick_qpchain_hands"):
            p, kt, gk = times[(name, nb)]
            print(f"time {name} batch {nb}: kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  "
                  f"plain (torch on the card) {p:.3f} ms  [{card}]")

    _, warm = tick._tick_impl(q_d, qd_d, fs_d, warm=tick.init_warm((B,)),
                              qp_iters=hcfg.qp_iters)

    def chain():
        qq_, w_ = q_d, warm
        for _ in range(K - 1):
            res, w_ = tick._tick_impl(qq_, qd_d, fs_d, warm=w_, qp_iters=WARM_ITERS)
            qq_ = qq_.clone()
            qq_[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd)

    chain_ms = cuda_time(chain, 2)
    q1, qd1, fs1 = q_d[0], qd_d[0], tuple(f[0] for f in fs_d)
    _, warm1 = tick._tick_impl(q1, qd1, fs1, warm=tick.init_warm(()), qp_iters=hcfg.qp_iters)
    single_warm_ms = cuda_time(lambda: tick._tick_impl(q1, qd1, fs1, warm=warm1,
                                                       qp_iters=WARM_ITERS), 10)
    print(f"hands-and-feet warm chain: {K - 1} ticks at batch {B} in {chain_ms:.3f} ms -> "
          f"{B * (K - 1) / (chain_ms / 1e3):.1f} solves/s; unbatched warm tick ({WARM_ITERS} "
          f"iterations) {single_warm_ms:.3f} ms, against the single-lane bar of 1 ms  [{card}]")
    return launches, kern


REDUCED_QP_DIMS = {"flagship": [(12, 44), (12, 44), (6, 44)], "config 3": [(6, 22), (6, 22)]}
REDUCED_QP_NAMES = {"flagship": ("level 0", "nc resultant", "redistribution"),
                    "config 3": ("level 0", "nc resultant")}
REDUCED_QP_OWN = 4.0       # the kernel's limit in units of plain float32's own error
EPS32 = float(np.finfo(np.float32).eps)


def qp_errs(c64, got, ref, lanes):
    """Max errors of the solve got against ref (each (x, s, λ)) over the
    given lanes — x, the gap and the primal residual absolute, λ relative to
    1 + |λ| — and got's gap and primal residual per lane, all from the
    unmirrored C and d of c64 in float64."""
    g_k, p_k = gap_pres(c64["C"], c64["d"], got[0].cpu().double(), got[2].cpu().double())
    g_r, p_r = gap_pres(c64["C"], c64["d"], ref[0].cpu().double(), ref[2].cpu().double())
    lam_rel = ((got[2].cpu().double() - ref[2].cpu().double()).abs()
               / (1.0 + ref[2].cpu().double().abs()))
    return dict(x=maxerr(got[0].cpu()[lanes], ref[0].cpu()[lanes]),
                lam=float(lam_rel[lanes].max()),
                gap=maxerr(g_k[lanes], g_r[lanes]),
                pres=maxerr(p_k[lanes], p_r[lanes])), g_k, p_k


def reduced_kernels(dev, tag, tick, q_d, qd_d, fs_d):
    """Phase 23, one configuration: the inputs one cold ReducedTick(cuda)
    tick gives psd_inverse and qp_solve at batch B; psd_inverse on A_R and
    the reduced W + V2ᵀV2 (A at n = 39 is phase 4's) vs the plain version
    in float64 on the CPU (relative, linalg_cuda.PSD_INV_RTOL), qp_solve on
    each QP vs the plain version in float32 on the CPU, cold at COLD_ITERS
    and warm at WARM_ITERS (the limits below).  Returns (captured inputs,
    psd abs errors by n, qp errors by (QP, cold/warm))."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda
    from libdwbc_tpu_torch.ops.linalg_cuda import PSD_INV_RTOL, psd_inverse_plain
    from libdwbc_tpu_torch.ops.qp_cuda import QP_SOLVE_TOL, qp_solve_plain

    seen = capture_kernel_inputs(tick, q_d, qd_d, fs_d, COLD_ITERS)
    co, r_sys = tick.ridx.co_dof, tick.ridx.reduced_system_dof
    cfree = sum(c.contact_dof for c in tick.cfg.contacts) - 6
    # A (ndof), A_R (co_dof + 12) and, with a contact free space, the
    # reduced contact space's W + V2ᵀV2 (co_dof + 6); Λ_c (6 per 6D foot)
    # and the task operators stay below psd_inverse's n = 16
    want_n = [tick.model.ndof, r_sys] + ([co + 6] if cfree else [])
    assert [tuple(A.shape) for A in seen["psd_inverse"]] == [(B, n, n) for n in want_n], \
        [tuple(A.shape) for A in seen["psd_inverse"]]
    assert [(tuple(p["C"].shape[1:]), p["mirror"]) for p in seen["qp_solve"]] == [
        ((m, n), co) for n, m in REDUCED_QP_DIMS[tag]]
    psd_abs = {}
    for A in seen["psd_inverse"][1:]:          # A at n = 39 is phase 4's
        n = A.shape[-1]
        out = linalg_cuda.psd_inverse(A)
        torch.cuda.synchronize()
        ref = psd_inverse_plain(A.cpu().double())
        scale = float(ref.abs().max())
        psd_abs[n] = maxerr(out, ref)
        own = maxerr(psd_inverse_plain(A.cpu()), ref) / scale
        symmetric = torch.equal(out, out.transpose(-1, -2))
        print(f"reduced {tag}: psd_inverse n = {n} vs plain float64 (max abs err / max "
              f"|A⁻¹|, [plain float32's own] <= limit): {psd_abs[n] / scale:.3e} [{own:.3e}] "
              f"<= {PSD_INV_RTOL[n]:g}; exactly symmetric: {symmetric}")
        assert torch.isfinite(out).all() and symmetric
        assert psd_abs[n] / scale <= PSD_INV_RTOL[n], (tag, n, psd_abs[n] / scale)
    # qp_solve vs the plain float32 version within QP_SOLVE_TOL, or where
    # larger within REDUCED_QP_OWN × the plain float32 version's own
    # distance from a float64 solve of the same QP (the gap: or its own
    # gap), the primal residual within float32 roundoff of the rows' scale:
    # the tangential redistribution QP's dense H and forces of ~200 N put
    # float32's relative roundoff far above QP_SOLVE_TOL's absolute limits,
    # which were set on QPs whose x is ≪ 1
    qps_err, qps_lim, qps_unsolved = {}, {}, {}
    for name, p in zip(REDUCED_QP_NAMES[tag], seen["qp_solve"]):
        cpu = {k: p[k].cpu() for k in "HgCd"}
        c64 = {k: v.double() for k, v in cpu.items()}
        kw = dict(ridge=p["ridge"], mirror=p["mirror"])
        ref_c = qp_solve_plain(cpu["H"], cpu["g"], cpu["C"], cpu["d"], iters=COLD_ITERS, **kw)
        ker_c = qp_cuda.qp_solve(p["H"], p["g"], p["C"], p["d"], iters=COLD_ITERS, **kw)
        f64_c = qp_solve_plain(c64["H"], c64["g"], c64["C"], c64["d"], iters=COLD_ITERS, **kw)
        x0, lam0 = ref_c[0], ref_c[2]
        ref_w = qp_solve_plain(cpu["H"], cpu["g"], cpu["C"], cpu["d"], x0, lam0,
                               iters=WARM_ITERS, **kw)
        ker_w = qp_cuda.qp_solve(p["H"], p["g"], p["C"], p["d"], x0.to(dev), lam0.to(dev),
                                 iters=WARM_ITERS, **kw)
        f64_w = qp_solve_plain(c64["H"], c64["g"], c64["C"], c64["d"], x0.double(),
                               lam0.double(), iters=WARM_ITERS, **kw)
        torch.cuda.synchronize()
        for t_, ref, ker, f64 in (("cold", ref_c, ker_c, f64_c), ("warm", ref_w, ker_w, f64_w)):
            for t in ker:
                assert torch.isfinite(t).all(), (tag, name, t_)
            every = torch.ones(B, dtype=torch.bool)
            _, g_own, p_own = qp_errs(c64, ref, f64, every)
            # lanes the plain float32 version leaves unsolved (gap or primal
            # residual above QP_FAIL: config 3's nc resultant QP, whose rows
            # float32 assembles as noise, see reduced_serving) are compared
            # by count: the kernel may leave no more, within phase 13's
            # spread; every other lane by value
            solved = (g_own <= QP_FAIL) & (p_own <= QP_FAIL)
            qps_err[(name, t_)], g_k, p_k = qp_errs(c64, ker, ref, solved)
            own = qp_errs(c64, ref, f64, solved)[0]
            n_ker = int(((g_k > QP_FAIL) | (p_k > QP_FAIL)).sum())
            n_plain = B - int(solved.sum())
            qps_unsolved[(name, t_)] = (n_ker, n_plain)
            assert n_ker <= 1.25 * n_plain + 1e-3 * B, (tag, name, t_, n_ker, n_plain)
            own["gap"] = max(own["gap"], float(g_own[solved].max()))
            lim = {k: max(QP_SOLVE_TOL[k], REDUCED_QP_OWN * own[k]) for k in own}
            # a float32 solution meets its rows to float32 roundoff of their
            # scale: ε₃₂·max |d| (QP_SOLVE_TOL's limit is that of a unit row)
            lim["pres"] = max(lim["pres"], EPS32 * float(cpu["d"].abs().max()))
            qps_lim[(name, t_)] = lim
    print(f"reduced {tag}: qp_solve vs plain float32 (max abs err of x, gap and pres; of λ "
          f"relative to 1 + |λ|; <= the larger of QP_SOLVE_TOL and {REDUCED_QP_OWN:g} × the "
          "plain float32's own error against float64): "
          + "  ".join(f"{n}.{t}: " + " ".join(f"{k} {v:.3e} <= {qps_lim[(n, t)][k]:.3e}"
                                             for k, v in e.items())
                      + " lanes unsolved (kernel, plain) {}".format(qps_unsolved[(n, t)])
                      for (n, t), e in qps_err.items()))
    for (n, t), e in qps_err.items():
        for k, v in e.items():
            assert v <= qps_lim[(n, t)][k], (tag, n, t, k, v, qps_lim[(n, t)][k])
    return seen, psd_abs, qps_err


def reduced_serving(dev, model, tag, tick, q, qd, fs, card):
    """Phases 24 and 25, one configuration: ReducedTick(cuda) at batch B — a
    cold tick at COLD_ITERS, K − 1 warm ticks at WARM_ITERS carrying (x, λ)
    (q[:, 6:39] += 1e-6·tanh(τ_cmd) between ticks), one unbatched tick —
    its launch counts set to 0 just before and read just after; the truth
    guard on 4 lanes; the warm chain's solves/s beside CompiledTick(cuda)'s
    on the same inputs, the unbatched warm tick, and the warm tick's device
    time split by torch.profiler.  Returns (launches, solves/s)."""
    from libdwbc_tpu_torch.ops import _build, linalg_cuda, qp_cuda
    from libdwbc_tpu_torch.profile_tick import tick_split
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick
    from libdwbc_tpu_torch.wbc.reduced_tick import ReducedTick

    md = model.model_dof
    q_d, qd_d = torch.as_tensor(q, device=dev), torch.as_tensor(qd, device=dev)
    fs_d = tuple(torch.as_tensor(f, device=dev) for f in fs)

    def step(qq, warm, iters, tk=tick):
        res, warm = tk._tick_impl(qq, qd_d.to(qq.dtype), tuple(f.to(qq.dtype) for f in fs_d),
                                  warm=warm, qp_iters=iters)
        qq = qq.clone()
        qq[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd)
        return res, qq, warm

    def serve(tk, qq):
        """The serving chain of tick tk: K ticks at batch B from qq."""
        warm, results = tk.init_warm((B,)), []
        for k in range(K):
            res, qq, warm = step(qq, warm, COLD_ITERS if k == 0 else WARM_ITERS, tk)
            results.append(res)
        return results, warm

    linalg_cuda.launches["psd_inverse"] = 0
    qp_cuda.launches["qp_solve"] = 0
    results, warm = serve(tick, q_d)
    res1 = tick._tick_impl(q_d[0], qd_d[0], tuple(f[0] for f in fs_d))
    torch.cuda.synchronize()
    launches = {"psd_inverse": linalg_cuda.launches["psd_inverse"],
                "qp_solve": qp_cuda.launches["qp_solve"]}
    print(f"ReducedTick {tag} serving path: {K} ticks at batch {B} + 1 unbatched tick, "
          f"launches {launches}")
    # per tick: psd_inverse on A (n = 39), A_R (co_dof + 12) and, with a
    # contact free space, W + V2ᵀV2 (co_dof + 6); qp_solve on every QP that
    # init_warm lists (each co level, the nc resultant, the redistribution)
    n_inv = 2 + (tick.ridx.co_dof + 6 >= 16
                 and sum(c.contact_dof for c in tick.cfg.contacts) > 6)
    n_qp = len(tick.init_warm())
    assert (n_inv, n_qp) == {"flagship": (3, 3), "config 3": (2, 2)}[tag], (n_inv, n_qp)
    assert launches == {"psd_inverse": n_inv * (K + 1), "qp_solve": n_qp * (K + 1)}, launches
    for r in results + [res1]:
        for name, v in r._asdict().items():
            if v.dtype != torch.bool:
                assert torch.isfinite(v).all(), f"ReducedTick {tag}: non-finite {name}"
    assert res1.torque_cmd.shape == (md,)
    assert [tuple(x.shape) + tuple(l.shape) for x, l in warm] == [
        (B, nv, B, m) for nv, m in REDUCED_QP_DIMS[tag]]

    def flagged(rs):
        return (sum(int(r.qp_error.sum()) for r in rs), max(float(r.qp_gap.max()) for r in rs),
                max(float(r.qp_primal_res.max()) for r in rs))

    n_err, gap_max, pres_max = flagged(results)
    print(f"ReducedTick {tag} serving path: gap max {gap_max:.3e}  pres max {pres_max:.3e}  "
          f"qp_error lane-ticks {n_err} of {K * B}  unbatched τ_cmd[0:3] "
          f"{res1.torque_cmd[:3].tolist()} (qp_error {bool(res1.qp_error)})")
    if tag == "flagship":
        assert n_err == 0 and gap_max <= QP_FAIL and pres_max <= QP_FAIL
        assert not bool(res1.qp_error)
    else:
        # In single support the nc resultant QP's torque map J_base_R_kt is
        # zero to roundoff (2e-14 in float64): float32 assembles it as noise
        # of ~3e-2 and flags lanes, the JAX package's float32 tick too, while
        # float64 flags none.  The kernels may flag no more lane-ticks than
        # the plain float32 tick on the card, within the spread of two
        # rollouts that part on roundoff (phase 13's rule); the same chain in
        # float64 on the card flags none.
        plain = flagged(serve(ReducedTick(model, tick.cfg, dev, backend="torch"), q_d)[0])
        f64 = ReducedTick(model, tick.cfg, dev, torch.float64, backend="torch")
        r64, _ = serve(f64, q_d.double())
        n64 = flagged(r64)
        print(f"ReducedTick {tag} serving path, the same chain through the plain float32 tick "
              f"on the card: qp_error lane-ticks {plain[0]}, gap max {plain[1]:.3e}, pres max "
              f"{plain[2]:.3e}; through the plain float64 tick on the card: {n64[0]}, "
              f"{n64[1]:.3e}, {n64[2]:.3e}")
        assert n_err <= 1.25 * plain[0] + 1e-3 * K * B, (n_err, plain[0])
        assert n64[0] == 0 and n64[2] <= QP_FAIL, n64

    # the truth guard: tick 0 on four lanes against the port's ReducedTick
    # and CompiledTick (the independent formulation) in float64 on the CPU
    lanes = (q[:4].astype(np.float64), qd[:4].astype(np.float64),
             tuple(f[:4].astype(np.float64) for f in fs))
    r64 = ReducedTick(model, tick.cfg, "cpu", torch.float64, backend="torch")
    rr64, _ = r64._tick_impl(*lanes, warm=r64.init_warm((4,)), qp_iters=COLD_ITERS)
    c64 = CompiledTick(model, tick.cfg, "cpu", torch.float64, backend="torch")
    rc64, _ = c64._tick_impl(*lanes, warm=c64.init_warm((4,)), qp_iters=COLD_ITERS)
    n64 = ReducedTick(model, tick.cfg, "cpu", torch.float64, backend="torch",
                      tangential_weight=False)
    rn64, _ = n64._tick_impl(*lanes, warm=n64.init_warm((4,)), qp_iters=COLD_ITERS)
    d_grav = maxerr(results[0].torque_grav[:4], rr64.torque_grav)
    d_cmd = maxerr(results[0].torque_cmd[:4], rr64.torque_cmd)
    d_grav_c = maxerr(results[0].torque_grav[:4], rc64.torque_grav)
    print(f"ReducedTick {tag} truth guard (4 lanes): vs ReducedTick float64 τ_grav "
          f"{d_grav:.3e} τ_cmd {d_cmd:.3e}; vs CompiledTick float64 τ_grav {d_grav_c:.3e}; "
          f"printed, not held (the flat-face rule): τ_cmd of ReducedTick(tangential_weight="
          f"False) float64 vs CompiledTick float64 {maxerr(rn64.torque_cmd, rc64.torque_cmd):.3e}, "
          f"ReducedTick(cuda) vs CompiledTick float64 {maxerr(results[0].torque_cmd[:4], rc64.torque_cmd):.3e}")
    assert max(d_grav, d_cmd, d_grav_c) <= TAU_GRAV_TOL, (tag, d_grav, d_cmd, d_grav_c)

    # phase 25: the warm chain, the unbatched warm tick, the device split
    def chain(tk=tick, w0=warm, n=K - 1):
        qq_, w_ = q_d, w0
        for _ in range(n):
            _, qq_, w_ = step(qq_, w_, WARM_ITERS, tk)

    chain_ms = cuda_time(chain, 1)
    solves = B * (K - 1) / (chain_ms / 1e3)
    ctick = CompiledTick(model, tick.cfg, dev, backend="cuda")
    _, cwarm = ctick._tick_impl(q_d, qd_d, fs_d, warm=ctick.init_warm((B,)), qp_iters=COLD_ITERS)
    c_solves = B * (K - 1) / (cuda_time(lambda: chain(ctick, cwarm), 1) / 1e3)
    q1, qd1, fs1 = q_d[0], qd_d[0], tuple(f[0] for f in fs_d)
    _, warm1 = tick._tick_impl(q1, qd1, fs1, warm=tick.init_warm(()), qp_iters=COLD_ITERS)
    single_warm_ms = cuda_time(lambda: tick._tick_impl(q1, qd1, fs1, warm=warm1,
                                                       qp_iters=WARM_ITERS), 10)
    print(f"ReducedTick {tag} warm chain: {K - 1} ticks at batch {B} in {chain_ms:.3f} ms -> "
          f"{solves:.1f} solves/s (CompiledTick, same inputs and run: {c_solves:.1f} solves/s); "
          f"unbatched warm tick ({WARM_ITERS} iterations) {single_warm_ms:.3f} ms, against the "
          f"single-lane bar of 1 ms  [{card}]")
    split = tick_split(lambda: chain(n=K_SPLIT), K_SPLIT, _build.library())
    psd_prof = sum(e.time_range.end - e.time_range.start for e in split["kernels"]
                   if "psd_inverse_kernel" in e.name) / 1e3 / K_SPLIT
    wall = chain_ms / (K - 1)
    print(f"ReducedTick {tag} warm tick at batch {B}, split per tick: wall {wall:.3f} ms (CUDA "
          f"events around the chain); under torch.profiler the device busy {split['busy']:.3f} "
          f"ms: qp_solve {split['qp_prof']:.3f} ms ({split['qp_launches']:g} launches; "
          f"{split['qp_events']:.3f} ms by CUDA events around them), psd_inverse "
          f"{psd_prof:.3f} ms, the other kernels {split['busy'] - split['qp_prof'] - psd_prof:.3f} "
          f"ms ({len(split['kernels']) / K_SPLIT:.0f} device kernels per tick); the host alone "
          f"(the device idle) {wall - split['busy']:.3f} ms; device busy share "
          f"{split['busy'] / wall:.3f}  [{card}]")
    return launches, solves


def reduced_kernel_times(seen, tag, times, card):
    """Phase 25: each kernel at the reduced shapes against its plain version
    on the card, at B and 1 (qp_solve warm at WARM_ITERS from the kernel's
    cold solve), and psd_inverse against torch.linalg.inv.  Returns the
    library times by (n, batch)."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_plain
    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_plain

    lib_ms = {}
    for A in seen["psd_inverse"][1:]:
        n = A.shape[-1]
        for nb in (B, 1):
            An = A[:nb].contiguous()
            times[("psd_inverse", tag, n, nb)] = interleaved(
                lambda: psd_inverse_plain(An), lambda: linalg_cuda.psd_inverse(An), 2, 10)
            lib_ms[(n, nb)] = cuda_time(lambda: torch.linalg.inv(An), 10)
            p, kt, gk = times[("psd_inverse", tag, n, nb)]
            print(f"time psd_inverse reduced {tag} n {n} batch {nb}: kernel {kt:.3f} ms (graph "
                  f"replay {gk:.3f} ms)  plain (torch on the card) {p:.3f} ms  "
                  f"torch.linalg.inv {lib_ms[(n, nb)]:.3f} ms  [{card}]")
    for name, p in zip(REDUCED_QP_NAMES[tag], seen["qp_solve"]):
        kw = dict(iters=WARM_ITERS, ridge=p["ridge"], mirror=p["mirror"])
        x0, _, lam0 = qp_cuda.qp_solve(p["H"], p["g"], p["C"], p["d"], iters=COLD_ITERS,
                                       ridge=p["ridge"], mirror=p["mirror"])
        for nb in (B, 1):
            a = [t[:nb].contiguous() for t in (p["H"], p["g"], p["C"], p["d"], x0, lam0)]
            times[("qp_solve", tag, name, nb)] = interleaved(
                lambda: qp_solve_plain(*a, **kw), lambda: qp_cuda.qp_solve(*a, **kw), 2, 10)
            pt, kt, gk = times[("qp_solve", tag, name, nb)]
            print(f"time qp_solve reduced {tag} {name} (warm, {WARM_ITERS} iterations) batch "
                  f"{nb}: kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  plain (torch on the "
                  f"card) {pt:.3f} ms  [{card}]")
    return lib_ms


def hands_masked_loop(dev, model, card, times):
    """Phase 22: the masked four-candidate sweep — FusedTick(masked=True,
    cuda) on the hands-and-feet candidates through make_control_loop over
    B_M scenarios (entry._hands_masked_inputs: the hypotheses of entry.
    HANDS_HYPOTHESES cycled over the lanes) and K_M ticks, tick 0 at the
    configuration's qp_iters, then warm at WARM_ITERS, gap_fallback
    GAP_FALLBACK, its launch counts set to 0 just before and read just
    after: every output finite, no qp_error, primal residual ≤ QP_FAIL, the
    normal forces summing below −400 N on every lane and tick; the kernels'
    times at B_M and 1 against their plain versions on the card (into
    times) and the loop's solves/s.  Returns (launches, TickKernels)."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    md = model.model_dof
    hcfg = entry._hands_feet_config(model)
    q, qd, fs, masks = entry._hands_masked_inputs(model, B_M, seed=0)
    q_d, qd_d, m_d = (torch.as_tensor(a, device=dev) for a in (q, qd, masks))
    fs_d = tuple(torch.as_tensor(f, device=dev) for f in fs)
    tick = FusedTick(model, hcfg, dev, backend="cuda", masked=True)
    plan = tick.prog.plan
    fz = []

    def advance(qq, qd_, res, dt):
        fz.append(float(normal_force(res, plan).max()))
        qq = qq.clone()
        qq[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd)
        return qq, qd_

    loop = make_control_loop(tick, transition=advance, K=K_M, warm_start=True,
                             warm_iters=WARM_ITERS, gap_fallback=GAP_FALLBACK)
    torch.cuda.synchronize()
    for k in tick.kernels.launches:
        tick.kernels.launches[k] = 0
    tick.prestage_reuses = 0
    t0 = time.perf_counter()
    lr = loop(q_d, qd_d, fs_d, m_d)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = dict(tick.kernels.launches)
    n_solve = K_M + lr.refined_ticks
    m_err, m_pres = int(lr.qp_error.sum()), float(lr.qp_primal_res.max())
    print(f"hands-and-feet masked sweep (make_control_loop, gap_fallback {GAP_FALLBACK:g}): "
          f"{K_M} ticks at batch {B_M}, tick 0 at {hcfg.qp_iters} iterations, refined ticks "
          f"{lr.refined_ticks} ({tick.prestage_reuses} on their warm tick's prestage), "
          f"launches {launches}, {loop_s * 1e3:.3f} ms; qp_error "
          f"ticks×lanes {m_err}  qp_primal_res max {m_pres:.3e}  Σ normal force max "
          f"{max(fz):.1f} N")
    assert launches == {"tick_prestage": n_solve - tick.prestage_reuses,
                        "tick_qpchain": n_solve}, launches
    for name, v in lr._asdict().items():
        if isinstance(v, torch.Tensor) and v.dtype != torch.bool:
            assert torch.isfinite(v).all(), f"hands masked loop: non-finite {name}"
    assert m_err == 0 and m_pres <= QP_FAIL and max(fz) < -400.0

    kern = tick.kernels
    plain_dev = TickProgram(model, hcfg, dev, torch.float32, masked=True)
    q_el, cm_el = q_d.T.contiguous(), m_d.T.contiguous()
    fs_el = [f.T.contiguous() for f in fs_d]
    for nb in (B_M, 1):
        qe, ce = q_el[:, :nb].contiguous(), cm_el[:, :nb].contiguous()
        fe = [f[:, :nb].contiguous() for f in fs_el]
        pre_buf = kern.prestage_packed(qe, ce)
        pre_d = kern.unpack_pre(pre_buf)
        w_d = kern.unpack_result(*kern.qpchain_packed(pre_buf, fe, None, COLD_ITERS))["warm_out"]
        times[("tick_prestage_hands_masked", nb)] = interleaved(
            lambda: plain_dev.prestage(qe, ce), lambda: kern.prestage_packed(qe, ce), 1, 3)
        times[("tick_qpchain_hands_masked", nb)] = interleaved(
            lambda: plain_dev.qpchain(pre_d, fe, w_d, WARM_ITERS),
            lambda: kern.qpchain_packed(pre_buf, fe, w_d, WARM_ITERS), 1, 3)
        for name in ("tick_prestage_hands_masked", "tick_qpchain_hands_masked"):
            p, kt, gk = times[(name, nb)]
            print(f"time {name} batch {nb}: kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  "
                  f"plain (torch on the card) {p:.3f} ms  [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(q_d, qd_d, fs_d, m_d)
    torch.cuda.synchronize()
    loop_s2 = time.perf_counter() - t0
    print(f"hands-and-feet masked sweep at batch {B_M}, {K_M} ticks: fallback loop "
          f"{loop_s2 * 1e3:.3f} ms -> {B_M * K_M / loop_s2:.1f} solves/s  [{card}]")
    return launches, kern


FACADE_REPS = 50           # the facade's OSF-HQP and reduced methods: median of 50 calls
FACADE_OWN = 4.0           # a card result's limit in units of plain float32's own error
B_BRIDGE = 1024            # BatchedRlWBCBridge and the hypothesis sweep: environments
K_RL = 16                  # RlWBCBridge ticks


def count_launches(fn):
    """(fn's result, {"psd_inverse": n, "qp_solve": n}): the kernel
    launches of one call of fn, the counts set to 0 just before and read
    just after."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda

    linalg_cuda.launches["psd_inverse"] = 0
    qp_cuda.launches["qp_solve"] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"psd_inverse": linalg_cuda.launches["psd_inverse"],
                 "qp_solve": qp_cuda.launches["qp_solve"]}


def osf_tick(rd, flags, q, qd, fs):
    """One OSF-HQP tick through the facade, stage by stage: its statuses,
    torques and each QP's x."""
    from libdwbc_tpu_torch import entry

    entry._facade_set(rd, flags, q, qd, fs)
    status = [rd.CalcContactConstraint()]
    rd.CalcGravCompensation()
    status += [rd.CalcTaskControlTorque(), rd.CalcContactRedistribute()]
    out = {"status": status, "qp_error": rd.qp_error_, "torque_grav": rd.torque_grav_,
           "torque_task": rd.torque_task_, "torque_contact": rd.torque_contact_,
           "torque_cmd": rd.torque_grav_ + rd.torque_task_ + rd.torque_contact_}
    out.update({f"x level {h}": r.x for h, r in enumerate(rd.qp_results)})
    if rd.cspace.NwJw.shape[-1]:
        out["x redistribution"] = rd.cf_redis_qp_
    return out


def reduced_chain(rd):
    """The facade's Reduced* chain on its current state: statuses, torques
    and each QP's x."""
    rd.ReducedDynamicsCalculate()
    status = [rd.ReducedCalcContactConstraint()]
    rd.ReducedCalcGravCompensation()
    status.append(rd.ReducedCalcTaskControlTorque())
    out = {}
    if rd.cspace_r.NwJw.shape[-1]:
        status.append(rd.ReducedCalcContactRedistribute())
        out["x redistribution"] = rd.redist_r_result.x
    out.update({"status": status, "torque_grav": rd.torque_grav_, "torque_task": rd.torque_task_,
                "torque_contact": rd.torque_contact_,
                "torque_cmd": rd.torque_grav_ + rd.torque_task_ + rd.torque_contact_})
    out.update({f"x qp {i}": r.x for i, r in enumerate(rd._r_qp_results)})
    return out


def accel_methods(rd):
    """The facade's LQP, JACC, _R and _R_NC methods on its current state,
    in the facade tests' order: each method's torque."""
    rd.ConfigureLQP()
    out = {"LQP": rd.CalcControlTorqueLQP(), "JACC": rd.CalcTaskControlTorqueJACC()}
    rd.ReducedDynamicsCalculate()
    rd.ReducedCalcContactConstraint()
    out["JACC_R"] = rd.CalcTaskControlTorqueJACC_R()
    out["JACC_R_NC"] = rd.CalcTaskControlTorqueJACC_R_NC()
    rd.ConfigureLQP_R()
    out["LQP_R"] = rd.CalcControlTorqueLQP_R()
    rd.ConfigureLQP_R_NC(rd.lqp_r_result.y[:rd._ridx.reduced_system_dof])
    out["LQP_R_NC"] = rd.CalcControlTorqueLQP_R_NC()
    return out


def own_guard(tag, got, f32, f64, keys):
    """Each key of got within FACADE_OWN × plain float32's own distance
    from float64 (at least QP_SOLVE_TOL's x limit), as phase 23 holds the
    kernels; returns the errors and limits."""
    from libdwbc_tpu_torch.ops.qp_cuda import QP_SOLVE_TOL

    rows = {}
    for k in keys:
        assert torch.isfinite(torch.as_tensor(got[k])).all(), (tag, k)
        e, own = maxerr(torch.as_tensor(got[k]), torch.as_tensor(f64[k])), maxerr(
            torch.as_tensor(f32[k]), torch.as_tensor(f64[k]))
        rows[k] = (e, max(FACADE_OWN * own, QP_SOLVE_TOL["x"]))
    print(f"{tag} vs the port's facade in float64 on the CPU (max abs err <= {FACADE_OWN:g} × "
          "plain float32's own): " + "  ".join(f"{k} {e:.3e} <= {lim:.3e}"
                                               for k, (e, lim) in rows.items()))
    for k, (e, lim) in rows.items():
        assert e <= lim, (tag, k, e, lim)
    return rows


def capture_calls(fn):
    """fn run once with the psd_inverse and qp_solve wrappers wrapped to
    keep a copy of each call's inputs and output; returns (fn's result,
    the copies: psd_inverse's (A, A⁻¹), qp_solve's dicts)."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp_cuda

    seen = {"psd_inverse": [], "qp_solve": []}
    inv, solve = linalg_cuda.psd_inverse, qp_cuda.qp_solve

    def copy(t):
        return None if t is None else t.clone()

    def inv_rec(A):
        out = inv(A)
        seen["psd_inverse"].append((A.clone(), out.clone()))
        return out

    def solve_rec(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6, mirror=0):
        rec = dict(H=H.clone(), g=g.clone(), C=C.clone(), d=d.clone(), x0=copy(x0),
                   lam0=copy(lam0), iters=iters, ridge=ridge, mirror=mirror)
        out = solve(H, g, C, d, x0, lam0, iters=iters, ridge=ridge, mirror=mirror)
        rec["out"] = tuple(t.clone() for t in out)
        seen["qp_solve"].append(rec)
        return out

    linalg_cuda.psd_inverse, qp_cuda.qp_solve = inv_rec, solve_rec
    try:
        out = fn()
    finally:
        linalg_cuda.psd_inverse, qp_cuda.qp_solve = inv, solve
    torch.cuda.synchronize()
    return out, seen


def facade_qp_vs_plain(tag, p):
    """One qp_solve launch of the facade (capture_calls' record, with its
    output) against the plain version on the same inputs in float32 on the
    CPU, by phase 23's rule: x, λ and the gap within the larger of
    QP_SOLVE_TOL and REDUCED_QP_OWN × the plain float32 version's own
    distance from a float64 solve of the same QP (the gap: or its own gap),
    the primal residual within float32 roundoff of the rows' scale; the
    kernel may leave no problem unsolved (gap or primal residual above
    QP_FAIL) that the plain version solves.  The objective ½xᵀHx + gᵀx,
    which a face of solutions shares where x is not unique, is held
    relative to 1 + |objective| by the same rule.  Returns the errors."""
    from libdwbc_tpu_torch.ops.qp_cuda import QP_SOLVE_TOL, qp_solve_plain

    cpu = [p[k].cpu() for k in "HgCd"]
    c64 = {k: v.double() for k, v in zip("HgCd", cpu)}
    warm = [None if p[k] is None else p[k].cpu() for k in ("x0", "lam0")]
    kw = dict(iters=p["iters"], ridge=p["ridge"], mirror=p["mirror"])
    ref = qp_solve_plain(*cpu, *warm, **kw)
    f64 = qp_solve_plain(*c64.values(), *(None if w is None else w.double() for w in warm), **kw)
    every = torch.ones(cpu[2].shape[0], dtype=torch.bool)
    for t in p["out"]:
        assert torch.isfinite(t).all(), tag
    err, g_k, p_k = qp_errs(c64, p["out"], ref, every)
    own, g_own, p_own = qp_errs(c64, ref, f64, every)
    own["gap"] = max(own["gap"], float(g_own.max()))

    def objective(x):
        x = x.cpu().double()
        return 0.5 * (x * (c64["H"] @ x[..., None])[..., 0]).sum(-1) + (c64["g"] * x).sum(-1)

    o_ref = objective(ref[0])
    err["obj"] = float(((objective(p["out"][0]) - o_ref).abs() / (1.0 + o_ref.abs())).max())
    own["obj"] = float(((objective(f64[0]) - o_ref).abs() / (1.0 + o_ref.abs())).max())
    # the objective's floor: float32 roundoff, relative
    lim = {k: max(QP_SOLVE_TOL.get(k, 16 * EPS32), REDUCED_QP_OWN * own[k]) for k in own}
    lim["pres"] = max(lim["pres"], EPS32 * float(cpu[3].abs().max()))
    n_ker = int(((g_k > QP_FAIL) | (p_k > QP_FAIL)).sum())
    n_plain = int(((g_own > QP_FAIL) | (p_own > QP_FAIL)).sum())
    _, nc, nv = cpu[2].shape
    print(f"{tag}: qp_solve (n {nv}, m {nc}, mirror {p['mirror']}, {p['iters']} iterations, "
          f"{'warm' if warm[0] is not None else 'cold'}) as launched vs plain float32 on the same "
          "inputs (x, gap, pres absolute; λ and the objective relative to 1 + |.|; <= the larger "
          f"of QP_SOLVE_TOL and {REDUCED_QP_OWN:g} × plain float32's own error against float64): "
          + "  ".join(f"{k} {v:.3e} <= {lim[k]:.3e}" for k, v in err.items())
          + f"; unsolved (kernel, plain) ({n_ker}, {n_plain})")
    assert n_ker <= n_plain, (tag, n_ker, n_plain)
    for k, v in err.items():
        assert v <= lim[k], (tag, k, v, lim[k])
    return err


def cascade_objectives(levels, y):
    """Per level of an LQP cascade, the values it minimizes in turn at y:
    ‖B y + b‖ and ‖max(A y + a, 0)‖ over rows normalized as the cascade
    normalizes them, and yᵀHy; float64, flat."""
    y = y.detach().cpu().double()
    out = []
    for L in levels:
        terms = [(L.B, L.b, False)] + ([(L.A, L.a, True)] if L.A is not None else [])
        for M, v, one_sided in terms:
            M, v = M.detach().cpu().double(), v.detach().cpu().double()
            nrm = torch.linalg.vector_norm(M, dim=-1)
            r = (M @ y + v) / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
            out.append(torch.linalg.vector_norm(torch.clamp_min(r, 0.0) if one_sided else r))
        if L.H is not None:
            out.append(y @ L.H.detach().cpu().double() @ y)
    return torch.stack(out)


def lqp_r_y(rd, solve):
    """The facade's ConfigureLQP_R + CalcControlTorqueLQP_R again on its
    current state, with qp_cuda.qp_solve replaced by solve: the cascade's
    y."""
    from libdwbc_tpu_torch.ops import qp_cuda

    kernel = qp_cuda.qp_solve
    qp_cuda.qp_solve = solve
    try:
        rd.ConfigureLQP_R()
        rd.CalcControlTorqueLQP_R()
    finally:
        qp_cuda.qp_solve = kernel
    return rd.lqp_r_result.y.clone()


def plain64_solve(H, g, C, d, x0=None, lam0=None, **kw):
    """The plain qp_solve in float64 on float32 inputs, its output float32."""
    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_plain

    def up(t):
        return None if t is None else t.double()

    return tuple(t.float() for t in qp_solve_plain(up(H), up(g), up(C), up(d), up(x0), up(lam0),
                                                   **kw))


def truth_guard(tag, got, f32, f64):
    """τ_grav within TAU_GRAV_TOL of the float64 facade's; τ_cmd within
    TAU_GRAV_TOL, or twice the plain float32 facade's own error where that
    is larger (phase 14's rule: the float32 task operators' relative ridge
    of 1e-4 puts the plain float32 facade itself up to 0.09 Nm from float64
    on the standing cases)."""
    d_grav = maxerr(got["torque_grav"], f64["torque_grav"])
    d_cmd = maxerr(got["torque_cmd"], f64["torque_cmd"])
    own = maxerr(f32["torque_cmd"], f64["torque_cmd"])
    lim = max(TAU_GRAV_TOL, 2.0 * own)
    print(f"{tag} truth guard vs the port's facade in float64 on the CPU: τ_grav {d_grav:.3e} "
          f"(<= {TAU_GRAV_TOL:g}) τ_cmd {d_cmd:.3e} (<= {lim:.3e}; plain float32's own "
          f"{own:.3e}) Nm")
    assert d_grav <= TAU_GRAV_TOL and d_cmd <= lim, (tag, d_grav, d_cmd, lim)


def facade_phase(dev, card):
    """Phase 26: the facade (RobotData(): the card, float32, backend cuda)
    on the flagship's standing cases 1 and 2 — the OSF-HQP tick, the
    Reduced* chain, the LQP and JACC methods — then after
    ChangeLinkToFixedJoint on the right wrist, and on config 3; each run's
    kernel launches counted (counts set to 0 just before, read just after)
    and held to what the routing rules give its shapes; the truth guard
    against the port's facade in float64 on the CPU, the plain float32
    facade on the CPU giving each field's own-error scale.  Returns the
    flagship OSF-HQP ticks' launches."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops import qp_cuda
    from libdwbc_tpu_torch.ops.qp_cuda import QP_SOLVE_TOL, qp_solve_plain
    from libdwbc_tpu_torch.wbc import lqp
    from libdwbc_tpu_torch.wbc import robot as robot_mod

    rd, flags = entry._facade()                 # the card, float32, backend cuda
    assert rd.device.type == "cuda" and rd.backend == "cuda" and rd.dtype == torch.float32
    r64, _ = entry._facade(torch.float64, "cpu", "torch")
    r32, _ = entry._facade(torch.float32, "cpu", "torch")
    osf_launches = {"psd_inverse": 0, "qp_solve": 0}
    for case, (q, qd, fs) in entry._facade_cases().items():
        tag = f"facade flagship case {case}"
        got, n = count_launches(lambda: osf_tick(rd, flags, q, qd, fs))
        for k in osf_launches:
            osf_launches[k] += n[k]
        print(f"{tag}: OSF-HQP tick launches {n}, statuses {got['status']}, "
              f"qp_error {got['qp_error']}")
        # psd_inverse on A (n = 39) and W + V2ᵀV2 (33); qp_solve on the two
        # level QPs (12, 86), (9, 86) and the redistribution QP (6, 86)
        assert n == {"psd_inverse": 2, "qp_solve": 3}, n
        assert got["status"] == [1, 1, 1] and got["qp_error"] == 0
        f64, f32 = osf_tick(r64, flags, q, qd, fs), osf_tick(r32, flags, q, qd, fs)
        truth_guard(f"{tag} OSF-HQP", got, f32, f64)
        own_guard(f"{tag} OSF-HQP", got, f32, f64,
                  ["torque_task"] + [k for k in got if k.startswith("x ")])

        got, n = count_launches(lambda: reduced_chain(rd))
        print(f"{tag}: Reduced* chain launches {n} (after the OSF-HQP tick's "
              f"UpdateKinematics), statuses {got['status']}")
        # psd_inverse on A_R (24), the reduced W + V2ᵀV2 (18) and the full
        # W + V2ᵀV2 (33); qp_solve on the pelvis level, the nc resultant and
        # the redistribution QP
        assert n == {"psd_inverse": 3, "qp_solve": 3}, n
        assert got["status"] == [1, 1, 1]
        f64, f32 = reduced_chain(r64), reduced_chain(r32)
        truth_guard(f"{tag} Reduced*", got, f32, f64)
        own_guard(f"{tag} Reduced*", got, f32, f64,
                  ["torque_task"] + [k for k in got if k.startswith("x ")])

        shapes = []
        plain = {m: m.solve_qp for m in (lqp, robot_mod)}

        def recorded(fn, where):
            def run(H, g, A, lb, ub, Aeq=None, *a, **kw):
                shapes.append((where, H.shape[-1], A.shape[-2], 0 if Aeq is None else
                               Aeq.shape[-2]))
                return fn(H, g, A, lb, ub, Aeq, *a, **kw)
            return run

        lqp.solve_qp = recorded(plain[lqp], "LQP level")
        robot_mod.solve_qp = recorded(plain[robot_mod], "JACC")
        try:
            (got, seen), n = count_launches(lambda: capture_calls(lambda: accel_methods(rd)))
        finally:
            lqp.solve_qp, robot_mod.solve_qp = plain[lqp], plain[robot_mod]
        takes = [qp_cuda.kernel_takes(nv, m, 0) and p == 0 for _, nv, m, p in shapes]
        print(f"{tag}: LQP / JACC / _R / _R_NC launches {n}; their QPs (n, m, equality rows; "
              "* where qp_solve takes it — the others have equality rows or n > 24): "
              + ", ".join(f"{w} ({nv}, {m}, {p}){'*' if t else ''}"
                          for (w, nv, m, p), t in zip(shapes, takes)))
        # psd_inverse on the reduced dynamics' A_R and both W + V2ᵀV2;
        # qp_solve on each QP the routing rule takes (the reduced cascade's
        # (18, 92) level), none of the others
        assert n == {"psd_inverse": 3, "qp_solve": sum(takes)} and sum(takes) == 1, (n, shapes)
        assert [tuple(p["C"].shape) for p in seen["qp_solve"]] == [(1, 92, 18)], shapes
        facade_qp_vs_plain(f"{tag} LQP_R level (18, 92)", seen["qp_solve"][0])
        # the cascade's y as the path gave it, against the same facade on
        # the card with the plain version in the kernel's place: within
        # FACADE_OWN × how far that y moves when the plain version solves
        # the (18, 92) level in float64 (its face is flat along the feet's
        # internal force, which the cascade leaves free)
        y_k = rd.lqp_r_result.y.clone()
        y_p = lqp_r_y(rd, qp_solve_plain)
        y_64 = lqp_r_y(rd, plain64_solve)
        r = rd._ridx.reduced_system_dof
        y_rows = {}
        for part, sl in (("q̈", slice(0, r)), ("f_c", slice(r, None))):
            e, own = maxerr(y_k[sl], y_p[sl]), maxerr(y_p[sl], y_64[sl])
            y_rows[part] = (e, max(FACADE_OWN * own, QP_SOLVE_TOL["x"]), own)
        # and the cascade's objectives at y, which a face of solutions
        # shares (relative to 1 + |objective|; floor: float32 roundoff)
        o_k, o_p, o_64 = (cascade_objectives(rd._lqp_r_levels, y) for y in (y_k, y_p, y_64))
        e = float(((o_k - o_p).abs() / (1.0 + o_p.abs())).max())
        own = float(((o_64 - o_p).abs() / (1.0 + o_p.abs())).max())
        y_rows["objectives"] = (e, max(FACADE_OWN * own, 16 * EPS32), own)
        print(f"{tag}: LQP_R's y (the path's) vs the facade with plain qp_solve on the card (max "
              f"abs err, objectives relative; <= {FACADE_OWN:g} × its move under a float64 solve of "
              "the (18, 92) level): " + "  ".join(f"{k} {e:.3e} <= {lim:.3e} [own {own:.3e}]"
                                                  for k, (e, lim, own) in y_rows.items()))
        for k, (e, lim, _) in y_rows.items():
            assert e <= lim, (tag, k, e, lim)
        f64, f32 = accel_methods(r64), accel_methods(r32)
        own_guard(f"{tag} acceleration methods (torques)", got, f32, f64, list(got))

    # surgery on the card: the right wrist's joint fixed, then a tick
    q, qd, fs = entry._facade_cases()[1]
    outs = {}
    for key, (dt, dv, bk) in {"card": (torch.float32, None, "cuda"),
                              "f32": (torch.float32, "cpu", "torch"),
                              "f64": (torch.float64, "cpu", "torch")}.items():
        rs, fl = entry._facade(dt, dv, bk)
        j = int(rs.model.q_index[33])
        rs.ChangeLinkToFixedJoint(33)
        rs.SetTorqueLimit(np.full(rs.model_dof_, 300.0))   # the limits follow the dofs
        run = (lambda rs=rs, fl=fl: osf_tick(rs, fl, np.delete(q, j), np.delete(qd, j), fs))
        if key == "card":
            (outs[key], seen), n = count_launches(lambda: capture_calls(run))
            sizes = [A.shape[-1] for A, _ in seen["psd_inverse"]]
            print(f"facade after ChangeLinkToFixedJoint(33): {rs.model.ndof} dofs, launches {n}, "
                  f"psd_inverse at n = {sizes}")
            assert sizes == [38, 32] and n == {"psd_inverse": 2, "qp_solve": 3}, (sizes, n)
            assert outs[key]["status"] == [1, 1, 1] and outs[key]["qp_error"] == 0
        else:
            outs[key] = run()
    truth_guard("facade after ChangeLinkToFixedJoint(33)", outs["card"], outs["f32"], outs["f64"])

    # config 3 through the facade
    r3, flags3 = entry._facade(swing=True)
    r3_64, _ = entry._facade(torch.float64, "cpu", "torch", swing=True)
    r3_32, _ = entry._facade(torch.float32, "cpu", "torch", swing=True)
    for case, (q, qd, fs) in entry._facade_cases(swing=True).items():
        tag = f"facade config 3 case {case}"
        got, n = count_launches(lambda: osf_tick(r3, flags3, q, qd, fs))
        print(f"{tag}: OSF-HQP tick launches {n}, statuses {got['status']}, "
              f"qp_error {got['qp_error']}; by the routing rules: psd_inverse on A (39) and "
              "on W (33: one 6D contact, no V2), Λ_c (6) below n = 16; qp_solve on the three "
              "level QPs (6, 76), (3, 76), (6, 76) with 33 mirrored pairs; no free contact "
              "space, so no redistribution QP")
        assert n == {"psd_inverse": 2, "qp_solve": 3}, n
        assert got["status"] == [1, 1, 1] and got["qp_error"] == 0
        f64, f32 = osf_tick(r3_64, flags3, q, qd, fs), osf_tick(r3_32, flags3, q, qd, fs)
        truth_guard(f"{tag} OSF-HQP", got, f32, f64)
        own_guard(f"{tag} OSF-HQP", got, f32, f64,
                  ["torque_task"] + [k for k in got if k.startswith("x ")])
    return osf_launches


def median_ms(fn, reps):
    """Median ms of fn over reps calls, each synced, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def once_ms(fn):
    """ms of one synced call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def facade_times(dev, card, times):
    """Phase 27: ms per facade method and per OSF-HQP tick on the flagship
    and config 3 (median of FACADE_REPS synced calls after a warm-up; the
    LQP and JACC methods, 0.1-2 s a call on the plain IPM, one synced call
    each), the tick against the 1 ms bar (printed, not held), its
    device-busy share by torch.profiler with qp_solve's and psd_inverse's
    shares, and each kernel at the flagship facade's shapes at B = 1: as
    the tick launched it against its plain version (psd_inverse relative
    to max |A⁻¹| within PSD_INV_RTOL, qp_solve by facade_qp_vs_plain), and
    timed against its plain version on the card (psd_inverse also against
    torch.linalg.inv).  Returns the kernels' errors against their plain
    versions, torch.linalg.inv's time and the captured shapes."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops import _build, linalg_cuda, qp_cuda
    from libdwbc_tpu_torch.ops.linalg_cuda import PSD_INV_RTOL, psd_inverse_plain
    from libdwbc_tpu_torch.ops.qp_cuda import qp_solve_plain
    from libdwbc_tpu_torch.profile_tick import tick_split

    for swing in (False, True):
        name = "config 3" if swing else "flagship"
        rd, fl = entry._facade(swing=swing)
        q, qd, fs = entry._facade_cases(swing=swing)[1]
        osf_tick(rd, fl, q, qd, fs)
        tc0 = rd.torque_contact_

        def redistribute():
            rd.torque_contact_ = tc0
            rd.CalcContactRedistribute()

        rows = {"UpdateKinematics": lambda: rd.UpdateKinematics(q, qd),
                "CalcContactConstraint": rd.CalcContactConstraint,
                "CalcGravCompensation": rd.CalcGravCompensation,
                "CalcTaskSpace": rd.CalcTaskSpace,
                "CalcTaskControlTorque": lambda: rd.CalcTaskControlTorque(
                    update_task_space=False),
                "CalcContactRedistribute": redistribute,
                "OSF-HQP tick": lambda: osf_tick(rd, fl, q, qd, fs),
                "Reduced* chain": lambda: reduced_chain(rd)}
        ms = {k: median_ms(fn, FACADE_REPS) for k, fn in rows.items()}
        if not swing:
            rr = rd._ridx.reduced_system_dof

            def lqp_r_nc():
                rd.ConfigureLQP_R_NC(rd.lqp_r_result.y[:rr])
                rd.CalcControlTorqueLQP_R_NC()

            acc = {"LQP": lambda: (rd.ConfigureLQP(), rd.CalcControlTorqueLQP()),
                   "JACC": rd.CalcTaskControlTorqueJACC,
                   "JACC_R": rd.CalcTaskControlTorqueJACC_R,
                   "JACC_R_NC": rd.CalcTaskControlTorqueJACC_R_NC,
                   "LQP_R": lambda: (rd.ConfigureLQP_R(), rd.CalcControlTorqueLQP_R()),
                   "LQP_R_NC": lqp_r_nc}
            accel_methods(rd)
            ms.update({k: once_ms(fn) for k, fn in acc.items()})
        print(f"time facade {name} (ms per call, median of {FACADE_REPS} synced calls; LQP and "
              "JACC one synced call each): " + "  ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"  [{card}]")
        print(f"time facade {name}: OSF-HQP tick {ms['OSF-HQP tick']:.3f} ms against the "
              f"single-lane bar of 1 ms (printed, not held)  [{card}]")
        n_t = K_SPLIT
        split = tick_split(lambda: [osf_tick(rd, fl, q, qd, fs) for _ in range(n_t)], n_t,
                           _build.library())
        psd_prof = sum(e.time_range.end - e.time_range.start for e in split["kernels"]
                       if "psd_inverse_kernel" in e.name) / 1e3 / n_t
        wall = ms["OSF-HQP tick"]
        print(f"facade {name} OSF-HQP tick under torch.profiler, per tick: device busy "
              f"{split['busy']:.3f} ms of {wall:.3f} ms (busy share {split['busy'] / wall:.3f}); "
              f"qp_solve {split['qp_prof']:.3f} ms ({split['qp_launches']:g} launches, share "
              f"{split['qp_prof'] / wall:.3f}), psd_inverse {psd_prof:.3f} ms (share "
              f"{psd_prof / wall:.3f}), the other kernels "
              f"{split['busy'] - split['qp_prof'] - psd_prof:.3f} ms "
              f"({len(split['kernels']) / n_t:.0f} device kernels per tick)  [{card}]")

    # each kernel at the flagship facade's shapes, B = 1
    rd, fl = entry._facade()
    q, qd, fs = entry._facade_cases()[1]
    _, seen = capture_calls(lambda: osf_tick(rd, fl, q, qd, fs))
    out = {"psd_err": 0.0, "qp_err": 0.0, "lib_ms": None}
    for A, got in seen["psd_inverse"]:
        n = A.shape[-1]
        ref = psd_inverse_plain(A.cpu().double())
        e = maxerr(got, ref)
        scale = float(ref.abs().max())
        assert torch.isfinite(got).all() and e / scale <= PSD_INV_RTOL[n], (n, e / scale)
        out["psd_err"] = max(out["psd_err"], e)
        key = ("psd_inverse_facade", n, 1)
        times[key] = interleaved(lambda: psd_inverse_plain(A), lambda: linalg_cuda.psd_inverse(A),
                                 5, 20)
        lib = cuda_time(lambda: torch.linalg.inv(A), 20)
        if n == 39:
            out["lib_ms"] = lib
        p_, k_, g_ = times[key]
        print(f"time psd_inverse facade n {n} batch 1: kernel {k_:.3f} ms (graph replay {g_:.3f} "
              f"ms)  plain (torch on the card) {p_:.3f} ms  torch.linalg.inv {lib:.3f} ms; max "
              f"abs err vs plain float64 {e:.3e} (max |A⁻¹| {scale:.3e}; relative {e / scale:.3e} "
              f"<= {PSD_INV_RTOL[n]:g})  [{card}]")
    for name, p in zip(QP_NAMES, seen["qp_solve"]):
        out["qp_err"] = max(out["qp_err"], facade_qp_vs_plain(f"facade flagship {name}", p)["x"])
        kw = dict(iters=p["iters"], ridge=p["ridge"], mirror=p["mirror"])
        a = [p[k] for k in ("H", "g", "C", "d", "x0", "lam0")]
        times[("qp_solve_facade", name, 1)] = interleaved(
            lambda: qp_solve_plain(*a, **kw), lambda: qp_cuda.qp_solve(*a, **kw), 2, 20)
        p_, k_, g_ = times[("qp_solve_facade", name, 1)]
        print(f"time qp_solve facade {name} (n {p['H'].shape[-1]}, m {p['C'].shape[-2]}, mirror "
              f"{p['mirror']}; {'warm' if p['x0'] is not None else 'cold'}, {p['iters']} "
              f"iterations) batch 1: kernel {k_:.3f} ms (graph replay {g_:.3f} ms)  plain (torch "
              f"on the card) {p_:.3f} ms  [{card}]")
    out["seen"] = seen
    return out


def bridge_inputs(model, n, seed):
    """MuJoCo-layout qpos (x y z, qw qx qy qz, joints), qvel, qacc and the
    two f* of n perturbed standing robots, numpy float32."""
    from libdwbc_tpu_torch import entry

    q, _, fs = entry._example_inputs(model, np.float64)
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.concatenate([q[0:3], [q[39]], q[3:6], q[6:39]]), (n, 1))
    qpos[:, 7:] += 0.02 * rng.standard_normal((n, 33))
    qvel = 0.05 * rng.standard_normal((n, 39))
    f = [np.tile(x, (n, 1)) + 0.05 * rng.standard_normal((n, x.shape[0])) for x in fs]
    return tuple(a.astype(np.float32) for a in (qpos, qvel, np.zeros((n, 39)), f[0], f[1]))


def bridges_phase(dev, card):
    """Phase 28: RlWBCBridge on the card for K_RL ticks (2 + 3 launches a
    tick); BatchedRlWBCBridge at N = B_BRIDGE on CompiledTick(cuda) (2 + 3
    per solve, no lane with qp_error, the truth guard on 4 lanes against
    the port's RlWBCBridge in float64 on the CPU, solves/s); the hypothesis
    sweep at B = B_BRIDGE over the two feet's three modes (each mode's
    CompiledTick(cuda) launching its kernels; 2 lanes per mode against the
    port's sweep in float64 on the CPU: τ within 0.05 Nm, the same argmin
    over those lanes; solves/s)."""
    from libdwbc_tpu_torch import bridge, entry
    from libdwbc_tpu_torch.parallel import hypotheses as H
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    rl = bridge.RlWBCBridge()
    assert rl.rd_.backend == "cuda" and rl.rd_.device.type == "cuda"
    qpos, qvel, qacc, f0, f1 = bridge_inputs(rl.rd_.model, K_RL, 0)

    def rl_tick(k):
        rl.UpdateKinematics(qpos[k], qvel[k], qacc[k])
        rl.SetContact(True, True)
        rl.SetTaskSpace(0, f0[k])
        rl.SetTaskSpace(1, f1[k])
        rl.CalcTorque()
        return rl.getTorqueCommand(), rl.rd_.qp_error_

    outs, n = count_launches(lambda: [rl_tick(k) for k in range(K_RL)])
    assert n == {"psd_inverse": 2 * K_RL, "qp_solve": 3 * K_RL}, n
    assert all(np.isfinite(t).all() and len(t) == 33 and e == 0 for t, e in outs)
    rl_ms = median_ms(lambda: rl_tick(0), K_RL)
    print(f"RlWBCBridge on the card: {K_RL} ticks, launches {n}; {rl_ms:.3f} ms a tick (median "
          f"of {K_RL})  [{card}]")

    br = bridge.BatchedRlWBCBridge(B_BRIDGE)
    assert br.tick.backend == "cuda" and br.tick.device.type == "cuda"
    qpos, qvel, qacc, f0, f1 = bridge_inputs(br.model, B_BRIDGE, 1)
    tau, n = count_launches(lambda: br.solve(qpos, qvel, qacc, f0, f1))
    print(f"BatchedRlWBCBridge({B_BRIDGE}) on CompiledTick(cuda): one solve, launches {n}")
    assert n == {"psd_inverse": 2, "qp_solve": 3}, n
    assert tau.shape == (B_BRIDGE, 33) and np.isfinite(tau).all()
    m = br.model
    qs = bridge.mujoco_to_dwbc_q(qpos, m.ndof, m.model_dof, np.float32)
    res = br.tick._tick_impl(qs, qvel, (f0, f1))
    print(f"BatchedRlWBCBridge({B_BRIDGE}): lanes with qp_error {int(res.qp_error.sum())}; the "
          f"bridge's τ_cmd vs its tick's on the same inputs {maxerr(res.torque_cmd, torch.as_tensor(tau)):.3e}")
    assert not bool(res.qp_error.any())
    ref = bridge.RlWBCBridge(dtype=torch.float64, device="cpu", backend="torch")
    ref.rd_.qp_iters = 12                   # the batched bridge's budget
    d_grav = d_cmd = 0.0
    for i in range(4):
        ref.UpdateKinematics(qpos[i], qvel[i], qacc[i])
        ref.SetContact(True, True)
        ref.SetTaskSpace(0, f0[i])
        ref.SetTaskSpace(1, f1[i])
        ref.CalcTorque()
        d_grav = max(d_grav, maxerr(res.torque_grav[i], ref.rd_.torque_grav_))
        d_cmd = max(d_cmd, maxerr(torch.as_tensor(tau[i]), torch.as_tensor(
            ref.rd_.GetControlTorque())))
    print(f"BatchedRlWBCBridge truth guard (4 lanes) vs the port's RlWBCBridge in float64 on "
          f"the CPU: τ_grav {d_grav:.3e} τ_cmd {d_cmd:.3e} (Nm, <= {TAU_GRAV_TOL:g})")
    assert max(d_grav, d_cmd) <= TAU_GRAV_TOL
    solve_ms = median_ms(lambda: br.solve(qpos, qvel, qacc, f0, f1), 10)
    print(f"BatchedRlWBCBridge({B_BRIDGE}): {solve_ms:.3f} ms a solve (median of 10, inputs from "
          f"and torques to host numpy) -> {B_BRIDGE / solve_ms * 1e3:.1f} solves/s  [{card}]")

    cfg = standard_tocabi_config(m, qp_iters=12)
    modes, ticks = H.contact_mode_ticks(m, cfg.contacts, cfg.task_specs, cfg.torque_limit)
    assert all(t.backend == "cuda" for t in ticks)
    q, qd, fs = entry._swing_inputs(m, B_BRIDGE, seed=4)
    fs = fs[:2]
    mode_idx = np.arange(B_BRIDGE) % len(modes)
    (tau_s, cost, best), n = count_launches(
        lambda: H.hypothesis_sweep(m, modes, ticks, mode_idx, q, qd, fs))
    print(f"hypothesis_sweep over modes {modes} at B = {B_BRIDGE}: launches {n}; best lane "
          f"{int(best)} (mode {modes[int(mode_idx[int(best)])]})")
    # each mode's tick once: A and W + V2ᵀV2 (both feet) or W (one foot) on
    # psd_inverse; both feet's two level QPs and redistribution QP, each
    # single-support mode's two level QPs on qp_solve
    assert n == {"psd_inverse": 6, "qp_solve": 7}, n
    assert torch.isfinite(tau_s).all() and torch.isfinite(cost).all()
    lanes = np.array([0, 3, 1, 4, 2, 5])
    m64, t64 = H.contact_mode_ticks(m, cfg.contacts, cfg.task_specs, cfg.torque_limit,
                                    dtype=torch.float64, device="cpu", backend="torch")
    tau64, cost64, best64 = H.hypothesis_sweep(m, m64, t64, mode_idx[lanes], q[lanes].astype(
        np.float64), qd[lanes].astype(np.float64), tuple(f[lanes].astype(np.float64) for f in fs))
    d_tau = maxerr(tau_s[lanes], tau64)
    best_here = int(torch.argmin(cost[lanes].cpu()))
    print(f"hypothesis_sweep truth guard (2 lanes per mode) vs the port's sweep in float64 on "
          f"the CPU: τ {d_tau:.3e} Nm (<= {TAU_GRAV_TOL:g}); argmin over those lanes {best_here} "
          f"(float64 {int(best64)})")
    assert d_tau <= TAU_GRAV_TOL and best_here == int(best64)
    sweep_ms = median_ms(lambda: H.hypothesis_sweep(m, modes, ticks, mode_idx, q, qd, fs), 5)
    print(f"hypothesis_sweep at B = {B_BRIDGE}: {sweep_ms:.3f} ms a sweep (median of 5) -> "
          f"{B_BRIDGE / sweep_ms * 1e3:.1f} solves/s  [{card}]")


MESH_GRID = 32             # phase 29: the mesh step's (H, R) grid, B = MESH_GRID²
MESH_MASKS = np.array([[1, 1], [1, 0], [0, 1]], np.float32)   # both, left, right; lane % 3
RT_TICKS, RT_PERIOD_US = 10_000, 500   # phase 30: producer ticks and period
RT_BAR_US = 1000.0                     # the 1 kHz loop's bar (printed, not held)


def mesh_phase(dev, model, card):
    """Phase 29: the scenario mesh on the card — an NCCL process group of one
    rank on tcp://127.0.0.1, a 1 × 1 ('hyp', 'roll') mesh, and
    sharded_batch_solver over FusedTick(backend="cuda") on a MESH_GRID² grid
    of the flagship (entry._grid_inputs, seed 0), static and then masked
    (MESH_MASKS cycled over the lanes): a cold step at COLD_ITERS and K − 1
    warm steps at WARM_ITERS carrying (x, λ), the launch counts set to 0
    just before and read just after (exactly 2 per step); every lane's τ_cmd
    bit for bit one unsharded _tick_impl of the same chain on the flattened
    batch, and each step's best its argmin; the cold step's τ_cmd within
    TAU_CMD_TOL of the plain float32 tick on the card; the warm steps'
    solves/s beside the unsharded chain's.  Returns {tag: launches}."""
    import torch.distributed as dist

    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.parallel.mesh import (free_port, init_distributed, make_mesh,
                                                 shard_scenarios, sharded_batch_solver)
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    G, nb = MESH_GRID, MESH_GRID * MESH_GRID
    t0 = time.perf_counter()
    assert init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    out = {}
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = make_mesh()
        assert mesh.shape == {"hyp": 1, "roll": 1} and mesh.device_mesh is not None
        print(f"mesh: NCCL process group of {dist.get_world_size()} rank up in "
              f"{time.perf_counter() - t0:.1f} s, mesh {mesh.shape}")
        q, qd, fs = entry._grid_inputs(model, G, G)
        masks = MESH_MASKS[np.arange(nb) % 3].reshape(G, G, 2)
        cfg = standard_tocabi_config(model, qp_iters=COLD_ITERS)
        for tag, masked in (("static", False), ("masked", True)):
            tick = FusedTick(model, cfg, dev, backend="cuda", masked=masked)
            step, block_of = sharded_batch_solver(tick._tick_impl, mesh)
            assert block_of((G, G)) == (slice(0, G), slice(0, G))
            extra = (masks,) if masked else ()
            blk = shard_scenarios(mesh, q, qd, fs, *extra)
            flat = tuple(torch.as_tensor(a.reshape(nb, -1), device=dev) for a in (q, qd))
            flat_fs = tuple(torch.as_tensor(f.reshape(nb, -1), device=dev) for f in fs)
            flat_x = tuple(torch.as_tensor(a.reshape(nb, -1), device=dev) for a in extra)

            def sharded():
                """The chain through the mesh step: τ_cmd and best per step,
                and the warm steps' time (synced before and after only)."""
                warm, taus, bests = tick.init_warm((nb,)), [], []
                for k in range(K):
                    if k == 1:
                        torch.cuda.synchronize()
                        t_ = time.perf_counter()
                    (res, warm), best, _ = step(*blk, warm=warm, qp_iters=WARM_ITERS if k
                                                else COLD_ITERS)
                    taus.append(res.torque_cmd.reshape(nb, -1))
                    bests.append(best)
                torch.cuda.synchronize()
                return taus, bests, time.perf_counter() - t_

            def unsharded():
                """The same chain through one _tick_impl on the flat batch: each
                step's result and the warm steps' time."""
                warm, results = tick.init_warm((nb,)), []
                for k in range(K):
                    if k == 1:
                        torch.cuda.synchronize()
                        t_ = time.perf_counter()
                    res, warm = tick._tick_impl(*flat, flat_fs, *flat_x, warm=warm,
                                                qp_iters=WARM_ITERS if k else COLD_ITERS)
                    results.append(res)
                torch.cuda.synchronize()
                return results, time.perf_counter() - t_

            for k_ in tick.kernels.launches:
                tick.kernels.launches[k_] = 0
            taus, bests, t_sh = sharded()
            launches = dict(tick.kernels.launches)
            print(f"mesh ({tag}): {K} steps of the {G}x{G} grid, launches {launches}")
            assert launches == {"tick_prestage": K, "tick_qpchain": K}, launches
            refs, t_un = unsharded()
            for k, ref in enumerate(refs):
                cost = (ref.torque_cmd ** 2).sum(-1) + 1e6 * ref.qp_primal_res
                assert torch.equal(taus[k], ref.torque_cmd), (tag, k, maxerr(taus[k],
                                                                             ref.torque_cmd))
                assert int(bests[k]) == int(torch.argmin(cost)), (tag, k)
                assert torch.isfinite(taus[k]).all()
            n_err = sum(int(ref.qp_error.sum()) for ref in refs)
            plain = FusedTick(model, cfg, dev, torch.float32, backend="torch", masked=masked)
            err = maxerr(taus[0], plain._tick_impl(*flat, flat_fs, *flat_x,
                                                   qp_iters=COLD_ITERS).torque_cmd)
            # the timed pair again, in the other order
            t_un2, t_sh2 = unsharded()[1], sharded()[2]
            solves = (K - 1) * nb
            print(f"mesh ({tag}): every step's τ_cmd bit for bit the unsharded chain's, best "
                  f"its argmin (last step: {int(bests[-1])}); qp_error lane-steps {n_err} "
                  f"(recorded); cold τ_cmd vs the plain float32 tick on the card {err:.3e} Nm "
                  f"(<= {TAU_CMD_TOL:g})")
            assert err <= TAU_CMD_TOL, (tag, err)
            print(f"mesh ({tag}): warm steps {solves / t_sh:.1f} and {solves / t_sh2:.1f} "
                  f"solves/s sharded, the unsharded chain {solves / t_un:.1f} and "
                  f"{solves / t_un2:.1f} (host clock, synced before and after the {K - 1} "
                  f"warm steps)  [{card}]")
            out[tag] = launches
    finally:
        dist.destroy_process_group()
    return out


def native_phase(dev, model, card):
    """Phase 30: the native host runtime — the library built with g++ from
    native/, a golden round trip (the port's write_golden read back by the
    native reader, < 1e-15), then run_rt_loop for RT_TICKS producer ticks of
    RT_PERIOD_US: the producer writes a standing q moved by a smooth function
    of its tick, q̇ and f* alike, and the tick number; the consumer thread
    serves FusedTick(backend="cuda") unbatched through native.TickConsumer
    (cold at COLD_ITERS, then warm at WARM_ITERS, (x, λ) carried, τ_cmd
    written out), its launch counts set to 0 just before and read just
    after (exactly 2 per consumed tick).  Held: no torn read (every consumed
    state the producer's state of its own tick number, exactly), every τ
    finite and no qp_error, no exception stored by a callback, every τ_cmd
    bit for bit the same chain called directly on the consumed states, and
    the first within TAU_CMD_TOL of the plain float32 tick on the card.
    Printed: consumed ticks, missed deadlines, the consumer's latency
    against the 1 ms bar.  Returns the launches."""
    import tempfile

    from libdwbc_tpu_torch import entry, native
    from libdwbc_tpu_torch.utils.golden import write_golden
    from libdwbc_tpu_torch.wbc.fused import FusedTick

    t0 = time.perf_counter()
    so = native.build_native()
    native.get_lib()
    print(f"native: {so.name} built with g++ in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        M = np.random.default_rng(0).standard_normal((7, 5))
        write_golden(f"{tmp}/mat.bin", M)
        d = native.golden_diff_native(f"{tmp}/mat.bin", M)
    print(f"native: golden round trip {d:.3e}")
    assert d < 1e-15, d

    _, tick = entry._model_and_tick(dev, qp_iters=COLD_ITERS)
    assert isinstance(tick, FusedTick) and tick.backend == "cuda"
    assert native.WARM_ITERS == WARM_ITERS
    state_at = entry._rt_state(model, RT_PERIOD_US)
    cons = native.TickConsumer(tick)
    assert cons.state_dim == state_at(0).shape[0]
    outs = []

    def producer(state, t):
        state[:] = state_at(t)

    def consumer(state, out_):
        cons(state, out_)
        outs.append(out_.copy())

    for k in tick.kernels.launches:
        tick.kernels.launches[k] = 0
    stats = native.run_rt_loop(RT_PERIOD_US, RT_TICKS, cons.state_dim, cons.out_dim,
                               producer, consumer)
    torch.cuda.synchronize()
    launches = dict(tick.kernels.launches)
    n = stats["ticks"]
    torn = sum(not np.array_equal(s, state_at(int(s[-1]))) for s in cons.states)
    print(f"rt loop: {RT_TICKS} producer ticks at {RT_PERIOD_US} us, {n} consumed (ticks "
          f"{int(cons.states[0][-1])} to {int(cons.states[-1][-1])}), {torn} torn reads, "
          f"{stats['missed_deadlines']} missed producer deadlines (the Python producer shares "
          f"the GIL with the consumer), no exception stored by a callback; launches {launches}")
    print(f"rt loop: consumer latency avg {stats['avg_us']:.1f} min {stats['min_us']:.1f} max "
          f"{stats['max_us']:.1f} p99 {stats['p99_us']:.1f} us against the {RT_BAR_US:.0f} us "
          f"bar (printed, not held)  [{card}]")
    assert n == len(cons.states) == len(outs) > 0
    assert torn == 0, torn
    assert launches == {"tick_prestage": n, "tick_qpchain": n}, launches
    assert all(np.isfinite(o).all() for o in outs) and not any(cons.qp_error)
    warm = tick.init_warm()
    for k, s in enumerate(cons.states):
        q, qd, fs = cons.split(s)
        res, warm = tick._tick_impl(q, qd, fs, warm=warm,
                                    qp_iters=WARM_ITERS if k else COLD_ITERS)
        assert np.array_equal(res.torque_cmd.cpu().numpy(), outs[k].astype(np.float32)), k
    q, qd, fs = cons.split(cons.states[0])
    plain = FusedTick(model, tick.cfg, dev, torch.float32, backend="torch")
    err = maxerr(torch.as_tensor(outs[0]),
                 plain._tick_impl(q, qd, fs, qp_iters=COLD_ITERS).torque_cmd)
    print(f"rt loop: every τ_cmd bit for bit the directly called chain's; the first vs the "
          f"plain float32 tick on the card {err:.3e} Nm (<= {TAU_CMD_TOL:g})")
    assert err <= TAU_CMD_TOL, err
    return launches


def hands_pool(dev, card):
    """Phase 31: the benchmark's hands-and-feet rollout pool against its
    float64 reference (see the module docstring)."""
    from libdwbc_tpu_torch.wbc.loop import make_control_loop
    from wbcbench import program, recipes
    from wbcbench.harness import load_json
    from wbcbench.record import Recorder
    from wbcbench.reference import RefTick

    config = load_json(ROOT / "wbcbench" / "configs" / "tocabi_hands_feet.json")
    traffic = load_json(ROOT / "wbcbench" / "traffic" / "rollouts_b1024.json")
    lim = config["limits"]
    tick = program.build_tick(config, dev)
    ref = RefTick(config, dev, torch.float64)
    tdofs = ref.plan.level_tdofs
    B, K, gain = traffic["batch"], traffic["rollout_ticks"], traffic["nudge"]
    q0, fs0 = recipes.standing(traffic, tick.model.nq, tick.model.ndof)
    worst = {n: 0.0 for n in ("tau_grav_nm", "tau_task_nm", "force_tau_n", "task_x")}
    tally = {"calls": 0, "lanes": 0, "flagged": 0, "over": 0}
    blocks = {}

    def judge(calls):
        """Every unflagged lane of ``calls`` (one budget) against the
        reference from the call's own inputs."""
        def cat(f):
            return torch.cat([f(c) for c in calls], 0)

        q = cat(lambda c: c["q"])
        fs = [cat(lambda c, h=h: c["fstars"][h]) for h in range(len(tdofs))]
        warm = [(cat(lambda c, h=h: c["warm_in"][h][0]), cat(lambda c, h=h: c["warm_in"][h][1]))
                for h in range(len(tdofs) + 1)]
        out = ref.tick_el(q, fs, None, warm, calls[0]["iters"])
        res = {f: cat(lambda c, f=f: getattr(c["res"], f))
               for f in ("torque_grav", "torque_task", "torque_cmd", "contact_force", "qp_error")}
        ok = ~res["qp_error"]
        pre = out["pre"]
        want_f = (torch.einsum("ij...,j...->i...", pre["Jbar_act"],
                               res["torque_cmd"].T.double()) - pre["P_C"]).T
        lane = {"tau_grav_nm": (res["torque_grav"].double() - out["torque_grav"]).abs().amax(1),
                "tau_task_nm": (res["torque_task"].double() - out["torque_task"]).abs().amax(1),
                "force_tau_n": (res["contact_force"].double() - want_f).abs().amax(1),
                "task_x": torch.stack([
                    (cat(lambda c, h=h: c["warm_out"][h][0])[:, :t].double()
                     - out["warm_out"][h][0][:, :t]).abs().amax(1)
                    for h, t in enumerate(tdofs)], 0).amax(0)}
        over = torch.zeros_like(ok)
        for n, v in lane.items():
            v = torch.where(ok, v, torch.zeros_like(v))
            worst[n] = max(worst[n], float(v.max()))
            over |= v > lim[n]
        tally["calls"] += len(calls)
        tally["lanes"] += int(ok.numel())
        tally["flagged"] += int((~ok).sum())
        tally["over"] += int(over.sum())

    def offer(call):
        group = blocks.setdefault(call["iters"], [])
        group.append(call)
        if len(group) * B >= 4096:
            judge(group)
            group.clear()

    def flush():
        for group in blocks.values():
            if group:
                judge(group)
                group.clear()

    rec = Recorder(tick, config["warm_iters"])
    loop = make_control_loop(rec, lambda q, qd, res, dt: (recipes.nudge(q, res.torque_cmd, gain),
                                                           qd),
                             K=K, warm_start=True, warm_iters=config["warm_iters"],
                             gap_fallback=traffic["gap_fallback"])
    t0 = time.perf_counter()
    gen = recipes.generator(dev, traffic["pool_seed"])
    pool = [recipes.draw_batch(traffic, q0, fs0, (B,), gen, dev) for _ in range(traffic["pool"])]
    served_flagged, refined = 0, 0
    for d, (q, qd, fs) in enumerate(pool):
        sink = {}
        rec.arm(range(K), sink)
        out = loop(q, qd, fs)
        rec.arm((), None)
        served_flagged += int(out.qp_error.sum())
        refined += out.refined_ticks
        for k in range(K):
            for call in sink[k]:
                offer(call)
        del sink, out
    flush()
    print(f"hands-and-feet rollout pool (pool_seed {traffic['pool_seed']}, {len(pool)} draws x {B} "
          f"lanes, K = {K}): {tally['calls']} calls, {tally['lanes']} lane-solves against the "
          f"float64 reference, {tally['flagged']} flagged, {tally['over']} unflagged over the "
          f"limits; served lane-ticks flagged {served_flagged}; {refined} of "
          f"{len(pool) * (K - 1)} warm ticks re-solved; worst "
          + ", ".join(f"{n} {v:.4e} (limit {lim[n]:g})" for n, v in worst.items())
          + f"  ({time.perf_counter() - t0:.1f} s)  [{card}]")
    pool0, over0 = dict(worst), tally["over"]
    for key in worst:
        worst[key] = 0.0
    tally.update(calls=0, lanes=0, flagged=0, over=0)
    t0 = time.perf_counter()
    for seed in range(1, 9):
        gen = recipes.generator(dev, seed)
        for _ in range(traffic["pool"]):
            q, qd, fs = recipes.draw_batch(traffic, q0, fs0, (B,), gen, dev)
            warm = tick.init_warm((B,))
            res, wout = tick._tick_impl(q, qd, fs, warm=warm, qp_iters=config["cold_iters"])
            offer(dict(q=q, fstars=tuple(fs), warm_in=warm, iters=config["cold_iters"], res=res,
                       warm_out=wout))
    flush()
    print(f"hands-and-feet fresh pools (pool_seed 1-8, tick 0 cold at {config['cold_iters']}): "
          f"{tally['lanes']} lane-solves, {tally['flagged']} flagged, {tally['over']} unflagged "
          f"over the limits; worst "
          + ", ".join(f"{n} {v:.4e}" for n, v in worst.items())
          + f"  ({time.perf_counter() - t0:.1f} s)  [{card}]")
    assert over0 == 0, "hands-and-feet pool: an unflagged lane over the limits"
    assert served_flagged == 0, "hands-and-feet pool: a served lane-tick flagged"
    assert tally["over"] == 0, "hands-and-feet fresh pools: an unflagged lane over the limits"
    return pool0


def main():
    t_start = time.perf_counter()
    marks = [("1", t_start)]

    def phase(label):
        """Print the time of the phase that ends here and start the next."""
        prev, t_ = marks[-1]
        now = time.perf_counter()
        print(f"chip_smoke: phase {prev} took {now - t_:.1f} s")
        marks.append((label, now))

    # ------------------------------------------------------ 1. environment
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops import _build, linalg_cuda, qp_cuda
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.linalg_cuda import PSD_INV_RTOL, psd_inverse_plain
    from libdwbc_tpu_torch.ops.qp_cuda import QP_SOLVE_TOL, qp_solve_plain
    from libdwbc_tpu_torch.ops.tick_cuda import PRE_TOL, QP_TOL, TickKernels
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.profile_tick import tick_split
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import CompiledTick, standard_tocabi_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    print(f"card: {card}")
    dev = torch.device("cuda", 0)

    # ------------------------------------------------------------ 2. build
    phase("2")
    t0 = time.perf_counter()
    so, log = _build.build(verbose=True)
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    for name in KERNELS:
        assert f"{name}_kernel" in log or not log, f"no {name} kernel in the build log"
    spills = ptxas_spills(log)

    # ----------------------- 3. the fused tick's kernels vs their plain versions
    phase("3")
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

    # -------------------- 4. the compiled tick's kernels vs their plain versions
    phase("4")
    q_d = torch.as_tensor(qs, device=dev)
    qd_d = torch.zeros((B, model.ndof), device=dev)
    fs_d = tuple(torch.as_tensor(f, device=dev) for f in fs)
    md = model.model_dof
    _, ctick = entry._model_and_tick(dev, qp_iters=COLD_ITERS, fused=False)
    assert isinstance(ctick, CompiledTick) and ctick.backend == "cuda"
    seen = capture_kernel_inputs(ctick, q_d, qd_d, fs_d, COLD_ITERS)
    assert [tuple(A.shape) for A in seen["psd_inverse"]] == [(B, 39, 39), (B, 33, 33)]
    assert [(tuple(p["C"].shape), p["mirror"]) for p in seen["qp_solve"]] == [
        ((B, 86, n), 33) for n in (12, 9, 6)]

    psd_err, psd_abs = {}, {}
    for A in seen["psd_inverse"]:
        n = A.shape[-1]
        out = linalg_cuda.psd_inverse(A)
        torch.cuda.synchronize()
        ref = psd_inverse_plain(A.cpu().double())
        scale = float(ref.abs().max())
        psd_abs[n] = maxerr(out, ref)
        psd_err[n] = psd_abs[n] / scale
        own = maxerr(psd_inverse_plain(A.cpu()), ref) / scale
        symmetric = torch.equal(out, out.transpose(-1, -2))
        print(f"psd_inverse n = {n} vs plain float64 (max abs err / max |A⁻¹|, [plain "
              f"float32's own] <= limit): {psd_err[n]:.3e} [{own:.3e}] <= {PSD_INV_RTOL[n]:g}; "
              f"exactly symmetric: {symmetric}")
        assert torch.isfinite(out).all() and symmetric
        assert psd_err[n] <= PSD_INV_RTOL[n], (n, psd_err[n], PSD_INV_RTOL[n])

    qps_err = {}
    for name, p in zip(QP_NAMES, seen["qp_solve"]):
        cpu = {k: p[k].cpu() for k in "HgCd"}
        kw = dict(ridge=p["ridge"], mirror=p["mirror"])
        ref_c = qp_solve_plain(cpu["H"], cpu["g"], cpu["C"], cpu["d"], iters=COLD_ITERS, **kw)
        ker_c = qp_cuda.qp_solve(p["H"], p["g"], p["C"], p["d"], iters=COLD_ITERS, **kw)
        x0, lam0 = ref_c[0], ref_c[2]
        ref_w = qp_solve_plain(cpu["H"], cpu["g"], cpu["C"], cpu["d"], x0, lam0,
                               iters=WARM_ITERS, **kw)
        ker_w = qp_cuda.qp_solve(p["H"], p["g"], p["C"], p["d"], x0.to(dev), lam0.to(dev),
                                 iters=WARM_ITERS, **kw)
        torch.cuda.synchronize()
        for tag, ref, ker in (("cold", ref_c, ker_c), ("warm", ref_w, ker_w)):
            for t in ker:
                assert torch.isfinite(t).all(), (name, tag)
            g_k, p_k = gap_pres(cpu["C"], cpu["d"], ker[0].cpu(), ker[2].cpu())
            g_r, p_r = gap_pres(cpu["C"], cpu["d"], ref[0], ref[2])
            qps_err[(name, tag)] = dict(
                x=maxerr(ker[0], ref[0]),
                lam=float(((ker[2].cpu() - ref[2]).abs() / (1.0 + ref[2].abs())).max()),
                gap=maxerr(g_k, g_r), pres=maxerr(p_k, p_r))
            assert float(g_k.max()) <= QP_FAIL and float(p_k.max()) <= QP_FAIL, (name, tag)
    print("qp_solve vs plain float32 (max abs err of x, gap and pres; of λ relative to "
          "1 + |λ|): "
          + "  ".join(f"{n}.{t}: " + " ".join(f"{k} {v:.3e}" for k, v in e.items())
                      for (n, t), e in qps_err.items()))
    for (n, t), e in qps_err.items():
        for k, v in e.items():
            assert v <= QP_SOLVE_TOL[k], (n, t, k, v, QP_SOLVE_TOL[k])

    # ------------------------------------------------ 5. the serving paths
    phase("5")
    model, tick = entry._model_and_tick(dev, qp_iters=COLD_ITERS)
    assert isinstance(tick, FusedTick) and tick.backend == "cuda"

    def step(tk, qq, warm, iters):
        res, warm = tk._tick_impl(qq, qd_d, fs_d, warm=warm, qp_iters=iters)
        qq = qq.clone()
        qq[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd[:, :md])
        return res, qq, warm

    for k in tick.kernels.launches:
        tick.kernels.launches[k] = 0
    qq, warm = q_d, tick.init_warm((B,))
    results = []
    for k in range(K):
        res, qq, warm = step(tick, qq, warm, COLD_ITERS if k == 0 else WARM_ITERS)
        results.append(res)
    res1 = tick._tick_impl(q_d[0], qd_d[0], tuple(f[0] for f in fs_d))
    torch.cuda.synchronize()
    launches = dict(tick.kernels.launches)
    print(f"FusedTick serving path: {K} ticks at batch {B} + 1 unbatched tick, "
          f"launches {launches}")
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
    print(f"FusedTick serving path: gap max {gap_max:.3e}  pres max {pres_max:.3e}  "
          f"qp_error lanes {n_err}  unbatched τ_cmd[0:3] "
          f"{res1.torque_cmd[:3].tolist()}")
    assert n_err == 0 and gap_max <= QP_FAIL and pres_max <= QP_FAIL

    linalg_cuda.launches["psd_inverse"] = 0
    qp_cuda.launches["qp_solve"] = 0
    qq, cwarm = q_d, ctick.init_warm((B,))
    cresults = []
    for k in range(K_C):
        res, qq, cwarm = step(ctick, qq, cwarm, COLD_ITERS if k == 0 else WARM_ITERS)
        cresults.append(res)
    cres1 = ctick._tick_impl(q_d[0], qd_d[0], tuple(f[0] for f in fs_d))
    torch.cuda.synchronize()
    claunches = {"psd_inverse": linalg_cuda.launches["psd_inverse"],
                 "qp_solve": qp_cuda.launches["qp_solve"]}
    print(f"CompiledTick serving path: {K_C} ticks at batch {B} + 1 unbatched tick, "
          f"launches {claunches}")
    assert claunches == {"psd_inverse": 2 * (K_C + 1), "qp_solve": 3 * (K_C + 1)}, claunches
    for r in cresults + [cres1]:
        for name, v in r._asdict().items():
            if v.dtype != torch.bool:
                assert torch.isfinite(v).all(), f"CompiledTick: non-finite {name}"
    assert cres1.torque_cmd.shape == (md,) and not bool(cres1.qp_error)
    assert [tuple(x.shape) + tuple(l.shape) for x, l in cwarm] == [
        (B, nv, B, m) for nv, m in tick.prog.plan.qp_dims]
    cgap = max(float(r.qp_gap.max()) for r in cresults)
    cpres = max(float(r.qp_primal_res.max()) for r in cresults)
    c_err = sum(int(r.qp_error.sum()) for r in cresults)
    print(f"CompiledTick serving path: gap max {cgap:.3e}  pres max {cpres:.3e}  "
          f"qp_error lanes {c_err}  unbatched τ_cmd[0:3] {cres1.torque_cmd[:3].tolist()}")
    assert c_err == 0 and cgap <= QP_FAIL and cpres <= QP_FAIL

    # ------------------------------------------------------ 6. truth guard
    phase("6")
    # tick 0 on four lanes against float64 CPU ticks: the plain fused tick,
    # and the port's CompiledTick (the independent formulation) for both
    lanes = (qs[:4].astype(np.float64), np.zeros((4, model.ndof)),
             tuple(f[:4].astype(np.float64) for f in fs))
    _, ref_tick = entry._model_and_tick("cpu", dtype=torch.float64,
                                        qp_iters=COLD_ITERS, backend="torch")
    r64, _ = ref_tick._tick_impl(*lanes, warm=ref_tick.init_warm((4,)))
    _, ref_ctick = entry._model_and_tick("cpu", dtype=torch.float64, qp_iters=COLD_ITERS,
                                         backend="torch", fused=False)
    c64, _ = ref_ctick._tick_impl(*lanes, warm=ref_ctick.init_warm((4,)))
    for label, got, want in (("FusedTick(cuda) vs plain fused float64", results[0], r64),
                             ("FusedTick(cuda) vs CompiledTick float64", results[0], c64),
                             ("CompiledTick(cuda) vs CompiledTick float64", cresults[0], c64)):
        d_grav = maxerr(got.torque_grav[:4], want.torque_grav)
        d_cmd = maxerr(got.torque_cmd[:4], want.torque_cmd)
        print(f"truth guard, {label} (4 lanes): τ_grav {d_grav:.3e}  τ_cmd {d_cmd:.3e}")
        assert d_grav <= TAU_GRAV_TOL and d_cmd <= TAU_CMD_TOL, (label, d_grav, d_cmd)

    # ------------------------------------------------------------ 7. times
    phase("7")
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
        for (name, b_), (p, kt, gk) in times.items():
            if b_ == nb:
                print(f"time {name} batch {nb}: kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  "
                      f"plain (torch on the card) {p:.3f} ms  [{card}]")

    def chain():
        qq_, w_ = q_d, warm
        for _ in range(K - 1):
            _, qq_, w_ = step(tick, qq_, w_, WARM_ITERS)

    chain_ms = cuda_time(chain, 2)
    solves = B * (K - 1) / (chain_ms / 1e3)
    q1, qd1, fs1 = q_d[0], qd_d[0], tuple(f[0] for f in fs_d)
    single_ms = cuda_time(lambda: tick._tick_impl(q1, qd1, fs1), 10)
    _, warm1 = tick._tick_impl(q1, qd1, fs1, warm=tick.init_warm(()), qp_iters=COLD_ITERS)
    single_warm_ms = cuda_time(lambda: tick._tick_impl(q1, qd1, fs1, warm=warm1,
                                                       qp_iters=WARM_ITERS), 10)
    print(f"FusedTick warm chain: {K - 1} ticks at batch {B} in {chain_ms:.3f} ms -> "
          f"{solves:.1f} solves/s; unbatched cold tick ({COLD_ITERS} iterations) "
          f"{single_ms:.3f} ms, unbatched warm tick ({WARM_ITERS} iterations) "
          f"{single_warm_ms:.3f} ms, against the single-lane bar of 1 ms  [{card}]")

    lib_ms = {}
    for A in seen["psd_inverse"]:
        n = A.shape[-1]
        for nb in (B, 1):
            An = A[:nb].contiguous()
            times[("psd_inverse", n, nb)] = interleaved(
                lambda: psd_inverse_plain(An), lambda: linalg_cuda.psd_inverse(An), 2, 10)
            lib_ms[(n, nb)] = cuda_time(lambda: torch.linalg.inv(An), 10)
            p, kt, gk = times[("psd_inverse", n, nb)]
            print(f"time psd_inverse n {n} batch {nb}: kernel {kt:.3f} ms (graph replay "
                  f"{gk:.3f} ms)  plain (torch on the card) {p:.3f} ms  torch.linalg.inv "
                  f"{lib_ms[(n, nb)]:.3f} ms  [{card}]")
    for name, p in zip(QP_NAMES, seen["qp_solve"]):
        kw = dict(iters=WARM_ITERS, ridge=p["ridge"], mirror=p["mirror"])
        x0, _, lam0 = qp_cuda.qp_solve(p["H"], p["g"], p["C"], p["d"], iters=COLD_ITERS,
                                       ridge=p["ridge"], mirror=p["mirror"])
        for nb in (B, 1, B_M):            # B_M: the batch tiled, as MaskedTick's sweep
            a = [t.repeat((-(-nb // B),) + (1,) * (t.ndim - 1))[:nb].contiguous()
                 for t in (p["H"], p["g"], p["C"], p["d"], x0, lam0)]
            times[("qp_solve", name, nb)] = interleaved(
                lambda: qp_solve_plain(*a, **kw), lambda: qp_cuda.qp_solve(*a, **kw), 2, 10)
            pt, kt, gk = times[("qp_solve", name, nb)]
            print(f"time qp_solve {name} (warm, {WARM_ITERS} iterations) batch {nb}: "
                  f"kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  plain (torch on the card) "
                  f"{pt:.3f} ms  [{card}]")

    def cchain():
        qq_, w_ = q_d, cwarm
        for _ in range(K_C - 1):
            _, qq_, w_ = step(ctick, qq_, w_, WARM_ITERS)

    cchain_ms = cuda_time(cchain, 1)
    csolves = B * (K_C - 1) / (cchain_ms / 1e3)
    csingle_ms = cuda_time(lambda: ctick._tick_impl(q_d[0], qd_d[0],
                                                    tuple(f[0] for f in fs_d)), 3)
    print(f"CompiledTick warm chain: {K_C - 1} ticks at batch {B} in {cchain_ms:.3f} ms -> "
          f"{csolves:.1f} solves/s; unbatched cold tick {csingle_ms:.3f} ms  [{card}]")
    split = tick_split(cchain, K_C - 1, _build.library())
    print(f"CompiledTick warm tick at batch {B}, split per tick: wall {cchain_ms / (K_C - 1):.3f} "
          f"ms (CUDA events around the chain); qp_solve {split['qp_events']:.3f} ms by CUDA "
          f"events around its {split['qp_launches']:g} launches ({split['qp_prof']:.3f} ms by "
          f"torch.profiler); the device's other kernels {split['busy'] - split['qp_prof']:.3f} "
          f"ms; the host alone (the device idle) {cchain_ms / (K_C - 1) - split['busy']:.3f} "
          f"ms; device busy share {split['busy'] / (cchain_ms / (K_C - 1)):.3f} "
          f"(busy {split['busy']:.3f} ms: the union of its kernels' intervals, torch.profiler)  "
          f"[{card}]")

    # --------------------- 8. the masked kernels vs their plain versions
    phase("8")
    from libdwbc_tpu_torch.ops.tick_cuda import PRE_TOL_MASKED, QP_TOL_MASKED
    from libdwbc_tpu_torch.wbc.loop import make_control_loop
    from libdwbc_tpu_torch.wbc.masked import MaskedTick

    mq, mqd, mfs, mmask = entry._masked_inputs(model, B_M, seed=0)
    mplain64 = TickProgram(model, cfg, "cpu", torch.float64, masked=True)
    mplain32 = TickProgram(model, cfg, "cpu", torch.float32, masked=True)
    mkern = TickKernels(TickProgram(model, cfg, dev, torch.float32, masked=True))
    mq_el = torch.as_tensor(np.ascontiguousarray(mq.T))
    mcm_el = torch.as_tensor(np.ascontiguousarray(mmask.T))
    mfs_el = [torch.as_tensor(np.ascontiguousarray(f.T)) for f in mfs]
    q_n, cm_n = mq_el[:, :N_M].contiguous(), mcm_el[:, :N_M].contiguous()
    fs_n = [f[:, :N_M].contiguous() for f in mfs_el]
    mpre64 = mplain64.prestage(q_n.double(), cm_n.double())
    mpre_k = mkern.prestage(q_n.to(dev), cm_n.to(dev))
    torch.cuda.synchronize()
    mpre_own = mplain32.prestage(q_n, cm_n)
    mpre_err, mpre_own_err = {}, {}
    for name in PRE_TOL_MASKED:
        got, own, want = mpre_k[name], mpre_own[name], mpre64[name]
        if name == "Ntorques":
            got, own, want = (torch.cat([t.reshape(-1, N_M) for t in x], 0)
                              for x in (got, own, want))
        assert torch.isfinite(got).all(), f"masked prestage: non-finite {name}"
        mpre_err[name] = per_hyp(got, want, N_M)
        mpre_own_err[name] = per_hyp(own, want, N_M)
    print("tick_prestage (masked) vs plain float64, per hypothesis "
          f"{'/'.join(HYPOTHESES)} (max abs err, [plain float32's own] <= limit): "
          + "  ".join(f"{k} " + "/".join(f"{e:.3e}" for e in v)
                      + " [" + "/".join(f"{e:.3e}" for e in mpre_own_err[k])
                      + f"] <= {PRE_TOL_MASKED[k]:g}" for k, v in mpre_err.items()))
    for k in ("crow_mask", "active_cdof"):
        assert torch.equal(mpre_k[k].cpu().double(), mpre64[k]), k
    lane = torch.arange(N_M) % 3
    nw, jb = mpre_k["NwJw"].cpu(), mpre_k["Jbar_act"].cpu()
    zero_ok = (not nw[..., lane != 0].any() and not jb[6:, :, lane == 1].any()
               and not jb[:6, :, lane == 2].any())
    print(f"tick_prestage (masked): crow_mask and active_cdof exact; single-support "
          f"lanes' NwJw and dead rows of J̄ᵀ exact zeros: {zero_ok}")
    assert zero_ok
    for k, v in mpre_err.items():
        assert max(v) <= PRE_TOL_MASKED[k], (k, v, PRE_TOL_MASKED[k])
    assert max(mpre_err["torque_grav"]) <= TAU_GRAV_TOL

    mpre32 = {k: ([t.float() for t in v] if isinstance(v, list) else v.float())
              for k, v in mpre64.items()}
    mpre32_dev = {k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
                  for k, v in mpre32.items()}
    mfs_dev = [f.to(dev) for f in fs_n]
    mref_cold = mplain32.qpchain(mpre32, fs_n, None, COLD_ITERS)
    mker_cold = mkern.qpchain(mpre32_dev, mfs_dev, None, COLD_ITERS)
    mw_cpu = mref_cold["warm_out"]
    mref_warm = mplain32.qpchain(mpre32, fs_n, mw_cpu, WARM_ITERS)
    mker_warm = mkern.qpchain(mpre32_dev, mfs_dev, [(x.to(dev), l.to(dev)) for x, l in mw_cpu],
                              WARM_ITERS)
    torch.cuda.synchronize()
    mqp_err = {}
    for tag, ref, ker in (("cold", mref_cold, mker_cold), ("warm", mref_warm, mker_warm)):
        for name in list(QP_TOL_MASKED) + ["qp_gap", "qp_primal_res"]:
            assert torch.isfinite(ker[name]).all(), f"masked tick_qpchain: non-finite {name}"
            mqp_err[f"{tag}.{name}"] = per_hyp(ker[name], ref[name], N_M)
        assert float(ker["qp_primal_res"].max()) <= QP_FAIL, tag
    print("tick_qpchain (masked) vs plain float32, per hypothesis (max abs err): "
          + "  ".join(f"{k} " + "/".join(f"{e:.3e}" for e in v) for k, v in mqp_err.items()))
    for tag in ("cold", "warm"):
        for name, tol in QP_TOL_MASKED.items():
            assert max(mqp_err[f"{tag}.{name}"]) <= tol, (tag, name, mqp_err[f"{tag}.{name}"])

    mchain_k = mkern.qpchain(mpre_k, mfs_dev, None, COLD_ITERS)
    mchain64 = mplain64.qpchain(mpre64, [f.double() for f in fs_n], None, COLD_ITERS)
    mchain32 = mplain32.qpchain(mpre_own, fs_n, None, COLD_ITERS)
    mchain_err = {k: per_hyp(mchain_k[k], mchain64[k], N_M) for k in CHAIN_TOL_MASKED}
    print("tick_prestage → tick_qpchain (masked) vs plain float64 tick, per hypothesis "
          "(max abs err, [plain float32's own] <= limit): " + "  ".join(
              f"{k} " + "/".join(f"{e:.3e}" for e in v) + " ["
              + "/".join(f"{e:.3e}" for e in per_hyp(mchain32[k], mchain64[k], N_M))
              + f"] <= {CHAIN_TOL_MASKED[k]:g}" for k, v in mchain_err.items()))
    for k, v in mchain_err.items():
        assert max(v) <= CHAIN_TOL_MASKED[k], (k, v)

    # ------------------------------------------ 9. the masked serving path
    phase("9")
    _, mtick = entry._model_and_tick(dev, qp_iters=COLD_ITERS, masked=True)
    assert isinstance(mtick, FusedTick) and mtick.masked and mtick.backend == "cuda"
    mq_d, mqd_d, mm_d = (torch.as_tensor(a, device=dev) for a in (mq, mqd, mmask))
    mfs_d = tuple(torch.as_tensor(f, device=dev) for f in mfs)

    def advance(qq, qd, res, dt):
        qq = qq.clone()
        qq[:, 6:6 + md] += 1e-6 * torch.tanh(res.torque_cmd)
        return qq, qd

    loop = make_control_loop(mtick, transition=advance, K=K_M, warm_start=True,
                             warm_iters=WARM_ITERS, gap_fallback=GAP_FALLBACK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in mtick.kernels.launches:
        mtick.kernels.launches[k] = 0
    mtick.prestage_reuses = 0
    t0 = time.perf_counter()
    lr = loop(mq_d, mqd_d, mfs_d, mm_d)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    mlaunches = dict(mtick.kernels.launches)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    n_solve = K_M + lr.refined_ticks
    print(f"masked serving path (make_control_loop, gap_fallback {GAP_FALLBACK:g}): {K_M} "
          f"ticks at batch {B_M}, refined ticks {lr.refined_ticks} ({mtick.prestage_reuses} "
          f"on their warm tick's prestage), launches {mlaunches}, "
          f"peak device memory {peak_mb:.1f} MiB, {loop_s * 1e3:.3f} ms")
    assert mlaunches == {"tick_prestage": n_solve - mtick.prestage_reuses,
                         "tick_qpchain": n_solve}, mlaunches
    for name, v in lr._asdict().items():
        if isinstance(v, torch.Tensor) and v.dtype != torch.bool:
            assert torch.isfinite(v).all(), f"masked loop: non-finite {name}"
    assert lr.torques.shape == (K_M, B_M, md)
    m_err, m_pres = int(lr.qp_error.sum()), float(lr.qp_primal_res.max())
    print(f"masked serving path: qp_error ticks×lanes {m_err}  qp_primal_res max {m_pres:.3e}")
    assert m_err == 0 and m_pres <= QP_FAIL

    def plain_chain():
        """The warm chain without the fallback: (q, max gap, max residual)."""
        res, w_ = mtick._tick_impl(mq_d, mqd_d, mfs_d, mm_d,
                                   warm=mtick.init_warm((B_M,)), qp_iters=COLD_ITERS)
        qq, _ = advance(mq_d, mqd_d, res, 0.0)
        gaps, pres_ = [], []
        for _ in range(K_M - 1):
            res, w_ = mtick._tick_impl(qq, mqd_d, mfs_d, mm_d, warm=w_, qp_iters=WARM_ITERS)
            qq, _ = advance(qq, mqd_d, res, 0.0)
            gaps.append(res.qp_gap.max())
            pres_.append(res.qp_primal_res.max())
        return qq, torch.stack(gaps).max(), torch.stack(pres_).max()

    _, nofb_gap, nofb_pres = plain_chain()
    print(f"masked warm chain without the fallback: qp_gap_max {float(nofb_gap):.6e}  "
          f"qp_primal_res_max {float(nofb_pres):.6e} (recorded, not asserted)")

    # ------------------------------------------------ 10. masked truth guard
    phase("10")
    r0m, _ = mtick._tick_impl(mq_d, mqd_d, mfs_d, mm_d, warm=mtick.init_warm((B_M,)),
                              qp_iters=COLD_ITERS)
    nl = 6
    lanes_m = (mq[:nl].astype(np.float64), mqd[:nl].astype(np.float64),
               tuple(f[:nl].astype(np.float64) for f in mfs), mmask[:nl].astype(np.float64))
    _, mref = entry._model_and_tick("cpu", dtype=torch.float64, qp_iters=COLD_ITERS,
                                    backend="torch", masked=True)
    mr64, _ = mref._tick_impl(*lanes_m, warm=mref.init_warm((nl,)))
    mt64 = MaskedTick(model, cfg, "cpu", torch.float64, backend="torch")
    mt64r, _ = mt64._tick_impl(*lanes_m, warm=mt64.init_warm((nl,)))
    for label, want in (("plain masked fused float64", mr64), ("MaskedTick float64", mt64r)):
        d_grav = [maxerr(r0m.torque_grav[h:nl:3], want.torque_grav[h::3]) for h in range(3)]
        d_cmd = [maxerr(r0m.torque_cmd[h:nl:3], want.torque_cmd[h::3]) for h in range(3)]
        print(f"masked truth guard, FusedTick(masked, cuda) vs {label} ({nl} lanes, per "
              f"hypothesis): τ_grav " + "/".join(f"{e:.3e}" for e in d_grav)
              + "  τ_cmd " + "/".join(f"{e:.3e}" for e in d_cmd))
        assert max(d_grav) <= TAU_GRAV_TOL and max(d_cmd) <= TAU_CMD_TOL, (label, d_grav, d_cmd)

    # ------------------------------------------------------ 11. masked times
    phase("11")
    mplain_dev = TickProgram(model, cfg, dev, torch.float32, masked=True)
    for nb in (B_M, 1):
        qe, ce = mq_el[:, :nb].contiguous().to(dev), mcm_el[:, :nb].contiguous().to(dev)
        fe = [f[:, :nb].contiguous().to(dev) for f in mfs_el]
        pre_buf = mkern.prestage_packed(qe, ce)
        pre_d = mkern.unpack_pre(pre_buf)
        w_d = mkern.unpack_result(*mkern.qpchain_packed(pre_buf, fe, None, COLD_ITERS))["warm_out"]
        times[("tick_prestage_masked", nb)] = interleaved(
            lambda: mplain_dev.prestage(qe, ce), lambda: mkern.prestage_packed(qe, ce), 2, 5)
        times[("tick_qpchain_masked", nb)] = interleaved(
            lambda: mplain_dev.qpchain(pre_d, fe, w_d, WARM_ITERS),
            lambda: mkern.qpchain_packed(pre_buf, fe, w_d, WARM_ITERS), 2, 5)
        for name in ("tick_prestage_masked", "tick_qpchain_masked"):
            p, kt, gk = times[(name, nb)]
            print(f"time {name} batch {nb}: kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  "
                  f"plain (torch on the card) {p:.3f} ms  [{card}]")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0_

    loop_s2 = timed(lambda: loop(mq_d, mqd_d, mfs_d, mm_d))
    chain_s = timed(plain_chain)
    print(f"masked sweep at batch {B_M}, {K_M} ticks (tick 0 cold at {COLD_ITERS} "
          f"iterations, then warm at {WARM_ITERS}): fallback loop {loop_s2 * 1e3:.3f} ms -> "
          f"{B_M * K_M / loop_s2:.1f} solves/s; plain warm chain {chain_s * 1e3:.3f} ms -> "
          f"{B_M * K_M / chain_s:.1f} solves/s  [{card}]")

    # ------------------------------- 12. the servo'd kernels vs their plain versions
    phase("12")
    from libdwbc_tpu_torch.ops.tick_cuda import SERVO_TOL, SERVO_ELEMS, TASK_STATE
    from libdwbc_tpu_torch.wbc.loop import forward_dynamics_transition
    from libdwbc_tpu_torch.wbc.pipeline import servos_to

    sq, sqd, sfs, servos = entry._servo_inputs(model, B, seed=0)
    stick = FusedTick(model, cfg, dev, backend="cuda")
    skern = stick.kernels
    s64 = FusedTick(model, cfg, "cpu", torch.float64, backend="torch")
    s32 = FusedTick(model, cfg, "cpu", torch.float32, backend="torch")
    sq_el, sqd_el = (torch.as_tensor(np.ascontiguousarray(a.T)) for a in (sq, sqd))
    sfs_el = [torch.as_tensor(np.ascontiguousarray(f.T)) for f in sfs]
    sv_dev, sv64, sv32 = (t._servos_el(servos, B) for t in (stick, s64, s32))

    def servo_fields(pre):
        """The servo section of a prestage dict: f* and the task states,
        each over the levels, (elem, lanes)."""
        out = {"fstars": torch.cat([f.reshape(-1, f.shape[-1]) for f in pre["fstars"]], 0)}
        for i, (name, _) in enumerate(TASK_STATE):
            out[name] = torch.cat([pre["task_states"][(h, 0)][i].reshape(-1, B)
                                   for h in range(len(pre["fstars"]))], 0)
        return out

    def check_servo(tag, kern_, p64, p32, q_el_, cm_el_, pre_tol, qp_tol, chain_tol, split):
        """Phase 12 on one plan: the servo'd prestage, the QP chain on a
        servo'd buffer and the two chained, each against its plain version;
        returns (servo f* error, QP chain τ_cmd error) for the record."""
        d = (lambda t: t.to(dev))
        cm_d = None if cm_el_ is None else d(cm_el_)
        pre_k = kern_.prestage(d(q_el_), cm_d, d(sqd_el), [d(f) for f in sfs_el], sv_dev)
        torch.cuda.synchronize()
        cm64 = None if cm_el_ is None else cm_el_.double()
        pre64 = p64.prestage_servo(q_el_.double(), cm64, sqd_el.double(),
                          [f.double() for f in sfs_el], sv64)
        own = p32.prestage_servo(q_el_, cm_el_, sqd_el, sfs_el, sv32)
        errs, own_errs = {}, {}
        for name in pre_tol:
            got, o, want = pre_k[name], own[name], pre64[name]
            if name == "Ntorques":
                got, o, want = (torch.cat([t.reshape(-1, B) for t in x], 0)
                                for x in (got, o, want))
            assert torch.isfinite(got).all(), f"servo'd prestage ({tag}): non-finite {name}"
            errs[name], own_errs[name] = split(got, want), split(o, want)
        sk, so, s64_ = servo_fields(pre_k), servo_fields(own), servo_fields(pre64)
        for name in SERVO_TOL:
            assert torch.isfinite(sk[name]).all(), f"servo'd prestage ({tag}): non-finite {name}"
            errs[name], own_errs[name] = split(sk[name], s64_[name]), split(so[name], s64_[name])
        limits = dict(pre_tol, **SERVO_TOL)
        print(f"tick_prestage (servo, {tag}) vs plain float64 (max abs err, [plain float32's "
              "own] <= limit): " + "  ".join(
                  f"{k} " + "/".join(f"{e:.3e}" for e in v) + " ["
                  + "/".join(f"{e:.3e}" for e in own_errs[k]) + f"] <= {limits[k]:g}"
                  for k, v in errs.items()))
        for k, v in errs.items():
            assert max(v) <= limits[k], (tag, k, v, limits[k])

        # The servo's f* drive the QPs onto active constraints, where float32
        # is far from float64 and two float32 solves of one recurrence part
        # by roundoff on a few lanes: each lane is held to the larger of the
        # flagship's limit and SERVO_OWN × its own float32 distance from
        # float64, at most SERVO_LANES_OVER of the lanes beyond
        # (tick_cuda.servo_lanes_over).  Beside the kernel's count stands
        # that of the plain float32 QP chain against itself with its inputs
        # moved by one ulp: the lanes roundoff alone puts beyond their bar.
        pre32 = cast(pre64, lambda t: t.float())
        pre32_d = cast(pre32, d)
        ref_c = p32.qpchain(pre32, pre32["fstars"], None, COLD_ITERS)
        ker_c = kern_.qpchain(pre32_d, None, None, COLD_ITERS)
        w_cpu = ref_c["warm_out"]
        ref_w = p32.qpchain(pre32, pre32["fstars"], w_cpu, WARM_ITERS)
        ker_w = kern_.qpchain(pre32_d, None, [(d(x), d(l)) for x, l in w_cpu], WARM_ITERS)
        pre32_64 = cast(pre32, lambda t: t.double())
        ref64_c = p64.qpchain(pre32_64, pre32_64["fstars"], None, COLD_ITERS)
        ref64_w = p64.qpchain(pre32_64, pre32_64["fstars"],
                              [(x.double(), l.double()) for x, l in w_cpu], WARM_ITERS)
        gen = torch.Generator().manual_seed(1)
        pre_ulp = cast(pre32, lambda t: t + (torch.randint(0, 3, t.shape, generator=gen) - 1)
                       .to(t.dtype) * t.abs() * 2.0 ** -23)
        # the masks stay exact; τ_grav passes through the QP chain unchanged
        pre_ulp.update({k: pre32[k] for k in ("crow_mask", "active_cdof", "torque_grav")
                        if k in pre32})
        ulp_c = p32.qpchain(pre_ulp, pre_ulp["fstars"], None, COLD_ITERS)
        ulp_w = p32.qpchain(pre_ulp, pre_ulp["fstars"], w_cpu, WARM_ITERS)
        torch.cuda.synchronize()
        qerr, lines, over_all = {}, [], []
        for mode, ref, ker, r64, ulp in (("cold", ref_c, ker_c, ref64_c, ulp_c),
                                         ("warm", ref_w, ker_w, ref64_w, ulp_w)):
            for name in list(qp_tol) + ["qp_gap", "qp_primal_res"]:
                assert torch.isfinite(ker[name]).all(), f"servo'd tick_qpchain: non-finite {name}"
                qerr[f"{mode}.{name}"] = split(ker[name], ref[name])
            for name, tol in qp_tol.items():
                own_ = tc.lane_err(ref[name], r64[name])
                over, allowed = tc.servo_lanes_over(tc.lane_err(ker[name], ref[name]), own_, tol)
                self_over, _ = tc.servo_lanes_over(tc.lane_err(ulp[name], ref[name]), own_, tol)
                lines.append(f"{mode}.{name} " + "/".join(f"{e:.3e}" for e in qerr[f"{mode}.{name}"])
                             + f" [own max {float(own_.max()):.3e} median "
                             f"{float(own_.median()):.3e}] lanes beyond {over} [plain vs itself "
                             f"{self_over}] <= {allowed}")
                over_all.append((mode, name, over, allowed))
        print(f"tick_qpchain (servo, {tag}) vs plain float32 (max abs err, [plain float32 vs "
              f"float64 on the same prestage, per lane], lanes beyond max(limit, "
              f"{tc.SERVO_OWN:g} × own)): " + "  ".join(lines))
        ch_k = kern_.qpchain(pre_k, None, None, COLD_ITERS)
        ch64 = p64.qpchain(pre64, pre64["fstars"], None, COLD_ITERS)
        ch32 = p32.qpchain(own, own["fstars"], None, COLD_ITERS)
        lines = []
        for k, tol in chain_tol.items():
            own_ = tc.lane_err(ch32[k], ch64[k])
            over, allowed = tc.servo_lanes_over(tc.lane_err(ch_k[k], ch64[k]), own_, tol)
            lines.append(f"{k} " + "/".join(f"{e:.3e}" for e in split(ch_k[k], ch64[k]))
                         + f" [own max {float(own_.max()):.3e} median {float(own_.median()):.3e}]"
                         f" lanes beyond {over} <= {allowed}")
            over_all.append(("chain", k, over, allowed))
        print(f"tick_prestage → tick_qpchain (servo, {tag}) vs plain float64 servo'd tick (max "
              f"abs err, [plain float32's own per lane], lanes beyond max(limit, "
              f"{tc.SERVO_OWN:g} × own)): " + "  ".join(lines))
        for mode, name, over, allowed in over_all:
            assert over <= allowed, (tag, mode, name, over, allowed)
        return max(errs["fstars"]), max(max(qerr["cold.torque_cmd"]), max(qerr["warm.torque_cmd"]))

    sfs_err, sqp_err = check_servo("static", skern, s64.prog, s32.prog, sq_el, None, PRE_TOL,
                                   QP_TOL, CHAIN_TOL, lambda g, w: [maxerr(g, w)])
    m64 = FusedTick(model, cfg, "cpu", torch.float64, backend="torch", masked=True)
    m32 = FusedTick(model, cfg, "cpu", torch.float32, backend="torch", masked=True)
    msfs_err, msqp_err = check_servo("masked, " + "/".join(HYPOTHESES), mkern, m64.prog,
                                     m32.prog, q_n, cm_n, PRE_TOL_MASKED, QP_TOL_MASKED,
                                     CHAIN_TOL_MASKED, lambda g, w: per_hyp(g, w, N_M))

    # ------------------------------------------ 13. the servo'd serving path
    phase("13")
    K_S, DT = 150, 1e-3
    _, ctrans = entry._model_and_tick(dev, qp_iters=COLD_ITERS, fused=False)
    trans = forward_dynamics_transition(ctrans)

    def tracking(nb, dtype=torch.float32):
        """The loop's inputs on the card: (q, q̇, f*, servos, targets);
        nb = 1 gives one unbatched robot."""
        tq, tqd, tfs, tsv, target = entry._tracking_inputs(
            model, nb, dtype=np.float64 if dtype == torch.float64 else np.float32)
        args = [torch.as_tensor(a, device=dev) for a in (tq, tqd)]
        args.append(tuple(torch.as_tensor(f, device=dev) for f in tfs))
        if nb == 1:
            args = [args[0][0], args[1][0], tuple(f[0] for f in args[2])]
        return args, servos_to(tsv, dtype, dev), tq, target

    def pelvis_ratio(q0_, qf, target):
        """Per lane: final pelvis error / initial pelvis error."""
        p0_ = entry._link_frames(model, q0_)[0].numpy()
        pf = entry._link_frames(model, qf.detach().cpu().double().reshape(-1, model.nq))[0].numpy()
        return np.linalg.norm(pf - target, axis=1) / np.linalg.norm(p0_ - target, axis=1)

    def run_loop(tk, nb, label, count, transition=trans, K_S=K_S):
        """One K_S-tick servo'd loop; with count, the launch counters set to
        0 just before and checked just after."""
        args, sv, tq, target = tracking(nb, tk.dtype)
        loop = make_control_loop(tk, transition=transition, K=K_S, dt=DT, warm_start=True,
                                 warm_iters=WARM_ITERS, gap_fallback=GAP_FALLBACK)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        if count:
            for k in tk.kernels.launches:
                tk.kernels.launches[k] = 0
            linalg_cuda.launches["psd_inverse"] = 0
        t0_ = time.perf_counter()
        lr = loop(*args, servos=sv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0_
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        for name, v in lr._asdict().items():
            if isinstance(v, torch.Tensor) and v.dtype != torch.bool:
                assert torch.isfinite(v).all(), f"servo'd loop ({label}): non-finite {name}"
        ratio = pelvis_ratio(tq, lr.q_final, target)
        n_err, pres = int(lr.qp_error.sum()), float(lr.qp_primal_res.max())
        err_lanes = int(lr.qp_error.reshape(K_S, -1).any(0).sum())
        print(f"servo'd serving path ({label}): {K_S} ticks at batch {nb}, refined ticks "
              f"{lr.refined_ticks}, {wall * 1e3:.3f} ms, peak device memory {peak:.1f} MiB; "
              f"pelvis error final / initial max {ratio.max():.4f} mean {ratio.mean():.4f}; "
              f"qp_error ticks×lanes {n_err} on {err_lanes} lanes, qp_primal_res max "
              f"{pres:.3e} (recorded)")
        out = dict(lr=lr, wall=wall, peak=peak, ratio=ratio, n_err=n_err, pres=pres,
                   n_err_cmp=int(lr.qp_error.reshape(K_S, -1)[:K_CMP].sum()),
                   pres_cmp=float(lr.qp_primal_res.reshape(K_S, -1)[:K_CMP].max()))
        if count:
            n_solve = K_S + lr.refined_ticks
            out["launches"] = dict(tk.kernels.launches)
            out["psd"] = linalg_cuda.launches["psd_inverse"]
            print(f"servo'd serving path ({label}): launches {out['launches']}, psd_inverse "
                  f"{out['psd']}")
            assert out["launches"] == {"tick_prestage": n_solve, "tick_qpchain": n_solve}, \
                out["launches"]
            assert out["psd"] == K_S, out["psd"]
        return out

    serve_b = run_loop(stick, B, "kernels, batch 1024", True)
    serve_1 = run_loop(stick, 1, "kernels, unbatched", True)
    plain_dev32 = FusedTick(model, cfg, dev, torch.float32, backend="torch")
    # the comparison loops run the first K_CMP ticks of the kernels' loop
    # (the loop is causal: its first K_CMP ticks are a K_CMP-tick loop)
    serve_plain = run_loop(plain_dev32, B, "plain float32 tick on the card, batch 1024", False,
                           K_S=K_CMP)
    jax_dev32 = FusedTick(model, cfg, dev, torch.float32, backend="torch")
    jax_dev32.prog.hold_lost_pivots = False
    serve_jax = run_loop(jax_dev32, B, "plain float32 tick on the JAX package's IPM "
                         "recurrence, batch 1024", False, K_S=K_CMP)
    # float64 throughout, tick and transition: what float32 falls short of
    _, ctrans64 = entry._model_and_tick(dev, torch.float64, qp_iters=COLD_ITERS,
                                        backend="torch", fused=False)
    serve_64 = run_loop(FusedTick(model, cfg, dev, torch.float64, backend="torch"), B,
                        "plain float64 tick and transition on the card, batch 1024", False,
                        forward_dynamics_transition(ctrans64), K_S=K_CMP)
    for run in (serve_b, serve_1):
        assert (run["ratio"] < 0.5).all(), (int((run["ratio"] >= 0.5).sum()),
                                            float(run["ratio"].max()))
    # Float32 leaves a few of this loop's QPs unsolved where float64 solves
    # them all: over the same K_CMP ticks and lanes, the kernels may flag no
    # more lane-ticks than the plain float32 tick, within the spread of two
    # rollouts that part on roundoff (a quarter, and 0.1% of the
    # lane-ticks), and no more, with no larger primal residual, than the
    # JAX package's recurrence, which steps from the clamped factor of a
    # Gram that lost a pivot
    print(f"servo'd serving path: the kernels' first {K_CMP} ticks flag "
          f"{serve_b['n_err_cmp']} lane-ticks (qp_primal_res max {serve_b['pres_cmp']:.3e}), "
          f"the plain float32 tick {serve_plain['n_err']}, the JAX recurrence "
          f"{serve_jax['n_err']}, float64 {serve_64['n_err']}")
    assert serve_b["n_err_cmp"] <= 1.25 * serve_plain["n_err"] + 1e-3 * K_CMP * B, (
        serve_b["n_err_cmp"], serve_plain["n_err"])
    assert serve_b["n_err_cmp"] <= serve_jax["n_err"], (serve_b["n_err_cmp"],
                                                        serve_jax["n_err"])
    assert serve_b["pres_cmp"] <= max(QP_FAIL, serve_jax["pres"]), (serve_b["pres_cmp"],
                                                                     serve_jax["pres"])

    def split_times(tk, nb):
        """The loop again with CUDA events around every tick call and every
        transition: (device ms in ticks, in transitions, wall ms), per tick."""
        args, sv, _, _ = tracking(nb)
        ev = {"tick": [], "transition": []}

        def timed(name, fn):
            def f(*a, **k):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                out = fn(*a, **k)
                e1.record()
                ev[name].append((e0, e1))
                return out
            return f

        tk._tick_impl = timed("tick", tk._tick_impl)
        try:
            loop = make_control_loop(tk, transition=timed("transition", trans), K=K_S, dt=DT,
                                     warm_start=True, warm_iters=WARM_ITERS,
                                     gap_fallback=GAP_FALLBACK)
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            loop(*args, servos=sv)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0_) * 1e3
        finally:
            del tk._tick_impl
        return tuple(sum(a.elapsed_time(b) for a, b in ev[k]) / K_S
                     for k in ("tick", "transition")) + (wall / K_S,)

    split_b, split_1 = split_times(stick, B), split_times(stick, 1)
    for nb, (t_tick, t_tr, t_wall) in ((B, split_b), (1, split_1)):
        print(f"servo'd serving path per tick at batch {nb}: wall {t_wall:.3f} ms, of which "
              f"ticks {t_tick:.3f} ms and transition {t_tr:.3f} ms (CUDA events), the rest "
              f"{t_wall - t_tick - t_tr:.3f} ms  [{card}]")
    print(f"servo'd serving path: {B * K_S / serve_b['wall']:.1f} solves/s at batch {B} "
          f"(the counted run, re-solves included), {K_S / serve_1['wall']:.1f} ticks/s "
          f"unbatched  [{card}]")

    # ------------------------------------------------ 14. servo'd truth guard
    phase("14")
    gq, gqd, gfs, gsv = entry._servo_inputs(model, 4, seed=0)
    rg, _ = stick._tick_impl(gq, gqd, gfs, warm=stick.init_warm((4,)), qp_iters=COLD_ITERS,
                             servos=gsv)
    g64 = (gq.astype(np.float64), gqd.astype(np.float64), tuple(f.astype(np.float64) for f in gfs))
    gsv64 = servos_to(gsv, torch.float64, "cpu")
    _, gref = entry._model_and_tick("cpu", dtype=torch.float64, qp_iters=COLD_ITERS,
                                    backend="torch")
    gr64, _ = gref._tick_impl(*g64, warm=gref.init_warm((4,)), servos=gsv64)
    _, gcref = entry._model_and_tick("cpu", dtype=torch.float64, qp_iters=COLD_ITERS,
                                     backend="torch", fused=False)
    gc64, _ = gcref._tick_impl(*g64, warm=gcref.init_warm((4,)), servos=gsv64)
    # τ_cmd, per lane: 0.05 Nm where the plain float32 tick is within that
    # of float64, else twice the plain float32 tick's own error (the QPs sit
    # on active constraints, where float32 itself is further off)
    gp32 = FusedTick(model, cfg, "cpu", torch.float32, backend="torch")
    go32, _ = gp32._tick_impl(gq, gqd, gfs, warm=gp32.init_warm((4,)), servos=gsv)
    for label, want in (("plain servo'd fused float64", gr64), ("CompiledTick(servos=) float64", gc64)):
        d_grav = maxerr(rg.torque_grav, want.torque_grav)
        d_cmd = tc.lane_err(rg.torque_cmd.T, want.torque_cmd.T)
        own_cmd = tc.lane_err(go32.torque_cmd.T, want.torque_cmd.T)
        bar = torch.where(own_cmd <= TAU_CMD_TOL, torch.full_like(own_cmd, TAU_CMD_TOL),
                          2 * own_cmd)
        print(f"servo'd truth guard, FusedTick(cuda) vs {label} (4 lanes): τ_grav {d_grav:.3e}  "
              f"τ_cmd per lane {' '.join(f'{v:.3e}' for v in d_cmd.tolist())} [plain float32's "
              f"own {' '.join(f'{v:.3e}' for v in own_cmd.tolist())}]")
        assert d_grav <= TAU_GRAV_TOL, (label, d_grav)
        assert (d_cmd <= bar).all(), (label, d_cmd, own_cmd)

    # ---------------------------------------------------- 15. servo'd times
    phase("15")
    for nb in (B, 1):
        qe, qde = sq_el[:, :nb].contiguous().to(dev), sqd_el[:, :nb].contiguous().to(dev)
        fe = [f[:, :nb].contiguous().to(dev) for f in sfs_el]
        sve = tuple(tuple({k: v[..., :nb].contiguous() for k, v in dd.items()} for dd in lvl)
                    for lvl in sv_dev)
        pre_buf = skern.prestage_packed(qe, None, qde, fe, sve)
        pre_d = skern.unpack_pre(pre_buf)
        w_d = skern.unpack_result(*skern.qpchain_packed(pre_buf, None, None, COLD_ITERS))["warm_out"]
        sprog = stick.prog
        times[("tick_prestage_servo", nb)] = interleaved(
            lambda: sprog.prestage_servo(qe, None, qde, fe, sve),
            lambda: skern.prestage_packed(qe, None, qde, fe, sve), 2, 5)
        times[("tick_qpchain_servo", nb)] = interleaved(
            lambda: sprog.qpchain(pre_d, pre_d["fstars"], w_d, WARM_ITERS),
            lambda: skern.qpchain_packed(pre_buf, None, w_d, WARM_ITERS), 2, 5)
        for name in ("tick_prestage_servo", "tick_qpchain_servo"):
            p, kt, gk = times[(name, nb)]
            print(f"time {name} batch {nb}: kernel {kt:.3f} ms (graph replay {gk:.3f} ms)  "
                  f"plain (torch on the card) {p:.3f} ms  [{card}]")

    # --------------------- 16. MaskedTick(cuda) in float32 on the masked sweep
    phase("16")
    mt32 = MaskedTick(model, cfg, dev, torch.float32, backend="cuda")
    mt64 = MaskedTick(model, cfg, dev, torch.float64, backend="torch")
    real_qp_solve = qp_cuda.qp_solve
    qp_dtau = []                      # per qp_solve call: per lane max |C[:mr]·Δx|

    def qp_solve_beside_float64(H, g, C, d, x0=None, lam0=None, iters=12, ridge=1e-6,
                                mirror=0):
        out = real_qp_solve(H, g, C, d, x0, lam0, iters=iters, ridge=ridge, mirror=mirror)
        dbl = [None if t is None else t.double() for t in (H, g, C, d, x0, lam0)]
        ref = qp_solve_plain(*dbl, iters=iters, ridge=ridge, mirror=mirror)
        dx = out[0].double() - ref[0]
        qp_dtau.append((dbl[2][:, :mirror] @ dx[..., None])[..., 0].abs().amax(-1).cpu())
        return out

    mloop = {}
    for tag, tk, dt in (("float32", mt32, torch.float32), ("float64", mt64, torch.float64)):
        lp = make_control_loop(tk, transition=advance, K=K_M, warm_start=True,
                               warm_iters=WARM_ITERS, gap_fallback=GAP_FALLBACK)
        if tag == "float32":
            qp_cuda.qp_solve = qp_solve_beside_float64
            linalg_cuda.launches["psd_inverse"] = 0
            qp_cuda.launches["qp_solve"] = 0
        try:
            mloop[tag] = lp(*(t.to(dt) for t in (mq_d, mqd_d)), tuple(f.to(dt) for f in mfs_d),
                            mm_d.to(dt))
            torch.cuda.synchronize()
        finally:
            qp_cuda.qp_solve = real_qp_solve
        if tag == "float32":
            mt_launches = {"psd_inverse": linalg_cuda.launches["psd_inverse"],
                           "qp_solve": qp_cuda.launches["qp_solve"]}
    lr32, lr64 = mloop["float32"], mloop["float64"]
    for name, v in lr32._asdict().items():
        if isinstance(v, torch.Tensor) and v.dtype != torch.bool:
            assert torch.isfinite(v).all(), f"MaskedTick float32 loop: non-finite {name}"
    n_tick = K_M + lr32.refined_ticks
    assert mt_launches["qp_solve"] == 3 * n_tick == len(qp_dtau), (mt_launches, len(qp_dtau))
    lane_m = torch.arange(B_M) % 3
    dtau = torch.stack(qp_dtau)                        # (calls, lanes)
    dtau_h = [float(dtau[:, lane_m == h].max()) for h in range(3)]
    over_h = [int((dtau[:, lane_m == h] > MASKED_QP_TAU_TOL).sum()) for h in range(3)]
    dcmd = (lr32.torques.double() - lr64.torques).abs().amax(-1)     # (K, lanes)
    dcmd_h = [float(dcmd[:, lane_m == h].max()) for h in range(3)]
    print(f"MaskedTick(cuda) float32 masked sweep ({K_M} ticks at batch {B_M}, gap_fallback "
          f"{GAP_FALLBACK:g}): refined ticks {lr32.refined_ticks}, launches {mt_launches}, "
          f"qp_error ticks×lanes {int(lr32.qp_error.sum())} (float64 loop "
          f"{int(lr64.qp_error.sum())}), qp_primal_res max {float(lr32.qp_primal_res.max()):.3e}")
    print("MaskedTick(cuda) float32: torque moved by each qp_solve solution against a float64 "
          f"solve of the same QP from the same warm start, per hypothesis {'/'.join(HYPOTHESES)} "
          "(max Nm over calls and lanes, [lane-calls beyond] <= limit): "
          + "/".join(f"{e:.3e}" for e in dtau_h) + " [" + "/".join(str(n) for n in over_h)
          + f"] <= {MASKED_QP_TAU_TOL:g}; τ_cmd against the float64 loop on the card: "
          + "/".join(f"{e:.3e}" for e in dcmd_h))
    assert max(dtau_h) <= MASKED_QP_TAU_TOL, (dtau_h, over_h)

    # ------------- 17. the general-plan kernels vs their plain versions
    phase("17")
    from libdwbc_tpu_torch.ops.tick_cuda import GENERAL_TOL

    cfg3 = standard_tocabi_config(model, both_feet=False, swing_task=True, qp_iters=COLD_ITERS)
    mcfg = entry._mixed_tasks_config(model, cfg)
    q3, _, fs3 = entry._swing_inputs(model, B, seed=0)
    gfs = [torch.as_tensor(np.ascontiguousarray(
        (0.05 * np.random.default_rng(1).standard_normal((B, t)).astype(np.float32)).T))
        for t in (6, 6, 3)]
    one = (lambda g, w: [maxerr(g, w)])
    g_err = {}
    for tag, gcfg, masked, gq, gf, gcm, split in (
            ("config 3", cfg3, False, torch.as_tensor(np.ascontiguousarray(q3.T)),
             [torch.as_tensor(np.ascontiguousarray(f.T)) for f in fs3], None, one),
            ("mixed", mcfg, False, q_el, gfs, None, one),
            ("mixed masked", mcfg, True, q_n, gfs, cm_n, lambda g, w: per_hyp(g, w, N_M))):
        g_err[tag] = general_kernels(dev, model, tag, gcfg, masked, gq, gf, gcm,
                                     GENERAL_TOL[tag], split)

    # ----------------------------------------- 18. config 3's serving path
    phase("18")
    launches3, kern3 = swing_serving(dev, model, cfg3, card, times)

    # -------------------------------- 19. config 3's servo'd closed loop
    phase("19")
    swing_loop(dev, model, cfg3, card)

    # ---------- 20. the hands-and-feet, LINE-feet and no-limit kernels vs plain
    phase("20")
    g_err.update(new_plan_kernels(dev, model, q_el, fs_el))

    # ------------------------------- 21. the hands-and-feet serving path
    phase("21")
    launches_h, kern_h = hands_serving(dev, model, card, times)

    # ----------------------- 22. the masked four-candidate sweep (hands and feet)
    phase("22")
    launches_hm, kern_hm = hands_masked_loop(dev, model, card, times)

    # ----------------- 23. the kernels at the reduced shapes vs their plain versions
    phase("23")
    from libdwbc_tpu_torch.wbc.reduced_tick import ReducedTick

    q3s, qd3s, fs3s = entry._swing_inputs(model, B, seed=0)
    red = {"flagship": (qs, np.zeros((B, model.ndof), np.float32), fs),
           "config 3": (q3s, qd3s, fs3s)}
    red_ticks, red_seen, red_psd, red_qp = {}, {}, {}, {}
    for tag, (rq, rqd, rfs) in red.items():
        _, rtick = entry._model_and_tick(dev, qp_iters=COLD_ITERS, reduced=True,
                                         swing=tag == "config 3")
        assert isinstance(rtick, ReducedTick) and rtick.backend == "cuda"
        red_ticks[tag] = rtick
        red_seen[tag], red_psd[tag], red_qp[tag] = reduced_kernels(
            dev, tag, rtick, torch.as_tensor(rq, device=dev), torch.as_tensor(rqd, device=dev),
            tuple(torch.as_tensor(f, device=dev) for f in rfs))

    # ----------------------------- 24. the reduced serving path, 25. its times
    phase("24-25")
    red_launches, red_solves, red_lib = {}, {}, {}
    for tag, (rq, rqd, rfs) in red.items():
        red_launches[tag], red_solves[tag] = reduced_serving(dev, model, tag, red_ticks[tag],
                                                             rq, rqd, rfs, card)
        red_lib[tag] = reduced_kernel_times(red_seen[tag], tag, times, card)

    # --------------- 26. the facade on the card, 27. its times, 28. bridges and sweep
    phase("26")
    fac_launches = facade_phase(dev, card)
    phase("27")
    fac = facade_times(dev, card, times)
    phase("28")
    bridges_phase(dev, card)

    # ------------- 29. the scenario mesh on the card, 30. the native host runtime
    phase("29")
    mesh_launches = mesh_phase(dev, model, card)
    phase("30")
    rt_launches = native_phase(dev, model, card)
    phase("31")
    hands_pool(dev, card)
    phase("bounds, resources and the record")

    # bounds at batch B (B_M masked): bytes of each kernel's inputs and
    # outputs, and its operations on this run's shapes, every tick kernel's
    # counted by tick_flops on the plan as run
    def tick_bounds(k, nb, n_in, servo=False):
        """(prestage, qpchain) bounds of TickKernels k at batch nb: n_in the
        prestage's inputs per scenario beyond its buffer (q, the mask; with
        the servo q̇, f*, the servo buffer), the f* the QP chain reads."""
        plan_ = k.plan
        n_pre_ = tc._elems(tc.pre_layout(plan_, servo=servo))
        n_out_, n_warm_ = tc._elems(tc.out_layout(plan_)), tc._elems(tc.warm_layout(plan_))
        pre_ops, qp_ops = tick_flops(plan_, WARM_ITERS)
        if servo:
            pre_ops += servo_extra_flops(plan_)
        n_fs_ = 0 if servo else sum(plan_.level_tdofs)
        return (bound(4 * (nb * (n_in + n_pre_) + k.table.numel()), pre_ops * nb),
                bound(4 * (nb * (n_pre_ + n_fs_ + 2 * n_warm_ + n_out_) + k.table.numel()),
                      qp_ops * nb))

    plan = kern.plan
    n_q, n_fs = q_el.shape[0], sum(f.shape[0] for f in fs_el)
    n_sv = SERVO_ELEMS * len(plan.level_tdofs)
    bounds = {"psd_inverse": bound(4 * B * (39 * 40 // 2 + 39 * 39),
                                   linalg_cuda.psd_inverse_flops(39) * B)}
    for tag, k_, nb, n_in, servo in (
            ("", kern, B, n_q, False), ("_masked", mkern, B_M, n_q + len(cfg.contacts), False),
            ("_servo", kern, B, n_q + model.ndof + n_fs + n_sv, True), ("_swing", kern3, B, n_q, False),
            ("_hands", kern_h, B, n_q, False),
            ("_hands_masked", kern_hm, B_M, n_q + len(kern_hm.plan.cfg.contacts), False)):
        bounds["tick_prestage" + tag], bounds["tick_qpchain" + tag] = tick_bounds(
            k_, nb, n_in, servo)
        ops = tick_flops(k_.plan, WARM_ITERS)
        print(f"operations per solve ({'flagship' if not tag else tag[1:]}, tick_flops): "
              f"prestage {ops[0] + (servo_extra_flops(k_.plan) if servo else 0)}, qpchain "
              f"{ops[1]}")
    print(f"the flagship by XLA's cost analysis of the JAX program "
          f"(benchmarks/sol_tick_r05.json, not used for the bounds): prestage "
          f"{SOL_TICK_R05[0]:.1f}, qpchain {SOL_TICK_R05[1]:.1f}")
    p0 = seen["qp_solve"][0]
    _, m0, n0 = p0["C"].shape
    me0 = m0 - p0["mirror"]
    bounds["qp_solve"] = bound(4 * B * (n0 * n0 + n0 + me0 * n0 + m0 + (n0 + m0) + (n0 + 2 * m0)),
                               qp_cuda.qp_solve_flops(n0, m0, p0["mirror"], WARM_ITERS) * B)
    for tag, suffix in (("flagship", "_reduced"), ("config 3", "_reduced_swing")):
        n_r = red_seen[tag]["psd_inverse"][1].shape[-1]        # A_R
        bounds["psd_inverse" + suffix] = bound(4 * B * (n_r * (n_r + 1) // 2 + n_r * n_r),
                                               linalg_cuda.psd_inverse_flops(n_r) * B)
        pr = red_seen[tag]["qp_solve"][0]
        _, m_r, nv_r = pr["C"].shape
        me_r = m_r - pr["mirror"]
        bounds["qp_solve" + suffix] = bound(
            4 * B * (nv_r * nv_r + nv_r + me_r * nv_r + m_r + (nv_r + m_r) + (nv_r + 2 * m_r)),
            qp_cuda.qp_solve_flops(nv_r, m_r, pr["mirror"], WARM_ITERS) * B)
    # the facade's kernels at batch 1: A (n = 39), and the first level QP
    # cold at the facade's iteration budget (no warm start read)
    bounds["psd_inverse_facade"] = bound(4 * (39 * 40 // 2 + 39 * 39),
                                         linalg_cuda.psd_inverse_flops(39))
    pf = fac["seen"]["qp_solve"][0]
    _, m_f, nv_f = pf["C"].shape
    bounds["qp_solve_facade"] = bound(
        4 * (nv_f * nv_f + nv_f + (m_f - pf["mirror"]) * nv_f + m_f + (nv_f + 2 * m_f)),
        qp_cuda.qp_solve_flops(nv_f, m_f, pf["mirror"], pf["iters"]))
    for name, (ms, by) in bounds.items():
        nb = B_M if name.endswith("masked") else 1 if name.endswith("facade") else B
        print(f"bound {name} at batch {nb}: "
              f"{ms:.6f} ms ({by})")

    # each kernel's resources at the launch shape of its record: registers
    # and local bytes per thread, shared bytes per block, blocks per SM, and
    # ptxas's spill bytes
    resources = {"psd_inverse": _build.kernel_info("psd_inverse", 39)}
    for name, p in zip(QP_NAMES, seen["qp_solve"]):
        _, m_, n_ = p["C"].shape
        res = _build.kernel_info("qp_solve", n_, m_, p["mirror"])
        resources.setdefault("qp_solve", res)          # the record's: level 0
        print(f"qp_solve launch shape, {name} (n {n_}, m {m_}, mirror {p['mirror']}): "
              f"{res['threads_per_block'] // 32} problems per block, "
              f"{res['smem_per_block']} shared bytes per block ({qp_cuda.smem_elems(n_, m_, p['mirror'])} floats per problem), "
              f"{res['blocks_per_sm']} blocks per SM")
    for tag, suffix in (("flagship", "_reduced"), ("config 3", "_reduced_swing")):
        resources["psd_inverse" + suffix] = _build.kernel_info(
            "psd_inverse", red_seen[tag]["psd_inverse"][1].shape[-1])
        pr = red_seen[tag]["qp_solve"][0]
        resources["qp_solve" + suffix] = _build.kernel_info(
            "qp_solve", pr["C"].shape[2], pr["C"].shape[1], pr["mirror"])
    for tag, k_ in (("", kern), ("_masked", mkern), ("_swing", kern3), ("_hands", kern_h),
                    ("_hands_masked", kern_hm)):
        sz = k_._lib_and_sizes()[1]
        resources["tick_prestage" + tag] = _build.kernel_info("tick_prestage", sz["stride_pre"])
        resources["tick_qpchain" + tag] = _build.kernel_info("tick_qpchain", sz["smem_qp"])
    resources["tick_qpchain_nolim"] = _build.kernel_info(
        "tick_qpchain_nolim", TickKernels(TickProgram(model, dataclasses.replace(
            cfg, torque_limit=None), dev, torch.float32))._lib_and_sizes()[1]["smem_qp"])
    for name, res in resources.items():
        print(f"resources {name}: " + "  ".join(f"{k} {v}" for k, v in res.items())
              + "  ptxas spill stores/loads {}/{} bytes".format(
                  *spills.get(kernel_source(name), ("not reported",) * 2)))

    def entry_(name, launches_, err, key, library_ms, replaces):
        """The record of one kernel; key: its times at the recorded batch."""
        plain_ms, ms, graph_ms = times[key]
        src = kernel_source(name)
        res = resources.get(name.removesuffix("_servo"), resources.get(src))
        st, ld = spills.get(src, (None, None))
        return {"name": name, "route": "cuda",
                "source": f"libdwbc_tpu_torch/csrc/{src}.cu", "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": library_ms, "graph_ms": graph_ms, "registers": res["registers"],
                "spill_store_bytes": st, "spill_load_bytes": ld,
                "local_bytes": res["local_bytes"], "smem_per_block": res["smem_per_block"],
                "threads_per_block": res["threads_per_block"],
                "blocks_per_sm": res["blocks_per_sm"]}

    qp_key = ("qp_solve", QP_NAMES[0], B)
    fused_site = "libdwbc_tpu/wbc/fused.py:364"
    record = {"kernels": [
        entry_("tick_prestage", launches["tick_prestage"], pre_err["torque_grav"],
               ("tick_prestage", B), None, fused_site),
        entry_("tick_qpchain", launches["tick_qpchain"],
               max(qp_err["cold.torque_cmd"], qp_err["warm.torque_cmd"]),
               ("tick_qpchain", B), None, fused_site),
        entry_("psd_inverse", claunches["psd_inverse"], max(psd_abs.values()),
               ("psd_inverse", 39, B), lib_ms[(39, B)], "libdwbc_tpu/ops/pallas_linalg.py:145"),
        entry_("qp_solve", claunches["qp_solve"], max(e["x"] for e in qps_err.values()),
               qp_key, None, "libdwbc_tpu/ops/pallas_qp.py:302"),
        entry_("tick_prestage_masked", mlaunches["tick_prestage"], max(mpre_err["torque_grav"]),
               ("tick_prestage_masked", B_M), None, fused_site),
        entry_("tick_qpchain_masked", mlaunches["tick_qpchain"],
               max(max(mqp_err["cold.torque_cmd"]), max(mqp_err["warm.torque_cmd"])),
               ("tick_qpchain_masked", B_M), None, fused_site),
        entry_("tick_prestage_servo", serve_b["launches"]["tick_prestage"],
               max(sfs_err, msfs_err), ("tick_prestage_servo", B), None, fused_site),
        entry_("tick_qpchain_servo", serve_b["launches"]["tick_qpchain"], max(sqp_err, msqp_err),
               ("tick_qpchain_servo", B), None, fused_site),
        entry_("tick_prestage_swing", launches3["tick_prestage"], g_err["config 3"][0],
               ("tick_prestage_swing", B), None, fused_site),
        entry_("tick_qpchain_swing", launches3["tick_qpchain"], g_err["config 3"][1],
               ("tick_qpchain_swing", B), None, fused_site),
        entry_("tick_prestage_hands", launches_h["tick_prestage"], g_err["hands"][0],
               ("tick_prestage_hands", B), None, fused_site),
        entry_("tick_qpchain_hands", launches_h["tick_qpchain"], g_err["hands"][1],
               ("tick_qpchain_hands", B), None, fused_site),
        entry_("tick_prestage_hands_masked", launches_hm["tick_prestage"],
               g_err["hands masked"][0], ("tick_prestage_hands_masked", B_M), None, fused_site),
        entry_("tick_qpchain_hands_masked", launches_hm["tick_qpchain"],
               g_err["hands masked"][1], ("tick_qpchain_hands_masked", B_M), None, fused_site),
    ] + [
        rec_
        for tag, suffix in (("flagship", "_reduced"), ("config 3", "_reduced_swing"))
        for n_r in [red_seen[tag]["psd_inverse"][1].shape[-1]]
        for rec_ in (
            entry_("psd_inverse" + suffix, red_launches[tag]["psd_inverse"],
                   max(red_psd[tag].values()), ("psd_inverse", tag, n_r, B),
                   red_lib[tag][(n_r, B)], "libdwbc_tpu/ops/pallas_linalg.py:145"),
            entry_("qp_solve" + suffix, red_launches[tag]["qp_solve"],
                   max(e["x"] for e in red_qp[tag].values()),
                   ("qp_solve", tag, REDUCED_QP_NAMES[tag][0], B), None,
                   "libdwbc_tpu/ops/pallas_qp.py:302"))
    ] + [
        entry_("psd_inverse_facade", fac_launches["psd_inverse"], fac["psd_err"],
               ("psd_inverse_facade", 39, 1), fac["lib_ms"], "libdwbc_tpu/ops/pallas_linalg.py:145"),
        entry_("qp_solve_facade", fac_launches["qp_solve"], fac["qp_err"],
               ("qp_solve_facade", QP_NAMES[0], 1), None, "libdwbc_tpu/ops/pallas_qp.py:302"),
    ]}
    # the mesh step (phase 29: static, masked) and the RT loop's consumer
    # (phase 30) run the flagship's kernels measured above: their launch
    # counts go on those rows
    rows = {r["name"]: r for r in record["kernels"]}
    for name in ("tick_prestage", "tick_qpchain"):
        rows[name]["launches_mesh"] = mesh_launches["static"][name]
        rows[name]["launches_rt"] = rt_launches[name]
        rows[name + "_masked"]["launches_mesh"] = mesh_launches["masked"][name]
    phase("done")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["hands_pool"]:
        sys.path.insert(0, str(ROOT))
        from libdwbc_tpu_torch.ops import _build as _b
        _b.build()
        hands_pool(torch.device("cuda", 0), gpu_line())
    else:
        main()
