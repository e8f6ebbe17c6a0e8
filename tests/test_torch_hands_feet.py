"""The four-contact hands-and-feet plan (the benchmark's ``tocabi_hands_feet``:
6D feet, POINT hands on links 23 and 31, 25 cold and 7 warm IPM iterations)
on the port's plain path on the CPU.

* The plain float32 ``FusedTick`` against the benchmark's frozen plain
  reference (``wbcbench/reference``, float64) at B = 4 on seeded draws, cold
  at 25 iterations and warm at 7 from the port's own warm state, within the
  configuration's limits.
* NwJw's inner system J̄ᵀ[rows]·V2 is singular on this plan (rank 11 of 12).
  On the card, ``tick_prestage`` left lane 487 of draw 3 of the rollout
  pool (``wbcbench/recipes.draw_batch`` on the card's generator,
  ``pool_seed`` 0; its float32 q, q̇ and f* in ``data/hands_feet_lane487.npz``)
  with the dropped pivot at float32 roundoff just above qr_pinv's float64
  rcond, 1e-6 of the largest: kept, it scaled NwJw's dropped direction to
  ~2.8e6, the IPM's Gram lost 11 of its 12 contact pivots at every step, and
  the lane stopped on the lost-pivot rule at μ 5.4e-4, τ_task 5.93 Nm from
  the optimum, unflagged.  The host's float32 arithmetic does not leave that
  pivot there (the g++ build of the prestage matches the card's buffer in
  under 4% of its elements), so the test puts the card's roundoff into the
  plain prestage's inner system, 3e-6 of the largest in its null direction,
  and holds the tick to the float64 one within the plan's limits.  With the
  float64 rcond at float32 (``NWJW_RCOND_F32`` = 1e-6) the pivot is kept and
  the τ_task assertion fails.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from libdwbc_tpu_torch.ops import elemlin as el
from libdwbc_tpu_torch.ops import tick_kernel

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LANE = ROOT / "tests" / "data" / "hands_feet_lane487.npz"
# the card's float32 roundoff in the singular inner system's dropped pivot
ROUNDOFF = 3e-6


@pytest.fixture(scope="module")
def plan():
    from wbcbench import program
    from wbcbench.harness import load_json
    from wbcbench.reference import RefTick

    config = load_json(ROOT / "wbcbench" / "configs" / "tocabi_hands_feet.json")
    tick = program.build_tick(config, "cpu", backend="torch")
    ref = RefTick(config, "cpu", torch.float64)
    return config, tick, ref


def _errs(tick_res, tick_warm, ref_out, tdofs):
    """τ_grav, τ_task, force_tau and task_x distances, per the benchmark's
    check (``wbcbench/check.py``), worst over the lanes."""
    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    pre = ref_out["pre"]
    want_f = (torch.einsum("ij...,j...->i...", pre["Jbar_act"],
                           tick_res.torque_cmd.T.double()) - pre["P_C"]).T
    return {"tau_grav_nm": gap(tick_res.torque_grav, ref_out["torque_grav"]),
            "tau_task_nm": gap(tick_res.torque_task, ref_out["torque_task"]),
            "force_tau_n": gap(tick_res.contact_force, want_f),
            "task_x": max(gap(tick_warm[h][0][:, :t], ref_out["warm_out"][h][0][:, :t])
                          for h, t in enumerate(tdofs))}


def test_fused_tick_matches_reference_cold_and_warm(plan):
    from wbcbench import recipes
    from wbcbench.harness import load_json

    config, tick, ref = plan
    traffic = load_json(ROOT / "wbcbench" / "traffic" / "rollouts_b1024.json")
    q0, fs0 = recipes.standing(traffic, tick.model.nq, tick.model.ndof)
    q, qd, fs = recipes.draw_batch(traffic, q0, fs0, (4,), recipes.generator("cpu", 2**33 + 5),
                                   "cpu")
    tdofs = ref.plan.level_tdofs
    res, warm = tick._tick_impl(q, qd, fs, warm=tick.init_warm((4,)),
                                qp_iters=config["cold_iters"])
    assert not res.qp_error.any()
    out = ref.tick_el(q, fs, None, None, config["cold_iters"])
    for name, v in _errs(res, warm, out, tdofs).items():
        assert v <= config["limits"][name], ("cold", name, v)
    q2 = recipes.nudge(q, res.torque_cmd, traffic["nudge"])
    res2, warm2 = tick._tick_impl(q2, qd, fs, warm=warm, qp_iters=config["warm_iters"])
    assert not res2.qp_error.any()
    out2 = ref.tick_el(q2, fs, None, [(x, lam) for x, lam in warm], config["warm_iters"])
    for name, v in _errs(res2, warm2, out2, tdofs).items():
        assert v <= config["limits"][name], ("warm", name, v)


def _with_roundoff(qr_pinv):
    """qr_pinv with ROUNDOFF × the largest singular value of each lane's
    matrix added along its smallest singular pair: a singular inner system's
    dropped pivot left where float32 roundoff on the card left it."""
    def wrapped(M, rcond=1e-6):
        Mb = M.movedim((0, 1), (-2, -1)).double()
        U, S, Vh = torch.linalg.svd(Mb)
        bump = ROUNDOFF * S[..., :1, None] * U[..., :, -1:] * Vh[..., -1:, :]
        return qr_pinv((Mb + bump).to(M.dtype).movedim((-2, -1), (0, 1)), rcond)
    return wrapped


@pytest.mark.parametrize("rcond", ["float32", "float64"])
def test_lane487_nwjw_pivot_at_float32_roundoff(plan, monkeypatch, rcond):
    """The card's lane 487, cold at 25 iterations, through the plain float32
    tick with the card's roundoff in NwJw's inner system: NwJw stays a sound
    basis and the tick lands within the plan's limits of the float64 tick.
    At the float64 rcond (the rule before, also run here) the pivot is kept,
    NwJw's largest singular value reaches ~1e6 and τ_task is off by ~6 Nm."""
    config, tick, ref = plan
    z = np.load(LANE)
    q, qd = torch.as_tensor(z["q"])[None], torch.as_tensor(z["qd"])[None]
    fs = (torch.as_tensor(z["f0"])[None], torch.as_tensor(z["f1"])[None])
    out = ref.tick_el(q, fs, None, None, config["cold_iters"])
    monkeypatch.setattr(el, "qr_pinv", _with_roundoff(el.qr_pinv))
    if rcond == "float64":
        monkeypatch.setattr(tick_kernel, "NWJW_RCOND_F32", 1e-6)
    pre = tick.prog.prestage(q.T.contiguous())
    top = float(torch.linalg.svdvals(pre["NwJw"][..., 0].double())[0])
    res, warm = tick._tick_impl(q, qd, fs, warm=tick.init_warm((1,)),
                                qp_iters=config["cold_iters"])
    errs = _errs(res, warm, out, ref.plan.level_tdofs)
    if rcond == "float64":
        assert top > 1e4 and errs["tau_task_nm"] > config["limits"]["tau_task_nm"]
        return
    assert top < 100.0
    assert not res.qp_error.any()
    for name, v in errs.items():
        assert v <= config["limits"][name], (name, v)
