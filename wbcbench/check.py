"""The check that decides ``correct``: what the timed path produced, held
against the plain reference (``wbcbench/reference``) after the window.

Each recorded call is re-run by the reference in float64 from the call's
own inputs: the harness's state and f*, and the warm (x, λ) the serving
layer handed the call.  Tick 0 of every recorded unit starts from the cold
state, so the chain's start is checked from nothing the program made; a
warm tick follows the program's own warm state, and the serving layer's
carry of that state from one tick to the next is checked on its own, bit
for bit (``carry``).

The numbers (each the worst over every recorded lane):

* ``tau_grav_nm``, ``tau_task_nm``, ``tau_contact_nm``, ``tau_cmd_nm``,
  ``force_n``: the gap between the program's field and the reference's;
* ``force_tau_n``: the program's contact force against the reference's
  J̄·τ_cmd − P_C of the program's own τ_cmd (determined where τ_cmd is not);
* ``task_x``: the level QPs' task variables x[:t] against the reference's;
* ``warm_x``, ``warm_lam``: every QP's warm state out (x; λ relative to
  1 + |λ|) against the reference's;
* ``gap_abs``, ``pres_abs``: the QP diagnostics against the reference's;
* ``carry``: tensors of the serving layer that differ from what its
  contract makes of the recorded calls (warm carry, re-solve selection,
  the served torques, the transition's input): 0 when sound;
* ``best_disagree``, ``best_pick_rel``, ``best_cost_rel``: on the mesh, the
  ranks that returned another best scenario than rank 0, and the gathered
  best's cost against the least reference cost of the grid.
"""

from __future__ import annotations

import math

import torch

from .reference import RefTick

# lanes per reference call: bounds the reference's memory after the window
CHUNK = 4096


RES_FIELDS = ("torque_grav", "torque_task", "torque_contact", "torque_cmd", "contact_force",
              "qp_gap", "qp_primal_res")


def _lanes(c: dict, dev) -> dict:
    """One recorded call as (B, ...) float64 tensors on ``dev`` (an
    unbatched call as B = 1)."""
    q = torch.as_tensor(c["q"])
    one = (lambda x: x) if q.ndim == 2 else (lambda x: x[None])

    def L(x):
        return one(torch.as_tensor(x).to(dev, torch.float64))

    B = L(q).shape[0]
    return dict(q=L(q), fs=[L(f) for f in c["fstars"]],
                mask=None if c["mask"] is None else L(c["mask"]).expand(B, -1),
                warm=[(L(x), L(lam)) for x, lam in c["warm_in"]],
                res={f: L(getattr(c["res"], f)) for f in RES_FIELDS},
                wout=[L(x) for x, _ in c["warm_out"]],
                wlam=[L(lam) for _, lam in c["warm_out"]],
                ok=~one(torch.as_tensor(c["res"].qp_error).to(dev)))


def _cat(parts: list, lo: int, hi: int):
    """Lanes lo:hi of the lane-wise concatenation of ``parts`` (nested
    lists, tuples and dicts of (B, ...) tensors alike)."""
    p0 = parts[0]
    if p0 is None:
        return None
    if isinstance(p0, dict):
        return {k: _cat([p[k] for p in parts], lo, hi) for k in p0}
    if isinstance(p0, (list, tuple)):
        return [_cat([p[i] for p in parts], lo, hi) for i in range(len(p0))]
    return torch.cat(parts, 0)[lo:hi]


def reference_numbers(config: dict, calls: list, device, names, on_ref=None) -> dict:
    """The field numbers over ``calls`` (recorded call dicts), the reference
    run in float64 on ``device`` over whole calls of one budget together, up
    to CHUNK lanes at a time.  Returns {name: worst value} for the names
    asked; on_ref(call, reference output of its lanes) sees each call."""
    ref = RefTick(config, device, torch.float64)
    tdofs = ref.plan.level_tdofs
    worst = {n: 0.0 for n in names}
    by_iters = {}
    for c in calls:
        by_iters.setdefault(c["iters"], []).append(c)
    for iters, group in by_iters.items():
        chunk, lanes = [], 0
        for i, c in enumerate(group):
            row = _lanes(c, device)
            chunk.append((c, row))
            lanes += row["q"].shape[0]
            if lanes >= CHUNK or i == len(group) - 1:
                r = _cat([x for _, x in chunk], 0, lanes)
                out = ref.tick_el(r["q"], r["fs"], r["mask"], r["warm"], iters)
                _fold(worst, names, out, r["res"], r["wout"], r["wlam"], tdofs, r["ok"])
                if on_ref is not None:
                    lo = 0
                    for cc, x in chunk:
                        hi = lo + x["q"].shape[0]
                        on_ref(cc, {k: out[k][lo:hi] for k in ("torque_cmd", "qp_primal_res")})
                        lo = hi
                chunk, lanes = [], 0
    return worst


def _gap(a, b) -> float:
    d = (a.double() - b.double()).abs()
    if d.numel() == 0:
        return 0.0
    m = d.max()
    return float("inf") if not torch.isfinite(m) else float(m)


FIELDS = {"tau_grav_nm": "torque_grav", "tau_task_nm": "torque_task",
          "tau_contact_nm": "torque_contact", "tau_cmd_nm": "torque_cmd",
          "force_n": "contact_force", "gap_abs": "qp_gap", "pres_abs": "qp_primal_res"}


# every number the reference computes from the recorded calls
NUMBERS = tuple(FIELDS) + ("force_tau_n", "task_x", "warm_x", "warm_lam")


def _fold(worst, names, out, res, wout, wlam, tdofs, ok):
    """Fold one reference call's gaps into the worst ones, over the lanes
    the program did not flag (``qp_error``: a lane that says it failed is
    counted as failed, not judged)."""
    out = {k: (v[ok] if torch.is_tensor(v) else v) for k, v in out.items()}
    out["warm_out"] = [(x[ok], lam[ok]) for x, lam in out["warm_out"]]
    res = {k: v[ok] for k, v in res.items()}
    wout, wlam = [x[ok] for x in wout], [lam[ok] for lam in wlam]
    for name in names:
        if name in FIELDS:
            f = FIELDS[name]
            v = _gap(res[f].reshape(out[f].shape), out[f])
        elif name == "force_tau_n":
            pre = out["pre"]
            tau = res["torque_cmd"].T.contiguous()
            want = (torch.einsum("ij...,j...->i...", pre["Jbar_act"][..., ok], tau)
                    - pre["P_C"][..., ok]).T
            v = _gap(res["contact_force"], want)
        elif name == "task_x":
            v = max(_gap(wout[h][:, :t], out["warm_out"][h][0][:, :t])
                    for h, t in enumerate(tdofs))
        elif name == "warm_x":
            v = max(_gap(x, rx) for x, (rx, _) in zip(wout, out["warm_out"]))
        elif name == "warm_lam":
            v = max(_gap(lam / (1 + rl.abs()), rl / (1 + rl.abs()))
                    for lam, (_, rl) in zip(wlam, out["warm_out"]))
        else:
            continue
        worst[name] = max(worst[name], v) if not math.isnan(v) else float("inf")


def same(a, b) -> bool:
    """Bit for bit, NaN where NaN."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(torch.where(na, 0, a), torch.where(nb, 0, b)))


def same_warm(w1, w2) -> bool:
    return len(w1) == len(w2) and all(same(x1, x2) and same(l1, l2)
                                      for (x1, l1), (x2, l2) in zip(w1, w2))


def cold_warm(warm) -> bool:
    """Whether a warm state is the cold one: x = 0, λ = 1."""
    return all(bool((torch.as_tensor(x) == 0).all()) and bool((torch.as_tensor(lam) == 1).all())
               for x, lam in warm)


def loop_carry(unit: dict, served, transition, gap_fallback) -> int:
    """Mismatches of the serving loop over one recorded rollout.

    unit: {tick k: [call, re-solve call or nothing]}; served: the loop's
    result torques (K, B, m); transition(q, τ) the harness's step.  Per
    recorded tick: tick 0 starts cold; a warm tick is re-solved iff some
    lane tripped the fallback, the re-solve starts from that tick's warm
    output; the served τ and the warm state carried are the per-lane
    selection; the next recorded tick's q and warm input are the
    transition's and the carry's."""
    bad = 0
    for k, calls in unit.items():
        c = calls[0]
        if k == 0:
            bad += (not cold_warm(c["warm_in"])) + (len(calls) != 1)
            res, warm = c["res"], c["warm_out"]
        else:
            trip = torch.maximum(c["res"].qp_gap, c["res"].qp_primal_res) > gap_fallback \
                if gap_fallback is not None else torch.zeros_like(c["res"].qp_gap, dtype=bool)
            if bool(trip.any()) != (len(calls) == 2):
                bad += 1
                continue
            res, warm = c["res"], c["warm_out"]
            if len(calls) == 2:
                r = calls[1]
                bad += (not same(r["q"], c["q"])) + (not same_warm(r["warm_in"], c["warm_out"]))

                def sel(a, b):
                    return torch.where(trip.reshape(trip.shape + (1,) * (a.ndim - trip.ndim)),
                                       a, b)

                res = type(res)(*(sel(a, b) for a, b in zip(r["res"], res)))
                warm = tuple((sel(x2, x), sel(l2, lo)) for (x2, l2), (x, lo) in
                             zip(r["warm_out"], warm))
        bad += not same(served[k], res.torque_cmd)
        nxt = unit.get(k + 1)
        if nxt:
            bad += not same_warm(nxt[0]["warm_in"], warm)
            bad += not same(nxt[0]["q"], transition(c["q"], res.torque_cmd))
    return bad


def lane_carry(pairs: dict, served: dict) -> int:
    """Mismatches of the single-lane consumer over the recorded ticks
    {k: [call]}: tick 0 starts cold, tick k+1's warm input is tick k's warm
    output, and the host buffer the consumer filled holds the tick's τ_cmd
    (``served[k]``)."""
    bad = 0
    for k, calls in pairs.items():
        c = calls[0]
        bad += len(calls) != 1
        if k == 0:
            bad += not cold_warm(c["warm_in"])
        bad += not same(torch.as_tensor(served[k]), c["res"].torque_cmd.detach().cpu())
        nxt = pairs.get(k + 1)
        if nxt:
            bad += not same_warm(nxt[0]["warm_in"], c["warm_out"])
    return bad


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a number that is not finite fails)."""
    return all(math.isfinite(numbers[n]) and numbers[n] <= limits[n] for n in limits)
