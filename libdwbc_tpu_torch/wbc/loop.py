"""The K-tick control loop of the serving path (counterpart of
``libdwbc_tpu/wbc/loop.py``): K ticks with the robot state advanced between
them by a transition function, the warm (x, λ) of every QP carried from one
tick to the next, the on-device servos' clocks advanced by dt per tick, and
a per-lane safety net that re-solves a warm tick at the full iteration
budget where it left a real gap or violation.  ``forward_dynamics_transition``
is the closed-loop simulator step.

The JAX loop is one ``lax.scan`` with a ``lax.cond`` around the re-solve.
Here the ticks are a Python loop, and the condition is one read of the
tripped lanes' count per warm tick: one host sync per warm tick when
``gap_fallback`` is set, none otherwise.  The re-solve launches only when
that count is not 0; its result and warm state are taken per lane with
``torch.where``.  The read, the re-solve with its selection and each
transition are spans of ``tracing`` (``dwbc.loop.sync``,
``dwbc.loop.resolve``, ``dwbc.loop.transition``), the count is added to
its counter ``dwbc.loop.resolve_lanes``, and every tick is a request block
(loop call, tick) whose spans carry it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import tracing
from ..kin.rotations import quat_mul
from .pipeline import TickResult


class LoopResult(NamedTuple):
    q_final: torch.Tensor
    qdot_final: torch.Tensor
    torques: torch.Tensor        # (K, ..., model_dof)
    qp_primal_res: torch.Tensor  # (K, ...)
    qp_error: torch.Tensor       # (K, ...) per-lane per-tick failure flags: the
    # loop serves whatever the tick produced; the caller decides the hold or
    # zero policy per flagged lane (the reference returns 0, src/dwbc.cpp:836-846)
    refined_ticks: int = 0       # warm ticks whose gap_fallback re-solve ran


def _advance_servos(servos, tk):
    """Every ServoParams clock of the nested per-level / per-spec servos
    shifted by tk (the reference's control time advancing between
    UpdateTaskSpace calls); None entries pass through."""
    if servos is None:
        return None
    return tuple(None if lvl is None else tuple(
        None if sp is None else sp._replace(t=sp.t + tk) for sp in lvl) for lvl in servos)


def default_transition(model):
    """The state held between ticks: q and q̇ unchanged (use a simulator
    step for closed-loop rollouts)."""

    def step(q, qdot, res, dt):
        return q, qdot

    return step


def forward_dynamics_transition(tick):
    """The closed-loop transition through the engine's own dynamics, from a
    ``CompiledTick``'s kinematics: q̈ = A⁻¹(Sᵀτ − B − J_Cᵀf_c) at the current
    state (A q̈ + J_Cᵀf_c + B = Sᵀτ, the support's normal force f_z < 0),
    integrated semi-implicitly, the base quaternion advanced on the
    manifold.  With ``CompiledTick(backend="cuda")`` its A⁻¹ runs the
    ``psd_inverse`` kernel, once per step."""
    kin, model = tick.kin, tick.model

    def step(q, qdot, res, dt):
        st = kin.update(q, qdot)
        tau_full = torch.cat([q.new_zeros(q.shape[:-1] + (6,)), res.torque_cmd], dim=-1)
        J_C = tick._contact_jacobian_from_state(st)
        rhs = tau_full - st.B - torch.einsum("...cn,...c->...n", J_C, res.contact_force)
        qdd = torch.einsum("...ij,...j->...i", st.A_inv, rhs)
        qdot_new = qdot + dt * qdd
        # translation and joints linearly, the quaternion on the manifold
        q_new = q.clone()
        q_new[..., 0:3] += dt * qdot_new[..., 0:3]
        q_new[..., 6:6 + model.model_dof] += dt * qdot_new[..., 6:]
        w = qdot_new[..., 3:6] * dt
        angle = torch.linalg.vector_norm(w, dim=-1)
        axis = w / torch.clamp_min(angle, 1e-12)[..., None]
        dq = torch.cat([axis * torch.sin(angle / 2)[..., None],
                        torch.cos(angle / 2)[..., None]], dim=-1)
        quat = torch.stack([q[..., 3], q[..., 4], q[..., 5], q[..., model.ndof]], dim=-1)
        qn = quat_mul(quat, dq)
        q_new[..., 3:6] = qn[..., 0:3]
        q_new[..., model.ndof] = qn[..., 3]
        return q_new, qdot_new

    return step


def make_control_loop(
    tick,
    transition: Callable | None = None,
    K: int = 100,
    dt: float = 0.001,
    warm_start: bool = False,
    warm_iters: int | None = None,
    gap_fallback: float | None = None,
):
    """Build a K-tick loop ``loop(q0, qdot0, fstars, contact_mask=None,
    servos=None)``.

    tick: a ``CompiledTick``, a ``FusedTick`` or a ``MaskedTick``.  A
    ``MaskedTick`` or a ``FusedTick(masked=True)`` takes the per-scenario
    ``contact_mask`` (held fixed across the K ticks); any other tick refuses
    one.

    transition(q, qdot, TickResult, dt) -> (q', qdot') runs between ticks.

    servos: the ticks' nested ServoParams; tick k runs them at the clock
    t + k·dt (the gap_fallback re-solve of a tick at that tick's clock).

    warm_start=True carries each QP's primal/dual point across ticks (the
    reference's persistent hot-started solvers, include/dwbc.h:222-228):
    tick 0 runs at the full budget ``tick.cfg.qp_iters``, the other K−1 at
    ``warm_iters`` (default: half the budget, at least 4).

    gap_fallback (warm loops only): where a lane's warm tick leaves
    max(gap, primal residual) above it, the tick is re-solved at the full
    budget from that tick's warm output, and that lane takes the re-solved
    result and warm state; healthy lanes keep theirs (qpOASES's hot-start
    failure → cold re-init, src/qp_wrapper.cpp:298-339).
    """
    from .masked import MaskedTick

    trans = transition or default_transition(tick.model)
    masked = isinstance(tick, MaskedTick) or getattr(tick, "masked", False)

    def _tick(q, qdot, fstars, cmask, **kw):
        if masked:
            if cmask is None:
                raise ValueError("a masked tick's loop needs contact_mask")
            return tick._tick_impl(q, qdot, fstars, cmask, **kw)
        if cmask is not None:
            raise ValueError("contact_mask given for a tick that is not masked")
        return tick._tick_impl(q, qdot, fstars, **kw)

    def step(q, qdot, res):
        with tracing.span("dwbc.loop.transition"):
            return trans(q, qdot, res, dt)

    def stack(rs):
        return (torch.stack([r.torque_cmd for r in rs], 0),
                torch.stack([r.qp_primal_res for r in rs], 0),
                torch.stack([r.qp_error for r in rs], 0))

    def loop(q0, qdot0, fstars, contact_mask=None, servos=None):
        seq = tracing.sequence()
        q0, qdot0 = (torch.as_tensor(x, dtype=tick.dtype, device=tick.device)
                     for x in (q0, qdot0))
        if not warm_start:
            q, qdot, rs = q0, qdot0, []
            for k in range(K):
                with tracing.request(seq, k):
                    res = _tick(q, qdot, fstars, contact_mask,
                                servos=_advance_servos(servos, k * dt))
                    q, qdot = step(q, qdot, res)
                rs.append(res)
            return LoopResult(q, qdot, *stack(rs))

        full = tick.cfg.qp_iters
        w_iters = warm_iters or max(full // 2, 4)
        with tracing.request(seq, 0):
            res, warm = _tick(q0, qdot0, fstars, contact_mask,
                              warm=tick.init_warm(q0.shape[:-1]), qp_iters=full, servos=servos)
            q, qdot = step(q0, qdot0, res)
        rs, refined = [res], 0
        for k in range(1, K):
            with tracing.request(seq, k):
                sv = _advance_servos(servos, k * dt)
                res, warm = _tick(q, qdot, fstars, contact_mask, warm=warm, qp_iters=w_iters,
                                  servos=sv)
                if gap_fallback is not None:
                    trip = torch.maximum(res.qp_gap, res.qp_primal_res) > gap_fallback
                    with tracing.span("dwbc.loop.sync"):
                        tripped = int(trip.sum())    # the loop's one host sync
                    if tripped:
                        with tracing.span("dwbc.loop.resolve"):
                            res2, warm2 = _tick(q, qdot, fstars, contact_mask, warm=warm,
                                                qp_iters=full, servos=sv)

                            def sel(a, b):
                                t = trip.reshape(trip.shape + (1,) * (a.ndim - trip.ndim))
                                return torch.where(t, a, b)

                            res = TickResult(*(sel(a, b) for a, b in zip(res2, res)))
                            warm = tuple((sel(x2, x), sel(l2, l))
                                         for (x2, l2), (x, l) in zip(warm2, warm))
                        tracing.count("dwbc.loop.resolve_lanes", tripped)
                        refined += 1
                q, qdot = step(q, qdot, res)
            rs.append(res)
        return LoopResult(q, qdot, *stack(rs), refined_ticks=refined)

    return loop
