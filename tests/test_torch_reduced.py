"""The port's reduced-dimension path (``wbc/reduced.py``,
``wbc/reduced_tick.py::ReducedTick``, the QP builders' ``limit_rows``)
against the JAX package's, float64 on the CPU, on ``models/tocabi.npz``.

The JAX ticks run jitted once per configuration in a module fixture (about
20 s a compile): the flagship and BASELINE's config 3 at 12 IPM iterations,
cold (x = 0, λ = 1) and warm (the cold tick's (x, λ), the joints moved by
1e-3), the flagship with ``tangential_weight=False`` and servos, and a
second topology made by ``change_link_to_fixed`` on the hands.  Limits:
τ_grav 1e-10; τ_task, τ_contact, τ_cmd, contact force, gap, primal
residual and the warm (x, λ) 1e-8.  Config 3's first QP sits on nearly
dependent active rows: its float64 polish (penalty 1e9) turns summation-
order roundoff into ~5e-5 in x, JAX against JAX-fed port included, so its
QP-dependent fields take the repository's flat-face limits (τ_task 2e-3,
τ_cmd and the contact force 5e-2, warm x 2e-3; λ, not unique on dependent
rows, is not compared) while τ_grav stays at 1e-10.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
B = 3
ITERS = 12
TICK_FIELDS = ("torque_grav", "torque_task", "torque_contact", "torque_cmd", "contact_force",
               "qp_gap", "qp_primal_res", "contact_rank_health")
TOL = {"torque_grav": 1e-10, "contact_rank_health": 1e-10}
# config 3's polished first QP (module docstring): the flat-face limits
FLAT = {"torque_task": 2e-3, "torque_contact": 2e-3, "torque_cmd": 5e-2,
        "contact_force": 5e-2}


def _tol(cfg_name, field):
    if field in TOL:
        return TOL[field]
    return FLAT.get(field, 1e-8) if cfg_name == "config 3" else 1e-8


def _models():
    from libdwbc_tpu.model.compile import RobotModel as JModel
    from libdwbc_tpu_torch.model.compile import RobotModel

    return JModel.load(MODEL), RobotModel.load(MODEL)


def _configs(jm, pm, name, **kw):
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config as jcfg
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config as pcfg

    opts = dict(both_feet=False, swing_task=True) if name == "config 3" else {}
    return jcfg(jm, qp_iters=ITERS, **opts, **kw), pcfg(pm, qp_iters=ITERS, **opts, **kw)


def _inputs(pm, name):
    from libdwbc_tpu_torch import entry

    q, qd, fs = entry._swing_inputs(pm, B, seed=4, dtype=np.float64)
    return q, qd, (fs if name == "config 3" else fs[:2])


def _moved(q):
    q2 = q.copy()
    q2[:, 6:] += 1e-3
    return q2


def _jax_servos(q):
    """JAX servos on B lanes: a pelvis 6D servo to a 2 mm offset with its
    rotation turned 0.01 rad about z, a link-15 rotation servo, gentle
    gains, per-lane clocks inside and past the trajectories."""
    from libdwbc_tpu.wbc.pipeline import make_servo
    from libdwbc_tpu_torch.entry import _link_frames
    from libdwbc_tpu_torch.kin.rotations import axis_angle_matrix

    _, pm = _models()
    p0, R0, R15 = (t.numpy() for t in _link_frames(pm, q))
    turn = axis_angle_matrix(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                             torch.tensor(0.01, dtype=torch.float64)).numpy()
    t = np.linspace(0.05, 0.3, B)
    pelvis = make_servo(pos_init=p0, pos_des=p0 + [0.002, 0.0, 0.001], rot_init=R0,
                        rot_des=turn @ R0, t=t, t0=0.0, tf=0.2, pos_p=100.0, pos_d=10.0,
                        rot_p=100.0, rot_d=10.0, dtype=jnp.float64)
    torso = make_servo(rot_init=R15, rot_des=R15, t=t, t0=0.0, tf=0.2, rot_p=50.0,
                       rot_d=5.0, dtype=jnp.float64)
    return ((pelvis,), (torso,))


def _servos_np(servos):
    return tuple(tuple(sp._replace(**{f: np.asarray(getattr(sp, f)) for f in sp._fields})
                       for sp in lvl) for lvl in servos)


def _jax_run(tick, q, qd, fs, warm, servos=None):
    from libdwbc_tpu_torch.convert import result_to_numpy, warm_to_numpy

    f = jax.jit(tick._tick_impl, static_argnames=("qp_iters",))
    r, w = f(jnp.asarray(q), jnp.asarray(qd), tuple(map(jnp.asarray, fs)), warm=warm,
             qp_iters=ITERS, servos=servos)
    return f, result_to_numpy(r), warm_to_numpy(w), w


def _hands_fixed(model, surgery):
    """The model with both hands (links 31, then 23) frozen onto their
    parents: 31 dofs, the legs, pelvis and torso untouched."""
    return surgery.change_link_to_fixed(surgery.change_link_to_fixed(model, 31), 23)


@pytest.fixture(scope="module")
def ref():
    """The JAX references (see the module docstring)."""
    from libdwbc_tpu.model import surgery as jsurg
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config as jcfg
    from libdwbc_tpu.wbc.reduced_tick import ReducedTick

    jm, pm = _models()
    out = {}
    for name in ("flagship", "config 3"):
        jc, _ = _configs(jm, pm, name)
        jt = ReducedTick(jm, jc, dtype=jnp.float64)
        q, qd, fs = _inputs(pm, name)
        f, cold, wcold, w = _jax_run(jt, q, qd, fs, jt.init_warm((B,)))
        rw, ww = f(jnp.asarray(_moved(q)), jnp.asarray(qd), tuple(map(jnp.asarray, fs)),
                   warm=w, qp_iters=ITERS)
        from libdwbc_tpu_torch.convert import result_to_numpy, warm_to_numpy

        out[name] = dict(cold=cold, w_cold=wcold, warm=result_to_numpy(rw),
                         w_warm=warm_to_numpy(ww), f=f, init=jt.init_warm((B,)))
    # the flagship with the min-norm redistribution and servos
    jc, _ = _configs(jm, pm, "flagship")
    jt = ReducedTick(jm, jc, dtype=jnp.float64, tangential_weight=False)
    q, qd, fs = _inputs(pm, "flagship")
    sv = _jax_servos(q)
    _, r, w, _ = _jax_run(jt, q, qd, fs, jt.init_warm((B,)), servos=sv)
    out["servo"] = dict(cold=r, w_cold=w, servos=_servos_np(sv))
    # a second topology: the hands frozen
    jm2 = _hands_fixed(jm, jsurg)
    jt = ReducedTick(jm2, jcfg(jm2, qp_iters=ITERS), dtype=jnp.float64)
    gone = [int(pm.q_index[23]), int(pm.q_index[31])]       # the frozen joints' dofs
    q2, qd2 = np.delete(q, gone, axis=1), np.delete(qd, gone, axis=1)
    _, r, w, _ = _jax_run(jt, q2, qd2, fs, jt.init_warm((B,)))
    out["hands fixed"] = dict(cold=r, w_cold=w, q=q2, qd=qd2)
    return out


def _port_tick(pm, pc, **kw):
    from libdwbc_tpu_torch.wbc.reduced_tick import ReducedTick

    return ReducedTick(pm, pc, "cpu", torch.float64, backend="torch", **kw)


@pytest.fixture(scope="module")
def port():
    """The port's ticks on the fixture's inputs."""
    from libdwbc_tpu_torch.convert import result_to_numpy, warm_to_numpy

    jm, pm = _models()
    out = {}
    for name in ("flagship", "config 3"):
        _, pc = _configs(jm, pm, name)
        t = _port_tick(pm, pc)
        q, qd, fs = _inputs(pm, name)
        rc, wc = t._tick_impl(q, qd, fs, warm=t.init_warm((B,)), qp_iters=ITERS)
        rw, ww = t._tick_impl(_moved(q), qd, fs, warm=wc, qp_iters=ITERS)
        out[name] = dict(cold=result_to_numpy(rc), w_cold=warm_to_numpy(wc),
                         warm=result_to_numpy(rw), w_warm=warm_to_numpy(ww), tick=t)
    return out


@pytest.mark.parametrize("phase", ["cold", "warm"])
@pytest.mark.parametrize("name", ["flagship", "config 3"])
@pytest.mark.parametrize("field", TICK_FIELDS)
def test_reduced_tick_matches_jax(ref, port, name, phase, field):
    got, want = port[name][phase][field], ref[name][phase][field]
    err = float(np.abs(got - want).max())
    print(f"{name} {phase} {field}: {err:.3e}")
    assert err <= _tol(name, field)
    assert np.array_equal(port[name][phase]["qp_error"], ref[name][phase]["qp_error"])
    assert not port[name][phase]["qp_error"].any()


@pytest.mark.parametrize("phase", ["w_cold", "w_warm"])
@pytest.mark.parametrize("name", ["flagship", "config 3"])
def test_reduced_warm_state_matches_jax(ref, port, name, phase):
    got, want = port[name][phase], ref[name][phase]
    assert [(x.shape, lam.shape) for x, lam in got] == [(x.shape, lam.shape) for x, lam in want]
    for (x, lam), (xr, lr) in zip(got, want):
        if name == "config 3":
            assert np.abs(x - xr).max() <= 2e-3
        else:
            assert np.abs(x - xr).max() <= 1e-8 and np.abs(lam - lr).max() <= 1e-8


def test_reduced_tick_servos_min_norm_matches_jax(ref):
    """tangential_weight=False (the full tick's objective) with servos."""
    from libdwbc_tpu_torch.convert import result_to_numpy, servos_from_numpy, warm_to_numpy

    jm, pm = _models()
    _, pc = _configs(jm, pm, "flagship")
    t = _port_tick(pm, pc, tangential_weight=False)
    q, qd, fs = _inputs(pm, "flagship")
    r, w = t._tick_impl(q, qd, fs, warm=t.init_warm((B,)), qp_iters=ITERS,
                        servos=servos_from_numpy(ref["servo"]["servos"]))
    got = result_to_numpy(r)
    for field in TICK_FIELDS:
        err = float(np.abs(got[field] - ref["servo"]["cold"][field]).max())
        print(f"servo'd, min-norm {field}: {err:.3e}")
        assert err <= _tol("flagship", field), field
    for (x, lam), (xr, lr) in zip(warm_to_numpy(w), ref["servo"]["w_cold"]):
        assert np.abs(x - xr).max() <= 1e-8 and np.abs(lam - lr).max() <= 1e-8


def test_reduced_tick_second_topology_matches_jax(ref):
    """change_link_to_fixed on the hands, the same call in both packages."""
    from libdwbc_tpu_torch.convert import result_to_numpy
    from libdwbc_tpu_torch.model import surgery
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    _, pm = _models()
    pm2 = _hands_fixed(pm, surgery)
    assert pm2.model_dof == 31
    t = _port_tick(pm2, standard_tocabi_config(pm2, qp_iters=ITERS))
    _, _, fs = _inputs(pm, "flagship")
    r, _ = t._tick_impl(ref["hands fixed"]["q"], ref["hands fixed"]["qd"], fs,
                        warm=t.init_warm((B,)), qp_iters=ITERS)
    got = result_to_numpy(r)
    for field in TICK_FIELDS:
        err = float(np.abs(got[field] - ref["hands fixed"]["cold"][field]).max())
        print(f"hands fixed {field}: {err:.3e}")
        assert err <= _tol("flagship", field), field


def test_reduced_unbatched_tick_is_lane_zero(port):
    t = port["flagship"]["tick"]
    _, pm = _models()
    q, qd, fs = _inputs(pm, "flagship")
    rb = t._tick_impl(q, qd, fs)
    r1 = t._tick_impl(q[0], qd[0], tuple(f[0] for f in fs))
    assert r1.torque_cmd.shape == (33,) and r1.qp_gap.shape == ()
    assert float((r1.torque_cmd - rb.torque_cmd[0]).abs().max()) <= 1e-9


def test_reduced_loop_warm_chain_matches_jax(ref):
    """make_control_loop over the port's ReducedTick, K = 4 warm ticks at
    the full budget with the state held, against the JAX tick chained by
    hand through its jitted function."""
    from libdwbc_tpu_torch.wbc.loop import make_control_loop

    jm, pm = _models()
    _, pc = _configs(jm, pm, "flagship")
    t = _port_tick(pm, pc)
    q, qd, fs = _inputs(pm, "flagship")
    out = make_control_loop(t, K=4, warm_start=True, warm_iters=ITERS)(q, qd, fs)
    f, w = ref["flagship"]["f"], ref["flagship"]["init"]
    taus = []
    for _ in range(4):
        r, w = f(jnp.asarray(q), jnp.asarray(qd), tuple(map(jnp.asarray, fs)), warm=w,
                 qp_iters=ITERS)
        taus.append(np.asarray(r.torque_cmd))
    assert out.torques.shape == (4, B, 33) and out.refined_ticks == 0
    assert np.abs(out.torques.numpy() - np.stack(taus)).max() <= 1e-8
    assert not out.qp_error.any()


@pytest.mark.parametrize("case", ["flagship", "config 3", "single contact", "no hqp"])
def test_reduced_init_warm_is_the_warm_state_out(case):
    """init_warm lists exactly the QPs the tick runs (JAX's list too): one
    6D contact runs no redistribution QP, use_hqp=False runs none."""
    from libdwbc_tpu.wbc.reduced_tick import ReducedTick as JTick

    jm, pm = _models()
    name = "config 3" if case == "config 3" else "flagship"
    kw = dict(both_feet=False) if case in ("single contact", "no hqp") else {}
    jc, pc = _configs(jm, pm, name, **kw)
    if case == "no hqp":
        jc, pc = dataclasses.replace(jc, use_hqp=False), dataclasses.replace(pc, use_hqp=False)
    t = _port_tick(pm, pc, tangential_weight=False)
    q, qd, fs = _inputs(pm, name)
    w0 = t.init_warm((B,))
    _, w1 = t._tick_impl(q, qd, fs, warm=w0, qp_iters=4)
    shapes = [(tuple(x.shape), tuple(lam.shape)) for x, lam in w0]
    assert shapes == [(tuple(x.shape), tuple(lam.shape)) for x, lam in w1]
    jt = JTick(jm, jc, dtype=jnp.float64)
    assert shapes == [(tuple(x.shape), tuple(lam.shape)) for x, lam in jt.init_warm((B,))]
    assert len(shapes) == {"flagship": 3, "config 3": 2, "single contact": 2, "no hqp": 0}[case]


def test_reduced_tick_refuses_a_degenerate_model():
    """A model whose every joint is on the contact chain: the same
    ValueError in both packages."""
    from libdwbc_tpu.model.compile import JointSpec as JJ, LinkSpec as JL
    from libdwbc_tpu.model.compile import compile_from_links as jcompile
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu.wbc.pipeline import PipelineConfig as JCfg
    from libdwbc_tpu.wbc.reduced_tick import ReducedTick as JTick
    from libdwbc_tpu_torch.model.compile import JointSpec, LinkSpec, compile_from_links
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.pipeline import PipelineConfig

    msgs = []
    for LS, JS, comp, TT, Cfg, tick in (
            (JL, JJ, jcompile, JT, JCfg, lambda m, c: JTick(m, c)),
            (LinkSpec, JointSpec, compile_from_links, T, PipelineConfig,
             lambda m, c: _port_tick(m, c))):
        links = [LS("base", 3.0, np.zeros(3), np.diag([0.1, 0.1, 0.1]), -1),
                 LS("l1", 1.0, np.array([0, 0, -0.2]), np.diag([0.01] * 3), 0)]
        joints = [JS("floating", name="root"),
                  JS("revolute", np.array([0, 1.0, 0]), np.array([0, 0, -0.3]), name="j1")]
        cfg = Cfg(contacts=(TT.ContactDef(
            link=1, contact_type=TT.CONTACT_POINT, contact_point=np.array([0.0, 0.0, -0.2]),
            contact_direction=np.array([0.0, 0.0, 1.0]), plane_x=0.0, plane_y=0.0,
            active=True),), task_specs=(((TT.TASK_LINK_POSITION, 0),),),
            torque_limit=np.full(1, 50.0))
        with pytest.raises(ValueError, match="degenerate") as e:
            tick(comp(links, joints), cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_reduced_tick_refuses_a_level_on_both_chains():
    jm, pm = _models()
    from libdwbc_tpu_torch.wbc import types as T

    _, pc = _configs(jm, pm, "flagship")
    pc = dataclasses.replace(pc, task_specs=(((T.TASK_LINK_6D, 0), (T.TASK_LINK_ROTATION, 15)),))
    with pytest.raises(NotImplementedError, match="both chains"):
        _port_tick(pm, pc)


# ------------------------------------------------- wbc/reduced.py pieces

@pytest.fixture(scope="module")
def dyn_pair():
    """reduced_dynamics, reduced_contact_space and reduced_gravity of both
    packages on the flagship's states (JAX eager)."""
    from libdwbc_tpu.kin.engine import Kinematics as JKin
    from libdwbc_tpu.wbc import reduced as jred
    from libdwbc_tpu_torch.kin.engine import Kinematics
    from libdwbc_tpu_torch.wbc import reduced as pred

    jm, pm = _models()
    _, pc = _configs(jm, pm, "flagship")
    q, qd, _ = _inputs(pm, "flagship")
    qd = 0.05 * np.random.default_rng(2).standard_normal(qd.shape)
    links = [c.link for c in pc.contacts]
    jidx, pidx = jred.classify_chains(jm, links), pred.classify_chains(pm, links)
    points = tuple((c.link, tuple(float(x) for x in c.contact_point)) for c in pc.contacts)

    @jax.jit
    def jax_side(q, qd):
        st = JKin(jm).update(q, qd, points=points)
        rd = jred.reduced_dynamics(jm, jidx, st)
        cs, JCR = jred.reduced_contact_space(
            jidx, jnp.concatenate([st.J_pts[:, i] for i in range(2)], axis=-2), rd)
        return rd, cs, JCR, jred.reduced_gravity(jidx, cs, rd, st.G)

    jrd, jcs, jJCR, jg = jax_side(jnp.asarray(q), jnp.asarray(qd))
    pst = Kinematics(pm).update(torch.as_tensor(q), torch.as_tensor(qd), points=points)
    prd = pred.reduced_dynamics(pm, pidx, pst)
    pJ = torch.cat([pst.J_pts[:, i] for i in range(2)], dim=-2)
    pcs, pJCR = pred.reduced_contact_space(pidx, pJ, prd)
    pg = pred.reduced_gravity(pidx, pcs, prd, pst.G)
    return dict(jidx=jidx, pidx=pidx, jrd=jrd, prd=prd, jcs=jcs, pcs=pcs, jJCR=jJCR,
                pJCR=pJCR, jg=jg, pg=pg)


def test_reduced_index_matches_jax(dyn_pair):
    a, b = dyn_pair["jidx"], dyn_pair["pidx"]
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), f.name
    assert (b.co_dof, b.nc_dof, b.reduced_system_dof) == (12, 21, 24)


RD_FIELDS = ("mass_nc", "com_pos_nc", "inertia_nc", "cmm_nc", "J_I_nc", "A_NC_joint", "J_R",
             "A_R_inv", "A_R", "J_I_nc_inv_T", "N_I_nc", "J_R_INV_T", "G_R", "G_NC")


@pytest.mark.parametrize("field", RD_FIELDS)
def test_reduced_dynamics_matches_jax(dyn_pair, field):
    got = getattr(dyn_pair["prd"], field).numpy()
    want = np.asarray(getattr(dyn_pair["jrd"], field))
    err = float(np.abs(got - want).max())
    print(f"{field}: {err:.3e}")
    assert err <= 1e-10


@pytest.mark.parametrize("field", ["Lambda_c", "J_C_INV_T", "N_C", "A_inv_N_C", "W", "W_inv",
                                   "NwJw", "J_CR", "tg_full", "tg_R", "P_CR"])
def test_reduced_contact_space_and_gravity_match_jax(dyn_pair, field):
    if field == "J_CR":
        got, want = dyn_pair["pJCR"].numpy(), np.asarray(dyn_pair["jJCR"])
    elif field in ("tg_full", "tg_R", "P_CR"):
        i = ("tg_full", "tg_R", "P_CR").index(field)
        got, want = dyn_pair["pg"][i].numpy(), np.asarray(dyn_pair["jg"][i])
    else:
        got, want = getattr(dyn_pair["pcs"], field).numpy(), np.asarray(getattr(
            dyn_pair["jcs"], field))
    if field == "NwJw":     # the kernel basis follows roundoff; NwJw·NwJwᵀ does not
        got, want = got @ got.swapaxes(-1, -2), want @ want.swapaxes(-1, -2)
    err = float(np.abs(got - want).max())
    print(f"{field}: {err:.3e}")
    assert err <= 1e-10 * max(1.0, float(np.abs(want).max()))


# ------------------------------------------------- the builders' limit_rows

@pytest.fixture(scope="module")
def builder_args():
    """The arguments the port's flagship ReducedTick hands its QP builders
    on the fixture's states, float64: (task level 0, redistribution)."""
    from libdwbc_tpu_torch.wbc import hqp as ph
    from libdwbc_tpu_torch.wbc import reduced_tick as rt

    jm, pm = _models()
    _, pc = _configs(jm, pm, "flagship")
    t = _port_tick(pm, pc)
    q, qd, fs = _inputs(pm, "flagship")
    seen = {}
    orig = (rt.solve_task_level_qp, rt.solve_contact_redistribution_qp)

    def rec(name, fn):
        def wrapped(*a, **kw):
            seen.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapped

    rt.solve_task_level_qp = rec("task", ph.solve_task_level_qp)
    rt.solve_contact_redistribution_qp = rec("redistribution", ph.solve_contact_redistribution_qp)
    try:
        t._tick_impl(q, qd, fs, warm=t.init_warm((B,)), qp_iters=ITERS)
    finally:
        rt.solve_task_level_qp, rt.solve_contact_redistribution_qp = orig
    return seen, t.ridx.co_dof


@pytest.mark.parametrize("builder", ["task", "redistribution"])
@pytest.mark.parametrize("limited", [False, True])
def test_qp_builders_limit_rows_match_jax(builder_args, builder, limited):
    """Both builders on the reduced tick's own arguments, with its
    limit_rows (the co_dof actuated rows of 18) and without, against JAX at
    float64, and the mirror count they hand solve_qp: len(limit_rows)."""
    from libdwbc_tpu.wbc import hqp as jh
    from libdwbc_tpu_torch.wbc import hqp as ph

    seen, co = builder_args
    a, kw = seen[builder]
    kw = {k: v for k, v in kw.items() if k not in ("warm", "backend", "limit_rows")}
    rows = tuple(range(co)) if limited else None
    jfn = jh.solve_task_level_qp if builder == "task" else jh.solve_contact_redistribution_qp
    pfn = ph.solve_task_level_qp if builder == "task" else ph.solve_contact_redistribution_qp

    def j(v):
        return jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v

    want = jfn(*map(j, a), **{k: j(v) for k, v in kw.items()}, limit_rows=rows)
    calls = []
    solve = ph.solve_qp

    def rec(*args, **kwargs):
        calls.append((args[2].shape[-2], kwargs["mirror"]))
        return solve(*args, **kwargs)

    ph.solve_qp = rec
    try:
        got = pfn(*a, **kw, limit_rows=rows)
    finally:
        ph.solve_qp = solve
    n_lim = co + 6 if rows is None else co           # the reduced model dof, or co_dof
    assert calls == [(2 * n_lim + 20, n_lim)]
    for f in ("x", "lam", "gap", "primal_res"):
        err = float(np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f))).max())
        print(f"{builder} limit_rows={rows} {f}: {err:.3e}")
        assert err <= 1e-8, f


@pytest.mark.parametrize("name", ["flagship", "config 3"])
def test_reduced_qps_route_to_the_kernel(name):
    """Every QP of ReducedTick is one that qp_cuda.kernel_takes accepts with
    mirror = co_dof, and every inverse of 16 ≤ n ≤ 64 one that
    linalg_cuda.use_kernel routes: seen by widening the routing rules on
    the CPU, as tests/test_torch_compiled.py does."""
    from libdwbc_tpu_torch.ops import linalg_cuda, qp as qpmod, qp_cuda

    jm, pm = _models()
    _, pc = _configs(jm, pm, name)
    t = _port_tick(pm, pc)
    q, qd, fs = _inputs(pm, name)
    seen_qp, seen_inv = [], []
    use_qp, use_inv = qpmod._use_kernel, linalg_cuda.use_kernel

    def wide_qp(H, A, lb, Aeq, backend, mirror=0):
        ok = lb is None and Aeq is None and qp_cuda.kernel_takes(H.shape[-1], A.shape[-2],
                                                                 mirror)
        seen_qp.append((H.shape[-1], A.shape[-2], mirror, ok))
        return False

    def wide_inv(M, backend):
        seen_inv.append((M.shape[-1], linalg_cuda.MIN_N <= M.shape[-1] <= linalg_cuda.MAX_N))
        return False

    qpmod._use_kernel, linalg_cuda.use_kernel = wide_qp, wide_inv
    try:
        t._tick_impl(q, qd, fs, warm=t.init_warm((B,)), qp_iters=2)
    finally:
        qpmod._use_kernel, linalg_cuda.use_kernel = use_qp, use_inv
    co = t.ridx.co_dof
    want = {"flagship": [(12, 44), (12, 44), (6, 44)], "config 3": [(6, 22), (6, 22)]}[name]
    assert seen_qp == [(n, m, co, True) for n, m in want]
    routed = [n for n, ok in seen_inv if ok]
    assert routed == {"flagship": [39, 24, 18], "config 3": [39, 18]}[name]


def test_reduced_tick_cuda_backend_refuses_the_cpu():
    """ReducedTick(backend="cuda") needs a CUDA device, as CompiledTick."""
    from libdwbc_tpu_torch import entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry._model_and_tick("cpu", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry._model_and_tick(reduced=True, swing=True)
