"""The port's plain prestage against the JAX TickProgram.prestage at float64.

Both packages load models/tocabi.npz themselves and run the flagship
configuration (standard_tocabi_config) on the same four seeded states: the
two reference cases and two perturbed copies, one with a rotated base.  The
JAX program runs eagerly (no jit), once per module.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CASE_Q, full_q

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
FIELDS = ("torque_grav", "P_C", "Jbar_act", "NwJw", "Ntorques.0", "Ntorques.1",
          "Atemp", "bA0", "health")


def _states():
    rng = np.random.default_rng(7)
    qs = [full_q(CASE_Q[1]), full_q(CASE_Q[2]),
          full_q(CASE_Q[1] + 0.02 * rng.standard_normal(33)),
          full_q(CASE_Q[2] + 0.02 * rng.standard_normal(33))]
    quat = np.array([0.02, -0.03, 0.05, 1.0])
    qs[3][3:6], qs[3][39] = (quat / np.linalg.norm(quat))[0:3], (quat / np.linalg.norm(quat))[3]
    return np.ascontiguousarray(np.stack(qs).T)          # element-leading (nq, 4)


def _flat(pre):
    out = {k: np.asarray(v) for k, v in pre.items() if k != "Ntorques"}
    for h, t in enumerate(pre["Ntorques"]):
        out[f"Ntorques.{h}"] = np.asarray(t)
    return out


@pytest.fixture(scope="module")
def q_el():
    return _states()


@pytest.fixture(scope="module")
def jax_pre(q_el):
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.ops.tick_kernel import TickProgram
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    prog = TickProgram(m, standard_tocabi_config(m), jnp.float64)
    return _flat(prog.prestage(jnp.asarray(q_el)))


def _port_prog(dtype):
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(MODEL)
    return TickProgram(m, standard_tocabi_config(m), "cpu", dtype)


@pytest.fixture(scope="module")
def torch_pre(q_el):
    return _flat(_port_prog(torch.float64).prestage(torch.as_tensor(q_el)))


@pytest.mark.parametrize("field", FIELDS)
def test_prestage_matches_jax(field, jax_pre, torch_pre):
    ref, out = jax_pre[field], torch_pre[field]
    assert out.shape == ref.shape
    tol = 1e-12 if field == "health" else 1e-9
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{field}: max abs error {err:.3e}"


def test_prestage_float32_close_to_float64(q_el, torch_pre):
    """float32 (with the task-space ridge) stays within bench.py's τ_grav
    truth-guard bar of float64."""
    pre32 = _port_prog(torch.float32).prestage(torch.as_tensor(q_el, dtype=torch.float32))
    err = float(np.abs(pre32["torque_grav"].double().numpy() - torch_pre["torque_grav"]).max())
    assert err < 0.05
    assert all(torch.isfinite(t).all() for t in pre32["Ntorques"])


def _variant_cfg(T, cfg_mod, model, variant):
    """Static-mode branches the flagship does not take: mixed 6D/line/point
    contacts with a whole-body COM task and custom/COM-frame task points,
    a single foot (no redistribution space, cfree = 0), BASELINE's config
    3, a single foot with a swing-foot third level, the reference's
    hands-and-feet fixture (6D feet, POINT hands on links 23 and 31 with a
    0.04 × 0.04 plane; tests/test_contacts_non6d.py:20-40), or the
    flagship on LINE feet (edge stance, plane_y 0)."""
    import dataclasses

    if variant == "swing":
        return cfg_mod.standard_tocabi_config(model, both_feet=False, swing_task=True)
    if variant == "hands":
        base = cfg_mod.standard_tocabi_config(model)
        return dataclasses.replace(base, contacts=base.contacts + tuple(
            dataclasses.replace(base.contacts[0], link=link, contact_type=T.CONTACT_POINT,
                                plane_x=0.04, plane_y=0.04) for link in (23, 31)))
    if variant == "line_feet":
        base = cfg_mod.standard_tocabi_config(model)
        return dataclasses.replace(base, contacts=tuple(
            dataclasses.replace(c, contact_type=T.CONTACT_LINE, plane_y=0.0)
            for c in base.contacts))
    base = cfg_mod.standard_tocabi_config(model, both_feet=variant == "mixed")
    if variant == "single_foot":
        return base
    foot = base.contacts[0]
    contacts = (
        foot,
        dataclasses.replace(foot, link=12, contact_type=T.CONTACT_LINE, plane_y=0.0),
        dataclasses.replace(foot, link=23, contact_type=T.CONTACT_POINT,
                            contact_point=np.array([0.0, 0.0, -0.05])),
    )
    tasks = (((T.TASK_LINK_6D, model.nbody),),
             ((T.TASK_LINK_POSITION_CUSTOM_FRAME, 15, np.array([0.1, 0.0, 0.2])),
              (T.TASK_LINK_ROTATION, 31)),
             ((T.TASK_LINK_POSITION_COM_FRAME, 27),))
    return dataclasses.replace(base, contacts=contacts, task_specs=tasks)


@pytest.fixture(scope="module", params=["mixed", "single_foot", "swing", "hands", "line_feet"])
def variant(request, q_el):
    from libdwbc_tpu.model.compile import RobotModel as JM
    from libdwbc_tpu.ops.tick_kernel import TickProgram as JP
    from libdwbc_tpu.wbc import pipeline as jpipe
    from libdwbc_tpu.wbc import types as JT
    from libdwbc_tpu_torch.model.compile import RobotModel as PM
    from libdwbc_tpu_torch.ops.tick_kernel import TickProgram as PP
    from libdwbc_tpu_torch.wbc import pipeline as ppipe
    from libdwbc_tpu_torch.wbc import types as PT

    jm, pm = JM.load(MODEL), PM.load(MODEL)
    jpre = JP(jm, _variant_cfg(JT, jpipe, jm, request.param), jnp.float64).prestage(
        jnp.asarray(q_el))
    ppre = PP(pm, _variant_cfg(PT, ppipe, pm, request.param), "cpu", torch.float64
              ).prestage(torch.as_tensor(q_el))
    return request.param, jpre, ppre


def test_prestage_variant_matches_jax(variant):
    name, jpre, ppre = variant
    assert (ppre["NwJw"] is None) == (name in ("single_foot", "swing"))
    keys = [k for k in jpre if k not in ("Ntorques", "health") and jpre[k] is not None]
    assert set(keys) >= {"torque_grav", "P_C", "Jbar_act", "Atemp", "bA0"}
    if name in ("mixed", "swing"):
        assert len(jpre["Ntorques"]) == 3
    if name == "mixed":
        assert "Jcom_total" in keys
    for k in keys:
        err = float(np.abs(ppre[k].numpy() - np.asarray(jpre[k])).max())
        assert err <= 1e-9, f"{name}.{k}: {err:.3e}"
    for a, b in zip(ppre["Ntorques"], jpre["Ntorques"], strict=True):
        assert float(np.abs(np.asarray(b)).max()) < 1e3          # well-posed levels
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-9
    assert abs(float((ppre["health"].numpy() - np.asarray(jpre["health"])).max())) <= 1e-12
