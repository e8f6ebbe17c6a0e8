"""Model and config carry-over into the port, and the CUDA kernels' packed table."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from libdwbc_tpu_torch import convert
from libdwbc_tpu_torch.model.compile import RobotModel as PortModel
from libdwbc_tpu_torch.wbc import types as T
from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
FIELDS = [f.name for f in dataclasses.fields(PortModel)]


@pytest.fixture(scope="module")
def models():
    from libdwbc_tpu.model.compile import RobotModel as JaxModel

    jm = JaxModel.load(MODEL)
    return jm, PortModel.load(MODEL), convert.from_jax_model(jm)


def _same(a, b):
    if isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(
            a[k][0] == b[k][0] and np.array_equal(a[k][1], b[k][1])
            and np.array_equal(a[k][2], b[k][2]) for k in b)
    return type(a) is type(b) and a == b


def test_port_model_has_every_jax_field(models):
    jm, _, _ = models
    assert FIELDS == [f.name for f in dataclasses.fields(type(jm))]


@pytest.mark.parametrize("field", FIELDS)
def test_loader_reproduces_jax_field(models, field):
    jm, pm, _ = models
    assert _same(getattr(pm, field), getattr(jm, field)), field


@pytest.mark.parametrize("field", FIELDS)
def test_from_jax_model_reproduces_field(models, field):
    jm, _, cm = models
    assert _same(getattr(cm, field), getattr(jm, field)), field


def test_config_from_jax(models):
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config as jax_cfg

    jm, pm, _ = models
    got = convert.config_from_jax(jax_cfg(jm, qp_iters=12))
    want = standard_tocabi_config(pm, qp_iters=12)
    assert got.task_specs == want.task_specs
    assert np.array_equal(got.torque_limit, want.torque_limit)
    assert (got.qp_iters, got.use_hqp, got.qp_fail_gap, got.qp_fail_pres) == \
           (want.qp_iters, want.use_hqp, want.qp_fail_gap, want.qp_fail_pres)
    for a, b in zip(got.contacts, want.contacts, strict=True):
        for f in dataclasses.fields(T.ContactDef):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_kernel_table_layout(models):
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan

    _, pm, _ = models
    plan = TickPlan(pm, standard_tocabi_config(pm))
    tab = tc.kernel_table(plan)
    hdr = tab[:tc.HDR]
    assert list(hdr[:10]) == [34, 39, 33, 4, 2, 12, 6, 20, 2, 40]
    assert list(hdr[tc.H_LEV_T:tc.H_LEV_T + tc.NLEV_MAX]) == [6, 3, 0, 0]
    assert (hdr[tc.H_MASKED], hdr[tc.H_NTASK], hdr[tc.H_TOT], hdr[tc.H_LIM]) == (0, 2, 0, 1)
    assert hdr[tc.H_MASS] == pm.total_mass
    nb, nd, npts, nc, ntask = 34, 39, 4, 2, 2
    want = (tc.HDR + 2 * nb + nd + 3 * nb + 9 * nb + 3 * nb + 3 * nb + 9 * nb + nb
            + nb * nd + 3 + npts + 3 * npts + (7 + 6 + 10 + 60) * nc
            + 4 * ntask + 33)
    assert tab.shape == (want,)
    # the contact section: point slot, link, type (6D), J_C rows from 0 and
    # 6, constraint rows from 0 and 10
    c0 = tc.HDR + 2 * nb + nd + 28 * nb + nb * nd + 3 + 4 * npts
    assert tab[c0:c0 + 14].tolist() == [0, 6, 0, 0, 6, 0, 10, 1, 12, 0, 6, 6, 10, 10]
    # the header's integers exact in float32 (the mass is the one real number)
    ints = np.delete(hdr, tc.H_MASS)
    assert np.array_equal(ints.astype(np.float32).astype(np.float64), ints)
    # the task section (level, point slot, first row, rows): the pelvis 6D
    # task, then the link-15 rotation task (rows 3-5 of its point's jacobian)
    assert tab[-33 - 8:-33].tolist() == [0, plan.task_slots[0][0][1], 0, 6,
                                         1, plan.task_slots[1][0][1], 3, 3]
    assert tab[-33:].tolist() == [300.0] * 33


@pytest.mark.parametrize("variant", ["single_foot", "three_levels", "position_task",
                                     "swing", "com_task", "point_contact", "four_contacts",
                                     "no_torque_limit", "line_feet", "hands_masked"])
def test_kernel_table_takes_general_configs(models, variant):
    """One to four contacts of any type (6D, POINT, LINE; masked: as
    candidates), with or without a torque limit, under up to four levels
    of 6D, position and rotation tasks (a whole-body COM task too) build a
    table and the kernels' module; the task section lists every task in
    level order, the contact section every contact's rows, the tlim
    section is there exactly with a limit."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan, TickProgram

    _, pm, _ = models
    cfg = standard_tocabi_config(pm, both_feet=variant not in ("single_foot", "swing"),
                                 swing_task=variant in ("three_levels", "swing"))
    if variant == "position_task":
        cfg = dataclasses.replace(cfg, task_specs=(
            cfg.task_specs[0], ((T.TASK_LINK_POSITION, 15),)))
    elif variant == "com_task":
        cfg = dataclasses.replace(cfg, task_specs=(
            ((T.TASK_LINK_6D, pm.nbody),),
            ((T.TASK_LINK_POSITION, 15), (T.TASK_LINK_ROTATION, 31))))
    elif variant == "point_contact":
        cfg = dataclasses.replace(cfg, contacts=(
            dataclasses.replace(cfg.contacts[0], contact_type=T.CONTACT_POINT),)
            + cfg.contacts[1:])
    elif variant in ("four_contacts", "hands_masked"):
        cfg = entry._hands_feet_config(pm, T.CONTACT_6D if variant == "four_contacts"
                                       else T.CONTACT_POINT)
    elif variant == "no_torque_limit":
        cfg = dataclasses.replace(cfg, torque_limit=None)
    elif variant == "line_feet":
        cfg = dataclasses.replace(cfg, contacts=tuple(
            dataclasses.replace(c, contact_type=T.CONTACT_LINE, plane_y=0.0)
            for c in cfg.contacts))
    plan = TickPlan(pm, cfg, masked=variant == "hands_masked")
    assert tc.kernel_unsupported(plan) is None
    tab = tc.kernel_table(plan)
    tasks = tc.tasks(plan)
    nlim = 0 if variant == "no_torque_limit" else 33
    assert tab[tc.H_LIM] == float(nlim > 0)
    assert tab[tc.H_NTASK] == len(tasks) and tab[tc.H_TOT] == float(variant == "com_task")
    assert tab[len(tab) - nlim - 4 * len(tasks):len(tab) - nlim].reshape(-1, 4).tolist() == [
        [h, slot, r0, nr] for h, _, slot, r0, nr in tasks]
    nc = len(cfg.contacts)
    c0 = len(tab) - nlim - 4 * len(tasks) - (7 + 6 + 10 + 60) * nc
    assert tab[c0:c0 + 7 * nc].reshape(nc, 7).tolist() == [
        [slot, c.link, c.contact_type, *rows] for slot, c, rows in
        zip(plan.contact_slots, cfg.contacts, tc.contact_rows(plan))]
    assert sum(r[1] for r in tc.contact_rows(plan)) == plan.cdof
    assert sum(r[3] for r in tc.contact_rows(plan)) == plan.k_rows
    tc.TickKernels(TickProgram(pm, cfg, "cpu", torch.float64, masked=variant == "hands_masked"))


@pytest.mark.parametrize("variant", ["no_contacts", "five_contacts", "five_levels",
                                     "beyond_shared_fit"])
def test_kernel_table_refuses_other_configs(models, variant):
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan, TickProgram

    _, pm, _ = models
    cfg = standard_tocabi_config(pm)
    if variant == "no_contacts":
        cfg = dataclasses.replace(cfg, contacts=())
    elif variant == "five_contacts":
        cfg = entry._hands_feet_config(pm)
        cfg = dataclasses.replace(cfg, contacts=cfg.contacts + (
            dataclasses.replace(cfg.contacts[2], link=27),))
    elif variant == "five_levels":
        cfg = dataclasses.replace(cfg, task_specs=cfg.task_specs + (
            ((T.TASK_LINK_ROTATION, 31),), ((T.TASK_LINK_ROTATION, 23),),
            ((T.TASK_LINK_POSITION, 27),)))
    elif variant == "beyond_shared_fit":
        cfg = dataclasses.replace(cfg, task_specs=(
            tuple((T.TASK_LINK_6D, link) for link in (0, 15, 31, 23)),))
    plan = TickPlan(pm, cfg)
    assert tc.kernel_unsupported(plan)
    with pytest.raises(NotImplementedError):
        tc.kernel_table(plan)
    with pytest.raises(NotImplementedError):
        tc.TickKernels(TickProgram(pm, cfg, "cpu", torch.float64))


def test_results_and_warm_state_round_trip_as_numpy():
    """A tick's result fields and warm state as numpy, and the warm state
    back in as tensors of another dtype."""
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.convert import result_to_numpy, warm_from_numpy, warm_to_numpy

    model, tick = entry._model_and_tick("cpu", torch.float64, backend="torch")
    q, qd, fs = entry._example_inputs(model, np.float64)
    res, warm = tick._tick_impl(q, qd, fs, warm=tick.init_warm())
    out = result_to_numpy(res)
    assert list(out) == list(res._fields)
    assert all(isinstance(v, np.ndarray) for v in out.values())
    assert np.array_equal(out["torque_cmd"], res.torque_cmd.numpy())
    back = warm_from_numpy(warm_to_numpy(warm), "cpu", torch.float32)
    for (x, lam), (bx, blam) in zip(warm, back):
        assert bx.dtype == torch.float32 and torch.equal(bx, x.float())
        assert torch.equal(blam, lam.float())
