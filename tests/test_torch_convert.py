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
    assert list(hdr[tc.H_LEV_T:tc.H_LEV_T + 2]) == [6, 3]
    nb, nd, npts, nc = 34, 39, 4, 2
    want = (tc.HDR + 2 * nb + nd + 3 * nb + 9 * nb + 3 * nb + 3 * nb + 9 * nb + nb
            + nb * nd + 3 + npts + 3 * npts + 2 * nc + 60 * nc
            + 2 * tc.NLEV_MAX + 33)
    assert tab.shape == (want,)
    assert np.array_equal(tab.astype(np.float32).astype(np.float64)[:tc.HDR], hdr)
    # spec slots and modes: the pelvis 6D task, then the link-15 rotation task
    assert tab[-33 - 4:-33].tolist() == [plan.task_slots[0][0][1], plan.task_slots[1][0][1],
                                         tc.SPEC_6D, tc.SPEC_ROT]
    assert tab[-33:].tolist() == [300.0] * 33


@pytest.mark.parametrize("variant", ["single_foot", "point_contact", "four_contacts",
                                     "three_levels", "position_task"])
def test_kernel_table_refuses_other_configs(models, variant):
    from libdwbc_tpu_torch.ops import tick_cuda as tc
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan, TickProgram

    _, pm, _ = models
    cfg = standard_tocabi_config(pm, both_feet=variant != "single_foot")
    if variant == "point_contact":
        cfg = dataclasses.replace(cfg, contacts=(
            dataclasses.replace(cfg.contacts[0], contact_type=T.CONTACT_POINT),)
            + cfg.contacts[1:])
    elif variant == "four_contacts":
        cfg = dataclasses.replace(cfg, contacts=cfg.contacts + tuple(
            dataclasses.replace(cfg.contacts[0], link=link) for link in (23, 31)))
    elif variant == "three_levels":
        cfg = standard_tocabi_config(pm, swing_task=True)
    elif variant == "position_task":
        cfg = dataclasses.replace(cfg, task_specs=(
            cfg.task_specs[0], ((T.TASK_LINK_POSITION, 15),)))
    plan = TickPlan(pm, cfg)
    assert tc.kernel_unsupported(plan)
    with pytest.raises(NotImplementedError):
        tc.kernel_table(plan)
    with pytest.raises(NotImplementedError):
        tc.TickKernels(TickProgram(pm, cfg, "cpu", torch.float64))
