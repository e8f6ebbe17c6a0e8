"""The frozen work counts equal the port's own at the commit they were
copied from (PERF.md §6: the flagship 316,336 + 414,704 operations a solve
at a warm tick of 7 IPM iterations, the hands plan 459,803 + 899,777), and
the traffic recipes and configurations equal the port's entry points."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from wbcbench import recipes, work
from wbcbench.harness import ROOT
from wbcbench.reference import plan_of

CONFIGS = ROOT / "wbcbench" / "configs"
TRAFFIC = ROOT / "wbcbench" / "traffic"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name, want", [
    ("tocabi_stand", (316336, 414704)),
    ("tocabi_hands_feet", (459803, 899777)),
    ("tocabi_contact_sweep", (317842, 415246)),
])
def test_tick_flops_frozen(name, want):
    assert work.tick_flops(plan_of(config(name)), 7) == want


def test_work_equals_the_ports_count():
    import chip_smoke
    from libdwbc_tpu_torch.entry import _hands_feet_config
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.ops.tick_kernel import TickPlan
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config

    m = RobotModel.load(str(ROOT / "models" / "tocabi.npz"))
    for name, cfg, masked in (("tocabi_stand", standard_tocabi_config(m), False),
                              ("tocabi_hands_feet", _hands_feet_config(m), False),
                              ("tocabi_contact_sweep", standard_tocabi_config(m), True)):
        for iters in (7, 12, 25):
            assert work.tick_flops(plan_of(config(name)), iters) == chip_smoke.tick_flops(
                TickPlan(m, cfg, masked=masked), iters)


def test_least_time_is_operations_bound():
    plan = plan_of(config("tocabi_stand"))
    t, by = work.least_seconds(plan, {7: 1024})
    assert by == "operations"
    assert t == pytest.approx((316336 + 414704) * 1024 / 67e12)
    assert work.tick_bytes(plan) * 1024 / 3.35e12 < t


def test_configs_equal_the_ports():
    from libdwbc_tpu_torch.entry import _hands_feet_config
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc.pipeline import standard_tocabi_config
    from wbcbench.program import build_tick

    m = RobotModel.load(str(ROOT / "models" / "tocabi.npz"))
    for name, want in (("tocabi_stand", standard_tocabi_config(m, qp_iters=12)),
                       ("tocabi_contact_sweep", standard_tocabi_config(m, qp_iters=12)),
                       ("tocabi_hands_feet", _hands_feet_config(m))):
        got = build_tick(config(name), "cpu", backend="torch").cfg
        assert got.task_specs == want.task_specs and got.qp_iters == want.qp_iters
        np.testing.assert_array_equal(got.torque_limit, want.torque_limit)
        assert len(got.contacts) == len(want.contacts)
        for a, b in zip(got.contacts, want.contacts):
            for f in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_recipes_equal_the_ports_inputs():
    from libdwbc_tpu_torch import entry
    from libdwbc_tpu_torch.model.compile import RobotModel

    m = RobotModel.load(str(ROOT / "models" / "tocabi.npz"))
    q, _, fs = entry._example_inputs(m, np.float64)
    for mix in ("rollouts_b1024", "lane_closed"):
        t = json.loads((TRAFFIC / f"{mix}.json").read_text())
        q0, fs0 = recipes.standing(t, m.nq, m.ndof)
        np.testing.assert_array_equal(q0, q)
        for a, b in zip(fs0, fs):
            np.testing.assert_array_equal(a, b)
    t = json.loads((TRAFFIC / "sweep_mesh64.json").read_text())
    qs, _, fss, masks = entry._masked_inputs(m, B=6, seed=0)
    q0, fs0 = recipes.standing(t, m.nq, m.ndof)
    noise = 0.02 * np.random.default_rng(0).standard_normal((6, m.model_dof)).astype(np.float32)
    base = qs.copy()
    base[:, 6:39] -= noise
    np.testing.assert_allclose(base, np.tile(q0, (6, 1)), rtol=0, atol=1e-6)
    for a, b in zip(fs0, fss):
        np.testing.assert_array_equal(a.astype(np.float32), b[0])
    got = recipes.hypothesis_masks(t, np.arange(6), 1, "cpu")[:, 0].numpy()
    np.testing.assert_array_equal(got, masks)
    lane = json.loads((TRAFFIC / "lane_closed.json").read_text())
    want = entry._rt_state(m, period_us=1000)
    state_at = recipes.rt_state(lane, m.nq, m.ndof, phase=7)
    for t_ in (0, 5, 1999):
        np.testing.assert_allclose(state_at(t_)[:-1], want(t_ + 7)[:-1], rtol=0, atol=1e-15)


def test_draws_repeat_by_seed():
    t = json.loads((TRAFFIC / "rollouts_b1024.json").read_text())
    q0, fs0 = recipes.standing(t, 40, 39)

    def draw(seed):
        return recipes.draw_batch(t, q0, fs0, (4,), recipes.generator("cpu", seed), "cpu")

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2][0], b[2][0])
    assert not torch.equal(a[0], c[0])
