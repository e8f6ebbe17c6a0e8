"""Wrappers of the two CUDA kernels of the WBC tick (``csrc/``).

``TickKernels`` launches ``tick_prestage`` and ``tick_qpchain`` for one
configuration.  Its methods take and return what the plain
``TickProgram`` does (element-leading tensors, batch last), and follow one
rule: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises (dtype other than float32, a wrong shape,
device or layout, a failed build, a refused launch).  Nothing falls back.

A servo'd tick is still these two launches: ``tick_prestage`` also takes
q̇, the caller's f* and the servo buffer (``pack_servos``), and writes the
servo'd f* into a section of its output, from which ``tick_qpchain`` reads
them.  A packed prestage (``PackedPre``) carries whether it has that
section; its layout, its packing and the f* the QP chain reads follow from
that one flag.

Each wrapper adds one to ``launches[name]`` where it launches its kernel.
Outputs and workspace are allocated here with ``torch.empty``; the kernels
run on the current stream, allocate nothing and do not synchronise.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import _build
from .tick_kernel import _CROW_MASK, _POS, _ROW_MASK, _SIX, SERVO_ELEM_SHAPES

# ---- packed kernel table: header slots and caps (csrc/tick_common.cuh)
HDR = 32
H_NBODY, H_NDOF, H_MDOF, H_NPTS, H_NC, H_CDOF, H_CFREE, H_KROWS, H_NLEV, H_NQ = range(10)
H_MASKED = 10           # 1: the padded candidate layout with a contact mask
H_NTASK = 11            # tasks in all levels
H_TOT = 12              # 1: a task on the whole-body COM
H_MASS = 13             # the model's total mass
H_LIM = 14              # 1: a torque limit (the QPs' mirrored ±τ rows)
H_LEV_T = 16            # NLEV_MAX slots: task dofs per level
NLEV_MAX = 4
NTASK_MAX = 16          # the servo's task mask is an int
NC_MAX = 4              # contacts (masked mode: candidates)
TASK_TOT = -1           # a task's point slot for the whole-body COM
CROWS = 10              # constraint rows of a 6D contact: a block's slot is CROWS × 6
# shared floats per scenario of tick_prestage (csrc/tick_prestage.cu::
# kPreSmemMax; up to 7,232 it runs two blocks per SM, beyond that one)
PRE_SMEM_MAX = 14464
# shared floats per scenario of tick_qpchain: four scenarios in a block's
# 227 KB (csrc/tick_qpchain.cu)
QP_SMEM_MAX = 227 * 1024 // (4 * 4)

# Max abs error of the kernels against their plain versions on the serving
# inputs of chip_smoke.py (batch 1024, seed 0), about ten times what an H100
# showed (outputs that showed 0 or ~1e-9 get 1e-6).  PRE_TOL: tick_prestage
# vs the plain prestage in float64.  QP_TOL: tick_qpchain vs the plain
# qpchain in float32, same prestage input.
PRE_TOL = {"torque_grav": 2e-2, "P_C": 5e-3, "Jbar_act": 5e-4, "NwJw": 5e-5,
           "Ntorques": 8e-2, "Atemp": 2e-4, "bA0": 5e-3, "health": 3e-6}
QP_TOL = {"torque_grav": 1e-6, "torque_task": 2e-5, "torque_contact": 1e-6,
          "torque_cmd": 4e-5, "contact_force": 2e-3, "health": 1e-6}
# The same limits of the masked kernels, per support hypothesis, on the
# masked sweep's inputs (chip_smoke.py: its first 1024 lanes, seed 0), about
# ten times what an H100 showed.  A single-support lane's float32 prestage
# is itself ~1e-2 Nm from float64 in τ_grav, so that limit stops at
# bench.py's 0.05 Nm truth guard.
PRE_TOL_MASKED = {"torque_grav": 5e-2, "P_C": 1e-2, "Jbar_act": 5e-4, "NwJw": 5e-5,
                  "Ntorques": 1e-1, "Atemp": 2e-4, "bA0": 6e-3, "health": 3e-6}
QP_TOL_MASKED = {"torque_grav": 1e-6, "torque_task": 4e-4, "torque_contact": 1e-6,
                 "torque_cmd": 5e-4, "contact_force": 4e-3, "health": 1e-6}

# The servo'd prestage's extra outputs against the plain float64 prestage
# and _apply_servos_el, on the servo'd inputs of chip_smoke.py
# (entry._servo_inputs, batch 1024, seed 0; masked: per hypothesis): the
# servo'd f* and the task-link states, about ten times what an H100 showed
# (5.8e-5, 2.8e-9, 7.3e-9, 1.05e-7, 1.5e-8; plain float32's own alike).
SERVO_TOL = {"fstars": 6e-4, "task_pos": 3e-8, "task_vel": 8e-8, "task_rot": 1.1e-6,
             "task_w": 2e-7}

# Servo'd QP chains sit on active constraints, where float32 itself is far
# from float64 (chip_smoke.py phase 12 prints each lane's distance) and two
# float32 solves of the same recurrence part by roundoff on a few lanes
# (phase 12 also prints on how many the plain float32 QP chain parts from
# itself when its inputs move by one ulp).  A servo'd comparison therefore
# holds each lane to the larger of the flagship's limit and SERVO_OWN times
# that lane's float32 distance from float64, and lets at most
# SERVO_LANES_OVER of the lanes exceed it.
SERVO_OWN, SERVO_LANES_OVER = 4.0, 0.1

# The general-plan kernels against their plain versions on chip_smoke.py
# phases 17 and 20's inputs (batch 1024, seed 0): BASELINE's config 3 on
# entry._swing_inputs; the mixed task set (entry._mixed_tasks_config) on the two
# 6D feet, static on phase 3's states and masked on the masked sweep's first
# 1024 lanes, per hypothesis (both feet, left, right), f* 0.05·N(0,1).  Each
# limit is four times the plain float32 tick's own error against float64 on
# the same inputs, rounded up (zero where that is exactly zero: τ_contact
# with one contact, NwJw of a single-support lane).  "pre": tick_prestage
# vs the plain float64 prestage; "qp": tick_qpchain vs the plain float32
# qpchain on the float64 prestage cast to float32, cold at 12 iterations
# and warm at 7 (in masked single support these QPs, without the float32
# ridge of the task-space inverses, leave plain float32 itself 311-626 Nm
# from float64, so that limit bounds nothing there); "qp32": the same on
# the plain float32 prestage; "chain": the two kernels chained vs the
# plain float64 tick.
GENERAL_TOL = {
    "config 3": dict(
        pre={"torque_grav": (0.036,), "P_C": (0.0049,), "Jbar_act": (0.00023,),
             "Ntorques": (0.079,), "Atemp": (9.1e-05,), "bA0": (0.0026,), "health": (1.2e-06,)},
        qp={"cold.torque_task": (0.022,), "cold.torque_contact": (0.0,),
            "cold.torque_cmd": (0.022,), "cold.contact_force": (0.032,),
            "warm.torque_task": (0.00016,), "warm.torque_contact": (0.0,),
            "warm.torque_cmd": (0.00016,), "warm.contact_force": (0.00071,)},
        qp32={"cold.torque_task": (0.022,), "cold.torque_contact": (0.0,),
              "cold.torque_cmd": (0.022,), "cold.contact_force": (0.032,),
              "warm.torque_task": (0.00016,), "warm.torque_contact": (0.0,),
              "warm.torque_cmd": (0.00016,), "warm.contact_force": (0.00076,)},
        chain={"torque_task": (0.043,), "torque_cmd": (0.028,), "contact_force": (0.041,)},
    ),
    "mixed": dict(
        pre={"torque_grav": (0.005,), "P_C": (0.0021,), "Jbar_act": (0.0002,),
             "NwJw": (1.5e-05,), "Ntorques": (0.092,), "Atemp": (9.1e-05,), "bA0": (0.0019,),
             "health": (1.2e-06,)},
        qp={"cold.torque_task": (3.7e-06,), "cold.torque_contact": (6.1e-09,),
            "cold.torque_cmd": (8.9e-06,), "cold.contact_force": (0.00028,),
            "warm.torque_task": (3.7e-06,), "warm.torque_contact": (7.9e-09,),
            "warm.torque_cmd": (8.9e-06,), "warm.contact_force": (0.00028,)},
        qp32={"cold.torque_task": (4.3e-06,), "cold.torque_contact": (5.2e-09,),
              "cold.torque_cmd": (8.6e-06,), "cold.contact_force": (0.00031,),
              "warm.torque_task": (4.3e-06,), "warm.torque_contact": (8.5e-09,),
              "warm.torque_cmd": (8.6e-06,), "warm.contact_force": (0.00031,)},
        chain={"torque_task": (0.021,), "torque_cmd": (0.021,), "contact_force": (0.065,)},
    ),
    "mixed masked": dict(
        pre={"torque_grav": (0.0045, 0.034, 0.039), "P_C": (0.0016, 0.0053, 0.0047),
             "Jbar_act": (0.00019, 0.00021, 0.00023), "NwJw": (1.3e-05, 0.0, 0.0),
             "Ntorques": (0.096, 0.058, 0.059), "Atemp": (9.3e-05, 8.2e-05, 0.00011),
             "bA0": (0.0016, 0.0026, 0.0025), "health": (1.2e-06, 1.3e-06, 1.1e-06)},
        qp={"cold.torque_task": (2.6e-06, 1300.0, 1300.0),
            "cold.torque_contact": (5.2e-09, 0.0, 0.0),
            "cold.torque_cmd": (8.6e-06, 1300.0, 1300.0),
            "cold.contact_force": (0.00028, 0.00086, 0.11),
            "warm.torque_task": (2.6e-06, 2600.0, 2500.0),
            "warm.torque_contact": (7.1e-09, 0.0, 0.0),
            "warm.torque_cmd": (8.6e-06, 2600.0, 2500.0),
            "warm.contact_force": (0.00028, 0.0011, 0.0011)},
        qp32={"cold.torque_task": (3e-06, 0.022, 0.091),
              "cold.torque_contact": (4.6e-09, 0.0, 0.0),
              "cold.torque_cmd": (9.1e-06, 0.022, 0.091),
              "cold.contact_force": (0.00033, 0.0008, 0.11),
              "warm.torque_task": (3e-06, 3.5, 3.8), "warm.torque_contact": (7.7e-09, 0.0, 0.0),
              "warm.torque_cmd": (9.1e-06, 3.5, 3.8),
              "warm.contact_force": (0.00033, 0.021, 0.025)},
        chain={"torque_task": (0.017, 0.9, 1.1), "torque_cmd": (0.017, 0.9, 1.1),
               "contact_force": (0.058, 0.024, 0.12)},
    ),
    # phase 20: the hands-and-feet fixture (entry._hands_feet_config) static
    # on entry._hands_feet_inputs and masked on the first 1024 lanes of
    # entry._hands_masked_inputs, per hypothesis (feet, + left hand, + right
    # hand, + both); LINE feet on the same states; the flagship without a
    # torque limit on phase 3's states.  Where NwJw's basis follows roundoff
    # (more than two contacts, or a POINT or LINE one) "NwJw" holds
    # J̄ᵀ[rows]·NwJw (nwjw_determined); with more than two
    # contacts "chain" holds τ_task only (τ_cmd and the contact force sit on
    # the contact block's flat face, plain float32 up to 69 Nm from float64).
    "hands": dict(
        pre={"torque_grav": (0.0014,), "P_C": (0.0021,), "Jbar_act": (0.0002,),
             "NwJw": (1.9e-05,), "Ntorques": (0.022,), "Atemp": (9.5e-05,), "bA0": (0.0018,),
             "health": (1.2e-06,)},
        qp={"cold.torque_task": (0.16,), "cold.torque_contact": (2.3,),
            "cold.torque_cmd": (2.4,), "cold.contact_force": (2.5,),
            "warm.torque_task": (0.16,), "warm.torque_contact": (110.0,),
            "warm.torque_cmd": (110.0,), "warm.contact_force": (140.0,)},
        qp32={"cold.torque_task": (0.16,), "cold.torque_contact": (2.4,),
              "cold.torque_cmd": (2.5,), "cold.contact_force": (2.6,),
              "warm.torque_task": (0.16,), "warm.torque_contact": (94.0,),
              "warm.torque_cmd": (94.0,), "warm.contact_force": (140.0,)},
        chain={"torque_task": (0.16,)},
    ),
    "hands masked": dict(
        pre={"torque_grav": (0.0041, 0.0041, 0.0011, 0.0015),
             "P_C": (0.0016, 0.0021, 0.0014, 0.0016),
             "Jbar_act": (0.00018, 0.00019, 0.0002, 0.00019),
             "NwJw": (3.6e-06, 6e-06, 6.8e-06, 1.6e-05),
             "Ntorques": (0.03, 0.025, 0.026, 0.022),
             "Atemp": (8.3e-05, 8.2e-05, 8.4e-05, 9e-05),
             "bA0": (0.0017, 0.0019, 0.0013, 0.0017),
             "health": (1.2e-06, 1.2e-06, 1.2e-06, 1.1e-06)},
        qp={"cold.torque_task": (6.2e-06, 0.048, 0.027, 0.16),
            "cold.torque_contact": (8.2e-09, 7.2, 2.3, 1.6),
            "cold.torque_cmd": (1.1e-05, 7.2, 2.3, 1.7),
            "cold.contact_force": (0.00034, 11.0, 2.3, 1.9),
            "warm.torque_task": (6.2e-06, 0.048, 0.027, 0.16),
            "warm.torque_contact": (1.6e-08, 79.0, 120.0, 110.0),
            "warm.torque_cmd": (1.1e-05, 79.0, 120.0, 110.0),
            "warm.contact_force": (0.00034, 84.0, 130.0, 120.0)},
        qp32={"cold.torque_task": (4.7e-06, 0.048, 0.027, 0.16),
              "cold.torque_contact": (7.2e-09, 7.2, 2.3, 1.7),
              "cold.torque_cmd": (9e-06, 7.2, 2.3, 1.6),
              "cold.contact_force": (0.00044, 11.0, 2.3, 1.8),
              "warm.torque_task": (4.7e-06, 0.048, 0.027, 0.16),
              "warm.torque_contact": (9.5e-09, 79.0, 92.0, 71.0),
              "warm.torque_cmd": (9e-06, 79.0, 92.0, 71.0),
              "warm.contact_force": (0.00044, 83.0, 110.0, 75.0)},
        chain={"torque_task": (0.0093, 0.047, 0.027, 0.16)},
    ),
    "line feet": dict(
        pre={"torque_grav": (0.014,), "P_C": (0.0018,), "Jbar_act": (0.0002,),
             "NwJw": (0.0018,), "Ntorques": (0.041,), "Atemp": (8.9e-05,), "bA0": (0.002,),
             "health": (5.2e-06,)},
        qp={"cold.torque_task": (0.36,), "cold.torque_contact": (2.6,),
            "cold.torque_cmd": (2.6,), "cold.contact_force": (3.4,),
            "warm.torque_task": (0.36,), "warm.torque_contact": (1.1,),
            "warm.torque_cmd": (1.3,), "warm.contact_force": (3.7,)},
        qp32={"cold.torque_task": (0.36,), "cold.torque_contact": (2.6,),
              "cold.torque_cmd": (2.6,), "cold.contact_force": (3.4,),
              "warm.torque_task": (0.36,), "warm.torque_contact": (1.1,),
              "warm.torque_cmd": (1.3,), "warm.contact_force": (3.7,)},
        chain={"torque_task": (0.38,), "torque_cmd": (2.7,), "contact_force": (3.6,)},
    ),
    "no limit": dict(
        pre={"torque_grav": (0.005,), "P_C": (0.0021,), "Jbar_act": (0.0002,),
             "NwJw": (1.5e-05,), "Ntorques": (0.03,), "Atemp": (9.1e-05,), "bA0": (0.0019,),
             "health": (1.2e-06,)},
        qp={"cold.torque_task": (6.2e-06,), "cold.torque_contact": (4.8e-07,),
            "cold.torque_cmd": (1.1e-05,), "cold.contact_force": (0.00047,),
            "warm.torque_task": (6.2e-06,), "warm.torque_contact": (6.5e-09,),
            "warm.torque_cmd": (1.1e-05,), "warm.contact_force": (0.00047,)},
        qp32={"cold.torque_task": (6.4e-06,), "cold.torque_contact": (5.1e-07,),
              "cold.torque_cmd": (1.1e-05,), "cold.contact_force": (0.00042,),
              "warm.torque_task": (6.4e-06,), "warm.torque_contact": (7.9e-09,),
              "warm.torque_cmd": (1.1e-05,), "warm.contact_force": (0.00042,)},
        chain={"torque_task": (0.011,), "torque_cmd": (0.011,), "contact_force": (0.067,)},
    ),
}

# the ServoParams fields in the order of the servo buffer (csrc/servo.cuh::ServoIn)
SERVO_FIELDS = tuple(sorted(SERVO_ELEM_SHAPES))
SERVO_ELEMS = sum(math.prod(SERVO_ELEM_SHAPES[f]) for f in SERVO_FIELDS)
TASK_STATE = (("task_pos", (3,)), ("task_vel", (3,)), ("task_rot", (3, 3)), ("task_w", (3,)))


def tasks(plan):
    """(level, spec index, point slot or TASK_TOT, first jacobian row, rows)
    of every task, levels in order: the kernel's task list."""
    out = []
    for h, lv in enumerate(plan.task_slots):
        for j, (kind, slot, mode) in enumerate(lv):
            r0, nr = (0, 6) if mode in _SIX else (0, 3) if mode in _POS else (3, 3)
            out.append((h, j, TASK_TOT if kind == "tot" else slot, r0, nr))
    return out


def prestage_x_fit(plan):
    """(floats, nd²) of the prestage's X buffer (csrc/tick_prestage.cu::
    prestage_x_elems): after A⁻¹ is formed it holds the small inverses' L
    and X (order max(cdof, 6, largest level)) and J_C, then J_C·A⁻¹
    (contact space) or a level's Jt, JtA and JAN (the JKT loop); the buffer
    is the larger of the two."""
    nd, cd = plan.ndof, plan.cdof
    tmax = max(plan.level_tdofs, default=0)
    ls = max(cd, 6, tmax)
    return 2 * ls * ls + cd * nd + max(cd * nd, 3 * tmax * nd), nd * nd


def prestage_smem(plan):
    """Shared floats per scenario of tick_prestage (csrc/tick_prestage.cu::
    PreWS::smem): A, X's buffer, the FK frames, then the largest of the
    CRBA's overlay, the servo's and the contact space's and JKT loop's."""
    nb, nd, md, cd, cf = plan.nbody, plan.ndof, plan.mdof, plan.cdof, plan.cfree
    tm = max(plan.level_tdofs, default=0)
    base = nd * nd + max(prestage_x_fit(plan)) + nd + 15 * nb
    crba = 3 * nb + 6 * nd + 36 * nb + 6 * nd
    servo = 6 * nb
    main = (md * md + md + 6 * cd + cd * cd + 2 * cd * cf + md * cf + 4 * cf * cf + cf + cd + md
            + cf * tm + 2 * cd * cd + 36 + 3 * tm * tm + tm * md + 4 * md * tm + tm * cd)
    return base + max(crba, servo, main)


def kernel_unsupported(plan) -> str | None:
    """Why the CUDA kernels cannot run this plan, or None if they can: they
    take one to NC_MAX contacts of any type (6D, POINT, LINE; masked mode:
    candidates), with or without a torque limit, at most NLEV_MAX levels of
    6D, position or rotation tasks on a point or on the whole-body COM,
    NTASK_MAX tasks in all, and a plan whose prestage fits its shared part
    (PRE_SMEM_MAX floats per scenario).  The library also refuses a model
    whose QP chain would not fit its shared memory (``TickKernels``)."""
    cfg = plan.cfg
    if not 1 <= len(cfg.contacts) <= NC_MAX:
        return (f"the CUDA tick takes one to {NC_MAX} contacts, the plan has "
                f"{len(cfg.contacts)}")
    if len(plan.task_slots) > NLEV_MAX:
        return f"the CUDA tick takes at most {NLEV_MAX} task levels"
    if len(tasks(plan)) > NTASK_MAX:
        return f"the CUDA tick takes at most {NTASK_MAX} tasks"
    need = prestage_smem(plan)
    if need > PRE_SMEM_MAX:
        return (f"the plan's prestage ({len(cfg.contacts)} contacts, a largest level of "
                f"{max(plan.level_tdofs)} task rows) does not fit tick_prestage's shared "
                f"memory: {need} floats per scenario for {PRE_SMEM_MAX}")
    return None


def contact_rows(plan):
    """(first J_C row, J_C rows, first constraint row, constraint rows) of
    each contact, in order: the kernel's contact section."""
    out, j0, k0 = [], 0, 0
    for c, blk in zip(plan.cfg.contacts, plan.const_blocks):
        dof = 6 if plan.masked else c.contact_dof
        out.append((j0, dof, k0, blk.shape[0]))
        j0, k0 = j0 + dof, k0 + blk.shape[0]
    return out


def kernel_table(plan) -> np.ndarray:
    """The packed table of the CUDA kernels, in float64 (integers stored as
    exact floats; the kernels read it as float32); section order as in
    csrc/tick_common.cuh."""
    why = kernel_unsupported(plan)
    if why is not None:
        raise NotImplementedError(why)
    m = plan.model
    task_list = tasks(plan)
    hdr = np.zeros(HDR)
    hdr[[H_NBODY, H_NDOF, H_MDOF, H_NPTS, H_NC, H_CDOF, H_CFREE, H_KROWS,
         H_NLEV, H_NQ]] = [plan.nbody, plan.ndof, plan.mdof, len(plan.points),
                           len(plan.cfg.contacts), plan.cdof, plan.cfree,
                           plan.k_rows, len(plan.task_slots), plan.nq]
    hdr[H_MASKED] = float(plan.masked)
    hdr[H_NTASK] = len(task_list)
    hdr[H_TOT] = float(plan.uses_tot)
    hdr[H_MASS] = float(m.total_mass)
    hdr[H_LIM] = float(plan.tlim is not None)
    hdr[H_LEV_T:H_LEV_T + len(plan.level_tdofs)] = plan.level_tdofs
    cs = plan.cfg.contacts
    blocks = np.zeros((len(cs), CROWS, 6))
    for k, b in enumerate(plan.const_blocks):
        blocks[k, :b.shape[0], :b.shape[1]] = b
    sections = [
        hdr,
        plan.parent, plan.q_index, plan.owner,
        m.axis, m.X_T_rot, m.X_T_trans, m.com, m.inertia, m.mass,
        m.ancestor_mask, m.gravity,
        [link for link, _ in plan.points], [pt for _, pt in plan.points],
        [(slot, c.link, c.contact_type) + rows
         for slot, c, rows in zip(plan.contact_slots, cs, contact_rows(plan))],
        [_ROW_MASK[c.contact_type] for c in cs], [_CROW_MASK[c.contact_type] for c in cs],
        blocks,
        [(h, slot, r0, nr) for h, _, slot, r0, nr in task_list],
        [] if plan.tlim is None else plan.tlim,
    ]
    return np.concatenate([np.asarray(s, np.float64).ravel() for s in sections])


def pre_layout(plan, servo=False):
    """(name, elem shape) of the prestage buffer, in kernel order
    (csrc/tick_common.cuh::Pre); servo: with the servo section (the f* of
    every level, then every task's point state, "task_pos.h.j" for spec j
    of level h)."""
    lay = [("torque_grav", (plan.mdof,)), ("P_C", (plan.cdof,)),
           ("Jbar_act", (plan.cdof, plan.mdof)), ("NwJw", (plan.mdof, plan.cfree))]
    lay += [(f"Ntorques.{h}", (plan.mdof, t)) for h, t in enumerate(plan.level_tdofs)]
    lay += [("Atemp", (plan.k_rows, plan.mdof)), ("bA0", (plan.k_rows,)), ("health", ())]
    if plan.masked:
        lay += [("crow_mask", (plan.k_rows,)), ("active_cdof", ())]
    if servo:
        lay += [(f"fstars.{h}", (t,)) for h, t in enumerate(plan.level_tdofs)]
        lay += [(f"{name}.{h}.{j}", shape) for h, j, *_ in tasks(plan)
                for name, shape in TASK_STATE]
    return lay


def out_layout(plan):
    """(name, elem shape) of the result buffer (csrc/tick_common.cuh::Out)."""
    return [("torque_grav", (plan.mdof,)), ("torque_task", (plan.mdof,)),
            ("torque_contact", (plan.mdof,)), ("torque_cmd", (plan.mdof,)),
            ("contact_force", (plan.cdof,)), ("qp_gap", ()),
            ("qp_primal_res", ()), ("health", ())]


def warm_layout(plan):
    """(x, λ) per QP (csrc/tick_common.cuh::warm_elems)."""
    return [(f"{k}.{h}", (dim,)) for h, (nv, m) in enumerate(plan.qp_dims)
            for k, dim in (("x", nv), ("lam", m))]


def _elems(layout):
    return sum(math.prod(shape) for _, shape in layout)


def lane_err(a, b):
    """Max abs difference of two (elem..., lanes) tensors, per lane (float64,
    on the CPU)."""
    d = a.detach().double().cpu() - b.detach().double().cpu()
    return d.abs().reshape(-1, d.shape[-1]).amax(0)


def servo_lanes_over(err, own, tol):
    """(lanes whose err exceeds max(tol, SERVO_OWN·own), lanes allowed to):
    err and own per lane."""
    over = int((err > torch.clamp_min(SERVO_OWN * own, tol)).sum())
    return over, int(SERVO_LANES_OVER * err.numel())


def nwjw_determined(pre, plan, cm):
    """J̄ᵀ's first (active contact dof − 6) active rows times NwJw, per lane
    (cfree, cfree, B): M·M⁺ of NwJw's inner system M (a prestage dict's
    "Jbar_act" and "NwJw"; cm: a masked plan's contact mask (nc, B), else
    None).  With more than two contacts, or a POINT or LINE one, M can be
    singular or the kernel space's completion can pick between tied
    residuals, and then NwJw itself follows roundoff (float32 and float64
    alike, the plain version and the kernels alike); this product does
    not."""
    jb, nw = pre["Jbar_act"], pre["NwJw"]
    if cm is None:
        return torch.einsum("ikb,kjb->ijb", jb[:plan.cfree], nw)
    rm = (torch.repeat_interleave(cm.to(jb), 6, 0)
          * torch.as_tensor(plan.row_mask, dtype=jb.dtype, device=jb.device)[:, None])
    idx = torch.cumsum(rm, 0) - 1.0
    t = torch.arange(plan.cfree, dtype=jb.dtype, device=jb.device)[:, None, None]
    sel = rm[None] * ((idx[None] - t).abs() < 0.5) * (t < rm.sum(0) - 6.0)
    return torch.einsum("tib,ikb,kjb->tjb", sel, jb, nw)


class PackedPre(NamedTuple):
    """A prestage buffer (elements, B) and whether it carries the servo
    section (every level's f* and task-link state), from which
    tick_qpchain then reads its f*."""
    buf: torch.Tensor
    servo: bool


def servo_mask(servos, plan):
    """The kernel's task mask of a servo request (bit k: task k of
    ``tasks(plan)`` servo'd), or raise where the kernel cannot take it."""
    if servos is None:
        return 0
    if len(servos) > len(plan.task_slots):
        raise ValueError(f"servos for {len(servos)} levels, the tick has "
                         f"{len(plan.task_slots)}")
    for h, lvl in enumerate(servos):
        if lvl is not None and len(lvl) != len(plan.task_slots[h]):
            raise ValueError(f"level {h}: {len(lvl)} servo entries for "
                             f"{len(plan.task_slots[h])} task specs")
    mask = 0
    for k, (h, j, *_) in enumerate(tasks(plan)):
        if h < len(servos) and servos[h] is not None and servos[h][j] is not None:
            mask |= 1 << k
    return mask


def pack_servos(servos, plan, B):
    """The servo buffer (SERVO_ELEMS per servo'd task, B): each servo'd
    task's fields (element-leading dicts, (elem...)+(B,)) in SERVO_FIELDS
    order, tasks in order.  Values pass as they are: a +inf clamp stays
    +inf."""
    parts, mask = [], servo_mask(servos, plan)
    for k, (h, j, *_) in enumerate(tasks(plan)):
        if (mask >> k) & 1:
            d = servos[h][j]
            for f in SERVO_FIELDS:
                t = d[f]
                want = SERVO_ELEM_SHAPES[f] + (B,)
                if tuple(t.shape) != want:
                    raise ValueError(f"servo level {h} spec {j} {f}: shape {tuple(t.shape)}, "
                                     f"expected {want}")
                parts.append(t.reshape(-1, B))
    return torch.cat(parts, 0).contiguous()


def _unpack(buf, layout):
    out, off, B = {}, 0, buf.shape[1]
    for name, shape in layout:
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape + (B,))
        off += n
    return out


class TickKernels(nn.Module):
    """The CUDA tick of one configuration; ``prog`` is its plain version.
    The packed float32 model/config table is the buffer ``table``, on the
    device of ``prog``'s tables."""

    def __init__(self, prog):
        super().__init__()
        self.prog = prog
        self.plan = prog.plan
        self._table_host = kernel_table(self.plan).astype(np.float32)
        self.register_buffer("table", torch.as_tensor(
            self._table_host, device=prog.axis.device), persistent=False)
        self.launches = {"tick_prestage": 0, "tick_qpchain": 0}
        self._sizes = None

    # ----------------------------------------------------------- checks
    def _lib_and_sizes(self):
        """Load the library (building it on first use) and check that the
        kernels' buffer layouts are the ones this module unpacks."""
        lib = _build.library()
        if self._sizes is None:
            host = self._table_host.ctypes.data_as(ctypes.c_void_p)
            sizes = dict(pre=lib.dwbc_pre_elems(host, 0),
                         pre_servo=lib.dwbc_pre_elems(host, 1), out=lib.dwbc_out_elems(host),
                         warm=lib.dwbc_warm_elems(host),
                         ws_pre=lib.dwbc_prestage_ws_elems(host),
                         smem_pre=lib.dwbc_prestage_smem_elems(host),
                         stride_pre=lib.dwbc_prestage_stride(host),
                         smem_qp=lib.dwbc_qpchain_smem_elems(host))
            if sizes["smem_pre"] > lib.dwbc_prestage_smem_cap():
                raise NotImplementedError(
                    f"tick_prestage needs {sizes['smem_pre']} shared floats per scenario "
                    f"for this model, the kernel has {lib.dwbc_prestage_smem_cap()}")
            if sizes["smem_qp"] > QP_SMEM_MAX:
                raise NotImplementedError(
                    f"tick_qpchain needs {sizes['smem_qp']} shared floats per scenario "
                    f"for this plan, the kernel has {QP_SMEM_MAX}")
            want = dict(pre=_elems(pre_layout(self.plan)),
                        pre_servo=_elems(pre_layout(self.plan, servo=True)),
                        out=_elems(out_layout(self.plan)),
                        warm=_elems(warm_layout(self.plan)))
            for k, v in want.items():
                if sizes[k] != v:
                    raise RuntimeError(f"kernel {k} layout has {sizes[k]} elements, "
                                       f"the wrapper expects {v}")
            self._sizes = sizes
        return lib, self._sizes

    def _check(self, name, t, shape):
        if t.device != self.table.device:
            raise ValueError(f"{name} is on {t.device}, the kernels' tables on "
                             f"{self.table.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA tick takes float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    @staticmethod
    def _raise_on(rc, name):
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    # --------------------------------------------------------- packed API
    def prestage_packed(self, q, cmask=None, qdot=None, fstars=None, servos=None):
        """q (nq, B) float32 on the device, and in masked mode the 0/1
        contact mask cmask (nc, B) → ``PackedPre``.  With servos (per level
        None or a per-spec tuple of element-leading dicts or None): also
        qdot (ndof, B) and f* per level (t, B), and the buffer carries the
        servo section."""
        B = q.shape[-1]
        plan = self.plan
        self._check("q", q, (plan.nq, B))
        if (cmask is not None) != plan.masked:
            raise ValueError("cmask goes with a masked plan, and only there")
        if cmask is not None:
            self._check("cmask", cmask, (len(plan.cfg.contacts), B))
        smask = servo_mask(servos, plan)
        fs = sv = None
        if smask:
            if qdot is None or fstars is None:
                raise ValueError("a servo'd prestage needs qdot and f*")
            self._check("qdot", qdot, (plan.ndof, B))
            self._check_fstars(fstars, B)
            fs = torch.cat(list(fstars), 0)
            sv = pack_servos(servos, plan, B)
            self._check("servo buffer", sv, (SERVO_ELEMS * bin(smask).count("1"), B))
        lib, sz = self._lib_and_sizes()
        pre = torch.empty((sz["pre_servo" if smask else "pre"], B), dtype=torch.float32,
                          device=q.device)
        ws = torch.empty((B, sz["ws_pre"]), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dwbc_tick_prestage(self.table.data_ptr(), q.data_ptr(),
                                    None if cmask is None else cmask.data_ptr(),
                                    None if not smask else qdot.data_ptr(),
                                    None if not smask else fs.data_ptr(),
                                    None if not smask else sv.data_ptr(), smask,
                                    pre.data_ptr(), ws.data_ptr(), sz["stride_pre"], B, stream)
        self._raise_on(rc, "tick_prestage")
        self.launches["tick_prestage"] += 1
        return PackedPre(pre, smask != 0)

    def _check_fstars(self, fstars, B):
        if len(fstars) != len(self.plan.level_tdofs):
            raise ValueError(f"{len(fstars)} f* for {len(self.plan.level_tdofs)} task levels")
        for h, (f, t) in enumerate(zip(fstars, self.plan.level_tdofs)):
            self._check(f"fstars[{h}]", f, (t, B))

    def qpchain_packed(self, pre, fstars, warm, iters):
        """``PackedPre``, f* per level (None for a servo'd buffer, whose
        servo section holds them), warm (x, λ) per QP or None → (result
        buffer (out_elems, B), warm buffer (warm_elems, B))."""
        buf = pre.buf
        B = buf.shape[-1]
        lib, sz = self._lib_and_sizes()
        self._check("pre", buf, (sz["pre_servo" if pre.servo else "pre"], B))
        if (fstars is None) != pre.servo:
            raise ValueError("a servo'd prestage buffer brings its own f*, any other "
                             "needs the caller's")
        if warm is not None and len(warm) != len(self.plan.qp_dims):
            raise ValueError(f"warm state for {len(warm)} QPs, the tick has "
                             f"{len(self.plan.qp_dims)}")
        fs = None                   # null: the kernel reads the servo section
        if not pre.servo:
            self._check_fstars(fstars, B)
            fs = torch.cat(list(fstars), 0)
        win = None
        if warm is not None:
            for h, ((x, lam), (nv, m)) in enumerate(zip(warm, self.plan.qp_dims)):
                self._check(f"warm[{h}].x", x, (nv, B))
                self._check(f"warm[{h}].lam", lam, (m, B))
            win = torch.cat([t for xl in warm for t in xl], 0)
        out = torch.empty((sz["out"], B), dtype=torch.float32, device=buf.device)
        wout = torch.empty((sz["warm"], B), dtype=torch.float32, device=buf.device)
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        launch = lib.dwbc_tick_qpchain if self.plan.tlim is not None else lib.dwbc_tick_qpchain_nolim
        rc = launch(
            self.table.data_ptr(), buf.data_ptr(), None if fs is None else fs.data_ptr(),
            None if win is None else win.data_ptr(), out.data_ptr(),
            wout.data_ptr(), sz["smem_qp"], B, int(iters), stream)
        self._raise_on(rc, "tick_qpchain")
        self.launches["tick_qpchain"] += 1
        return out, wout

    # ---------------------------------- the plain version's interface
    # A servo'd prestage dict also holds "fstars" (the f* of every level)
    # and "task_states" {(level, spec): (pos, vel, rot, w)}.
    def unpack_pre(self, pre):
        """``PackedPre`` → prestage dict."""
        nlev = len(self.plan.level_tdofs)
        d = _unpack(pre.buf, pre_layout(self.plan, pre.servo))
        d["Ntorques"] = [d.pop(f"Ntorques.{h}") for h in range(nlev)]
        if self.plan.cfree == 0:        # one contact: no kernel basis, as the plain prestage
            d["NwJw"] = None
        if pre.servo:
            d["fstars"] = [d.pop(f"fstars.{h}") for h in range(nlev)]
            d["task_states"] = {(h, j): tuple(d.pop(f"{n}.{h}.{j}") for n, _ in TASK_STATE)
                                for h, j, *_ in tasks(self.plan)}
        return d

    def pack_pre(self, pre):
        """``PackedPre`` of a prestage dict; a servo'd dict (one that holds
        its "fstars") gets the servo section (a task without a state gets
        zeros there, which the QP chain does not read)."""
        B = pre["torque_grav"].shape[-1]
        servo = "fstars" in pre
        parts = []
        for name, shape in pre_layout(self.plan, servo):
            key, _, h = name.partition(".")
            if key in ("Ntorques", "fstars"):
                t = pre[key][int(h)]
            elif key.startswith("task_"):
                st = pre["task_states"].get(tuple(int(i) for i in h.split(".")))
                t = (torch.zeros(shape + (B,), dtype=pre["torque_grav"].dtype,
                                 device=pre["torque_grav"].device) if st is None
                     else st[[n for n, _ in TASK_STATE].index(key)])
            elif pre[name] is None:         # NwJw with cfree = 0: no elements
                continue
            else:
                t = pre[name]
            parts.append(t.reshape(-1, B))
        return PackedPre(torch.cat(parts, 0), servo)

    def unpack_result(self, out, wout):
        res = _unpack(out, out_layout(self.plan))
        w = _unpack(wout, warm_layout(self.plan))
        res["warm_out"] = tuple((w[f"x.{h}"], w[f"lam.{h}"])
                                for h in range(len(self.plan.qp_dims)))
        return res

    def prestage(self, q, cmask=None, qdot=None, fstars=None, servos=None):
        """tick_prestage; for a CPU tensor the plain prestage (with servos
        ``prestage_servo``)."""
        if q.device.type == "cpu":
            if servos is None:
                return self.prog.prestage(q, cmask)
            return self.prog.prestage_servo(q, cmask, qdot, fstars, servos)
        return self.unpack_pre(self.prestage_packed(q, cmask, qdot, fstars, servos))

    def qpchain(self, pre, fstars, warm=None, iters=25):
        """tick_qpchain; the plain qpchain for CPU tensors.  A servo'd
        prestage dict brings its own f*."""
        if pre["torque_grav"].device.type == "cpu":
            return self.prog.qpchain(pre, pre.get("fstars", fstars), warm=warm, iters=iters)
        packed = self.pack_pre(pre)
        return self.unpack_result(*self.qpchain_packed(
            packed, None if packed.servo else fstars, warm, iters))

    def tick(self, q, fstars, warm=None, iters=25, cmask=None, qdot=None, servos=None):
        """Both kernels back to back; the plain tick for a CPU tensor."""
        if q.device.type == "cpu":
            return self.prog.tick(q, fstars, warm=warm, iters=iters, cmask=cmask, qdot=qdot,
                                  servos=servos)
        pre = self.prestage_packed(q, cmask, qdot, fstars, servos)
        return self.unpack_result(*self.qpchain_packed(pre, None if pre.servo else fstars,
                                                       warm, iters))
