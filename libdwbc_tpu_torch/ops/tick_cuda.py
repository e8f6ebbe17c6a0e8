"""Wrappers of the two CUDA kernels of the WBC tick (``csrc/``).

``TickKernels`` launches ``tick_prestage`` and ``tick_qpchain`` for one
configuration.  Its methods take and return what the plain
``TickProgram`` does (element-leading tensors, batch last), and follow one
rule: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises (dtype other than float32, a wrong shape,
device or layout, a failed build, a refused launch).  Nothing falls back.

Each wrapper adds one to ``launches[name]`` where it launches its kernel.
Outputs and workspace are allocated here with ``torch.empty``; the kernels
run on the current stream, allocate nothing and do not synchronise.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch import nn

from ..wbc import types as T
from . import _build
from .tick_kernel import _POS, _SIX

# ---- packed kernel table: header slots and caps (csrc/tick_common.cuh)
HDR = 32
H_NBODY, H_NDOF, H_MDOF, H_NPTS, H_NC, H_CDOF, H_CFREE, H_KROWS, H_NLEV, H_NQ = range(10)
H_LEV_T = 10            # NLEV_MAX slots: task dofs per level
NLEV_MAX = 2
SPEC_6D, SPEC_ROT = 0, 1

# Max abs error of the kernels against their plain versions on the serving
# inputs of chip_smoke.py (batch 1024, seed 0), about ten times what an H100
# showed (outputs that showed 0 or ~1e-9 get 1e-6).  PRE_TOL: tick_prestage
# vs the plain prestage in float64.  QP_TOL: tick_qpchain vs the plain
# qpchain in float32, same prestage input.
PRE_TOL = {"torque_grav": 2e-2, "P_C": 5e-3, "Jbar_act": 5e-4, "NwJw": 5e-5,
           "Ntorques": 8e-2, "Atemp": 2e-4, "bA0": 5e-3, "health": 3e-6}
QP_TOL = {"torque_grav": 1e-6, "torque_task": 2e-5, "torque_contact": 1e-6,
          "torque_cmd": 4e-5, "contact_force": 2e-3, "health": 1e-6}


def kernel_unsupported(plan) -> str | None:
    """Why the CUDA kernels cannot run this plan, or None if they can: they
    take the flagship's shape (two 6D contacts, a torque limit, at most
    NLEV_MAX levels of one 6D or rotation link task each)."""
    cfg = plan.cfg
    if len(cfg.contacts) != 2 or any(c.contact_type != T.CONTACT_6D
                                     for c in cfg.contacts):
        return "the CUDA tick takes two 6D contacts"
    if plan.tlim is None:
        return "the CUDA tick needs a torque limit"
    if len(plan.task_slots) > NLEV_MAX:
        return f"the CUDA tick takes at most {NLEV_MAX} task levels"
    if any(len(lv) != 1 or kind != "pt" or mode in _POS
           for lv in plan.task_slots for kind, _, mode in lv):
        return "the CUDA tick takes one 6D or rotation link task per level"
    return None


def kernel_table(plan) -> np.ndarray:
    """The packed table of the CUDA kernels, in float64 (integers stored as
    exact floats; the kernels read it as float32); section order as in
    csrc/tick_common.cuh."""
    why = kernel_unsupported(plan)
    if why is not None:
        raise NotImplementedError(why)
    m = plan.model
    hdr = np.zeros(HDR)
    hdr[[H_NBODY, H_NDOF, H_MDOF, H_NPTS, H_NC, H_CDOF, H_CFREE, H_KROWS,
         H_NLEV, H_NQ]] = [plan.nbody, plan.ndof, plan.mdof, len(plan.points),
                           len(plan.cfg.contacts), plan.cdof, plan.cfree,
                           plan.k_rows, len(plan.task_slots), plan.nq]
    spec_slot = np.zeros(NLEV_MAX)
    spec_mode = np.zeros(NLEV_MAX)
    for h, [(_, slot, mode)] in enumerate(plan.task_slots):
        hdr[H_LEV_T + h] = plan.level_tdofs[h]
        spec_slot[h] = slot
        spec_mode[h] = SPEC_6D if mode in _SIX else SPEC_ROT
    sections = [
        hdr,
        plan.parent, plan.q_index, plan.owner,
        m.axis, m.X_T_rot, m.X_T_trans, m.com, m.inertia, m.mass,
        m.ancestor_mask, m.gravity,
        [link for link, _ in plan.points], [pt for _, pt in plan.points],
        plan.contact_slots, [c.link for c in plan.cfg.contacts],
        plan.const_blocks,
        spec_slot, spec_mode,
        plan.tlim,
    ]
    return np.concatenate([np.asarray(s, np.float64).ravel() for s in sections])


def pre_layout(plan):
    """(name, elem shape) of the prestage buffer, in kernel order
    (csrc/tick_common.cuh::Pre)."""
    lay = [("torque_grav", (plan.mdof,)), ("P_C", (plan.cdof,)),
           ("Jbar_act", (plan.cdof, plan.mdof)), ("NwJw", (plan.mdof, plan.cfree))]
    lay += [(f"Ntorques.{h}", (plan.mdof, t)) for h, t in enumerate(plan.level_tdofs)]
    lay += [("Atemp", (plan.k_rows, plan.mdof)), ("bA0", (plan.k_rows,)), ("health", ())]
    return lay


def out_layout(plan):
    """(name, elem shape) of the result buffer (csrc/tick_common.cuh::Out)."""
    return [("torque_grav", (plan.mdof,)), ("torque_task", (plan.mdof,)),
            ("torque_contact", (plan.mdof,)), ("torque_cmd", (plan.mdof,)),
            ("contact_force", (plan.cdof,)), ("qp_gap", ()),
            ("qp_primal_res", ()), ("health", ())]


def warm_layout(plan):
    """(x, λ) per QP (csrc/tick_common.cuh::Warm)."""
    return [(f"{k}.{h}", (dim,)) for h, (nv, m) in enumerate(plan.qp_dims)
            for k, dim in (("x", nv), ("lam", m))]


def _elems(layout):
    return sum(math.prod(shape) for _, shape in layout)


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
            sizes = dict(pre=lib.dwbc_pre_elems(host), out=lib.dwbc_out_elems(host),
                         warm=lib.dwbc_warm_elems(host),
                         ws_pre=lib.dwbc_prestage_ws_elems(host),
                         ws_qp=lib.dwbc_qpchain_ws_elems(host))
            want = dict(pre=_elems(pre_layout(self.plan)),
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
    def prestage_packed(self, q):
        """q (nq, B) float32 on the device → prestage buffer (pre_elems, B)."""
        B = q.shape[-1]
        self._check("q", q, (self.plan.nq, B))
        lib, sz = self._lib_and_sizes()
        pre = torch.empty((sz["pre"], B), dtype=torch.float32, device=q.device)
        ws = torch.empty((sz["ws_pre"], B), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dwbc_tick_prestage(self.table.data_ptr(), q.data_ptr(),
                                    pre.data_ptr(), ws.data_ptr(), B, stream)
        self._raise_on(rc, "tick_prestage")
        self.launches["tick_prestage"] += 1
        return pre

    def qpchain_packed(self, pre, fstars, warm, iters):
        """Prestage buffer, f* per level, warm (x, λ) per QP or None →
        (result buffer (out_elems, B), warm buffer (warm_elems, B))."""
        B = pre.shape[-1]
        lib, sz = self._lib_and_sizes()
        self._check("pre", pre, (sz["pre"], B))
        if len(fstars) != len(self.plan.level_tdofs):
            raise ValueError(f"{len(fstars)} f* for {len(self.plan.level_tdofs)} task levels")
        if warm is not None and len(warm) != len(self.plan.qp_dims):
            raise ValueError(f"warm state for {len(warm)} QPs, the tick has "
                             f"{len(self.plan.qp_dims)}")
        for h, (f, t) in enumerate(zip(fstars, self.plan.level_tdofs)):
            self._check(f"fstars[{h}]", f, (t, B))
        fs = torch.cat(list(fstars), 0)
        win = None
        if warm is not None:
            for h, ((x, lam), (nv, m)) in enumerate(zip(warm, self.plan.qp_dims)):
                self._check(f"warm[{h}].x", x, (nv, B))
                self._check(f"warm[{h}].lam", lam, (m, B))
            win = torch.cat([t for xl in warm for t in xl], 0)
        out = torch.empty((sz["out"], B), dtype=torch.float32, device=pre.device)
        wout = torch.empty((sz["warm"], B), dtype=torch.float32, device=pre.device)
        ws = torch.empty((sz["ws_qp"], B), dtype=torch.float32, device=pre.device)
        stream = torch.cuda.current_stream(pre.device).cuda_stream
        rc = lib.dwbc_tick_qpchain(
            self.table.data_ptr(), pre.data_ptr(), fs.data_ptr(),
            None if win is None else win.data_ptr(), out.data_ptr(),
            wout.data_ptr(), ws.data_ptr(), B, int(iters), stream)
        self._raise_on(rc, "tick_qpchain")
        self.launches["tick_qpchain"] += 1
        return out, wout

    # ---------------------------------- the plain version's interface
    def unpack_pre(self, buf):
        d = _unpack(buf, pre_layout(self.plan))
        d["Ntorques"] = [d.pop(f"Ntorques.{h}") for h in range(len(self.plan.level_tdofs))]
        return d

    def pack_pre(self, pre):
        B = pre["torque_grav"].shape[-1]
        parts = []
        for name, _ in pre_layout(self.plan):
            t = (pre["Ntorques"][int(name.split(".")[1])]
                 if name.startswith("Ntorques.") else pre[name])
            parts.append(t.reshape(-1, B))
        return torch.cat(parts, 0)

    def unpack_result(self, out, wout):
        res = _unpack(out, out_layout(self.plan))
        w = _unpack(wout, warm_layout(self.plan))
        res["warm_out"] = tuple((w[f"x.{h}"], w[f"lam.{h}"])
                                for h in range(len(self.plan.qp_dims)))
        return res

    def prestage(self, q):
        """tick_prestage; the plain prestage for a CPU tensor."""
        if q.device.type == "cpu":
            return self.prog.prestage(q)
        return self.unpack_pre(self.prestage_packed(q))

    def qpchain(self, pre, fstars, warm=None, iters=25):
        """tick_qpchain; the plain qpchain for CPU tensors."""
        if pre["torque_grav"].device.type == "cpu":
            return self.prog.qpchain(pre, fstars, warm=warm, iters=iters)
        return self.unpack_result(*self.qpchain_packed(self.pack_pre(pre), fstars,
                                                       warm, iters))

    def tick(self, q, fstars, warm=None, iters=25):
        """Both kernels back to back; the plain tick for a CPU tensor."""
        if q.device.type == "cpu":
            return self.prog.tick(q, fstars, warm=warm, iters=iters)
        return self.unpack_result(*self.qpchain_packed(self.prestage_packed(q),
                                                       fstars, warm, iters))
