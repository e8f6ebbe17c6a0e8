"""Reduced-dimension contact-consistent dynamics in torch, batch-major
(counterpart of ``libdwbc_tpu/wbc/reduced.py``, the reference's ``_R``
path).

The kinematic tree is split per contact mode into the contact chain (the
links on a path from an active contact to the base) and the non-contact
chain; the non-contact chain is lumped into one 6-DoF virtual body by its
locked spatial inertia and centroidal momentum matrix, and the task
hierarchy runs in ``reduced_system_dof = co_dof + 12`` coordinates.

* ``classify_chains`` → ``ReducedIndex``: the static index arrays;
* ``reduced_dynamics`` → ``ReducedDynamics``: the lumped body, the
  reduction jacobian J_R, A_R⁻¹ = J_R A⁻¹ J_Rᵀ and its inverse, J̄_Rᵀ with
  its structural zeros, the reduced gravity;
* ``reduced_contact_space`` and ``reduced_gravity``: the contact-space
  factorization and τ_grav in reduced coordinates.

``backend="cuda"`` routes A_R (n = co_dof + 12: 24 on the flagship) and
the reduced contact space's W + V2ᵀV2 (n = co_dof + 6: 18) to the
``psd_inverse`` kernel where ``linalg_cuda.use_kernel`` takes them, as
``wbc/dynamics.py`` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kin.rotations import skew
from ..ops import smallmat as sm
from .dynamics import ContactSpace, _psd_inv, contact_space


@dataclasses.dataclass(frozen=True)
class ReducedIndex:
    """Static chain classification for one contact mode
    (src/dwbc.cpp:2755-2823)."""

    co_links: tuple[int, ...]
    nc_links: tuple[int, ...]
    co_joints: np.ndarray       # q̇ indices of contact-chain joints
    nc_joints: np.ndarray       # q̇ indices of non-contact-chain joints
    vc_joints: np.ndarray       # [0..5] + co_joints
    co_dof: int
    nc_dof: int
    vc_dof: int
    reduced_model_dof: int      # co_dof + 6
    reduced_system_dof: int     # co_dof + 12


def classify_chains(model, contact_links) -> ReducedIndex:
    co_links = {0}
    for cl in contact_links:
        k = cl
        while k != 0:
            co_links.add(k)
            k = int(model.parent[k])
    nc_links = [i for i in range(model.nbody) if i not in co_links]
    co_joints = sorted(int(model.q_index[i]) for i in co_links if i != 0)
    nc_joints = sorted(int(model.q_index[i]) for i in nc_links)
    co_dof, nc_dof = len(co_joints), len(nc_joints)
    return ReducedIndex(
        co_links=tuple(sorted(co_links)),
        nc_links=tuple(nc_links),
        co_joints=np.array(co_joints, dtype=np.int64),
        nc_joints=np.array(nc_joints, dtype=np.int64),
        vc_joints=np.array(list(range(6)) + co_joints, dtype=np.int64),
        co_dof=co_dof,
        nc_dof=nc_dof,
        vc_dof=co_dof + 6,
        reduced_model_dof=co_dof + 6,
        reduced_system_dof=co_dof + 12,
    )


class ReducedDynamics(NamedTuple):
    """Per-tick reduced-dynamics quantities (base frame where noted)."""

    mass_nc: torch.Tensor        # ()
    com_pos_nc: torch.Tensor     # (3,) nc-chain COM, base frame
    inertia_nc: torch.Tensor     # (3,3) nc-chain locked inertia about its COM
    cmm_nc: torch.Tensor         # (6,nc_dof) nc centroidal momentum matrix
    J_I_nc: torch.Tensor         # (6,nc_dof) lumped-body velocity map
    A_NC_joint: torch.Tensor     # (nc,nc) nc-subtree joint-space mass matrix
    J_R: torch.Tensor            # (r_sys,n) reduction jacobian
    A_R_inv: torch.Tensor        # (r_sys,r_sys)
    A_R: torch.Tensor
    J_I_nc_inv_T: torch.Tensor   # (6,nc_dof) dynamically consistent inverse-T
    N_I_nc: torch.Tensor         # (nc,nc) nc null projector
    J_R_INV_T: torch.Tensor      # (r_sys,n)
    G_R: torch.Tensor            # (r_sys,)
    G_NC: torch.Tensor           # (nc,)


def _scatter_reduced(batch, rows, n, vc_dof, vcj, ncj, nc_block, like):
    """(batch, rows, n) zeros with ones at (i, vcj[i]) for i < vc_dof and
    ``nc_block`` in rows vc_dof: at the nc columns (J_R, J̄_Rᵀ)."""
    out = like.new_zeros(batch + (rows, n))
    out[..., torch.arange(vc_dof, device=vcj.device), vcj] = 1.0
    out[..., vc_dof:, ncj] = nc_block
    return out


def reduced_dynamics(model, idx: ReducedIndex, st, backend="torch") -> ReducedDynamics:
    """Lump the non-contact chain into a virtual 6-DoF body
    (``ReducedDynamicsCalculate``, src/dwbc.cpp:2752-2989)."""
    dtype, dev = st.A.dtype, st.A.device
    nc = list(idx.nc_links)
    ncj = torch.as_tensor(idx.nc_joints, device=dev)
    vcj = torch.as_tensor(idx.vc_joints, device=dev)
    n = model.ndof
    vc_dof, nc_dof = idx.vc_dof, idx.nc_dof

    R0 = st.R[..., 0, :, :]
    R0T = R0.transpose(-1, -2)
    p0 = st.p[..., 0, :]

    mass = torch.as_tensor(np.asarray(model.mass, np.float64)[nc], dtype=dtype, device=dev)
    inertia_l = torch.as_tensor(np.asarray(model.inertia, np.float64)[nc], dtype=dtype,
                                device=dev)

    # nc-body poses relative to the base (base frame)
    R_rel = torch.einsum("...ij,...bjk->...bik", R0T, st.R[..., nc, :, :])
    com_rel = torch.einsum("...ij,...bj->...bi", R0T, st.com_w[..., nc, :] - p0[..., None, :])
    I_rel = torch.einsum("...bij,bjk,...blk->...bil", R_rel, inertia_l, R_rel)

    mass_nc = mass.sum()
    com_pos_nc = torch.einsum("b,...bi->...i", mass, com_rel) / mass_nc
    d = com_rel - com_pos_nc[..., None, :]
    sd = skew(d)
    inertia_nc = I_rel.sum(-3) + torch.einsum("b,...bij,...bkj->...ik", mass, sd, sd)

    # base-frame jacobians of the nc bodies' COMs over the nc joints: the
    # world-frame columns at the nc dofs, rotated by R0ᵀ
    Jv = torch.einsum("...ij,...bjk->...bik", R0T, st.Jcom[..., nc, 0:3, :][..., ncj])
    Jw = torch.einsum("...ij,...bjk->...bik", R0T, st.Jcom[..., nc, 3:6, :][..., ncj])

    lin = torch.einsum("b,...bik->...ik", mass, Jv)
    ang = (torch.einsum("...bij,...bjk->...ik", I_rel, Jw)
           + torch.einsum("b,...bij,...bjk->...ik", mass, sd, Jv))
    cmm_nc = torch.cat([lin, ang], dim=-2)                       # (...,6,ncd)

    # the nc subtree's joint-space mass matrix (src/dwbc.cpp:2892-2904):
    # the kinetic-energy metric of the nc bodies over the nc joint rates
    A_NC_joint = (torch.einsum("b,...bik,...bil->...kl", mass, Jv, Jv)
                  + torch.einsum("...bik,...bij,...bjl->...kl", Jw, I_rel, Jw))

    batch = cmm_nc.shape[:-2]
    SI_l = cmm_nc.new_zeros(batch + (6, 6))
    SI_l[..., 0, 0] = SI_l[..., 1, 1] = SI_l[..., 2, 2] = mass_nc
    SI_l[..., 3:6, 3:6] = inertia_nc
    J_I_nc = sm.psd_solve(SI_l, cmm_nc)                          # SI_l is 6×6 SPD

    # the reduction jacobian J_R (src/dwbc.cpp:2918-2930)
    r_sys = idx.reduced_system_dof
    J_R = _scatter_reduced(batch, r_sys, n, vc_dof, vcj, ncj, J_I_nc, cmm_nc)

    A_R_inv = J_R @ st.A_inv @ J_R.transpose(-1, -2)
    A_R_inv = 0.5 * (A_R_inv + A_R_inv.transpose(-1, -2))
    A_R = _psd_inv(A_R_inv, backend)

    # J̄_Rᵀ = A_R J_R A⁻¹ with its structural zeros (src/dwbc.cpp:2968-2980)
    JRIT_dense = A_R @ J_R @ st.A_inv
    J_I_nc_inv_T = JRIT_dense[..., vc_dof:, :][..., ncj]
    J_R_INV_T = _scatter_reduced(batch, r_sys, n, vc_dof, vcj, ncj, J_I_nc_inv_T, cmm_nc)

    N_I_nc = (torch.eye(nc_dof, dtype=dtype, device=dev)
              - J_I_nc.transpose(-1, -2) @ J_I_nc_inv_T)

    G_nc = st.G[..., ncj]
    G_R = torch.cat([st.G[..., vcj], (J_I_nc_inv_T @ G_nc[..., None])[..., 0]], dim=-1)
    return ReducedDynamics(
        mass_nc=mass_nc, com_pos_nc=com_pos_nc, inertia_nc=inertia_nc,
        cmm_nc=cmm_nc, J_I_nc=J_I_nc, A_NC_joint=A_NC_joint,
        J_R=J_R, A_R_inv=A_R_inv, A_R=A_R,
        J_I_nc_inv_T=J_I_nc_inv_T, N_I_nc=N_I_nc, J_R_INV_T=J_R_INV_T,
        G_R=G_R, G_NC=G_nc,
    )


def reduced_contact_space(idx: ReducedIndex, J_C, rd: ReducedDynamics,
                          backend="torch") -> tuple[ContactSpace, torch.Tensor]:
    """Contact-space factorization in reduced coordinates
    (``ReducedCalcContactConstraint``, src/dwbc.cpp:3077-3142), by the
    generic closed-form factorization; returns it and J_CR."""
    vcj = torch.as_tensor(idx.vc_joints, device=J_C.device)
    J_CR = J_C.new_zeros(J_C.shape[:-1] + (idx.reduced_system_dof,))
    J_CR[..., :, :idx.vc_dof] = J_C[..., vcj]
    return contact_space(J_CR, rd.A_R_inv, backend=backend), J_CR


def reduced_gravity(idx: ReducedIndex, cs_r: ContactSpace, rd: ReducedDynamics, G):
    """τ_g in reduced coordinates and its recomposition
    (src/dwbc.cpp:3144-3150): (τ_grav over model_dof in co-then-nc order,
    τ_grav_R over reduced_model_dof, P_CR)."""
    r_model = idx.reduced_model_dof
    NG = (cs_r.N_C @ rd.G_R[..., None])[..., 0]
    tgR = (cs_r.W_inv @ (rd.A_R_inv[..., -r_model:, :] @ NG[..., None]))[..., 0]
    P_CR = (cs_r.J_C_INV_T @ rd.G_R[..., None])[..., 0]
    # the co part from the reduced solve, the nc part raw gravity (the nc
    # chain compensates itself) — src/dwbc.cpp:3147-3148
    tg_full = torch.cat([tgR[..., :idx.co_dof], rd.G_NC], dim=-1)
    return tg_full, tgR, P_CR
