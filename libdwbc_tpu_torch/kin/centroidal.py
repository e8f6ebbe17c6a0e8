"""Centroidal momentum in torch, batch-major (counterpart of
``libdwbc_tpu/kin/centroidal.py``): the angular-momentum matrix built body
by body (``CalcAngularMomentumMatrix``, src/dwbc.cpp:1633-1680) — the
explicit cross-check of the CMM that ``kin/engine.py`` reads off the mass
matrix — of any body subset about any point (``CalcVirtualCMM``), and the
momentum observers.
"""

from __future__ import annotations

import numpy as np
import torch

from .rotations import skew


def virtual_cmm(kin, st, body_mask=None, about=None):
    """Angular-momentum matrix of a body subset about a point — the
    reference's ``CalcVirtualCMM`` (src/dwbc.cpp:1682-1709), which builds a
    throw-away RBDL model from a link list; here the subset is a 0/1 mask
    over the bodies.

    body_mask: (nbody,) 0/1 weights (None: every body, the full CMM);
    about: (...,3) the reference point (None: the whole-body COM).
    Returns the 3×ndof H with H·q̇ the selected bodies' angular momentum
    about ``about`` (world frame).  Needs a KinState whose J covers every
    body (an update without J_bodies)."""
    if st.J.shape[-3] != kin.nbody:
        raise ValueError(
            "virtual_cmm needs a full KinState (st.J over all bodies); got a "
            f"narrowed update with {st.J.shape[-3]} of {kin.nbody} body rows. "
            "Re-run kin.update without J_bodies narrowing.")
    m = kin.model
    kw = dict(dtype=st.A.dtype, device=st.A.device)
    mass = torch.as_tensor(np.asarray(m.mass, np.float64), **kw)
    inertia_l = torch.as_tensor(np.asarray(m.inertia, np.float64), **kw)
    if body_mask is not None:
        bm = torch.as_tensor(np.asarray(body_mask, np.float64), **kw)
        mass = mass * bm
        inertia_l = inertia_l * bm[:, None, None]
    com_l = torch.as_tensor(np.asarray(m.com, np.float64), **kw)

    R = st.R
    Jv, Jw = st.J[..., :, 0:3, :], st.J[..., :, 3:6, :]
    mb = mass[:, None, None]
    sk_c = skew(com_l)                                           # (nbody,3,3)
    # world inertia about each body origin, and R skew(c) Rᵀ
    Iw = torch.einsum("...bij,bjk,...blk->...bil", R,
                      inertia_l + mb * sk_c @ sk_c.transpose(-1, -2), R)
    RcRT = torch.einsum("...bij,bjk,...blk->...bil", R, sk_c, R)
    sk_x = skew(st.p)
    top = (torch.einsum("...bij,...bjn->...bin", Iw + sk_x @ RcRT.transpose(-1, -2) * mb, Jw)
           + torch.einsum("...bij,...bjn->...bin", RcRT * mb + mb * sk_x, Jv))
    bot = torch.einsum("...bij,...bjn->...bin", RcRT.transpose(-1, -2) * mb, Jw) + mb * Jv
    ref = st.com_pos if about is None else torch.as_tensor(about, **kw)
    return top.sum(-3) - skew(ref) @ bot.sum(-3)


def angular_momentum_matrix(kin, st):
    """The 3×ndof angular-momentum matrix about the whole-body COM, body by
    body (``CalcAngularMomentumMatrix``, src/dwbc.cpp:1633-1680): equal to
    the bottom rows of st.CMM."""
    return virtual_cmm(kin, st)


def momentum(st):
    """[linear momentum; angular momentum about the COM] = CMM · q̇."""
    return torch.einsum("...in,...n->...i", st.CMM, st.qdot)


def average_velocity(st):
    """The locked-inertia average 6D velocity of the robot (COM frame)."""
    return torch.einsum("...in,...n->...i", st.Jcom_total, st.qdot)
