"""The robot model as the reference reads it: the arrays of the model's
npz file, with the sizes derived from them (a floating base)."""

from __future__ import annotations

import json
import types

import numpy as np

ARRAYS = ("parent", "q_index", "X_T_rot", "X_T_trans", "axis", "mass", "com", "inertia",
          "ancestor_mask", "gravity")


def load_model(path) -> types.SimpleNamespace:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        arrays = {k: np.array(z[k]) for k in ARRAYS}
    if not meta["floating"]:
        raise ValueError("the reference tick takes floating-base models only")
    nbody = len(meta["body_names"])
    ndof = 6 + nbody - 1
    return types.SimpleNamespace(nbody=nbody, ndof=ndof, nq=ndof + 1, model_dof=ndof - 6,
                                 floating=True, **arrays)
