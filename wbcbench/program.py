"""The system under test: the port's serving tick for a configuration
file, built through the port's own API.  Nothing here is imported until a
run builds its tick, so that a directory without the port fails there."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def library_build_s() -> float | None:
    """Build the port's kernel library if this checkout has none for its
    sources; the seconds the build took, or None when it was there."""
    import time

    from libdwbc_tpu_torch.ops import _build

    so = _build.BUILD_DIR / f"libdwbc_tick_{_build.source_hash()}.so"
    if so.exists():
        return None
    t0 = time.perf_counter()
    _build.build()
    return time.perf_counter() - t0


def build_tick(config: dict, device, backend: str = "cuda"):
    """The port's ``FusedTick`` (float32) for ``config``: its contacts, task
    levels, torque limit and cold budget; masked when the file says so."""
    from libdwbc_tpu_torch.model.compile import RobotModel
    from libdwbc_tpu_torch.wbc import types as T
    from libdwbc_tpu_torch.wbc.fused import FusedTick
    from libdwbc_tpu_torch.wbc.pipeline import PipelineConfig

    model = RobotModel.load(str(ROOT / config["model"]))
    contacts = tuple(T.ContactDef(
        link=c["link"], contact_type=getattr(T, "CONTACT_" + c["type"]),
        contact_point=np.asarray(c["point"], np.float64),
        contact_direction=np.asarray(c["direction"], np.float64),
        plane_x=c["plane"][0], plane_y=c["plane"][1],
        friction_ratio=c["friction"][0], friction_ratio_z=c["friction"][1], active=True)
        for c in config["contacts"])
    tasks = tuple(tuple((getattr(T, "TASK_LINK_" + mode), link) for mode, link in level)
                  for level in config["tasks"])
    lim = config["torque_limit"]
    cfg = PipelineConfig(contacts=contacts, task_specs=tasks,
                         torque_limit=None if lim is None else np.full(model.model_dof, lim),
                         qp_iters=config["cold_iters"])
    return FusedTick(model, cfg, torch.device(device), dtype=torch.float32, backend=backend,
                     masked=bool(config["masked"]))


def launches(tick) -> dict:
    """The port's launch counters of a tick (empty for a tick without
    kernels)."""
    k = getattr(tick, "kernels", None)
    return dict(k.launches) if k is not None else {}
