"""libdwbc_tpu_torch: the WBC serving tick in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``libdwbc_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports torch and numpy only, never JAX.

Layout mirrors the JAX package: ``model/`` (the model compiler, surgery
and the npz artifacts), ``kin/`` (kinematics, dynamics, centroidal
momentum), ``ops/`` (element-leading linear algebra, the plain tick, the
CUDA wrappers and their build), ``wbc/`` (configuration, results, the
ticks — ``FusedTick``, ``CompiledTick``, ``MaskedTick``, ``ReducedTick`` —
the loop and the LQP cascade), ``csrc/`` (the CUDA sources), ``convert.py``
(model and config carry-over, the plain tick's tables) and ``entry.py``
(the serving entry points).  ``wbc/robot.py`` is the reference-compatible
controller facade ``RobotData``, ``bridge.py`` the RL bridges,
``parallel/hypotheses.py`` the contact-mode hypothesis sweep and
``utils/golden.py`` the golden-matrix I/O.

Entry points:
  RobotData            — reference-compatible controller facade
  CompiledTick         — the tick as batched tensor algebra
  ReducedTick          — the reduced-dimension tick
  RobotModel           — compiled model artifact (URDF → static arrays)

Importing the package builds nothing and leaves CUDA untouched: the kernels
are built on their first launch.  Float32 products on the card are exact
(TF32 off), set where a tick or the facade is made on a CUDA device.
"""

__version__ = "0.1.0"

from .model.compile import (  # noqa: F401
    JointSpec, LinkSpec, RobotModel, compile_from_links, compile_urdf,
)
from .wbc import types  # noqa: F401
from .wbc.pipeline import CompiledTick, PipelineConfig, standard_tocabi_config  # noqa: F401
from .wbc.reduced_tick import ReducedTick  # noqa: F401
from .wbc.robot import RobotData  # noqa: F401

__all__ = [
    "RobotData",
    "RobotModel",
    "CompiledTick",
    "ReducedTick",
    "PipelineConfig",
    "standard_tocabi_config",
    "compile_urdf",
    "compile_from_links",
    "LinkSpec",
    "JointSpec",
    "types",
]
