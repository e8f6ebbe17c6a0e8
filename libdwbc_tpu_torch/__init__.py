"""libdwbc_tpu_torch: the WBC serving tick in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``libdwbc_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports torch and numpy only, never JAX.

Layout mirrors the JAX package: ``model/`` (npz model loader), ``ops/``
(element-leading linear algebra, the plain tick, the CUDA wrappers and their
build), ``wbc/`` (configuration, results, ``FusedTick``), ``csrc/`` (the
CUDA sources), ``convert.py`` (model and config carry-over, the plain tick's
tables) and ``entry.py`` (the serving entry points).
"""
