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
(the serving entry points).
"""
