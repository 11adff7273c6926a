"""PyTorch/CUDA port of ``distributeddataparallel_tpu`` for an NVIDIA H100.

The module layout mirrors the JAX package's.  This package imports
``torch`` and never ``jax`` or the JAX package.  Entry point:
``python -m distributeddataparallel_tpu_torch.dpp``.
"""
