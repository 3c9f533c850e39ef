"""PyTorch/CUDA port of rcf_tpu for one NVIDIA H100.

Mirrors ``rcf_tpu/`` module for module. Imports torch, numpy, ctypes and
the standard library only: never JAX, never ``rcf_tpu``. Hand-written
CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at first use.
"""
