"""PyTorch/CUDA port of ppyolo_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``eval/``,
``checkpoint/``); hand-written CUDA kernels live in ``csrc/`` and build on
first use (``ops/_build.py``).  Imports torch and numpy, never jax or
ppyolo_tpu.
"""
