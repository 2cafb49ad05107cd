"""PyTorch/CUDA port of nextgen_uia_tpu for one NVIDIA Hopper GPU.

The JAX package ``nextgen_uia_tpu`` is the reference this package is held
against. Parameter names and layouts are the JAX package's (linear ``w`` is
[in, out], convolutions are HWIO), and every parameter's state-dict key is the
JAX flat path with '/' replaced by '.', so the two packages exchange weights
through the same flat ``.npz`` files (core/checkpoint.py).

This package imports ``torch`` and never ``jax``.
"""
