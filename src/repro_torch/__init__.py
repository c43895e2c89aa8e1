"""gDDIM serving on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `repro` with the same subpackage layout.  It
imports torch and never JAX; the JAX package is the reference its tests
hold it against.  Entry points run on `cuda` unless the caller passes
`device="cpu"`; the hand-written kernels (`kernels/`, sources in `csrc/`)
are built with nvcc at first use.
"""
