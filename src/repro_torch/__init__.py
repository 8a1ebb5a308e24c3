"""PyTorch port of the ``repro`` package, for NVIDIA Hopper.

Same sub-packages and function names as the JAX package, which stays the
reference: ``core`` and ``dsl`` are verbatim copies of the engine, the
models, serve steps and serve driver are rewritten in PyTorch, and the
Pallas TPU kernels become CUDA kernels under ``csrc/``.  Nothing here
imports JAX or the JAX package.
"""
