"""PyTorch port of the ``repro`` package, for NVIDIA Hopper.

Same sub-packages and function names as the JAX package, which stays the
reference: ``core``, ``dsl`` and ``data`` are verbatim copies of the
engine and the data pipeline; the models, the optimizer, the serve and
train steps, checkpointing and the serve and train drivers are rewritten
in PyTorch; and the Pallas TPU kernels become CUDA kernels under
``csrc/``.  Nothing here imports JAX or the JAX package.
"""
