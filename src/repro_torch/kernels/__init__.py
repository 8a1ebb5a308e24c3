"""Hand-written Hopper kernels for the compute hot spots.

flash_attention: fused GQA attention (causal/window/softcap), CUDA C++.
ssd_scan: the Mamba2 SSD chunk scan, CUDA C++.
decode_attention: one-token attention over a KV cache, CUDA C++.
optimizer: the train step's fused AdamW update and the grads' sum of
squares for the global-norm clip, CUDA C++.
ops: model-layout wrappers; ref: plain PyTorch oracles.
No attention or SSD kernel has a backward: their wrappers refuse inputs
that require grad, and training runs attention and the SSD scan as torch
ops, as the reference trains.  Training on CUDA launches the two optimizer
kernels (``optim.adamw`` chooses them by the tensors' device).
"""
from . import ops, ref
from .flash_attention import flash_attention_bhsd

__all__ = ["flash_attention_bhsd", "ops", "ref"]
