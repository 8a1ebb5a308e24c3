"""Hand-written Hopper kernels for the compute hot spots.

flash_attention: fused GQA attention (causal/window/softcap), CUDA C++.
ssd_scan: the Mamba2 SSD chunk scan, CUDA C++.
decode_attention: one-token attention over a KV cache, CUDA C++.
ops: model-layout wrappers; ref: plain PyTorch oracles.
No kernel has a backward: the wrappers refuse inputs that require
grad, and training runs the plain torch ops, as the reference trains.
"""
from . import ops, ref
from .flash_attention import flash_attention_bhsd

__all__ = ["flash_attention_bhsd", "ops", "ref"]
