"""Hand-written Hopper kernels for the compute hot spots.

flash_attention: fused GQA attention (causal/window/softcap), CUDA C++.
ops: model-layout wrappers; ref: plain PyTorch oracles.
The Mamba2 SSD scan kernel is not ported yet (ROADMAP queue 2).
"""
from . import ops, ref
from .flash_attention import flash_attention_bhsd

__all__ = ["flash_attention_bhsd", "ops", "ref"]
