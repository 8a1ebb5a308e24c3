"""Hand-written Hopper kernels for the compute hot spots.

flash_attention: fused GQA attention (causal/window/softcap), CUDA C++.
ssd_scan: the Mamba2 SSD chunk scan, CUDA C++.
decode_attention: one-token attention over a KV cache, CUDA C++.
optimizer: the train step's fused AdamW update and the grads' sum of
squares for the global-norm clip, CUDA C++.
train_attention: the train step's attention, forward and backward in the
reference's f32 arithmetic (an autograd function), CUDA C++.
moe_dispatch: the MoE block's slot positions, dispatch and combine on the
serve steps (no backward), CUDA C++.
gated_mlp: the gated MLP's act(a) * b, forward and backward (an autograd
function), on every train and gated serve path, CUDA C++.
cross_entropy: the train step's soft-capped cross-entropy of the head's
logits, forward and backward (an autograd function), CUDA C++.
ops: model-layout wrappers; ref: plain PyTorch oracles.
The serve kernels (flash, SSD, decode) have no backward: their wrappers
refuse inputs that require grad.  Training on CUDA launches the training
attention kernels (``models.attention._attend`` chooses them for calls
autograd records, by the tensors' device) and the two optimizer kernels
(``optim.adamw`` chooses them by the tensors' device), and the norm, RoPE,
gate and loss kernels; Mamba2's scan trains as torch ops, as the
reference's does.
"""
from . import ops, ref
from .flash_attention import flash_attention_bhsd

__all__ = ["flash_attention_bhsd", "ops", "ref"]
