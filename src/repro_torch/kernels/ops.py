"""Dispatch wrappers: model layout in, kernel layout inside.

``flash_attention`` is what the model layers call when ``use_kernel=True``.
On CUDA tensors it launches the hand-written kernel; on CPU tensors the
wrapper takes the kernel's plain version (``repro_torch.kernels.ref``).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """Model layout (B,S,H,D) in/out; kernel runs (B,H,S,D)."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = flash_attention_bhsd(qt, kt, vt, causal=causal, window=window,
                               logit_cap=logit_cap)
    return out.transpose(1, 2)

