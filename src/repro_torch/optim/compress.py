"""Int8 error-feedback gradient compression, PyTorch counterpart of
``repro/optim/compress.py``.

Per-tensor symmetric int8: scale = max|g| / 127 + 1e-12, q = clip(round(g /
scale), -127, 127).  Error feedback carries what the int8 grads lost into
the next step, so the sum of the decompressed grads plus the residual is
the sum of the true grads.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import tree_map, tree_map_n


def _quantise(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradients(grads: Any) -> Tuple[Any, Any]:
    """Per-tensor symmetric int8 quantisation: returns (q, scales)."""
    return tree_map_n(_quantise, 2, grads)


def decompress_gradients(qs: Any, scales: Any) -> Any:
    return tree_map(lambda q, s: q.float() * s, qs, scales)


def error_feedback_update(grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
    """(grads + residual) -> compress -> (q, scales, new residual)."""
    corrected = tree_map(lambda g, r: g.float() + r, grads, residual)
    qs, scales = compress_gradients(corrected)
    recon = decompress_gradients(qs, scales)
    new_residual = tree_map(lambda c, d: c - d, corrected, recon)
    return qs, scales, new_residual
