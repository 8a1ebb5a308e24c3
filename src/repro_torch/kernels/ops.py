"""Dispatch wrappers: model layout in, kernel layout inside.

``flash_attention`` / ``ssd_scan`` / ``decode_attention`` are what the
model layers call when ``use_kernel=True``; ``train_attention`` is what
``models.attention._attend`` calls for a full-sequence attention that
autograd records.  On CUDA tensors they launch the hand-written kernels;
on CPU tensors the kernels' wrappers take their plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import decode_attention as _decode
from . import train_attention as _train
from .flash_attention import flash_attention_bhsd
from .ssd_scan import ssd_scan_bhsd


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout x: (B,S,H,P), dt: (B,S,H), b/c: (B,S,G,N) -> (y
    (B,S,H,P), final state (B,H,N,P)).

    Groups reach the kernel by index (head h reads group h // (H/G)), not
    repeated per head.  initial_state must be None: the kernel starts from
    zero state (prefill semantics)."""
    if initial_state is not None:
        raise NotImplementedError(
            "kernel path starts from zero state; pass initial_state only "
            "on the torch path")
    # the copies into the kernel's layout, one profiler range
    with torch.profiler.record_function("ssd_scan_layout"):
        xt = x.transpose(1, 2).contiguous()               # (B,H,S,P)
        dtt = dt.float().transpose(1, 2).contiguous()     # (B,H,S)
        bt = b.transpose(1, 2).contiguous()               # (B,G,S,N)
        ct = c.transpose(1, 2).contiguous()
    y, state = ssd_scan_bhsd(xt, dtt, a.float().contiguous(), bt, ct, chunk)
    return y.transpose(1, 2), state


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, *, window: int = 0, logit_cap: float = 0.0,
                     all_rows: bool = False) -> torch.Tensor:
    """Model layout q (B,1,nq,D), k/v (B,T,nkv,D) (the cache, read in
    place: no transpose, no copy) -> (B,1,nq,D) f32."""
    out = _decode.decode_attention(q[:, 0], k, v, pos, window=window,
                                   logit_cap=logit_cap, all_rows=all_rows)
    return out[:, None]


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """Model layout q (B,S,nq,D), k/v (B,T,nkv,D), read by strides (no
    transposed copies) -> (B,S,nq,D), with a backward: the training
    kernels on CUDA, their plain version on the CPU and meta."""
    return _train.train_attention(q, k, v, causal=causal, window=window,
                                  logit_cap=logit_cap)
