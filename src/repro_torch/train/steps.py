"""Serve step functions: prefill and decode, greedy over the real vocab.

PyTorch counterpart of the serving half of ``repro/train/steps.py``.  The
steps are pure functions of (params, inputs) except that the caches (KV and
SSM) are updated in place; they are the payloads of the serve Application
Drops.
The train step is a later slice of the port (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models import model as M
from ..models.common import ArchConfig


def make_prefill_step(cfg: ArchConfig, *, use_kernel: Optional[bool] = None
                      ) -> Callable:
    """``prefill_step(params, batch, max_seq=None) -> (next_tok, cache)``.

    ``batch`` holds ``tokens`` and, for encdec, ``frames``; it reaches
    ``prefill`` unchanged.  ``use_kernel=None`` sends prefill attention and the SSD scan to the
    hand-written kernels when the tokens are on CUDA and to the plain
    torch ops otherwise."""
    def prefill_step(params, batch: Dict[str, torch.Tensor],
                     max_seq: Optional[int] = None):
        kernel = (batch["tokens"].device.type == "cuda"
                  if use_kernel is None else use_kernel)
        with torch.inference_mode():
            logits, cache = M.prefill(params, cfg, batch, use_kernel=kernel,
                                      max_seq=max_seq)
            next_tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        return next_tok.to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """``decode_one(params, cache, tokens, pos) -> (next_tok (B,1), cache)``."""
    def decode_one(params, cache, tokens: torch.Tensor, pos: int):
        with torch.inference_mode():
            logits, cache = M.decode_step(params, cfg, cache, tokens, pos)
            next_tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        return next_tok.to(torch.int32)[:, None], cache
    return decode_one


def decode_fn(cfg: ArchConfig, params: Any, cache: Dict[str, Any],
              first_token: torch.Tensor, start_pos: int, steps: int):
    """Greedy multi-token decode loop (host-side driver for examples)."""
    step = make_decode_step(cfg)
    toks = [first_token]
    tok = first_token
    for i in range(steps):
        tok, cache = step(params, cache, tok, start_pos + i)
        toks.append(tok)
    return torch.cat(toks, dim=1), cache
