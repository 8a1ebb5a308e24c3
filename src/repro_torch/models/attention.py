"""GQA attention with local/global windows, softcap, qk-norm, KV caches.

PyTorch counterpart of ``repro/models/attention.py``.  The plain path is
torch ops; with ``use_kernel=True`` full-sequence self-attention goes
through ``kernels.ops.flash_attention``, which launches the hand-written
CUDA kernel for CUDA tensors (and takes its plain version on the CPU).

Supports:
* grouped-query attention (num_kv_heads <= num_heads),
* sliding-window masks (gemma2 local layers; the window is a plain int per
  layer, since the port loops over layers in Python),
* attention logit soft-capping (gemma2),
* qk rms-norm (chameleon),
* decode against a (batch, max_seq, kv_heads, head_dim) cache written in
  place,
* cross-attention (whisper decoder): full-sequence against the encoder
  output, decode against the cached encoder K/V; always torch ops, as in
  the reference.
Projections promote mixed dtypes as JAX does (``common.einsum``): the
whisper encoder runs f32 activations through bf16 weights.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .common import (ArchConfig, apply_rope, dense_init, einsum, rms_norm,
                     softcap)

Params = Dict[str, torch.Tensor]


def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype, device: torch.device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (d, nq, hd), dtype, d, device),
        "wk": dense_init(gen, (d, nkv, hd), dtype, d, device),
        "wv": dense_init(gen, (d, nkv, hd), dtype, d, device),
        "wo": dense_init(gen, (nq, hd, d), dtype, nq * hd, device),
    }
    if cfg.use_bias:
        p["bq"] = torch.zeros((nq, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((nkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((nkv, hd), dtype=dtype, device=device)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 positions: Optional[torch.Tensor], *,
                 kv_src: Optional[torch.Tensor] = None,
                 use_rope: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q of x (B,S,d), k and v of ``kv_src`` (B,T,d; default x), with bias,
    qk-norm and (self-attention only) rope at ``positions``."""
    kv_src = x if kv_src is None else kv_src
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("btd,dhk->bthk", kv_src, p["wk"])
    v = einsum("btd,dhk->bthk", kv_src, p["wv"])
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """q: (B,S,nq,hd), k: (B,T,nkv,hd) -> scores (B,nkv,G,S,T), f32."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return scores / math.sqrt(hd)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,nkv,G,S,T), v: (B,T,nkv,hd) -> (B,S,nq,hd), f32."""
    b, nkv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, nkv * g, -1)


def _out_proj(p: Params, out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    if cfg.use_bias:
        y = y + p["bo"]
    return y


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ArchConfig, positions: Optional[torch.Tensor], window: int,
            use_kernel: bool, causal: bool = True) -> torch.Tensor:
    """Softmax attention of projected q (B,S,nq,hd) over k/v (B,T,nkv,hd);
    returns (B,S,nq,hd) in f32 (plain) or q's dtype (kernel).

    The causal and window masks compare q's and k's ``positions`` (self-
    attention); with neither, every key is visible and ``positions`` is
    not read (cross-attention)."""
    if use_kernel:
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    logit_cap=cfg.attn_softcap)
    scores = softcap(_gqa_scores(q, k, cfg), cfg.attn_softcap)
    if causal or window:
        qpos = positions[:, None, None, :, None]          # (B,1,1,S,1)
        kpos = positions[:, None, None, None, :]          # (B,1,1,1,T)
        mask = torch.ones((), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (qpos - kpos < window)
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    del scores          # one S x S tensor fewer while the product runs
    return _gqa_out(probs, v)


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, window: int = 0, causal: bool = True,
              kv_src: Optional[torch.Tensor] = None, use_rope: bool = True,
              use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence attention (train / prefill).

    ``window``: sliding-window size for this layer; 0 = full attention.
    ``kv_src``: encoder output for cross-attention, which attends to every
    encoder row, uses no rope and never the kernel (as in the
    reference)."""
    cross = kv_src is not None
    q, k, v = _project_qkv(p, x, cfg, positions, kv_src=kv_src,
                           use_rope=use_rope and not cross)
    if cross:
        out = _attend(q, k, v, cfg, None, 0, False, causal=False)
    else:
        out = _attend(q, k, v, cfg, positions, window, use_kernel,
                      causal=causal)
    return _out_proj(p, out.to(x.dtype), cfg)


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device: torch.device) -> Params:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Params, x: torch.Tensor, cache: Params, pos: int,
                     cfg: ArchConfig, *, window: int = 0,
                     use_rope: bool = True) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B,1,d); cache k/v: (B,T,nkv,hd); pos int.

    The new key and value are written into the cache in place at ``pos``
    (the JAX version returns a fresh cache from ``dynamic_update_slice``);
    the returned cache is the same tensors."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    t_max = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, use_rope=use_rope)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    scores = softcap(_gqa_scores(q, cache["k"], cfg), cfg.attn_softcap)
    kpos = torch.arange(t_max, device=x.device)[None, None, None, None, :]
    mask = kpos <= pos
    if window:
        mask = mask & (pos - kpos < window)
    scores = scores.masked_fill(~mask, -1e30)
    out = _gqa_out(torch.softmax(scores, dim=-1), cache["v"]).to(x.dtype)
    return _out_proj(p, out, cfg), cache


def decode_cross_attention(p: Params, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Cross-attention of x (B,1,d) against cached encoder K/V (B,T,nkv,hd),
    with no mask: every cache row is attended, the zero rows past the
    encoder output too, as in the reference (ROADMAP queue 3)."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.use_bias:
        q = q + p["bq"]
    probs = torch.softmax(_gqa_scores(q, k, cfg), dim=-1)
    return _out_proj(p, _gqa_out(probs, v).to(x.dtype), cfg)
