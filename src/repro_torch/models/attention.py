"""GQA attention with local/global windows, softcap, qk-norm, KV caches.

PyTorch counterpart of ``repro/models/attention.py``.  The plain path is
torch ops; with ``use_kernel=True`` full-sequence self-attention goes
through ``kernels.ops.flash_attention``, which launches the hand-written
CUDA kernel for CUDA tensors (and takes its plain version on the CPU).
Training's full-sequence attention (a call autograd records, on CUDA)
runs the training kernels, forward and backward
(``kernels.ops.train_attention``).

Supports:
* grouped-query attention (num_kv_heads <= num_heads),
* sliding-window masks (gemma2 local layers; the window is a plain int per
  layer, since the port loops over layers in Python),
* attention logit soft-capping (gemma2),
* qk rms-norm (chameleon),
* decode against a (batch, max_seq, kv_heads, head_dim) cache written in
  place, at a position given as an int or as a device tensor; with
  ``use_kernel=True`` the attention over the cache goes through
  ``kernels.ops.decode_attention`` (a hand-written CUDA kernel that reads
  the cache where it lies), else the kernel's plain version (torch ops),
* cross-attention (whisper decoder): full-sequence against the encoder
  output (torch ops, as in the reference), decode against the cached
  encoder K/V (the decode kernel over every row with ``use_kernel=True``).
Projections promote mixed dtypes as JAX does (``common.einsum``): the
whisper encoder runs f32 activations through bf16 weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import train_attention as _train_kernels
from ..kernels.decode_attention import decode_attention_plain
from ..kernels.ref import attention_core
from .common import ArchConfig, apply_rope_qk, dense_init, einsum, rms_norm

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
    qk-norm and (self-attention only) rope at ``positions``.  Where RoPE
    directly follows the q and k biases (no qk-norm between them),
    ``apply_rope_qk`` adds them (inside the RoPE kernel on CUDA); v's bias
    is always a plain add."""
    kv_src = x if kv_src is None else kv_src
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("btd,dhk->bthk", kv_src, p["wk"])
    v = einsum("btd,dhk->bthk", kv_src, p["wv"])
    biases = None
    if cfg.use_bias:
        if use_rope and not cfg.qk_norm:
            biases = (p["bq"], p["bk"])
        else:
            q = q + p["bq"]
            k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        q, k = apply_rope_qk(q, k, positions, cfg.rope_theta, biases=biases)
    return q, k, v


def out_bias(p: Params, cfg: ArchConfig) -> Optional[torch.Tensor]:
    """The output projection's bias (``bo``), or None."""
    return p["bo"] if cfg.use_bias else None


def _out_proj(p: Params, out: torch.Tensor) -> torch.Tensor:
    """The output projection without its bias: ``out_bias`` is left to the
    caller (``models.common.add_rms_norm`` adds it with the residual)."""
    return einsum("bshk,hkd->bsd", out, p["wo"])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ArchConfig, positions: Optional[torch.Tensor], window: int,
            use_kernel: bool, causal: bool = True, *,
            arange_positions: bool = False) -> torch.Tensor:
    """Softmax attention of projected q (B,S,nq,hd) over k/v (B,T,nkv,hd);
    returns (B,S,nq,hd) in f32 (plain) or the kernel's dtype.

    ``use_kernel`` sends the call to the serve's flash kernel, which has no
    backward.  Otherwise a call that autograd records (grad mode on and an
    input that requires grad) on CUDA tensors runs the training attention
    kernels (``kernels.ops.train_attention``: forward and backward, the
    reference's f32 softmax kept); every other call, and every call on CPU
    or meta tensors (DTensors among them), takes the plain ops
    (``ref.attention_core``).  The causal and window masks compare q's and
    k's ``positions`` (self-attention); with neither, every key is visible
    and ``positions`` is not read (cross-attention).  The training kernels
    mask by row and column index instead, so a masked call takes them only
    when its caller states that ``positions`` are ``arange``
    (``arange_positions``: ``models.model``'s ``forward_train``,
    ``encode``, ``prefill``); any other masked call takes the plain ops on
    its positions.  Nothing compares the positions on the device (a read
    would synchronise and break a graph capture).  The serve flash route
    (``use_kernel``) masks by index as the reference's Pallas kernel
    does."""
    cap = cfg.attn_softcap
    if use_kernel:
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    logit_cap=cap)
    by_index = arange_positions or not (causal or window)
    if by_index and torch.is_grad_enabled() \
            and (q.requires_grad or k.requires_grad or v.requires_grad) \
            and _train_kernels.takes_kernel((q, k, v)):
        from ..kernels import ops as kops
        return kops.train_attention(q, k, v, causal=causal, window=window,
                                    logit_cap=cap)
    return attention_core(q, k, v, positions, causal=causal, window=window,
                          logit_cap=cap)


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, window: int = 0, causal: bool = True,
              kv_src: Optional[torch.Tensor] = None, use_rope: bool = True,
              use_kernel: bool = False,
              arange_positions: bool = False) -> torch.Tensor:
    """Full-sequence attention (train / prefill).

    ``window``: sliding-window size for this layer; 0 = full attention.
    ``kv_src``: encoder output for cross-attention, which attends to every
    encoder row, uses no rope and never the kernel (as in the
    reference).  ``arange_positions``: the caller states that
    ``positions`` are ``arange`` (each row's index), which lets a masked
    call that autograd records run the training kernels (``_attend``).
    The output projection's bias is left to the caller (``out_bias``)."""
    cross = kv_src is not None
    q, k, v = _project_qkv(p, x, cfg, positions, kv_src=kv_src,
                           use_rope=use_rope and not cross)
    if cross:
        out = _attend(q, k, v, cfg, None, 0, False, causal=False)
    else:
        out = _attend(q, k, v, cfg, positions, window, use_kernel,
                      causal=causal, arange_positions=arange_positions)
    return _out_proj(p, out.to(x.dtype))


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device: torch.device) -> Params:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def position(pos, device: torch.device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``.  An int is
    filled in by a kernel: no copy from the host, so no synchronise."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), pos, dtype=torch.int64, device=device)


def _write_row(buf: torch.Tensor, pos, row: torch.Tensor) -> None:
    """``buf[:, pos] = row[:, 0]`` in place.  A tensor ``pos`` writes by
    ``index_copy_``, the counterpart of the reference's
    ``dynamic_update_slice``: it reads the position on the device, where an
    indexing by a 0-d tensor can read it on the host, which a CUDA graph's
    capture forbids.  An int writes by select and copy, the form DTensor
    shards (the dry-run's caches; it has no strategy for ``index_copy_``)."""
    if isinstance(pos, torch.Tensor):
        buf.index_copy_(1, pos.view(1), row.to(buf.dtype))
    else:
        buf[:, pos] = row[:, 0].to(buf.dtype)


def decode_attention(p: Params, x: torch.Tensor, cache: Params, pos,
                     cfg: ArchConfig, *, window: int = 0,
                     use_rope: bool = True, use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B,1,d); cache k/v: (B,T,nkv,hd).

    ``pos``, the new token's position, is an int or a 0-d int64 tensor on
    the cache's device (the reference's traced ``pos``: the decode graph
    reads it from a buffer, so one capture serves every position); both
    give the same bits.  The new key and value are written into the cache
    in place at ``pos`` (the JAX version returns a fresh cache from
    ``dynamic_update_slice``); the returned cache is the same tensors.
    The attention over the cache is ``kernels.ops.decode_attention`` with
    ``use_kernel`` (the CUDA kernel on CUDA tensors), else its plain
    version, the torch ops of the reference's formula.  The output
    projection's bias is left to the caller (``out_bias``)."""
    b = x.shape[0]
    at = position(pos, x.device)
    positions = at.view(1, 1).expand(b, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, use_rope=use_rope)
    _write_row(cache["k"], pos, k_new)
    _write_row(cache["v"], pos, v_new)
    if use_kernel:
        from ..kernels import ops as kops
        attend = kops.decode_attention
    else:
        attend = decode_attention_plain
    out = attend(q, cache["k"], cache["v"], at, window=window,
                 logit_cap=cfg.attn_softcap)
    return _out_proj(p, out.to(x.dtype)), cache


def decode_cross_attention(p: Params, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, cfg: ArchConfig, *,
                           use_kernel: bool = False) -> torch.Tensor:
    """Cross-attention of x (B,1,d) against cached encoder K/V (B,T,nkv,hd),
    with no mask and no softcap: every cache row is attended, the zero
    rows past the encoder output too, as in the reference (ROADMAP queue
    3); through ``kernels.ops.decode_attention`` with ``use_kernel``.
    The output projection's bias is left to the caller (``out_bias``)."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.use_bias:
        q = q + p["bq"]
    if use_kernel:
        from ..kernels import ops as kops
        out = kops.decode_attention(q, k, v, None, all_rows=True)
    else:
        out = decode_attention_plain(q, k, v, all_rows=True)
    return _out_proj(p, out.to(x.dtype))
