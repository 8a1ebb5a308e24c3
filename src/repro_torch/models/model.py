"""Composite model assembly: the dense, vlm, ssm and hybrid families.

PyTorch counterpart of ``repro/models/model.py``, same functional API:
  * ``init_params(cfg, gen, device)``   — parameter tree (layers stacked)
  * ``forward_train(params, cfg, batch)`` — mean token loss (+ aux)
  * ``init_cache(cfg, batch, max_seq, device)`` — KV / SSM / hybrid cache
  * ``prefill(params, cfg, batch)``       — logits + primed cache
  * ``decode_step(params, cfg, cache, tokens, pos)`` — one-token serve step

The parameter tree has the JAX pytree's keys and shapes, with the layers
stacked on axis 0, so weights bridge by a plain tree-map
(``repro_torch.bridge``).  Layers run in a Python loop over views of the
stacked tensors instead of a ``lax.scan``, so each layer's window is a
plain int.  The hybrid family (zamba2) applies one shared attention block
after every ``shared_attn_period`` Mamba2 layers.  The moe and encdec
families are later slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .attention import (_attend, _out_proj, _project_qkv, attention,
                        decode_attention, init_attention, init_kv_cache)
from .common import (ArchConfig, activation_fn, cross_entropy, dense_init,
                     resolve_device, rms_norm, softcap)
from .ssm import (init_mamba2, init_ssm_cache, mamba2_decode_step,
                  mamba2_forward, mamba2_prime)

_PORTED = ("dense", "vlm", "ssm", "hybrid")
_LATER = {
    "moe": "ROADMAP queue 1 item 7 (MoE)",
    "encdec": "ROADMAP queue 1 item 8 (encoder-decoder)",
}


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family in _PORTED:
        return
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to PyTorch "
            f"yet: {_LATER[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")


def _layer(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of layer ``i`` of a stacked parameter (or cache) tree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# Block params
# ---------------------------------------------------------------------------


def _init_mlp(gen: torch.Generator, cfg: ArchConfig, dt: torch.dtype,
              device: torch.device) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, (d, f), dt, d, device),
         "w2": dense_init(gen, (f, d), dt, f, device)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, (d, f), dt, d, device)
    return p


def _mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
         cfg: ArchConfig) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["w1"])
    if cfg.activation in ("swiglu", "geglu"):
        gate = activation_fn(cfg.activation)
        h = gate(h) * torch.einsum("bsd,df->bsf", x, p["w3"])
    else:
        h = activation_fn(cfg.activation)(h)
    return torch.einsum("bsf,fd->bsd", h, p["w2"])


def _init_dense_block(gen: torch.Generator, cfg: ArchConfig,
                      dt: torch.dtype, device: torch.device
                      ) -> Dict[str, Any]:
    return {"attn_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
            "attn": init_attention(gen, cfg, dt, device),
            "mlp_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
            "mlp": _init_mlp(gen, cfg, dt, device)}


def _stack_init(n: int, make: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    """Stack ``n`` freshly made layers on axis 0, filling one preallocated
    tensor per leaf layer by layer (no second full copy of the weights)."""
    first = make()

    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict)
                else v.new_empty((n, *v.shape)) for k, v in tree.items()}

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    stacked = alloc(first)
    put(stacked, first, 0)
    del first
    for i in range(1, n):
        put(stacked, make(), i)
    return stacked


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
                device: Any = "cuda") -> Dict[str, Any]:
    """Seeded random parameters on ``device``, made layer by layer.

    ``gen`` defaults to a generator on ``device`` seeded with 0."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    dt = cfg.torch_dtype
    d, vp = cfg.d_model, cfg.padded_vocab
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (vp, d), dt, d, dev),
        "final_norm": torch.zeros((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, vp), dt, d, dev)
    if cfg.family in ("ssm", "hybrid"):
        params["layers"] = _stack_init(
            cfg.num_layers,
            lambda: {"norm": torch.zeros((d,), dtype=dt, device=dev),
                     "mamba": init_mamba2(gen, cfg, dt, dev)})
        if cfg.family == "hybrid":
            _shared_groups(cfg)               # raises on a bad period
            params["shared"] = _init_dense_block(gen, cfg, dt, dev)
    else:
        params["layers"] = _stack_init(
            cfg.num_layers, lambda: _init_dense_block(gen, cfg, dt, dev))
    return params


def _shared_groups(cfg: ArchConfig) -> int:
    """Calls of the hybrid's shared block: one after every
    ``shared_attn_period`` Mamba2 layers."""
    per = cfg.shared_attn_period
    if per <= 0 or cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of shared_attn_period={per}")
    return cfg.num_layers // per


def _shared_after(cfg: ArchConfig, i: int) -> int:
    """Index of the shared-block call that follows layer ``i``, or -1."""
    if cfg.family != "hybrid" or (i + 1) % cfg.shared_attn_period:
        return -1
    return (i + 1) // cfg.shared_attn_period - 1


# ---------------------------------------------------------------------------
# Layer-window schedule (gemma2 alternating local/global)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ArchConfig) -> List[int]:
    """Sliding-window size of each layer; 0 = full attention."""
    if cfg.alternate_local_global:
        return [cfg.local_window if i % 2 == 0 else 0
                for i in range(cfg.num_layers)]
    return [cfg.local_window] * cfg.num_layers


# ---------------------------------------------------------------------------
# Forward (train / prefill share the full-sequence path)
# ---------------------------------------------------------------------------


def backbone(params: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor, *, use_kernel: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layers.  Returns (hidden, aux_loss)."""
    _require_ported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x
    if cfg.family in ("ssm", "hybrid"):
        for i in range(cfg.num_layers):
            p = _layer(params["layers"], i)
            h = h + mamba2_forward(p["mamba"], rms_norm(h, p["norm"]), cfg,
                                   use_kernel=use_kernel)
            if _shared_after(cfg, i) >= 0:
                h = _dense_block(params["shared"], h, cfg, positions, 0,
                                 use_kernel)
        return h, aux
    for i, window in enumerate(layer_windows(cfg)):
        h = _dense_block(_layer(params["layers"], i), h, cfg, positions,
                         window, use_kernel)
    return h, aux


def _dense_block(p: Dict[str, Any], h: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, window: int,
                 use_kernel: bool) -> torch.Tensor:
    """One attention + MLP block over the full sequence (a dense layer, or
    the hybrid's shared block with full causal attention)."""
    h = h + attention(p["attn"], rms_norm(h, p["attn_norm"]), cfg,
                      positions=positions, window=window,
                      use_kernel=use_kernel)
    return h + _mlp(p["mlp"], rms_norm(h, p["mlp_norm"]), cfg)


def embed_tokens(params: Dict[str, Any], cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def logits_fn(params: Dict[str, Any], cfg: ArchConfig,
              h: torch.Tensor) -> torch.Tensor:
    """Final norm, then the (tied or separate) head; f32 logits, soft-capped."""
    h = rms_norm(h, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", h, head)
    return softcap(logits.float(), cfg.final_softcap)


def forward_train(params: Dict[str, Any], cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor], *, use_kernel: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token loss of one batch (the forward half of a train step)."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device).expand(tokens.shape)
    h, aux = backbone(params, cfg, x, positions, use_kernel=use_kernel)
    loss = cross_entropy(logits_fn(params, cfg, h), labels, cfg.vocab_size)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device: Any = "cuda") -> Dict[str, Any]:
    """Zeroed caches, stacked on axis 0: ``kv`` (one per attention layer,
    or per call of the hybrid's shared block) at ``max_seq``, and ``ssm``
    (conv window and state, one per Mamba2 layer)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = cfg.torch_dtype

    def stack(one: Dict[str, torch.Tensor], n: int) -> Dict[str, Any]:
        return {k: v.new_zeros((n, *v.shape)) for k, v in one.items()}

    cache: Dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = stack(init_ssm_cache(cfg, batch, dt, dev),
                             cfg.num_layers)
    if cfg.family != "ssm":
        n = _shared_groups(cfg) if cfg.family == "hybrid" else cfg.num_layers
        cache["kv"] = stack(init_kv_cache(cfg, batch, max_seq, dt, dev), n)
    return cache


def _decode_block(p: Dict[str, Any], h: torch.Tensor, kv: Dict[str, Any],
                  pos: int, cfg: ArchConfig, window: int) -> torch.Tensor:
    """One attention + MLP block for one token against its KV cache."""
    a, _ = decode_attention(p["attn"], rms_norm(h, p["attn_norm"]), kv, pos,
                            cfg, window=window)
    h = h + a
    return h + _mlp(p["mlp"], rms_norm(h, p["mlp_norm"]), cfg)


def decode_step(params: Dict[str, Any], cfg: ArchConfig,
                cache: Dict[str, Any], tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serve step: tokens (B,1) at position ``pos`` -> (logits, cache).

    The cache is updated in place and returned.  The SSM state is kept in
    f32 from the first step on, as in the reference (see
    ``ssm.mamba2_decode_step``): a cache whose state is still in the model's
    dtype gets a new f32 state tensor."""
    _require_ported(cfg)
    h = embed_tokens(params, cfg, tokens)
    if cfg.family not in ("ssm", "hybrid"):
        for i, window in enumerate(layer_windows(cfg)):
            h = _decode_block(_layer(params["layers"], i), h,
                              _layer(cache["kv"], i), pos, cfg, window)
        return logits_fn(params, cfg, h), cache
    ssm = cache["ssm"]
    states = ssm["state"]
    promoted = torch.promote_types(states.dtype, torch.float32)
    if states.dtype != promoted:
        states = torch.empty(states.shape, dtype=promoted,
                             device=states.device)
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        y, new = mamba2_decode_step(p["mamba"], rms_norm(h, p["norm"]),
                                    _layer(ssm, i), cfg)
        h = h + y
        ssm["conv"][i] = new["conv"]
        states[i] = new["state"]
        g = _shared_after(cfg, i)
        if g >= 0:
            h = _decode_block(params["shared"], h, _layer(cache["kv"], g),
                              pos, cfg, 0)
    ssm["state"] = states
    return logits_fn(params, cfg, h), cache


def prefill(params: Dict[str, Any], cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], *, use_kernel: bool = False,
            max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the full prompt; return last-position logits + primed cache.

    The cache is allocated at ``max_seq`` (default: the prompt length)
    and filled in place, so decode continues in it without the copy the
    JAX serve makes when it pads the cache out."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    prime = _prime_ssm if cfg.family in ("ssm", "hybrid") else _prime_kv
    h = prime(params, cfg, x, positions, cache, use_kernel)
    return logits_fn(params, cfg, h[:, -1:, :]), cache


def _prime_block(p: Dict[str, Any], h: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, kv: Dict[str, Any], j: int,
                 window: int, use_kernel: bool) -> torch.Tensor:
    """One attention + MLP block over the prompt, writing its K/V into
    slot ``j`` of the stacked cache ``kv``.  K/V are projected once and
    feed both the cache and the attention (JAX projects them twice)."""
    S = h.shape[1]
    xin = rms_norm(h, p["attn_norm"])
    q, k, v = _project_qkv(p["attn"], xin, cfg, positions)
    kv["k"][j, :, :S] = k
    kv["v"][j, :, :S] = v
    out = _attend(q, k, v, cfg, positions, window, use_kernel)
    h = h + _out_proj(p["attn"], out.to(h.dtype), cfg)
    return h + _mlp(p["mlp"], rms_norm(h, p["mlp_norm"]), cfg)


def _prime_kv(params, cfg, x, positions, cache, use_kernel):
    """Run the layers once, writing each layer's K/V into the cache: the
    priming pass is the forward pass."""
    h = x
    for i, window in enumerate(layer_windows(cfg)):
        h = _prime_block(_layer(params["layers"], i), h, cfg, positions,
                         cache["kv"], i, window, use_kernel)
    return h


def _prime_ssm(params, cfg, x, positions, cache, use_kernel):
    """Run the layers once, writing each Mamba2 layer's conv window and
    final state (and the K/V of each call of the hybrid's shared block)
    into the cache.

    The shared block's attention goes through ``_attend(..., use_kernel)``
    as the dense prime's does; the reference's hybrid prime never passes
    ``use_kernel`` there (ROADMAP queue 3), which gives the same function."""
    S = x.shape[1]
    width = cfg.ssm_conv - 1
    tail = min(S, width)
    ssm = cache["ssm"]
    h = x
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        y, conv_in, state = mamba2_prime(p["mamba"], rms_norm(h, p["norm"]),
                                         cfg, use_kernel)
        h = h + y
        ssm["conv"][i, :, width - tail:] = conv_in[:, S - tail:]
        ssm["state"][i] = state
        g = _shared_after(cfg, i)
        if g >= 0:
            h = _prime_block(params["shared"], h, cfg, positions, cache["kv"],
                             g, 0, use_kernel)
    return h
