"""Composite model assembly: all six families (dense, vlm, moe, ssm,
hybrid, encdec).

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
after every ``shared_attn_period`` Mamba2 layers.  The moe family
(granite, grok) replaces each dense block's MLP with ``moe.moe_block``.
The encdec family (whisper) runs an encoder over frame embeddings
(``encode``), then decoder layers with rope-free self-attention,
cross-attention to the encoder output and an MLP, with sinusoidal
positions on both sides.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (_attend, _out_proj, _project_qkv, attention,
                        decode_attention, decode_cross_attention,
                        init_attention, init_kv_cache, out_bias, position)
from .common import (ArchConfig, activation_fn, add_rms_norm,
                     capped_cross_entropy, dense_init, einsum, gated_act,
                     resolve_device, rms_norm, sinusoidal_positions, softcap)
from .moe import init_moe, moe_block
from .ssm import (init_mamba2, init_ssm_cache, mamba2_decode_step,
                  mamba2_forward, mamba2_prime)
from ..sharding import ctx as sctx

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
Position = Union[int, torch.Tensor]     # a decode position (see decode_step)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


@functools.lru_cache(maxsize=16)
def _sinusoid(seq: int, dim: int, device: torch.device) -> torch.Tensor:
    """The (seq, dim) sinusoid table on ``device``, made once per shape
    (decode reads one row of it a step; not written to).  A normal tensor
    even when first made under inference mode, so autograd may read it."""
    with torch.inference_mode(False):
        return sinusoidal_positions(seq, dim, device)


def _layer(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of layer ``i`` of a stacked parameter (or cache) tree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _unstack(layers: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Views of all ``n`` layers of a stacked parameter tree, from one
    ``torch.unbind`` per leaf.  Under autograd the unbind's backward
    stacks the layers' grads once; taking ``stacked[i]`` per layer instead
    would give each layer's grad its own zero tensor the size of the whole
    stack (L of them per leaf per step)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else torch.unbind(v)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    per_leaf = split(layers)
    return [pick(per_leaf, i) for i in range(n)]


def _remat(fn: Callable, remat: bool) -> Callable:
    """``fn`` whose activations are recomputed in the backward pass
    (``jax.checkpoint`` in the reference) when ``remat`` is set and autograd
    is recording; the non-reentrant checkpoint lets ``fn`` read tensors it
    was not passed (the layer's params) and return non-tensors."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)   # no random ops


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
    h = einsum("bsd,df->bsf", x, p["w1"])
    if cfg.activation in ("swiglu", "geglu"):
        h = gated_act(h, einsum("bsd,df->bsf", x, p["w3"]), cfg.activation)
    else:
        h = activation_fn(cfg.activation)(h)
    return einsum("bsf,fd->bsd", h, p["w2"])


def _ffn(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig,
         num_groups: Optional[int] = None, use_kernel: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A block's feed-forward half: (y, moe aux loss or None).
    ``use_kernel`` sends the experts' dispatch to the MoE kernels (no
    backward: the full-sequence ``_block`` that trains passes False)."""
    if "moe" in p:
        return moe_block(p["moe"], x, cfg, num_groups=num_groups,
                         use_kernel=use_kernel)
    return _mlp(p["mlp"], x, cfg), None


def _init_dense_block(gen: torch.Generator, cfg: ArchConfig,
                      dt: torch.dtype, device: torch.device,
                      cross: bool = False) -> Dict[str, Any]:
    d = cfg.d_model
    p = {"attn_norm": torch.zeros((d,), dtype=dt, device=device),
         "attn": init_attention(gen, cfg, dt, device),
         "mlp_norm": torch.zeros((d,), dtype=dt, device=device)}
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg, dt, device)
    else:
        p["mlp"] = _init_mlp(gen, cfg, dt, device)
    if cross:
        p["cross_norm"] = torch.zeros((d,), dtype=dt, device=device)
        p["cross"] = init_attention(gen, cfg, dt, device)
    return p


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
    _check_family(cfg)
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
    elif cfg.family == "encdec":
        params["enc_layers"] = _stack_init(
            cfg.num_encoder_layers,
            lambda: _init_dense_block(gen, cfg, dt, dev))
        params["enc_norm"] = torch.zeros((d,), dtype=dt, device=dev)
        params["layers"] = _stack_init(
            cfg.num_layers,
            lambda: _init_dense_block(gen, cfg, dt, dev, cross=True))
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
             positions: torch.Tensor, *, use_kernel: bool = False,
             remat: bool = False, enc_out: Optional[torch.Tensor] = None,
             arange_positions: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layers.  Returns (hidden, aux_loss): the moe aux loss summed
    over layers, 0 for the other families.  encdec needs ``enc_out``.
    ``arange_positions``: the caller states that ``positions`` are
    ``arange`` (``models.attention._attend`` may then run the training
    kernels, which mask by index).

    ``remat`` checkpoints each layer's body, as the reference does; the
    hybrid family also checkpoints each group of ``shared_attn_period``
    Mamba2 layers together with the shared block that follows it."""
    _check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unstack(params["layers"], cfg.num_layers)
    if cfg.family in ("ssm", "hybrid"):
        def mamba(h, p):
            h = h + mamba2_forward(p["mamba"], rms_norm(h, p["norm"]), cfg,
                                   use_kernel=use_kernel)
            return sctx.constrain(h, "residual")
        mamba = _remat(mamba, remat)
        if cfg.family == "ssm":
            h = x
            for p in layers:
                h = mamba(h, p)
            return h, aux
        per = cfg.shared_attn_period

        def group(h, g):
            for p in layers[g * per:(g + 1) * per]:
                h = mamba(h, p)
            return _block(params["shared"], h, cfg, positions, 0,
                          use_kernel, arange_positions=arange_positions)[0]
        group = _remat(group, remat)
        h = x
        for g in range(_shared_groups(cfg)):
            h = group(h, g)
        return h, aux
    if cfg.family == "encdec" and enc_out is None:
        raise ValueError("the encdec backbone needs the encoder output")

    def layer(p, h, window):
        h, aux_l = _block(p, h, cfg, positions, window, use_kernel,
                          use_rope=cfg.family != "encdec", enc_out=enc_out,
                          arange_positions=arange_positions)
        return sctx.constrain(h, "residual"), aux_l
    block = _remat(layer, remat)
    h = x
    for p, window in zip(layers, layer_windows(cfg)):
        h, aux_l = block(p, h, window=window)
        if aux_l is not None:
            aux = aux + aux_l
    return h, aux


def _block(p: Dict[str, Any], h: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, window: int, use_kernel: bool, *,
           causal: bool = True, use_rope: bool = True,
           enc_out: Optional[torch.Tensor] = None,
           arange_positions: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block over the full sequence (a decoder layer, the hybrid's
    shared block, a whisper encoder layer): self-attention, cross-attention
    to ``enc_out`` when given, then the MLP or the experts.  Each add
    inside the block (an attention's output bias and the residual add) goes
    with the norm that reads it (``add_rms_norm``); the block's last add
    stays a plain add.  Returns (h, moe aux loss or None)."""
    a = attention(p["attn"], rms_norm(h, p["attn_norm"]), cfg,
                  positions=positions, window=window, causal=causal,
                  use_rope=use_rope, use_kernel=use_kernel,
                  arange_positions=arange_positions)
    bias = out_bias(p["attn"], cfg)
    if enc_out is not None:
        h, x = add_rms_norm(h, a, p["cross_norm"], bias)
        a = attention(p["cross"], x, cfg, positions=positions,
                      kv_src=enc_out)
        bias = out_bias(p["cross"], cfg)
    h, x = add_rms_norm(h, a, p["mlp_norm"], bias)
    m, aux = _ffn(p, x, cfg)
    return h + m, aux


def encode(params: Dict[str, Any], cfg: ArchConfig, frames: torch.Tensor, *,
           use_kernel: bool = False, remat: bool = False) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, enc_len, d): sinusoidal
    positions, non-causal self-attention without rope, the final
    ``enc_norm``.  The output keeps the frames' dtype when it is the wider
    one, as JAX promotes (f32 frames through bf16 weights stay f32).
    ``remat`` checkpoints each layer's body."""
    B, T, d = frames.shape
    h = frames + _sinusoid(T, d, frames.device).to(frames.dtype)
    positions = torch.arange(T, device=frames.device).expand(B, T)
    block = _remat(functools.partial(
        _block, cfg=cfg, positions=positions, window=0,
        use_kernel=use_kernel, causal=False, use_rope=False,
        arange_positions=True), remat)
    for p in _unstack(params["enc_layers"], cfg.num_encoder_layers):
        h, _ = block(p, h)
    return rms_norm(h, params["enc_norm"])


class _EmbedLookup(torch.autograd.Function):
    """``weight[tokens]`` whose backward is ``embedding_dense_backward``
    (``F.embedding``'s) instead of the ``index_put`` that an indexing's
    backward runs.  The values are the indexing's.  Under the dry-run,
    DTensor shards both ops in every release it meets; torch 2.11 has no
    usable strategy for ``index_put``, and ``F.embedding`` itself leaves a
    vocab-parallel lookup's rows as a ``_MaskPartial`` that the next
    pointwise op refuses."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, tokens: torch.Tensor):
        ctx.save_for_backward(tokens)
        ctx.num_weights = weight.shape[0]
        return weight[tokens]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        return torch.ops.aten.embedding_dense_backward(
            grad, tokens, ctx.num_weights, -1, False), None


def _embed_lookup(weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return _EmbedLookup.apply(weight, tokens.long())


def embed_tokens(params: Dict[str, Any], cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = _embed_lookup(params["embed"], tokens)
    if cfg.family == "encdec":
        x = x + _sinusoid(tokens.shape[-1], cfg.d_model,
                          x.device).to(x.dtype)
    return x


def _head(params: Dict[str, Any], cfg: ArchConfig,
          h: torch.Tensor) -> torch.Tensor:
    """Final norm, then the (tied or separate) head: the logits in the
    activations' dtype."""
    h = rms_norm(h, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return einsum("bsd,dv->bsv", h, head)


def logits_fn(params: Dict[str, Any], cfg: ArchConfig,
              h: torch.Tensor) -> torch.Tensor:
    """Final norm, then the (tied or separate) head; f32 logits, soft-capped."""
    return softcap(_head(params, cfg, h).float(), cfg.final_softcap)


def forward_train(params: Dict[str, Any], cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor], *, use_kernel: bool = False,
                  remat: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token loss of one batch (the forward half of a train step) plus
    0.01 x the moe aux loss; encdec reads ``batch["frames"]``.  ``remat``
    (the reference's default) checkpoints every layer body of the encoder
    and the backbone while autograd records."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device).expand(tokens.shape)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encode(params, cfg, batch["frames"], use_kernel=use_kernel,
                         remat=remat)
    h, aux = backbone(params, cfg, x, positions, use_kernel=use_kernel,
                      remat=remat, enc_out=enc_out, arange_positions=True)
    # on CUDA the capped loss reads the head's logits in their own dtype
    # (one kernel forward and one backward); elsewhere softcap(.float())
    # and cross_entropy, as logits_fn and the reference compute them
    loss = capped_cross_entropy(_head(params, cfg, h), labels,
                                cfg.final_softcap, cfg.vocab_size)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device: Any = "cuda") -> Dict[str, Any]:
    """Zeroed caches, stacked on axis 0: ``kv`` (one per attention layer,
    or per call of the hybrid's shared block) at ``max_seq``, ``ssm``
    (conv window and state, one per Mamba2 layer), and for encdec
    ``cross_k``/``cross_v`` (L, B, max(max_seq // encoder_ratio, 1), nkv,
    hd) for the encoder K/V."""
    _check_family(cfg)
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
    if cfg.family == "encdec":
        enc_len = max(max_seq // cfg.encoder_ratio, 1)
        shape = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def _decode_block(p: Dict[str, Any], h: torch.Tensor, kv: Dict[str, Any],
                  pos: Position, cfg: ArchConfig, window: int,
                  cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  use_kernel: bool = False) -> torch.Tensor:
    """One block for one token against its KV cache: attention (no rope
    for encdec), cross-attention against ``cross`` = the cached encoder
    (K, V) for encdec, then the MLP or (moe, one dispatch group) the
    experts.  ``use_kernel`` sends both attentions to the decode kernel
    and the experts' dispatch to the MoE kernels.  The adds inside the
    block go with their norms (``add_rms_norm``), as in ``_block``."""
    a, _ = decode_attention(p["attn"], rms_norm(h, p["attn_norm"]), kv, pos,
                            cfg, window=window,
                            use_rope=cfg.family != "encdec",
                            use_kernel=use_kernel)
    bias = out_bias(p["attn"], cfg)
    if cross is not None:
        h, x = add_rms_norm(h, a, p["cross_norm"], bias)
        a = decode_cross_attention(p["cross"], x, cross[0], cross[1], cfg,
                                   use_kernel=use_kernel)
        bias = out_bias(p["cross"], cfg)
    h, x = add_rms_norm(h, a, p["mlp_norm"], bias)
    m, _ = _ffn(p, x, cfg, num_groups=1, use_kernel=use_kernel)
    return h + m


def decode_step(params: Dict[str, Any], cfg: ArchConfig,
                cache: Dict[str, Any], tokens: torch.Tensor,
                pos: Position, *, use_kernel: bool = False,
                state_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serve step: tokens (B,1) at position ``pos`` -> (logits, cache).

    ``pos`` is an int or a 0-d int64 tensor on the tokens' device, as the
    reference's is a traced array: the decode graph
    (``train.steps.DecodeGraph``) passes a buffer it refills every step.
    The step reads it on the device only, so it never synchronises.  The
    cache is updated in place and returned.  The SSM state is kept in
    f32 from the first step on, as in the reference (see
    ``ssm.mamba2_decode_step``): a cache whose state is still in the model's
    dtype gets a new f32 state tensor, or, given ``state_out`` (an f32
    tensor of the state's shape: a serve slot's, so that a captured first
    step writes at fixed addresses), writes the new state there and keeps
    its own, which a later prefill fills again.  encdec adds the sinusoid row
    ``pos`` of the cache's length (as the reference slices it).
    ``use_kernel`` sends every attention over a cache (self and cross)
    to the decode kernel (``kernels.ops.decode_attention``); the default
    is its plain version, the torch ops the dry-run traces."""
    _check_family(cfg)
    if cfg.family == "encdec":
        table = _sinusoid(cache["kv"]["k"].shape[2], cfg.d_model,
                          tokens.device)
        row = table.index_select(0, position(pos, tokens.device).view(1))
        h = (_embed_lookup(params["embed"], tokens)
             + row.to(params["embed"].dtype))
    else:
        h = embed_tokens(params, cfg, tokens)
    if cfg.family not in ("ssm", "hybrid"):
        for i, window in enumerate(layer_windows(cfg)):
            cross = ((cache["cross_k"][i], cache["cross_v"][i])
                     if cfg.family == "encdec" else None)
            h = _decode_block(_layer(params["layers"], i), h,
                              _layer(cache["kv"], i), pos, cfg, window,
                              cross, use_kernel)
        return logits_fn(params, cfg, h), cache
    ssm = cache["ssm"]
    states = ssm["state"]
    promoted = torch.promote_types(states.dtype, torch.float32)
    keep = states.dtype != promoted and state_out is not None
    if keep:
        states = state_out
    elif states.dtype != promoted:
        states = torch.empty_like(states, dtype=promoted)
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
                              pos, cfg, 0, use_kernel=use_kernel)
    if not keep:
        ssm["state"] = states
    return logits_fn(params, cfg, h), cache


def prefill(params: Dict[str, Any], cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], *, use_kernel: bool = False,
            max_seq: Optional[int] = None,
            cache: Optional[Dict[str, Any]] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the full prompt; return last-position logits + primed cache.

    The cache is allocated at ``max_seq`` (default: the prompt length)
    and filled in place, so decode continues in it without the copy the
    JAX serve makes when it pads the cache out.  A ``cache`` from the
    caller (``init_cache``'s tree, zeroed; the dry-run's is laid out as
    DTensors) is filled instead and ``max_seq`` is ignored.  encdec runs
    the encoder over ``batch["frames"]`` first; its K/V fill the first
    rows of the cross cache, whose rows past them stay zero."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    if cache is None:
        cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    if cfg.family in ("ssm", "hybrid"):
        h = _prime_ssm(params, cfg, x, positions, cache, use_kernel,
                       arange_positions=True)
    else:
        enc_out = None
        if cfg.family == "encdec":
            enc_out = encode(params, cfg, batch["frames"],
                             use_kernel=use_kernel)
            if enc_out.shape[1] > cache["cross_k"].shape[2]:
                raise ValueError(
                    f"{enc_out.shape[1]} encoder frames do not fit the "
                    f"cross cache's {cache['cross_k'].shape[2]} rows")
        h = _prime_kv(params, cfg, x, positions, cache, enc_out, use_kernel,
                      arange_positions=True)
    return logits_fn(params, cfg, h[:, -1:, :]), cache


def _prime_block(p: Dict[str, Any], h: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, cache: Dict[str, Any], j: int,
                 window: int, use_kernel: bool,
                 enc_out: Optional[torch.Tensor] = None, *,
                 arange_positions: bool = False) -> torch.Tensor:
    """One block over the prompt, writing its K/V into slot ``j`` of the
    stacked ``cache["kv"]`` (and, with ``enc_out``, the encoder K/V into
    slot ``j`` of the cross cache).  K/V are projected once and feed both
    the cache and the attention (JAX projects them twice)."""
    S = h.shape[1]
    xin = rms_norm(h, p["attn_norm"])
    q, k, v = _project_qkv(p["attn"], xin, cfg, positions,
                           use_rope=cfg.family != "encdec")
    cache["kv"]["k"][j, :, :S] = k
    cache["kv"]["v"][j, :, :S] = v
    out = _attend(q, k, v, cfg, positions, window, use_kernel,
                  arange_positions=arange_positions)
    a = _out_proj(p["attn"], out.to(h.dtype))
    bias = out_bias(p["attn"], cfg)
    if enc_out is not None:
        T = enc_out.shape[1]
        h, x = add_rms_norm(h, a, p["cross_norm"], bias)
        q, k, v = _project_qkv(p["cross"], x, cfg, None, kv_src=enc_out,
                               use_rope=False)
        # the cache holds the model's dtype; the prefill attends over the
        # unrounded K/V, as the reference does
        cache["cross_k"][j, :, :T] = k
        cache["cross_v"][j, :, :T] = v
        out = _attend(q, k, v, cfg, None, 0, False, causal=False)
        a = _out_proj(p["cross"], out.to(h.dtype))
        bias = out_bias(p["cross"], cfg)
    h, x = add_rms_norm(h, a, p["mlp_norm"], bias)
    m, _ = _ffn(p, x, cfg, use_kernel=use_kernel)
    return h + m


def _prime_kv(params, cfg, x, positions, cache, enc_out, use_kernel, *,
              arange_positions=False):
    """Run the layers once, writing each layer's K/V into the cache: the
    priming pass is the forward pass."""
    h = x
    for i, window in enumerate(layer_windows(cfg)):
        h = _prime_block(_layer(params["layers"], i), h, cfg, positions,
                         cache, i, window, use_kernel, enc_out,
                         arange_positions=arange_positions)
    return h


def _prime_ssm(params, cfg, x, positions, cache, use_kernel, *,
               arange_positions=False):
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
            h = _prime_block(params["shared"], h, cfg, positions, cache, g,
                             0, use_kernel,
                             arange_positions=arange_positions)
    return h
