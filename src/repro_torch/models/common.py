"""Shared model substrate: configs, norms, rope, activations, losses.

PyTorch counterpart of ``repro/models/common.py``.  Params are plain
nested dicts of tensors (the same keys and shapes as the JAX pytree), and
every function here is a pure function of its tensor arguments, so the
Application Drops that wrap the serve steps stay stateless (paper §3.1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a box
    without it raises: nothing silently drops to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (exact published numbers in configs/)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention details
    rope_theta: float = 10000.0
    local_window: int = 0          # 0 -> full attention
    alternate_local_global: bool = False   # gemma2: even layers local
    attn_softcap: float = 0.0      # gemma2 logit soft-capping
    final_softcap: float = 0.0
    qk_norm: bool = False          # chameleon
    use_bias: bool = False
    activation: str = "swiglu"     # swiglu | gelu | relu2
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # hybrid (zamba2): one shared attention block applied every N layers
    shared_attn_period: int = 0
    # enc-dec (whisper)
    num_encoder_layers: int = 0
    encoder_ratio: int = 8         # enc_len = seq_len // ratio (stub frontend)
    # systems knobs
    dtype: str = "bfloat16"
    sharding_strategy: str = "dp"  # dp | fsdp
    subquadratic: bool = False     # eligible for long_500k
    notes: str = ""

    # -- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS and reporting)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * hd * nq + 2 * d * hd * nkv + hd * nq * d
        if self.activation in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            mlp_total = self.num_experts * mlp + d * self.num_experts
        else:
            mlp_total = mlp
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, n, g = self.ssm_inner, self.ssm_state, self.ssm_groups
            h = self.ssm_heads
            in_proj = d * (2 * di + 2 * g * n + h)
            conv = (di + 2 * g * n) * self.ssm_conv
            ssm = in_proj + conv + di * d + di + 2 * h  # out, norm, A/D
        per_layer: float
        if self.family == "ssm":
            per_layer = ssm + d            # + norm
        elif self.family == "hybrid":
            per_layer = ssm + 2 * d
        else:
            per_layer = attn + mlp_total + 2 * d
        total = self.num_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_period:
            total += attn + mlp_total + 2 * d   # one shared block
        if self.family == "encdec":
            enc = self.num_encoder_layers * (attn + mlp_total + 2 * d)
            dec_cross = self.num_layers * (attn + d)   # cross-attn per layer
            total += enc + dec_cross
        total += v * d                      # embedding
        if not self.tie_embeddings:
            total += v * d                  # lm head
        total += d                          # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe" or not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = (3 if self.activation in ("swiglu", "geglu") else 2) * d * f
        dead = self.num_layers * (self.num_experts - self.top_k) * mlp
        return int(self.param_count() - dead)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's dtype promotion.

    ``jnp.einsum`` promotes mixed operands (bf16 with f32 gives f32: the
    whisper encoder's f32 frames against bf16 weights); ``torch.einsum``
    raises on them.  Operands of one dtype pass through uncast."""
    dt = operands[0].dtype
    for t in operands[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(equation, *(t.to(dt) for t in operands))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to approximate=True, the tanh form
    return F.gelu(x, approximate="tanh")


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("swiglu", "geglu"):   # gated: handled at call sites
        return F.silu if name == "swiglu" else _gelu_tanh
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":   # nemotron squared-ReLU
        return _relu2
    raise ValueError(f"unknown activation {name!r}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)``.  A plain tensor outside autograd takes the
    tanh and the scaling in place on the quotient: the same values, one
    full-size temporary fewer (the plain-route prefill's f32 scores are
    8.6 GB a sequence and layer call at gemma2-27b's 8192 tokens)."""
    if not cap:
        return x
    if type(x) is torch.Tensor and not (torch.is_grad_enabled()
                                        and x.requires_grad):
        return x.div(cap).tanh_().mul_(cap)
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python-scalar base: no host-to-device copy (and sync) per call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Split-half rotation, computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs         # (..., S, hd/2)
    angles = angles[..., None, :]                         # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(emb, dtype=torch.float32, device=device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean CE over tokens; logits (..., V) fp32-accumulated; labels (...).

    Labels outside ``[0, vocab_size)`` are masked out of the mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    idx = labels.clamp(0, logits.shape[-1] - 1)
    gold = torch.gather(logits, -1, idx[..., None])         # (..., 1)
    mask = (labels >= 0) & (labels < vocab_size)
    # the gold axis goes after the subtraction: DTensor cannot drop an
    # axis of a gather from vocab-sharded logits before it is reduced
    loss = (lse[..., None] - gold)[..., 0] * mask
    return loss.sum() / mask.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# Initialisation helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype: torch.dtype, fan_in: Optional[int] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """N(0, 1/fan_in) draws from ``gen``, made in f32 then cast.

    ``gen`` must live on ``device``.  Draws differ from ``jax.random``, so
    cross-framework checks bridge weights instead of re-drawing them."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device if device is not None else gen.device)
    return (w * std).to(dtype)
