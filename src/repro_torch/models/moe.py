"""Mixture-of-Experts layer: top-k routing + capacity dispatch.

PyTorch counterpart of ``repro/models/moe.py``.  The token -> expert
shuffle is DALiuGE's static re-grouping (keys known a priori: the
router's top-k), done as a scatter/gather pair with computed slot
positions instead of a one-hot dispatch einsum.

Dispatch is group-wise (GShard-style): tokens are viewed as (groups, S, d)
with per-group expert capacity C = S*top_k*capacity_factor/E.  The
reference computes all of it in plain ``jnp`` outside any Pallas kernel,
so the port is torch ops throughout.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ArchConfig, activation_fn, dense_init, einsum
from ..sharding import ctx as sctx

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             device: torch.device) -> Params:
    """The router stays f32 whatever ``dtype`` is."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, d, device),
        "w1": dense_init(gen, (e, d, f), dtype, d, device),
        "w2": dense_init(gen, (e, f, d), dtype, f, device),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, (e, d, f), dtype, d, device)
    return p


def expert_capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)


def moe_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
              num_groups: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).

    ``num_groups``: dispatch groups (defaults to B).  Tokens within a group
    share one capacity budget; the assignment slots are taken in token
    order, top-1 before top-2 within a token, and those past an expert's
    capacity are dropped (they add nothing to y)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g = num_groups if num_groups else b
    tokens = b * s
    if tokens % g:
        raise ValueError(f"{tokens} tokens do not split into {g} groups")
    sg = tokens // g
    n = sg * k
    xg = x.reshape(g, sg, d)
    cap = expert_capacity(cfg, sg)

    # --- routing (f32) -----------------------------------------------------
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)             # (g, sg, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing aux loss (Switch/GShard): E * mean(frac_i * prob_i)
    me = probs.mean(dim=(0, 1))                           # (e,)
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    # --- slot positions within each expert's capacity ----------------------
    flat_idx = idx.reshape(g, n)
    pos_in_expert = F.one_hot(flat_idx, e).cumsum(dim=1) - 1   # (g, n, e)
    pos = pos_in_expert.gather(-1, flat_idx[..., None])[..., 0]
    keep = pos < cap
    # dropped slots go to a spare slot ``cap``, sliced off after the add
    # (the reference's scatter with mode="drop")
    pos_safe = torch.where(keep, pos, cap)

    # --- dispatch: buffer[g, e, c, d] via scatter-add ----------------------
    # over the flattened (expert, slot) axis: a kept slot receives exactly
    # one token (0 + x), the spare slots sum the dropped ones.  scatter_add
    # and its backward (gather) have DTensor strategies in every release
    # the dry-run meets; index_put_ has none in torch 2.11
    vals = xg.repeat_interleave(k, dim=1)                 # (g, n, d)
    slot = (flat_idx * (cap + 1) + pos_safe)[..., None].expand(g, n, d)
    buf = x.new_zeros((g, e * (cap + 1), d)).scatter_add(1, slot, vals)
    buf = buf.view(g, e, cap + 1, d)[:, :, :cap]
    # the ep profile turns tokens to their experts here
    buf = sctx.constrain(buf, "moe_buffer")

    # --- expert FFN over the E stacked experts -----------------------------
    h = einsum("gecd,edf->gecf", buf, p["w1"])
    if cfg.activation in ("swiglu", "geglu"):
        h = activation_fn(cfg.activation)(h) * einsum(
            "gecd,edf->gecf", buf, p["w3"])
    else:
        h = activation_fn(cfg.activation)(h)
    out_buf = sctx.constrain(einsum("gecf,efd->gecd", h, p["w2"]),
                             "moe_buffer")

    # --- combine: gather back + gate-weighted sum over k -------------------
    # the reference clamps the gather of a dropped slot, then masks it
    slot = (flat_idx * cap + pos_safe.clamp_max(cap - 1))[..., None]
    gathered = out_buf.reshape(g, e * cap, d).gather(1, slot.expand(g, n, d))
    gathered = torch.where(keep[..., None], gathered, 0.0)
    gathered = gathered.reshape(g, sg, k, d)
    y = torch.einsum("gskd,gsk->gsd", gathered.float(), gates).to(x.dtype)
    return y.reshape(b, s, d), aux
