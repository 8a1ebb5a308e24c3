"""Mixture-of-Experts layer: top-k routing + capacity dispatch.

PyTorch counterpart of ``repro/models/moe.py``.  The token -> expert
shuffle is DALiuGE's static re-grouping (keys known a priori: the
router's top-k), done as a scatter/gather pair with computed slot
positions instead of a one-hot dispatch einsum.

Dispatch is group-wise (GShard-style): tokens are viewed as (groups, S, d)
with per-group expert capacity C = S*top_k*capacity_factor/E.  The
reference computes all of it in plain ``jnp`` outside any Pallas kernel.
The serve steps on the card (``use_kernel=True``) run the glue between the
router's product and the experts, and between the experts and y, as
hand-written kernels (``kernels.moe_dispatch``: the routing in one launch,
the buffer written e-major, the combine); training, the dry-run's DTensors
and ``use_kernel=False`` keep the torch ops.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import (ArchConfig, activation_fn, dense_init, einsum,
                     gated_act)
from ..kernels import moe_dispatch as MD
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


def dispatch_ops(xg: torch.Tensor, idx: torch.Tensor, num_experts: int,
                 cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain route's dispatch of tokens xg (g, sg, d) to the top-k
    experts idx (g, sg, k): (buf (g, e, cap, d), pos (g, n), keep (g, n)),
    as torch ops that autograd and the dry-run's DTensors take."""
    g, sg, d = xg.shape
    k = idx.shape[-1]
    n = sg * k
    # --- slot positions within each expert's capacity ----------------------
    flat_idx = idx.reshape(g, n)
    pos, keep = MD.slot_positions(flat_idx, num_experts, cap)   # (g, n)
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
    buf = xg.new_zeros((g, num_experts * (cap + 1), d)).scatter_add(
        1, slot, vals)
    return buf.view(g, num_experts, cap + 1, d)[:, :, :cap], pos, keep


def moe_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
              num_groups: Optional[int] = None, use_kernel: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).

    ``num_groups``: dispatch groups (defaults to B).  Tokens within a group
    share one capacity budget; the assignment slots are taken in token
    order, top-1 before top-2 within a token, and those past an expert's
    capacity are dropped (they add nothing to y).  ``use_kernel`` runs the
    routing (softmax, top-k, gates, slot positions, aux loss), the dispatch
    and the combine through ``kernels.moe_dispatch`` (its kernels on CUDA,
    its plain versions on the CPU; no backward); else they are the torch
    ops autograd and the dry-run's DTensors take."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g = num_groups if num_groups else b
    tokens = b * s
    if tokens % g:
        raise ValueError(f"{tokens} tokens do not split into {g} groups")
    sg = tokens // g
    xg = x.reshape(g, sg, d)
    cap = expert_capacity(cfg, sg)

    # --- routing (f32) -----------------------------------------------------
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    if use_kernel:
        # softmax, top-k, gates, slot positions, the inverse map and the aux
        # loss in one launch; the buffer e-major, as the experts' einsums
        # batch it
        idx, gates, pos, keep, src, aux = MD.moe_route(logits, k, cap)
        buf = MD.moe_dispatch(xg, src)
    else:
        gates, idx, aux = MD.route_plain(logits, k)
        buf, pos, keep = dispatch_ops(xg, idx, e, cap)
    # the ep profile turns tokens to their experts here
    buf = sctx.constrain(buf, "moe_buffer")

    # --- expert FFN over the E stacked experts -----------------------------
    h = einsum("gecd,edf->gecf", buf, p["w1"])
    if cfg.activation in ("swiglu", "geglu"):
        h = gated_act(h, einsum("gecd,edf->gecf", buf, p["w3"]),
                      cfg.activation)
    else:
        h = activation_fn(cfg.activation)(h)
    out_buf = sctx.constrain(einsum("gecf,efd->gecd", h, p["w2"]),
                             "moe_buffer")

    # --- combine: gather back + gate-weighted sum over k -------------------
    combine = MD.moe_combine if use_kernel else MD.moe_combine_plain
    y = combine(out_buf, idx, pos, keep, gates, x.dtype)
    return y.reshape(b, s, d), aux
