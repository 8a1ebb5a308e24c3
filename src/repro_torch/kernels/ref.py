"""Plain PyTorch oracles for the hand-written kernels (the allclose truth)."""
from __future__ import annotations

import math

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  logit_cap: float = 0.0) -> torch.Tensor:
    """q: (B,Hq,Sq,D); k/v: (B,Hkv,Sk,D) -> (B,Hq,Sq,D).  GQA by head map.

    Computed in f32 and cast back to q's dtype.  Masked scores are -1e30,
    so a row with no visible key averages V uniformly, as in the JAX
    oracle."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=1)
    vx = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) / math.sqrt(d)
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= (rows - cols) < window
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.float())
    return out.to(q.dtype)
