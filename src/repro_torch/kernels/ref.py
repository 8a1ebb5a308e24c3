"""Plain PyTorch oracles for the hand-written kernels (the allclose truth)
and the model's attention math that the plain routes share."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


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


def gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,nq,hd), k: (B,T,nkv,hd) -> scores (B,nkv,G,S,T), f32: the
    model's attention scores (prefill and decode), GQA by reshape."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return scores / math.sqrt(hd)


def gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,nkv,G,S,T), v: (B,T,nkv,hd) -> (B,S,nq,hd), f32."""
    b, nkv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, nkv * g, -1)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: Optional[torch.Tensor], *, causal: bool = True,
                   window: int = 0, logit_cap: float = 0.0) -> torch.Tensor:
    """The model's full-sequence attention core, q (B,S,nq,hd) over k/v
    (B,T,nkv,hd) -> (B,S,nq,hd) f32: the scores (``gqa_scores``), the cap,
    -1e30 where the mask hides a pair, an f32 softmax, the product with v.
    The causal and window masks compare q's and k's ``positions`` (B,S)
    (self-attention); with neither, every key is visible and ``positions``
    is not read (cross-attention).  The plain route of
    ``models.attention._attend`` and the training kernels' plain version
    (``kernels.train_attention``)."""
    scores = softcap(gqa_scores(q, k), logit_cap)
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
    return gqa_out(probs, v)


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


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (exact) SSD recurrence.

    x: (B,H,S,P); dt: (B,H,S); a: (H,); b/c: (B,H,S,N).
    h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t . h_t
    Returns (y: (B,H,S,P), final_state: (B,H,N,P)), both in x's dtype;
    the state is carried in f32."""
    B, H, S, P = x.shape
    N = b.shape[-1]
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((B, H, N, P), dtype=torch.float32,
                          device=x.device))
    xf, dtf, af, bf, cf = (t.float() for t in (x, dt, a, b, c))
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, :, t] * af[None, :])              # (B,H)
        upd = torch.einsum("bhn,bhp->bhnp", bf[:, :, t],
                           xf[:, :, t] * dtf[:, :, t][..., None])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, :, t], h))
    return torch.stack(ys, dim=2).to(x.dtype), h.to(x.dtype)
