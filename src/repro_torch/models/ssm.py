"""Mamba2 — State Space Duality (SSD), chunked scan + O(1) decode.

PyTorch counterpart of ``repro/models/ssm.py``.  The SSD "dual form"
(arXiv:2405.21060) computes the selective-SSM sequence mixing as
chunk-local attention-like products plus a small cross-chunk recurrence.
With ``use_kernel=True`` the chunked scan goes through
``kernels.ops.ssd_scan``, which launches the hand-written CUDA kernel for
CUDA tensors (and takes its plain version on the CPU).  The decode step
has no kernel in the reference and stays torch ops.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ArchConfig, dense_init, rms_norm

Params = Dict[str, torch.Tensor]


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                device: torch.device) -> Params:
    """``A_log``, ``D`` and ``dt_bias`` stay f32 whatever ``dtype`` is."""
    d = cfg.d_model
    di, n, g, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * g * n + h), dtype, d,
                              device),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dtype,
                             cfg.ssm_conv, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((h,), dtype=f32, device=device),
        "D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, di, device),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, n, g = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_groups
    z, x, bc, dt = torch.split(
        zxbcdt, [di, di, 2 * g * n, zxbcdt.shape[-1] - 2 * di - 2 * g * n],
        dim=-1)
    b_, c_ = bc.chunk(2, dim=-1)
    return z, x, b_, c_, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B,S,C), w: (W,C).

    The W-1 leading zeros are a concatenated zero block, not ``F.pad``:
    the same values, and an op that DTensor shards in every release the
    dry-run meets (torch 2.11 fails inside ``constant_pad_nd``)."""
    wsz, s = w.shape[0], x.shape[1]
    zeros = x.new_zeros((x.shape[0], wsz - 1, x.shape[2]))
    xp = torch.cat([zeros, x], dim=1)
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(wsz))
    return F.silu(out + b)


class _CumSum(torch.autograd.Function):
    """``torch.cumsum`` along ``dim`` whose backward reverses the grad with
    ``gather`` where cumsum's own backward runs ``flip`` (reverse, cumsum,
    reverse): the same values.  Under the dry-run, DTensor in torch 2.11
    has no strategy for ``flip``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int):
        ctx.dim = dim
        return torch.cumsum(x, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        dim, n = ctx.dim, grad.shape[ctx.dim]
        shape = [1] * grad.ndim
        shape[dim] = n
        rev = torch.arange(n - 1, -1, -1, device=grad.device).view(
            shape).expand(grad.shape)
        return grad.gather(dim, rev).cumsum(dim).gather(dim, rev), None


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_: torch.Tensor, c_: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual-form scan.

    x: (B,S,H,P)   dt: (B,S,H)   a: (H,) negative decay rates
    b_, c_: (B,S,G,N) with G groups broadcast over H heads.
    Returns (y: (B,S,H,P), final_state: (B,H,N,P)).

    The torch path keeps the reference's dtypes (y in f32, the states
    that feed the next chunk rounded to x's dtype) and walks the chunks in
    a loop where the reference runs an associative scan: the same sums in
    another order."""
    B, S, H, P = x.shape
    G, N = b_.shape[2], b_.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc, Q = S // chunk, chunk
    rep = H // G

    if use_kernel:
        from ..kernels import ops as kops
        return kops.ssd_scan(x, dt, a, b_, c_, chunk,
                             initial_state=initial_state)

    f32 = torch.float32
    xc = x.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H)                      # already softplus'ed
    bc = b_.reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)
    cc = c_.reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)

    cum = _CumSum.apply(dtc * a, 2)                        # (B,nc,Q,H)

    # ---- intra-chunk (the "attention-like" quadratic term) -------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j; selected, since i < j overflows
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri[None, None, :, :, None],
                    torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]),
                    0.0)                                   # (B,nc,Q,Q,H)
    scores = torch.einsum("bnihk,bnjhk->bnijh", cc, bc)    # x's dtype
    att = scores.to(f32) * L * dtc[:, :, None, :, :]       # weight by dt_j
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", att, xc.to(f32))

    # ---- chunk states ---------------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,nc,Q,H)
    weighted_x = xc.to(f32) * (dtc * decay_to_end)[..., None]
    states = torch.einsum("bnqhk,bnqhp->bnhkp", bc.to(f32), weighted_x)

    # ---- inter-chunk recurrence, one chunk after the other ---------------
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    h = (initial_state if initial_state is not None
         else torch.zeros((B, H, N, P), dtype=x.dtype,
                          device=x.device)).to(f32)
    h_prevs = []
    for i in range(nc):
        h_prevs.append(h.to(x.dtype))
        h = chunk_decay[:, i, :, None, None] * h + states[:, i]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B,nc,H,N,P)

    # ---- inter-chunk contribution ----------------------------------------
    y_inter = torch.einsum("bnqhk,bnhkp->bnqhp",
                           cc.to(f32) * torch.exp(cum)[..., None],
                           h_prev.to(f32))
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, h.to(x.dtype)


def mamba2_prime(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 use_kernel: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 mixer that also returns what decode continues
    from.  x: (B,S,d) -> (out (B,S,d), conv input (B,S,C) whose last
    ``ssm_conv - 1`` rows are the conv window, final SSM state (B,H,N,P) in
    x's dtype)."""
    B, S, _ = x.shape
    di, n, g, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    P = cfg.ssm_headdim
    zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xin, b_, c_, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, b_, c_], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xin, b_, c_ = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, h, P)
    y, state = ssd_chunked(xh, dt, a, b_.reshape(B, S, g, n),
                           c_.reshape(B, S, g, n), min(cfg.ssm_chunk, S),
                           use_kernel=use_kernel)
    y = (y + xh * p["D"][None, None, :, None]).to(x.dtype)
    y = rms_norm(y.reshape(B, S, di) * F.silu(z), p["norm"])
    return torch.einsum("bsk,kd->bsd", y, p["out_proj"]), conv_in, state


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                   use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 mixer.  x: (B,S,d) -> (B,S,d)."""
    return mamba2_prime(p, x, cfg, use_kernel)[0]


# ---------------------------------------------------------------------------
# Decode (O(1) per token)
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Params:
    di, n, g = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_groups
    h, P = cfg.ssm_heads, cfg.ssm_headdim
    conv_ch = di + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, h, n, P), dtype=dtype, device=device),
    }


def mamba2_decode_step(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,d) one token; cache: conv window + SSM state.

    Returns fresh tensors.  As in the reference, the new state is f32
    whatever the cache's dtype: a bf16 cache times the f32 decay promotes,
    and only this step's update is rounded to the cache's dtype."""
    B = x.shape[0]
    di, n, g = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_groups
    h, P = cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xin, b_, c_, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, b_, c_], dim=-1)[:, 0]              # (B,C)
    window = torch.cat([cache["conv"], conv_in[:, None]], dim=1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                      + p["conv_b"])
    new_conv = window[:, 1:]
    xin, b_, c_ = torch.split(conv_out, [di, g * n, g * n], dim=-1)

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])             # (B,h)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)                                     # (B,h)
    rep = h // g
    bh = b_.reshape(B, g, n).repeat_interleave(rep, dim=1)        # (B,h,n)
    ch = c_.reshape(B, g, n).repeat_interleave(rep, dim=1)
    xh = xin.reshape(B, h, P)
    old = cache["state"]
    upd = torch.einsum("bhk,bhp->bhkp", bh.float() * dt[..., None],
                       xh.float()).to(old.dtype)
    state = old * decay[..., None, None] + upd
    y = torch.einsum("bhk,bhkp->bhp", ch.float(), state.float())
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return out, {"conv": new_conv, "state": state}

