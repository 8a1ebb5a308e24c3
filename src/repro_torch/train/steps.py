"""Step functions: microbatched train step, prefill and decode serve steps.

PyTorch counterpart of ``repro/train/steps.py``.  ``make_train_step``
builds the update in the reference's order:

  * grads of ``forward_train`` (remat per layer by default), accumulated
    over ``num_microbatches`` in f32 and then divided, as the reference's
    ``lax.scan`` does (one microbatch keeps the params' dtype),
  * optional int8 error-feedback compression of the grads,
  * global-norm clip, ``cosine_schedule(opt.step)``, AdamW.

``donate=True`` updates the state in place (the port's counterpart of
jitting the step with ``donate_argnums``): the clip factor is applied
slice by slice inside the AdamW update, so no f32 copy of the grads is
made.  It is what lets a 16-layer codeqwen1.5-7b step fit one 80 GB card.

Training runs attention and the SSD scan as torch ops (``use_kernel=False``,
as the reference trains): the hand-written kernels have no backward and
refuse inputs that require grad.

The serve steps are pure functions of (params, inputs) except that the
caches (KV and SSM) are updated in place; they are the payloads of the
serve Application Drops.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models import model as M
from ..models.common import ArchConfig, resolve_device
from ..optim import (AdamWState, adamw_init, adamw_update, adamw_update_,
                     clip_by_global_norm, cosine_schedule,
                     decompress_gradients, error_feedback_update)
from ..optim.adamw import clip_scale, global_norm
from ..tree import leaves, tree_map, unflatten_like


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    residual: Optional[Any]   # error-feedback residual (compression on)


def train_state_init(cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                     compress: bool = False, *,
                     device: Any = "cuda") -> TrainState:
    """Seeded params (``M.init_params``), zero f32 AdamW moments and, with
    ``compress``, a zero f32 residual, on ``device``."""
    params = M.init_params(cfg, gen, device=resolve_device(device))
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    residual = tree_map(zeros, params) if compress else None
    return TrainState(params, adamw_init(params), residual)


def _grads(loss_fn: Callable, params: Any, batch: Dict[str, torch.Tensor]
           ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads of loss wrt every param, in the params' dtype); a param
    the loss does not reach gets zeros, as ``jax.grad`` gives."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten_like(params, flat), batch)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)]
    return loss.detach(), unflatten_like(params, grads)


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows ``[i*b/n, (i+1)*b/n)`` of ``v``.  A DTensor keeps its batch's
    layout: DTensor replicates a slice of a sharded dim, which would make
    every rank run the whole microbatch, so the slice is laid out again
    (the reference's ``reshape`` is resharded by GSPMD the same way)."""
    m = v.shape[0] // n
    mb = v[i * m:(i + 1) * m]
    placements = getattr(v, "placements", None)
    if placements is not None and tuple(mb.placements) != tuple(placements):
        mb = mb.redistribute(v.device_mesh, placements)
    return mb


def make_train_step(cfg: ArchConfig, *, num_microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 1000, max_grad_norm: float = 1.0,
                    compress: bool = False, use_kernel: bool = False,
                    remat: bool = True, donate: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    hold ``loss``, ``grad_norm``, ``lr`` and ``step`` as device scalars.

    ``donate=True`` writes the new params and moments into ``state``'s
    tensors (the caller must not use the old state again)."""

    def loss_fn(params, mb):
        return M.forward_train(params, cfg, mb, use_kernel=use_kernel,
                               remat=remat)[0]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        if num_microbatches > 1:
            n = num_microbatches
            b = next(iter(batch.values())).shape[0]
            if b % n:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{n} microbatches")
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(n):
                mb = {k: _microbatch(v, i, n) for k, v in batch.items()}
                l, g = _grads(loss_fn, params, mb)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / n, gsum)
            loss = lsum / n
        else:
            loss, grads = _grads(loss_fn, params, batch)

        residual = state.residual
        if compress:
            if residual is None:
                raise ValueError("compress=True needs a state made with "
                                 "train_state_init(..., compress=True)")
            qs, scales, residual = error_feedback_update(grads, residual)
            grads = decompress_gradients(qs, scales)

        lr = cosine_schedule(state.opt.step, peak_lr=peak_lr,
                             warmup_steps=warmup_steps,
                             total_steps=total_steps)
        if donate:
            gnorm = global_norm(grads)
            new_params, new_opt = adamw_update_(
                params, grads, state.opt, lr=lr,
                scale=clip_scale(gnorm, max_grad_norm))
        else:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            new_params, new_opt = adamw_update(params, grads, state.opt,
                                               lr=lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": new_opt.step}
        return TrainState(new_params, new_opt, residual), metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, *, use_kernel: Optional[bool] = None
                      ) -> Callable:
    """``prefill_step(params, batch, max_seq=None) -> (next_tok, cache)``.

    ``batch`` holds ``tokens`` and, for encdec, ``frames``; it reaches
    ``prefill`` unchanged.  ``use_kernel=None`` sends prefill attention and the SSD scan to the
    hand-written kernels when the tokens are on CUDA and to the plain
    torch ops otherwise."""
    def prefill_step(params, batch: Dict[str, torch.Tensor],
                     max_seq: Optional[int] = None):
        kernel = (batch["tokens"].device.type == "cuda"
                  if use_kernel is None else use_kernel)
        with torch.inference_mode():
            logits, cache = M.prefill(params, cfg, batch, use_kernel=kernel,
                                      max_seq=max_seq)
            next_tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        return next_tok.to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """``decode_one(params, cache, tokens, pos) -> (next_tok (B,1), cache)``."""
    def decode_one(params, cache, tokens: torch.Tensor, pos: int):
        with torch.inference_mode():
            logits, cache = M.decode_step(params, cfg, cache, tokens, pos)
            next_tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        return next_tok.to(torch.int32)[:, None], cache
    return decode_one


def decode_fn(cfg: ArchConfig, params: Any, cache: Dict[str, Any],
              first_token: torch.Tensor, start_pos: int, steps: int):
    """Greedy multi-token decode loop (host-side driver for examples)."""
    step = make_decode_step(cfg)
    toks = [first_token]
    tok = first_token
    for i in range(steps):
        tok, cache = step(params, cache, tok, start_pos + i)
        toks.append(tok)
    return torch.cat(toks, dim=1), cache
