"""Step functions: microbatched train step, prefill and decode serve steps.

PyTorch counterpart of ``repro/train/steps.py``.  ``make_train_step``
builds the update in the reference's order:

  * grads of ``forward_train`` (remat per layer by default), accumulated
    over ``num_microbatches`` in f32 and then divided, as the reference's
    ``lax.scan`` does (one microbatch keeps the params' dtype),
  * optional int8 error-feedback compression of the grads,
  * global-norm clip, ``cosine_schedule(opt.step)``, AdamW.

The clip factor is applied inside the AdamW update on both branches, so
no f32 copy of the grads is made.  ``donate=True`` updates the state in
place, the step counter and the error-feedback residual included (the
port's counterpart of jitting the step with ``donate_argnums``); it is
what lets a 16-layer codeqwen1.5-7b step fit one 80 GB card.

On CUDA the whole step is captured once as a CUDA graph and replayed
(``TrainGraph``), the port's counterpart of the reference's
``jax.jit(make_train_step(...))``: forward, rematerialised backward,
microbatch accumulation, compression, the norm, the clip, the schedule,
AdamW and the step counter, with no host work inside it.

On CUDA the global norm and the update are the two hand-written kernels of
``kernels/optimizer.py`` (``sumsq`` once a grad, ``adamw_update`` once a
leaf), and every full-sequence attention of ``forward_train`` (a call
autograd records) runs the training attention kernels of
``kernels/train_attention.py``: a forward launch a layer, a second under
remat's recompute, and the backward's launches.  Those are the
counterparts of what XLA fuses under the reference's ``jax.jit``; on the
CPU, and on the dry-run's meta DTensors, their plain versions run.  The
step trains with ``use_kernel=False``, as the reference does: the serve
kernels (flash, the SSD scan, decode) have no backward and refuse inputs
that require grad, and Mamba2's scan trains as torch ops.

The serve steps are pure functions of (params, inputs) except that the
caches (KV and SSM) are updated in place; they are the payloads of the
serve Application Drops.  On CUDA the decode step is captured once per
cache as a CUDA graph and replayed (``DecodeGraph``), the counterpart of
the reference's jitted decode step, and its attention over the caches is
the hand-written decode kernel (``kernels.decode_attention``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models import model as M
from ..models.common import ArchConfig, resolve_device
from ..optim import (AdamWState, adamw_init, adamw_update, adamw_update_,
                     cosine_schedule, decompress_gradients,
                     error_feedback_update)
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


def _train_fn(cfg: ArchConfig, *, num_microbatches: int, peak_lr: float,
              warmup_steps: int, total_steps: int, max_grad_norm: float,
              compress: bool, use_kernel: bool, remat: bool) -> Callable:
    """The eager step, ``step(state, batch, donate) -> (state, metrics)``:
    what ``make_train_step`` runs, or captures."""

    def loss_fn(params, mb):
        return M.forward_train(params, cfg, mb, use_kernel=use_kernel,
                               remat=remat)[0]

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             donate: bool) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
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
            qs, scales, new_residual = error_feedback_update(grads, residual)
            grads = decompress_gradients(qs, scales)
            if donate:
                for r, new in zip(leaves(residual), leaves(new_residual)):
                    r.copy_(new)
            else:
                residual = new_residual
            del new_residual

        lr = cosine_schedule(state.opt.step, peak_lr=peak_lr,
                             warmup_steps=warmup_steps,
                             total_steps=total_steps)
        gnorm = global_norm(grads)
        update = adamw_update_ if donate else adamw_update
        new_params, new_opt = update(params, grads, state.opt, lr=lr,
                                     scale=clip_scale(gnorm, max_grad_norm))
        # a copy: a donated step advances ``new_opt.step`` in place
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": new_opt.step.clone()}
        return TrainState(new_params, new_opt, residual), metrics

    return step


def make_train_step(cfg: ArchConfig, *, num_microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 1000, max_grad_norm: float = 1.0,
                    compress: bool = False, use_kernel: bool = False,
                    remat: bool = True, donate: bool = False,
                    graph: Optional[bool] = None) -> "TrainStep":
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    hold ``loss``, ``grad_norm``, ``lr`` and ``step`` as device scalars
    (``step`` a copy of the state's).

    ``donate=True`` writes the new params, moments, step and residual into
    ``state``'s tensors (the caller must not use the old state again);
    else the state is left as it was and the new one is new tensors.

    ``graph=None`` runs the step through a CUDA graph (``TrainGraph``)
    when the params are CUDA tensors, and eagerly on the CPU and on meta
    tensors (the dry-run's DTensors among them); ``True`` always through
    a graph, and raises for params elsewhere; ``False`` eagerly on any
    device.  The first step on a (state, batch shapes) pair is an eager
    step that also captures the graph; later steps replay it.  A donated
    step's graph belongs to the state it was captured on: another state,
    or other batch shapes, capture anew.  ``train_step.close()`` frees
    the graph."""
    fn = _train_fn(cfg, num_microbatches=num_microbatches, peak_lr=peak_lr,
                   warmup_steps=warmup_steps, total_steps=total_steps,
                   max_grad_norm=max_grad_norm, compress=compress,
                   use_kernel=use_kernel, remat=remat)
    return TrainStep(fn, graph, donate)


# ---------------------------------------------------------------------------
# CUDA graphs
# ---------------------------------------------------------------------------

# one capture at a time: concurrent captures from several threads (the
# serve driver's decode apps) are a path PyTorch's caching allocator and
# generators exercise little, and a capture holds the GIL for most of its
# time anyway.  Other threads' eager work and replays go on meanwhile.
_CAPTURE_LOCK = threading.Lock()
_COUNTS_LOCK = threading.Lock()     # DecodeGraph.counts, TrainGraph.counts
# the stream each device captures on, used only under _CAPTURE_LOCK: one
# stream, not one a graph or a thread, because cuBLAS keeps a workspace
# (32 MiB on Hopper) for each (thread's handle, stream) pair it meets and
# never frees it
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def _capture(graph: "torch.cuda.CUDAGraph", dev: torch.device,
             fn: Callable, *args: Any, pool: Optional[tuple] = None
             ) -> Tuple[Any, float]:
    """``fn(*args)`` captured into ``graph``: (what it returned, the
    capture's ms).  One capture at a time, on the device's capture
    stream, after the caching allocator's free blocks are released (as
    ``torch.cuda.graph`` does: the graph's private pool takes new segments
    from free memory, and a capture cannot release the cached blocks of
    the others), in ``thread_local`` error mode: another thread's
    synchronise or copy to the host neither fails nor invalidates it.
    Work that ``fn`` hands to autograd's device thread lands in the same
    capture and pool (autograd runs a backward op on its forward's
    stream).  ``pool``: a memory pool shared with other graphs
    (``GraphPool``), else the graph's own.  A failed capture raises."""
    with _CAPTURE_LOCK:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn(*args)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        return out, (time.perf_counter() - t0) * 1e3


def _batch_key(batch: Dict[str, torch.Tensor]) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in
                 sorted(batch.items()))


def _state_key(state: TrainState) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(state))


class TrainGraph:
    """One train step captured as a CUDA graph and replayed every later
    step: the port's counterpart of the reference's
    ``jax.jit(make_train_step(...))``.  The graph holds the whole step
    (forward, rematerialised backward, microbatch accumulation,
    compression, the norm, the clip, the schedule, AdamW and the step
    counter); the step reads its scalars on the device, so nothing in it
    waits for the host.

    Made by the first step on a (state, batch shapes) pair, which runs
    eagerly on the caller's stream and is a real step (``first``): it
    loads the kernels and makes every lazily made tensor the graph reads
    (the kernels' tickets, sinusoid tables), so that they are allocated
    before the capture and outlive the graph's private pool.  The capture
    (``_capture``) reads the batch from static buffers, updates a state in
    place (the donating step: AdamW, the step counter and the residual
    written into their tensors) and writes the metrics into static
    outputs.

    ``donate=True``: the state updated is the caller's, so the graph
    belongs to that state (``takes``).  ``donate=False`` (the engine's
    write-once Drops): the graph owns a state of the same shapes; a
    replay copies the caller's state into it, replays, and returns fresh
    copies, so the caller's state is never written.  A failed capture or
    replay raises: nothing falls back to the eager step.

    ``counts`` tallies captures and replays process-wide."""

    counts = {"captures": 0, "replays": 0}

    def __init__(self, step: Callable, state: TrainState,
                 batch: Dict[str, torch.Tensor], donate: bool):
        dev = leaves(state.params)[0].device
        self.donate, self.replays = donate, 0
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype,
                                     device=dev).copy_(v)
                      for k, v in batch.items()}
        self.batch_key = _batch_key(batch)
        self.first = step(state, self.batch, donate)
        self.state = state if donate else tree_map(torch.empty_like, state)
        self.leaves = leaves(self.state)
        self.state_key = _state_key(self.state)
        self.graph = torch.cuda.CUDAGraph()
        (_, self.metrics), self.capture_ms = _capture(
            self.graph, dev, step, self.state, self.batch, True)
        with _COUNTS_LOCK:
            TrainGraph.counts["captures"] += 1

    def takes(self, state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> bool:
        """Whether a replay computes this step: the batch's shapes and
        dtypes are the capture's, and the state is the one captured
        (donating) or one of its shapes (not donating)."""
        if _batch_key(batch) != self.batch_key:
            return False
        if self.donate:
            now = leaves(state)
            return len(now) == len(self.leaves) and all(
                a is b for a, b in zip(now, self.leaves))
        return _state_key(state) == self.state_key

    def replay(self, state: TrainState, batch: Dict[str, torch.Tensor]
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The step on ``state`` and ``batch`` (see ``takes``); the metrics
        are copies, since the next replay overwrites the static outputs."""
        if not self.donate:
            for dst, src in zip(self.leaves, leaves(state)):
                dst.copy_(src)
        for k, v in self.batch.items():
            v.copy_(batch[k])
        self.graph.replay()
        with _COUNTS_LOCK:
            TrainGraph.counts["replays"] += 1
        self.replays += 1
        metrics = {k: v.clone() for k, v in self.metrics.items()}
        if self.donate:
            return state, metrics
        return tree_map(torch.clone, self.state), metrics

    def release(self) -> None:
        """Free the graph, its pool's tensors and, not donating, its own
        state."""
        del self.graph, self.metrics, self.state, self.leaves, self.batch


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)`` (see
    ``make_train_step``); ``graph`` the current ``TrainGraph`` or None."""

    def __init__(self, fn: Callable, graph: Optional[bool], donate: bool):
        self.fn, self.use_graph, self.donate = fn, graph, donate
        self.graph: Optional[TrainGraph] = None

    def on_graph(self, state: TrainState) -> bool:
        """Whether a step on ``state`` goes through a CUDA graph."""
        p = leaves(state.params)[0]
        cuda = (p.device.type == "cuda"
                and getattr(p, "placements", None) is None)
        if self.use_graph and not cuda:
            raise ValueError("make_train_step(graph=True) captures a CUDA "
                             f"graph; the params are on {p.device}")
        return cuda if self.use_graph is None else bool(self.use_graph)

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if not self.on_graph(state):
            return self.fn(state, batch, self.donate)
        g = self.graph
        if g is None or not g.takes(state, batch):
            self.close()
            g = self.graph = TrainGraph(self.fn, state, batch, self.donate)
            first, g.first = g.first, None
            return first
        return g.replay(state, batch)

    def close(self) -> None:
        """Release the graph, if any (the next step captures anew)."""
        if self.graph is not None:
            self.graph.release()
        self.graph = None


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def _clear_unwritten(cfg: ArchConfig, cache: Dict[str, Any], s: int,
                     t: int) -> None:
    """Zero the rows of a cache that a prefill of ``s`` tokens (and ``t``
    encoder frames) does not write: the KV rows past ``s``, the conv
    window's rows before a prompt shorter than it, the cross rows past
    ``t``.  A reused cache (a serve slot's) then holds after the prefill
    the bits of a fresh zeroed one, whatever the last microbatch's decode
    steps left in it; whisper's decode attends over the zero cross rows,
    as the reference's padded cache makes it."""
    if "kv" in cache:
        for t_ in cache["kv"].values():
            t_[:, :, s:].zero_()
    if "ssm" in cache:
        width = cfg.ssm_conv - 1
        cache["ssm"]["conv"][:, :, :width - min(s, width)].zero_()
    for name in ("cross_k", "cross_v"):
        if name in cache:
            cache[name][:, :, t:].zero_()


def _prefill(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor],
             cache: Optional[Dict[str, Any]], use_kernel: bool,
             max_seq: Optional[int] = None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One prefill: (next token (B,) int32, the cache).  A given ``cache``
    is filled in place, its unwritten rows zeroed first; else a zeroed one
    is made at ``max_seq``."""
    if cache is not None:
        frames = batch.get("frames")
        _clear_unwritten(cfg, cache, batch["tokens"].shape[1],
                         0 if frames is None else frames.shape[1])
    logits, cache = M.prefill(params, cfg, batch, use_kernel=use_kernel,
                              max_seq=max_seq, cache=cache)
    next_tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
    return next_tok.to(torch.int32), cache


class GraphPool:
    """The memory pool of a ``PrefillStep``'s graphs: one a step, unless
    several steps share one (a serve call's slots, a prefill graph each),
    so that their transients take the most one of them needs, not the sum:
    a prefill graph at gemma2-27b's 2 x 8192 tokens keeps several GB of
    activations in its pool.  Graphs that share a pool
    must not run at once, so each replay waits on the device for the one
    before it (``before``, ``after``: an event recorded on the replaying
    thread's stream), whichever thread and stream replay them.  The pool
    is freed with the last graph in it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.handle: Optional[tuple] = None
        self.last: Optional["torch.cuda.Event"] = None

    def pool(self) -> tuple:
        """The pool's handle, made on first use."""
        with self.lock:
            if self.handle is None:
                self.handle = torch.cuda.graph_pool_handle()
            return self.handle

    def before(self, dev: torch.device) -> None:
        if self.last is not None:
            torch.cuda.current_stream(dev).wait_event(self.last)

    def after(self, dev: torch.device) -> None:
        self.last = torch.cuda.Event()
        self.last.record(torch.cuda.current_stream(dev))


class PrefillGraph:
    """One cache's prefill, captured once as a CUDA graph and replayed for
    every later prompt of the same shapes: the port's counterpart of the
    reference's ``jax.jit(make_prefill_step(cfg))``.

    Made by the first prefill on a (params, cache, batch shapes), which
    runs eagerly on the caller's stream and is a real prefill (``first``):
    it loads the kernels and makes what they allocate lazily (the MoE
    route's scratch, the SSD scan's library) before the capture.  The
    capture (``_capture``) reads the batch from static inputs (``tokens``
    and, for encdec, ``frames``), zeroes the cache's unwritten rows, fills
    the cache in place at its addresses and writes the next token into a
    static output.  Nothing in it waits for the host: the prefill's shapes
    and windows are Python ints from the config and the prompt's shape.
    The graph captures into ``pool`` (a ``GraphPool``) and its replays
    take their turn there.  A failed capture or replay raises.

    ``counts`` tallies captures and replays process-wide."""

    counts = {"captures": 0, "replays": 0}

    def __init__(self, cfg: ArchConfig, params, batch: Dict[str, torch.Tensor],
                 cache: Dict[str, Any], use_kernel: bool, pool: GraphPool):
        dev = batch["tokens"].device
        self.params, self.cache, self.pool = params, cache, pool
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.batch_key = _batch_key(batch)
        self.first, _ = _prefill(cfg, params, self.batch, cache, use_kernel)
        self.graph = torch.cuda.CUDAGraph()
        (self.next, _), self.capture_ms = _capture(
            self.graph, dev, _prefill, cfg, params, self.batch, cache,
            use_kernel, pool=pool.pool())
        with _COUNTS_LOCK:
            PrefillGraph.counts["captures"] += 1

    def takes(self, params, batch: Dict[str, torch.Tensor],
              cache: Dict[str, Any]) -> bool:
        """Whether a replay computes this prefill: the params and the cache
        are the capture's, the batch of its shapes and dtypes."""
        return (params is self.params and cache is self.cache
                and _batch_key(batch) == self.batch_key)

    def replay(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The next token (B,) int32 after ``batch``'s prompt, the cache
        filled; a clone, since the next replay overwrites the output."""
        for k, v in self.batch.items():
            v.copy_(batch[k])
        with self.pool.lock:
            self.pool.before(self.next.device)
            self.graph.replay()
            out = self.next.clone()
            self.pool.after(self.next.device)
        with _COUNTS_LOCK:
            PrefillGraph.counts["replays"] += 1
        return out

    def release(self) -> None:
        """Free the graph and its pool's tensors."""
        del self.graph, self.next, self.batch, self.params, self.cache
        self.pool = None


class PrefillStep:
    """``prefill_step(params, batch, max_seq=None, cache=None) ->
    (next_tok (B,) int32, cache)`` (see ``make_prefill_step``); ``graph``
    the current ``PrefillGraph`` or None; ``pool`` the ``GraphPool`` its
    graphs capture into."""

    def __init__(self, cfg: ArchConfig, graph: Optional[bool],
                 use_kernel: Optional[bool], pool: GraphPool):
        self.cfg, self.use_graph, self.use_kernel = cfg, graph, use_kernel
        self.pool = pool
        self.graph: Optional[PrefillGraph] = None

    def on_graph(self, tokens: torch.Tensor) -> bool:
        """Whether a prefill of ``tokens`` into a cache goes through a CUDA
        graph."""
        cuda = tokens.device.type == "cuda"
        if self.use_graph and not cuda:
            raise ValueError("make_prefill_step(graph=True) captures a CUDA "
                             f"graph; the tokens are on {tokens.device}")
        return cuda if self.use_graph is None else bool(self.use_graph)

    def __call__(self, params, batch: Dict[str, torch.Tensor],
                 max_seq: Optional[int] = None,
                 cache: Optional[Dict[str, Any]] = None):
        tokens = batch["tokens"]
        on_graph = self.on_graph(tokens)
        if on_graph and cache is None:
            if self.use_graph:
                raise ValueError("make_prefill_step(graph=True) fills a "
                                 "cache of the caller's; pass cache=")
            on_graph = False
        kernel = (tokens.device.type == "cuda" if self.use_kernel is None
                  else self.use_kernel)
        with torch.inference_mode():
            if not on_graph:
                return _prefill(self.cfg, params, batch, cache, kernel,
                                max_seq)
            g = self.graph
            if g is None or not g.takes(params, batch, cache):
                self.close()
                g = self.graph = PrefillGraph(self.cfg, params, batch, cache,
                                              kernel, self.pool)
                first, g.first = g.first, None
                return first, cache
            return g.replay(batch), cache

    def close(self) -> None:
        """Release the graph, if any."""
        if self.graph is not None:
            self.graph.release()
        self.graph = None


def make_prefill_step(cfg: ArchConfig, *, use_kernel: Optional[bool] = None,
                      graph: Optional[bool] = None,
                      pool: Optional[GraphPool] = None) -> PrefillStep:
    """``prefill_step(params, batch, max_seq=None, cache=None) ->
    (next_tok (B,) int32, cache)``.

    ``batch`` holds ``tokens`` and, for encdec, ``frames``; it reaches
    ``prefill`` unchanged.  A given ``cache`` (``M.init_cache``'s tree, at
    the decode's length) is filled in place, the rows the prompt does not
    write zeroed, so a cache can serve one prompt after another; without
    one, the step makes a zeroed cache at ``max_seq`` (default: the
    prompt's length) each call, eagerly.

    ``graph=None`` runs a prefill into a given cache through a CUDA graph
    (``PrefillGraph``) when the tokens are on CUDA, and any other prefill
    eagerly; ``True`` always through a graph, and raises for tokens on the
    CPU or without a cache; ``False`` eagerly on either device.  A graph
    belongs to one (params, cache, batch shapes): the first prefill on a
    cache is eager and captures it, later prefills on that cache replay
    it, a prefill on another cache captures anew.  ``pool``: the
    ``GraphPool`` the graphs capture into, shared with other steps whose
    graphs never run at once (a serve call's slots); by default one of the
    step's own.  ``prefill_step.close()`` frees the graph.
    ``use_kernel=None`` sends prefill attention and the SSD scan to the
    hand-written kernels when the tokens are on CUDA and to the plain
    torch ops otherwise."""
    return PrefillStep(cfg, graph, use_kernel,
                       GraphPool() if pool is None else pool)


def _greedy(cfg: ArchConfig, params, cache, tokens: torch.Tensor, pos,
            use_kernel: bool, state_out: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: (greedy next token (B, 1) int32, logits)."""
    logits, _ = M.decode_step(params, cfg, cache, tokens, pos,
                              use_kernel=use_kernel, state_out=state_out)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
    return tok.to(torch.int32)[:, None], logits


def _set_position(buf: torch.Tensor, pos) -> None:
    """Refill the 0-d position buffer on the device, without a sync."""
    if isinstance(pos, torch.Tensor):
        buf.copy_(pos)
    else:
        buf.fill_(pos)


class DecodeGraph:
    """One cache's decode step, captured once as a CUDA graph and replayed
    every later step: the port's counterpart of the reference's
    ``jax.jit(make_decode_step(cfg))``, whose traced ``pos`` lets one
    executable serve every position.

    Made by its cache's first decode step, which runs eagerly on the
    caller's stream and is a real step: it writes the cache, promotes an
    SSM state to f32 and makes whisper's sinusoid table, so that every
    tensor the graph reads or writes (params, cache, the table) is
    allocated before the capture and outlives the graph's private pool.
    The capture reads the token and the position from static buffers
    (``tokens`` (B, 1) int32, ``pos`` 0-d int64) and writes the next
    token and the logits into static outputs; the cache is written in
    place, at the addresses captured.  Captures run one at a time, on the
    device's capture stream, after the caching allocator's free blocks are
    released (as ``torch.cuda.graph`` does), in ``thread_local`` error
    mode: another thread's synchronise or copy to the host (the serve
    driver runs decode apps in node threads) neither fails nor
    invalidates one.  A failed capture or replay raises.

    ``use_kernel`` sends the step's attention to the decode kernel, in the
    eager first step and in the capture alike.  ``state_out`` is
    ``M.decode_step``'s: the f32 state a first step on a cache whose SSM
    state is in a narrower dtype writes (``DecodeStep``'s first-step
    graph).

    ``counts`` tallies captures and replays process-wide (the replays of a
    graph are added when it is released), so that a run can show it went
    through graphs."""

    counts = {"captures": 0, "replays": 0}

    def __init__(self, cfg: ArchConfig, params, cache: Dict[str, Any],
                 tokens: torch.Tensor, pos, use_kernel: bool = True,
                 state_out: Optional[torch.Tensor] = None):
        dev = tokens.device
        # state_out is held so that the buffer the graph writes outlives it
        self.params, self.cache, self.state_out = params, cache, state_out
        self.tokens = tokens.to(torch.int32, copy=True)
        self.pos = torch.empty((), dtype=torch.int64, device=dev)
        _set_position(self.pos, pos)
        self.first, self.first_logits = _greedy(cfg, params, cache,
                                                self.tokens, self.pos,
                                                use_kernel, state_out)
        self.graph = torch.cuda.CUDAGraph()
        self.replays = 0
        (self.next, self.logits), self.capture_ms = _capture(
            self.graph, dev, _greedy, cfg, params, cache, self.tokens,
            self.pos, use_kernel, state_out)
        with _COUNTS_LOCK:
            DecodeGraph.counts["captures"] += 1

    def replay(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        """The next token (B, 1) int32 after ``tokens`` at ``pos``; a
        clone, since the next replay overwrites the static output."""
        self.tokens.copy_(tokens)
        _set_position(self.pos, pos)
        self.graph.replay()
        self.replays += 1
        return self.next.clone()

    def release(self) -> None:
        """Free the graph and its pool's tensors; add its replays to
        ``counts``."""
        with _COUNTS_LOCK:
            DecodeGraph.counts["replays"] += self.replays
        self.replays = 0
        del self.graph, self.next, self.logits, self.state_out


def _narrow_state(cache: Dict[str, Any]) -> bool:
    """Whether ``cache`` holds an SSM state in a dtype narrower than f32: a
    prefill's, which the first decode step reads and promotes."""
    ssm = cache.get("ssm")
    return ssm is not None and ssm["state"].dtype != torch.promote_types(
        ssm["state"].dtype, torch.float32)


class DecodeStep:
    """``decode_one(params, cache, tokens, pos) -> (next_tok (B,1), cache)``
    (see ``make_decode_step``).  ``logits`` holds the last step's logits
    (B, 1, V) (a graph's static output: the next replay overwrites it);
    ``graph`` the current ``DecodeGraph`` or None, ``first_graph`` the
    first step's on a cache with a narrow SSM state."""

    def __init__(self, cfg: ArchConfig, graph: Optional[bool],
                 use_kernel: Optional[bool] = None):
        self.cfg, self.use_graph, self.use_kernel = cfg, graph, use_kernel
        self.graph: Optional[DecodeGraph] = None
        self.first_graph: Optional[DecodeGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.views: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None

    def _view(self, cache: Dict[str, Any]) -> Dict[str, Any]:
        """``cache`` with an f32 SSM state of this step's own in place of
        its narrow one (the same KV, conv and cross tensors), made once a
        cache: what the steps after the first read and write."""
        if self.views is None or self.views[0] is not cache:
            ssm = cache["ssm"]
            state = torch.empty_like(ssm["state"], dtype=torch.promote_types(
                ssm["state"].dtype, torch.float32))
            self.views = (cache, {**cache, "ssm": {**ssm, "state": state}})
        return self.views[1]

    def _graph(self, attr: str, params, cache: Dict[str, Any],
               tokens: torch.Tensor, pos, kernel: bool,
               state_out: Optional[torch.Tensor]) -> torch.Tensor:
        """The step through the graph kept in ``attr``: a replay when it
        was captured on (params, cache), else a new capture after an eager
        step (whose token is returned)."""
        g = getattr(self, attr)
        if g is None or g.cache is not cache or g.params is not params:
            if g is not None:
                g.release()
                setattr(self, attr, None)
            g = DecodeGraph(self.cfg, params, cache, tokens, pos, kernel,
                            state_out)
            setattr(self, attr, g)
            self.logits = g.first_logits
            return g.first
        tok = g.replay(tokens, pos)
        self.logits = g.logits
        return tok

    def on_graph(self, tokens: torch.Tensor) -> bool:
        """Whether a step on ``tokens`` goes through a CUDA graph."""
        cuda = tokens.device.type == "cuda"
        if self.use_graph and not cuda:
            raise ValueError("make_decode_step(graph=True) captures a CUDA "
                             f"graph; the tokens are on {tokens.device}")
        return cuda if self.use_graph is None else bool(self.use_graph)

    def __call__(self, params, cache: Dict[str, Any], tokens: torch.Tensor,
                 pos):
        on_graph = self.on_graph(tokens)
        kernel = (tokens.device.type == "cuda" if self.use_kernel is None
                  else self.use_kernel)
        with torch.inference_mode():
            first = _narrow_state(cache)
            out = self._view(cache) if first else cache
            state_out = out["ssm"]["state"] if first else None
            if not on_graph:
                tok, self.logits = _greedy(self.cfg, params, cache, tokens,
                                           pos, kernel, state_out)
            else:
                tok = self._graph("first_graph" if first else "graph",
                                  params, cache, tokens, pos, kernel,
                                  state_out)
            return tok, out

    def close(self) -> None:
        """Release the graphs, if any (a step made again captures anew)."""
        for g in (self.graph, self.first_graph):
            if g is not None:
                g.release()
        self.graph = self.first_graph = self.logits = self.views = None


def make_decode_step(cfg: ArchConfig, *, graph: Optional[bool] = None,
                     use_kernel: Optional[bool] = None) -> DecodeStep:
    """``decode_one(params, cache, tokens, pos) -> (next_tok (B,1), cache)``.

    ``pos`` is an int or a 0-d int64 tensor on the tokens' device.
    ``graph=None`` runs the step through a CUDA graph (``DecodeGraph``)
    when the tokens are on CUDA and eagerly on the CPU; ``True`` always
    through a graph, and raises for tokens on the CPU; ``False`` eagerly
    on either device.  A graph belongs to one (params, cache): the first
    step on a cache captures it, later steps on that cache replay it, a
    step on another cache captures anew.  ``decode_one.close()`` frees it.

    A cache whose SSM state is in the model's dtype narrower than f32 (a
    bf16 prefill's) is left as it is: the first step reads its state and
    writes the f32 state of the steps after it (the reference's rounding)
    into a tensor of the step's own, and returns the cache with that state
    (``_view``), which the later steps take.  So a caller passes each
    step the cache the last one returned: given the prefill's cache again,
    the step is the first step once more (it reads the narrow state, which
    it never writes).  On the graph route that first step is a graph of
    its own, so a cache filled again by a prefill (a serve slot's) replays
    both.
    ``use_kernel=None`` sends the attention over the caches to the decode
    kernel (``kernels.ops.decode_attention``) when the tokens are on CUDA
    and to its plain version (torch ops) otherwise, as
    ``make_prefill_step`` does; ``True`` / ``False`` choose either.
    """
    return DecodeStep(cfg, graph, use_kernel)


def decode_fn(cfg: ArchConfig, params: Any, cache: Dict[str, Any],
              first_token: torch.Tensor, start_pos: int, steps: int):
    """Greedy multi-token decode loop (host-side driver for examples),
    through ``make_decode_step``'s default: a CUDA graph on CUDA, as the
    reference jits its step."""
    step = make_decode_step(cfg)
    toks = [first_token]
    tok = first_token
    try:
        for i in range(steps):
            tok, cache = step(params, cache, tok, start_pos + i)
            toks.append(tok)
    finally:
        step.close()
    return torch.cat(toks, dim=1), cache
