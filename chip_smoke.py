#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repo root with no arguments:

    python3 chip_smoke.py

(``--kernels-only`` stops after phase 3 and prints its kernels line but
no result line; ``--serve-parent`` times each serve path's prefill and
replayed decode step on the fused norm and RoPE kernels and on the
parent's route, the adds, silu and product as ATen ops beside the norm
and RoPE kernels, and on the gate's kernel against its plain ops
(granite's also on its MoE kernels and on the block's plain route), in
turns, after the build, and prints no result line.)

Full profiler tables land in ``chiprun_out/chip_smoke/`` (gitignored).
Phases, each printing one JSON line, its ``at_s`` the seconds since the
script started (any failure exits non-zero and prints no result):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: compile every CUDA kernel from ``src/repro_torch/csrc`` with nvcc
   (flash attention, the SSD scan, decode attention, the optimizer, the
   training attention, RMSNorm and RoPE, the MoE dispatch, the gated MLP's
   activation, the capped cross-entropy),
   all at once, and beside them flash attention with ``-DFLASH_FORCE_MMA``,
   the SSD scan with ``-DSSD_FORCE_MMA`` and the training attention with
   ``-DTRAIN_ATTN_FORCE_MMA`` (the ``mma_bf16`` routes at every shape), and
   flash and the training attention with ``-DFLASH_FORCE_SCALAR`` and
   ``-DTRAIN_ATTN_FORCE_SCALAR`` (``scalar_f32`` where ``mma_3xtf32``
   runs), and the MoE dispatch with ``-DMOE_DISPATCH_FORCE_PLAIN_COPY`` (a
   load a store, default stores), for checking and timing the old routes;
   ptxas registers, spills and warnings per kernel instance.  Fails if
   ptxas reported a spill, a serialised wgmma or an ignored setmaxnreg.
3. kernel: each kernel against its plain PyTorch version on the card, at
   the serve paths' shapes and at every option case in f32 (flash:
   ``mma_3xtf32``, split-f32 products on the tensor cores, at D <= 128,
   each such case also on the ``scalar_f32`` build and held to the same
   tolerance; ``scalar_f32`` at D = 256) and in bf16 (flash:
   ``wgmma_bf16`` at D = 64, 80 and 128, ``mma_bf16`` at
   the other head dims; every bf16 option case at D = 64, 80 and 128; the
   route of each flash call read from its device kernel's name in a
   profile); times of the kernel, the plain version and (where one exists)
   one library call at the path shapes, CUDA events: SDPA, or for a
   softcapped or windowed case a compiled ``flex_attention``; on the
   ``wgmma_bf16`` path shapes also the ``mma_bf16`` route's time
   (``prior_ms``), timed in turns with the new route.  The SSD scan the
   same way: each case's route by (dtype, P, N), the library's launches by
   device kernel equal to the route's and no profile showing more, the
   path shapes on ``wgmma_bf16`` timed in turns with ``mma_bf16``, and
   each route's device time split by kernel from a profile.  The decode
   kernel (one-token attention over a KV cache) the same way: every
   option case in f32 and in bf16 (GQA 1:1 to 12:1, D 16 to 256, a window
   over several splits, a position in the first split, the last row, the
   softcap, every row visible, K and V strided views of one tensor) and
   each serve path's decode shape at its last position, each on every
   route that takes it (``splitk_f32``; ``splitk_bf16`` and, at D a
   multiple of 16, ``mma_bf16``), each launch held to its plain version
   within 2e-5 x max|V| and to one launch on its route by the library's
   device counter; the routes timed in turns beside the plain version and
   the bound, at the path shapes also one library call (SDPA with a row
   mask, or for gemma2's capped shapes a compiled ``flex_attention``).
   The train step's two optimizer kernels (``adamw_update``, ``sumsq``)
   through the port's entry points (``optim.adamw``), leaf by leaf: p, m
   and v equal to the plain version's bit for bit, in place and out of
   place, on drawn leaves whose sqrt(v_hat) sits near eps (every params /
   grads dtype pair, with and without the clip factor, aligned, with a
   tail, unaligned), on tiny's and lm100m's f32 states and on
   codeqwen1.5-7b's full-width 16-layer bf16 state with the grads of one
   real backward; ``sumsq`` (one launch over every grad) within 1e-6
   relative of an f64 sum and the same bits over 3 calls; each timed over
   the whole state against its
   bound, the plain version and the library call (``torch._fused_adamw_``
   where it takes the dtypes, ``torch._foreach_norm``).  The training
   attention's kernels (``train_attention``: forward, and the backward's
   delta, dQ and dK dV) through the port's autograd entry point, every
   case of ``TA_CASES`` (causal and not, window 4096 with cap 50, GQA 6:1
   and 3:1, D 16 to 128, S != T, S not a multiple of the tile, bf16, f32,
   bf16 q against f32 k and v, q read by strides): o, the log-sum-exp and
   dq, dk, dv within the stated tolerance of the plain version in f32
   (``ta_within``), the same bits over 3 calls, each launch counted on the
   device by route; every case the wrapper sends to ``wgmma_bf16`` also on
   the ``-DTRAIN_ATTN_FORCE_MMA`` build (the old ``mma_bf16`` route) and
   every case it sends to ``mma_3xtf32`` (f32, and bf16 q against f32 k
   and v) on the ``-DTRAIN_ATTN_FORCE_SCALAR`` build (``scalar_f32``),
   each held to the same; at codeqwen1.5-7b's train shape (bf16) and
   lm100m's (f32) the forward, the backward and both timed against their
   bounds, the old route (in turns), the plain route and SDPA in the
   inputs' dtype and on f32 upcasts.  RMSNorm's forward and backward
   (dx; dscale by a second kernel) and RoPE's rotation of q and k (one
   launch, the backward by -angle) through their launch functions
   (``kernels.norm_rope``), at the paths' widths and heads
   (``NR_NORM_CASES``, ``NR_ROPE_CASES``: d_model, the SSM's f32 gated
   norm, chameleon's qk-norm, decode's (B, 1), GQA, D = 80, 8192
   positions, odd widths, an unaligned x): within the training
   attention's tolerance of the plain versions on f32 upcasts, RoPE the
   plain rotation's bits or within 1 bf16 ulp (its largest ulp
   difference printed), the same bits over 3 calls, one device launch a
   kernel a call (the norm backward's rows on the route its width, dtype
   and alignment take: ``staged_*``, or the register route's; the
   wrapper's plan, ``nr.bwd_plan``, equal to the library's on the card,
   ``nr.card_plan``); each timed at codeqwen1.5-7b's train shape in turns
   with its plain version, beside its bound and ``F.rms_norm`` on the f32
   upcast (RoPE: no library call).  The fused instances: the norm behind
   its add prologue (h' = h + (a + bias) written beside the normed rows;
   ``NR_ADD_CASES``: every (x, scale) dtype pair, with and without a bias,
   f32 x with a bf16 bias, rows in passes, unaligned, odd widths), behind
   its gate prologue (``y * silu(z)``, z a slice of the projection;
   ``NR_GATE_CASES``: mamba2's and zamba2's shapes, every dtype pair, an
   odd row stride, rows in passes, unaligned), and RoPE with the q and k
   biases (``NR_ROPE_BIAS_CASES``), forward and backward: h' the plain
   adds' bits, the rest within the norm's and RoPE's tolerances (the
   backward's chains of bf16 roundings within as many roundings,
   ``nr_within``), the bias grads within one rounding of the sums of the
   kernel's grads, the same bits over 3 calls, one device launch a kernel
   a call; each timed at its path shape (``NR_FUSED_SHAPE``) in turns with
   the parent's route (the adds as ATen ops, then the norm or RoPE kernel)
   and the plain version, beside its bound and the unfused library calls
   (the adds, then ``F.rms_norm``; no single PyTorch call computes any of
   them).  The MoE dispatch's three kernels
   (``kernels.moe_dispatch``: slot positions, dispatch, combine) at
   ``MOE_CASES`` (granite's prefill and decode shapes, grok's width, a
   forced capacity overflow, f32, 64 groups of 32 tokens, the smoke
   widths, an odd d, unaligned rows, 256 experts): pos, keep, the inverse
   map and the buffer equal to the plain versions', y within 1e-6 x
   max|y| (bf16: + 2^-8 |y|) of the plain combine's f32 sum, the same
   bits over 3 calls, one device launch a call; each, the three together
   and the plain route's glue they replace timed at granite's prefill
   shape, beside their byte bounds and ``index_select`` for the dispatch.
   The gated MLP's activation (``kernels.gated_mlp``: ``act(a) * b``
   forward; da and db in one backward launch) at ``GATE_CASES`` (the
   paths' d_ff, decode's (B, 1), granite's experts in their e-major
   layout, swiglu and geglu, f32 and bf16, odd widths, unaligned) and the
   capped cross-entropy (``kernels.cross_entropy``: the rows' lse and
   loss, their sum; the grad of the pre-cap logits) at ``LOSS_CASES``
   (codeqwen's train shape, gemma2's cap 30 over 256,000, granite's
   padded vocab, f32, odd widths, unaligned; labels -1, in the padding and
   at and past the width): the gate the plain ops' bits or within one
   bf16 ulp (f32 within 1e-6 x max|plain|), the loss and lse within 2e-6
   relative, the grad within one bf16 ulp (f32 1e-6 x max|plain|), the
   same bits over 3 calls, one device launch a kernel a call; each timed
   at codeqwen's train shape in turns with its plain version, beside its
   bound and (the loss) ``F.cross_entropy`` on the f32 upcast.
4. serve, for each of eight paths in turn: codeqwen1.5-7b (dense, flash
   kernel), mamba2-1.3b (ssm, SSD kernel), zamba2-2.7b (hybrid, both
   kernels), granite-moe-3b-a800m (moe, flash), whisper-large-v3 (encdec,
   flash in the encoder and the decoder), gemma2-27b (dense: local window
   4096 on alternate layers, softcaps), nemotron-4-15b (dense, GQA 6:1)
   and chameleon-34b (vlm, qk-norm).  A smoke config served on the card
   must give the CPU's tokens (a windowed one with prompts past its
   window).  Then the model at full width and depth (random weights from
   a seed): its prefill and decode steps timed alone, against their
   bounds, and profiled (the flash launches each route's wrapper counted
   in the profiled call must be the device kernels the profile shows);
   its decode step eager and through its CUDA graph (``decode_graph``:
   one microbatch's 15 steps each from one prefill's cache, both through
   the decode kernel, the tokens equal at every step and the last logits
   equal, one capture, made while another thread copies to the host and
   synchronises its stream, the decode kernel's launches exact on the
   host and on the device and no other kernel's, an eager step free of
   synchronises, one step on the plain route held to the kernel route's
   logits by the path's rule; each step's ms, the capture's ms, device
   busy and idle, and the plain route's replayed step, ``prior_ms``);
   its prefill through its CUDA graph (``prefill_graph``: a replay into a
   slot's cache that another prompt and a microbatch's decode steps left
   written equals the eager prefill into a new cache to the bit, next
   token and every cache tensor; eager and replayed ms in turns, busy,
   idle, capture ms, peaks);
   then 8 requests x 16 tokens with 512-token
   prompts (gemma2: 4 x 16 with 8192-token prompts, past its window)
   through the engine, with every kernel count set to 0 just before and
   read just after, as are the graphs' captures and replays (each cache
   slot of the run captures its prefill graph and its decode graphs once
   and every other prefill and decode step replays one,
   ``check_graphs`` against ``serve_runs``; flash, the SSD scan and
   decode held on the host, eager calls and captures, and on the device,
   eager calls and replays, ``serve_window``): each prefill kernel of the
   path must have launched exactly once per layer that runs it per
   prefill, on the route its
   inputs' dtype and head dim select (the full-width models are bf16;
   whisper's encoder runs f32, from the serve's f32 frames), and the
   decode kernel once per attention call per eager step and capture on
   the host and per executed step on the device (its replays are counted
   there), on the route ``route(dtype, group, D)`` names for the path's
   model, and the norm and RoPE kernels as often as the path's norms and
   self-attention calls imply (``expected_norm_rope_serve``, host and
   device, in all and by route: the add, gate and bias instances as
   ``norm_rope_calls`` counts them), the gate's forward once a gated MLP
   call a prefill and a decode step and no loss kernel
   (``expected_gate_serve``, host and device), and the MoE kernels once a
   MoE layer a prefill and a decode step (``expected_moe_serve``, host and
   device; granite only); the prefill of each of ``FUSED_OPS_PATHS``
   profiled again on the parent's route (``fused_ops_check``) must show
   exactly ``fused_prefill_ops`` more ATen adds, products and silus;
   granite's prefill profile must show none of the MoE's plain ops (``aten::cumsum``,
   ``scatter_add``, ``gather``), and its prefill, profiled and timed in
   turns with its replayed decode step, also on the MoE block's plain
   route (``moe_parent``); and full-width prefill
   logits
   through the kernels must be finite and near the plain route's (gemma2:
   one 8192-token sequence).  codeqwen1.5-7b then serves the same
   requests in the serve driver's other engine modes (``serve_modes``):
   the compiled substrate, streaming delivery, 3 sessions 2 at a time
   through a resident manager, and a stats dump; each must give the
   object substrate's tokens, the expected launches and the expected
   decode graphs (the sessions run captures in threads beside other
   threads' eager work).  Every path then serves 3 sessions one after
   another (gemma2 2) on its slots and on the parent's route (every
   prefill eager into a fresh cache, a decode graph a microbatch, driven
   directly: ``parent_route``) in turns (``serve_steady``): the tokens
   equal the serve run's, each app's ms, wall, tokens a second, graphs
   and peaks printed.  Each model is freed before the next.  No training attention
   or optimizer kernel launches while serving, and flash, the SSD scan
   and decode none on the device in phases 5-7.
5. train, after the serve paths, with every kernel count set to 0, each
   step through the train step's CUDA graph (``TrainGraph``: the first
   step on a state eager, then a capture, then replays) unless named
   eager: every kernel wrapper refuses CUDA inputs that require grad; (a)
   the ``tiny`` preset's train step on the card equals the port on the
   CPU over 4 steps (one and two microbatches, int8 compression); (b)
   replayed steps equal eager ones (``graph=False``) to the bit over 4
   steps from equal states (params, m, v, step, residual, loss, grad
   norm, lr): lm100m (f32, not donated; its capture beside another
   thread's copies of a state to the host, as the checkpoint app makes
   them), tiny (2 microbatches, compression, donated), codeqwen1.5-7b at
   full width cut to 2 layers (bf16, remat, donated), and lm100m's step
   eager and replayed on the host clock beside the replay's device span;
   (c)
   ``run_training(lm100m)`` through the engine (40 steps x 1024 tokens,
   f32, checkpoints under ``chiprun_out/``) equals the same steps without
   the engine (a plain loop, through the graph and eager), its last
   checkpoint restores bit for bit and a resumed run starts from the saved
   step; then the engine eager and through the graph in turns
   (``TRAIN_ENGINE_TURNS``); (d) codeqwen1.5-7b at full width cut to 16
   layers, one donated, rematerialised bf16 step on 8 x 512 tokens, in
   four columns in turns (``TRAIN_TURNS``): through its graph, eager,
   eager on the parent's route (``unfused_norm_rope``: the residual and
   bias adds, and the SSM gate, as ATen ops beside the norm and RoPE
   kernels) and eager on the gate's and the loss's plain ops
   (``plain_gate_loss``): time against ``train_step_bound``, device busy
   and idle, peaks of allocated, requested and reserved bytes, the
   capture's ms, the first loss equal to ``forward_train``'s, the loss
   falling on the repeated batch, step 1's loss and grad norm near the
   plain attention's, and at 2 layers remat on and off agreeing over two
   steps; each column's device time split by part (``train_profile``:
   optimizer, global norm, bf16 GEMMs, f32 GEMMs, the training attention
   kernels, other elementwise work by op family, idle; the replay by its
   kernels' names in the eager step's proportions, ``replay_split``); the
   eager kernels' peak no higher than the parent route's nor than the
   plain gate and loss's; (e) each
   part's graph captures and replays as ``expected_train_graphs`` says
   (``train_graph``); no serve kernel launched in the whole phase (flash,
   the SSD scan and decode have no backward: training runs with
   ``use_kernel=False``, as the reference does), the training attention
   once a forward (twice under remat) and once a backward an attention
   call a microbatch, the two optimizer kernels exactly once a param leaf
   a step on the card, the norm and RoPE kernels once a norm or
   self-attention call a forward (the layers' twice under remat) and a
   backward (``expected_norm_rope_launches``), the gate once a gated call
   a forward and a backward and the loss's kernels once a forward and a
   backward (``expected_gate_loss_launches``), counted on the device (a
   capture launches on the host only, a replay on the device only); no
   MoE kernel (the block trains on its plain route).
6. dryrun, with every kernel count set to 0: (a) the port's dry-run of
   mamba2-1.3b x decode_32k on the 256-rank fake mesh ends ok and agrees
   with the reference's committed record on params, chips, decisions and
   argument bytes, and four smoke cells (mamba2 prefill, granite decode,
   codeqwen and zamba2 train) end ok on a (2, 4) fake mesh under this
   host's torch; (b) its cost pass on a 1-rank mesh counts the same
   FLOPs as ``FlopCounterMode`` on the card for codeqwen1.5-7b's
   plain-route prefill (one serve microbatch, counted in phase 4) and
   (c) its 16-layer train step (one more step on the plain attention,
   counted in phase 5),
   printed with the roofline's terms beside the measured times; (d) no
   kernel launched (the steps run on meta DTensors, which take the
   optimizer's, the norms' and RoPE's, the gate's and the loss's plain
   versions; none calls the MoE kernels).
7. examples, with every kernel count set to 0: ``examples/torch/``'s
   CHILES pipeline recovers its source in band 2, and ``train_lm.py`` at
   its defaults (lm20m, 200 steps through the engine, one capture and 199
   replays) lowers the loss; no serve kernel launched, the training attention once a forward and once
   a backward a layer a step, the optimizer kernels once a param leaf a
   step, the norm and RoPE kernels once a call a forward and a backward,
   the gate and the loss likewise, no MoE kernel.
8. the kernels line (the ``mma_3xtf32`` routes also on lines of their
   own: flash at whisper's encoder, the training attention at lm100m's
   shape, each with its launches on that route; the norm and RoPE
   kernels, the MoE kernels and the gate's and the loss's with their
   device launches by serve path and phase), the card line, then the
   result line.

It imports nothing of JAX or of the JAX package.  Without CUDA it exits 2.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
PROFILE_DIR = ROOT / "chiprun_out" / "chip_smoke"   # gitignored

from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32)

SERVE = dict(num_requests=8, microbatch=4, prompt_len=512, decode_steps=16)
# gemma2-27b serves prompts past its 4096-token local window, so its 23
# local layers attend through the kernel's window route: 2 microbatches of
# 2 x 8192 tokens (their KV caches 12.4 GB beside 54.4 GB of weights)
SERVE_BY_PATH = {"gemma2_27b": dict(num_requests=4, microbatch=2,
                                    prompt_len=8192, decode_steps=16)}
# the plain route's S x S f32 scores take 8.6 GB a sequence and layer call
# at 8192 tokens, so gemma2's logits check runs one sequence
LOGITS_ROWS = {"gemma2_27b": 1}
H100_BYTES_PER_S = HBM_BW           # the card's constants: launch/mesh.py
H100_PEAK_FLOPS = {"torch.bfloat16": PEAK_FLOPS_BF16,
                   "torch.float32": PEAK_FLOPS_F32}


STARTED = time.monotonic()      # each line's ``at_s``: where the time goes


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.monotonic() - STARTED}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def serve_shape(arch: str) -> dict:
    """The requests a serve path runs: 8 x 512-token prompts x 16 new
    tokens in 2 microbatches of 4, unless ``SERVE_BY_PATH`` says other."""
    return SERVE_BY_PATH.get(arch, SERVE)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            budget_ms: float = 500.0) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls.

    The calls are queued behind a ~20 ms device sleep, so the device runs
    them back to back: without it, a kernel shorter than its wrapper's host
    time (the D=64 flash shapes, ~25 us) is timed at the host's pace.  A
    call slower than ``budget_ms / iters`` after the warm-up (a plain
    version at a path's shape, such as gemma2's 8192-token attention) is
    timed over fewer calls: about ``budget_ms`` in all, at least 3."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = start.elapsed_time(end)
    if one * iters > budget_ms:
        iters = max(3, int(budget_ms / one))
    torch.cuda._sleep(40_000_000)       # clock cycles: ~20 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to return (the wrapper's
    checks, allocations and launches), the device left to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


FLASH_PATH_CASES = ("path", "d80_bf16_mha", "granite_gqa3_d64_bf16",
                    "whisper_enc_f32", "whisper_dec_d64_bf16",
                    "gemma2_local_w4096_cap50", "gemma2_global_cap50",
                    "gemma2_local_w4096_cap50_b2", "gemma2_global_cap50_b2",
                    "nemotron_gqa6", "chameleon_gqa8")
# the device kernel of each flash route, as a profile names it
FLASH_KERNEL_ROUTES = {"flash_wgmma_kernel": "wgmma_bf16",
                       "flash_mma_kernel": "mma_bf16",
                       "flash_f32_kernel": "scalar_f32",
                       "flash_3xtf32_kernel": "mma_3xtf32"}
# the SSD scan's device kernels, as a profile names them, and their routes
# (each bf16 route launches two kernels a call)
SSD_KERNEL_ROUTES = {"ssd_wg_state_kernel": "wgmma_bf16",
                     "ssd_wg_y_kernel": "wgmma_bf16",
                     "ssd_cbt_kernel": "mma_bf16",
                     "ssd_mma_kernel": "mma_bf16",
                     "ssd_f32_kernel": "scalar_f32"}


def flash_routes_seen(torch, events) -> dict:
    """Flash launches by route in a profile's ``key_averages()``, read
    from the names of the device kernels that ran."""
    cuda = torch.autograd.DeviceType.CUDA
    seen = {}
    for e in events:
        if e.device_type != cuda:
            continue
        for kernel, route in FLASH_KERNEL_ROUTES.items():
            if kernel in e.key:
                seen[route] = seen.get(route, 0) + e.count
    return seen


def ssd_kernels_seen(torch, events) -> dict:
    """SSD launches by device kernel in a profile's ``key_averages()``."""
    cuda = torch.autograd.DeviceType.CUDA
    seen = {}
    for e in events:
        if e.device_type != cuda:
            continue
        for kernel in SSD_KERNEL_ROUTES:
            if kernel in e.key:
                seen[kernel] = seen.get(kernel, 0) + e.count
    return seen


def ssd_kernel_ms(trace: Path, calls: int) -> dict:
    """Device ms a call of each SSD kernel: the durations of its device
    kernels in a chrome trace of ``calls`` calls."""
    out = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("cat") != "kernel":
            continue
        for kernel in SSD_KERNEL_ROUTES:
            if kernel in e.get("name", ""):
                out[kernel] = out.get(kernel, 0.0) + e["dur"] / 1e3 / calls
    return out


def launch_delta(mod, lib, before: dict) -> dict:
    """Launches that ``lib`` made since its counts were ``before``
    (``mod.kernel_launches``: flash's by route, the SSD scan's by device
    kernel), those it did not launch left out."""
    after = mod.kernel_launches(lib)
    return {r: n - before[r] for r, n in after.items() if n != before[r]}


def ssd_kernels_of_call(torch, ss, lib, fn, calls: int = 1) -> tuple:
    """The result of ``calls`` calls of ``fn``, the SSD launches by device
    kernel that ``lib`` counted during them, those a profile of them shows,
    and each kernel's device ms a call from that profile's trace (the
    calls queued behind a device sleep, as ``cuda_ms`` times them)."""
    from torch.profiler import ProfilerActivity, profile
    before = ss.kernel_launches(lib)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(calls):
            out = fn()
        torch.cuda.synchronize()
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    trace = PROFILE_DIR / "ssd_trace.json"
    prof.export_chrome_trace(str(trace))
    split = ssd_kernel_ms(trace, calls)
    trace.unlink()
    return (out, launch_delta(ss, lib, before),
            ssd_kernels_seen(torch, prof.key_averages()), split)


def routes_of_call(torch, fa, lib, fn) -> tuple:
    """``fn()``'s result, the flash launches by route that the library
    ``lib`` counted during it, and those a profile of it shows."""
    from torch.profiler import ProfilerActivity, profile
    before = fa.kernel_launches(lib)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return (out, launch_delta(fa, lib, before),
            flash_routes_seen(torch, prof.key_averages()))


def route_faults(expected: dict, launched: dict, seen: dict) -> list:
    """How a call's launches by route (flash) or by device kernel (the SSD
    scan) disagree with ``expected``.
    The library's own counts (``launched``) must equal it.  A profile's
    (``seen``) may fall short, since the profiler can lose the device
    records of a session, but may show no route more often than expected."""
    faults = []
    if launched != expected:
        faults.append(f"the library launched {launched}")
    if any(n > expected.get(r, 0) for r, n in seen.items()):
        faults.append(f"the device ran {seen}")
    return faults


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible: the work this input needs."""
    total = 0
    for r in range(sq):
        lo = max(0, r - window + 1) if window > 0 else 0
        hi = min(sk, r + 1) if causal else sk
        total += max(0, hi - lo)
    return total


def attention_bound_ms(q, k, causal: bool, window: int) -> tuple:
    """Least time for the card: bytes of q, k, v, o once over HBM rate vs
    the visible pairs' FLOPs (QK^T and PV) over the dtype's peak."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * b * hq * d * visible_pairs(sq, sk, causal, window)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS[str(q.dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


MMA_DEFINES = ("FLASH_FORCE_MMA",)   # flash's mma_bf16 route at every D
# each route that an old route's build replaces: (old route, the build's
# defines); flash's and the training attention's
FLASH_OLD_ROUTES = {"wgmma_bf16": ("mma_bf16", MMA_DEFINES),
                    "mma_3xtf32": ("scalar_f32", ("FLASH_FORCE_SCALAR",))}
TA_OLD_ROUTES = {"wgmma_bf16": ("mma_bf16", ("TRAIN_ATTN_FORCE_MMA",)),
                 "mma_3xtf32": ("scalar_f32", ("TRAIN_ATTN_FORCE_SCALAR",))}
SSD_MMA_DEFINES = ("SSD_FORCE_MMA",)  # the SSD's mma_bf16 route, every shape
PTXAS_FAULT = re.compile(r"wgmma.*serializ|setmaxnreg.*ignor", re.I)


def ptxas_faults(ptxas: dict, logs: dict) -> list:
    """What the build phase fails on: a kernel instance that spills
    (``ptxas``: per build, ``_build.ptxas_summary``) and any line of a
    build's log (``logs``) saying that ptxas serialised a wgmma pipeline
    or ignored a setmaxnreg; either would cost the wgmma route most of
    its speed."""
    faults = [f"{lib}: {k['kernel']} spills {k['spill_bytes']} bytes"
              for lib, ks in ptxas.items() for k in ks if k["spill_bytes"]]
    faults += [f"{lib}: {line.strip()}" for lib, log in logs.items()
               for line in log.splitlines() if PTXAS_FAULT.search(line)]
    return faults


def phase_kernel(torch, fa):
    """Kernel vs plain version on the card; times at the path shapes,
    with the old route's (``prior_ms``: ``mma_bf16`` where ``wgmma_bf16``
    runs, ``scalar_f32`` where ``mma_3xtf32`` does, from the builds of
    ``FLASH_OLD_ROUTES``), whose f32 cases are held to the same tolerance.
    Returns the kernels line's entry at the path shape, the
    ``wgmma_bf16`` route's at zamba2's D = 80 and the ``mma_3xtf32``
    route's at whisper's f32 encoder."""
    prior_libs = {r: (old, fa._lib(defs))
                  for r, (old, defs) in FLASH_OLD_ROUTES.items()}

    def prior(q, k, v, opts):
        out = torch.empty_like(q)
        fa.launch(prior_libs[fa.route(q.dtype, q.shape[3])][1], q, k, v, out,
                  opts["causal"], opts["window"], opts["logit_cap"])
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    # name, B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, cap
    cases = [
        ("path", 4, 32, 32, 512, 512, 128, bf16, True, 0, 0.0),
        ("gqa_4to1", 2, 32, 8, 256, 256, 128, bf16, True, 0, 0.0),
        ("gqa_4to1_d64", 2, 32, 8, 256, 256, 64, bf16, True, 0, 0.0),
        ("ragged_17x33", 1, 4, 4, 17, 33, 8, f32, True, 0, 0.0),
        ("ragged_noncausal", 2, 2, 2, 48, 80, 32, f32, False, 0, 0.0),
        ("window16_cap50", 2, 4, 2, 200, 200, 64, f32, True, 16, 50.0),
        ("d80_f32", 2, 4, 2, 130, 130, 80, f32, True, 0, 0.0),
        ("noncausal", 2, 8, 2, 300, 300, 128, bf16, False, 0, 0.0),
        ("noncausal_d64", 2, 8, 2, 300, 300, 64, bf16, False, 0, 0.0),
        ("d256_f32", 1, 2, 1, 100, 100, 256, f32, True, 0, 0.0),
        # rows 12..19 see no key (window 3 ends before key 9): they must
        # average V over every key, as the plain version does
        ("no_visible_key", 1, 2, 1, 20, 10, 8, f32, True, 3, 0.0),
        # zamba2-2.7b's shared block: 32 heads x 80, MHA, bf16
        ("d80_bf16_mha", 4, 32, 32, 512, 512, 80, bf16, True, 0, 0.0),
        # the tensor-core route at the options above: one 16 x 16 mma
        # tile (fragment layout), ragged lengths, masks, cap, padded D
        ("mma_16x16_bf16", 1, 1, 1, 16, 16, 16, bf16, False, 0, 0.0),
        ("ragged_17x33_bf16", 1, 4, 4, 17, 33, 8, bf16, True, 0, 0.0),
        ("ragged_noncausal_bf16", 2, 2, 2, 48, 80, 32, bf16, False, 0, 0.0),
        ("window16_cap50_bf16", 2, 4, 2, 200, 200, 64, bf16, True, 16, 50.0),
        ("d256_bf16", 1, 2, 1, 100, 100, 256, bf16, True, 0, 0.0),
        ("no_visible_key_bf16", 1, 2, 1, 20, 10, 8, bf16, True, 3, 0.0),
        ("d40_bf16", 2, 4, 2, 130, 130, 40, bf16, True, 0, 0.0),
        # the wgmma route (D = 64 and 128) at the same options: its masks,
        # ragged edges past Sq and Sk (TMA zero fill, clipped stores),
        # lengths that are not a multiple of its 128-key tiles
        ("ragged_17x33_d64_bf16", 1, 4, 4, 17, 33, 64, bf16, True, 0, 0.0),
        ("ragged_17x33_d128_bf16", 1, 4, 4, 17, 33, 128, bf16, True, 0, 0.0),
        ("ragged_noncausal_d64_bf16", 2, 2, 2, 48, 80, 64, bf16, False, 0,
         0.0),
        ("ragged_noncausal_d128_bf16", 2, 2, 2, 48, 80, 128, bf16, False, 0,
         0.0),
        ("window16_cap50_d128_bf16", 2, 4, 2, 200, 200, 128, bf16, True, 16,
         50.0),
        ("no_visible_key_d64_bf16", 1, 2, 1, 20, 10, 64, bf16, True, 3, 0.0),
        ("no_visible_key_d128_bf16", 1, 2, 1, 20, 10, 128, bf16, True, 3,
         0.0),
        ("len130_d64_bf16", 2, 4, 2, 130, 130, 64, bf16, True, 0, 0.0),
        ("len130_d128_bf16", 2, 4, 2, 130, 130, 128, bf16, True, 0, 0.0),
        # the wgmma route at zamba2's D = 80 (a 64-column box in the
        # 128-byte swizzle and a 16-column one in the 32-byte swizzle) at
        # every option: GQA, ragged Sq and Sk, window and cap, rows that
        # see no key, lengths past one 128-key tile
        ("gqa_4to1_d80_bf16", 2, 32, 8, 256, 256, 80, bf16, True, 0, 0.0),
        ("ragged_17x33_d80_bf16", 1, 4, 4, 17, 33, 80, bf16, True, 0, 0.0),
        ("ragged_noncausal_d80_bf16", 2, 2, 2, 48, 80, 80, bf16, False, 0,
         0.0),
        ("window16_cap50_d80_bf16", 2, 4, 2, 200, 200, 80, bf16, True, 16,
         50.0),
        ("no_visible_key_d80_bf16", 1, 2, 1, 20, 10, 80, bf16, True, 3, 0.0),
        ("len130_d80_bf16", 2, 4, 2, 130, 130, 80, bf16, True, 0, 0.0),
        ("noncausal_d80_bf16", 2, 8, 2, 300, 300, 80, bf16, False, 0, 0.0),
        # granite-moe-3b's prefill: GQA 3:1 at D=64
        ("granite_gqa3_d64_bf16", 4, 24, 8, 512, 512, 64, bf16, True, 0, 0.0),
        # whisper-large-v3's encoder (f32: the serve's f32 frames promote
        # it) and its decoder's prefill
        ("whisper_enc_f32", 4, 20, 20, 64, 64, 64, f32, False, 0, 0.0),
        ("whisper_dec_d64_bf16", 4, 20, 20, 512, 512, 64, bf16, True, 0,
         0.0),
        # gemma2-27b's prefill past its window: a local layer (window 4096)
        # and a global one, both capped at 50; one 8192-token sequence,
        # then the serve path's microbatch of two
        ("gemma2_local_w4096_cap50", 1, 32, 16, 8192, 8192, 128, bf16, True,
         4096, 50.0),
        ("gemma2_global_cap50", 1, 32, 16, 8192, 8192, 128, bf16, True, 0,
         50.0),
        ("gemma2_local_w4096_cap50_b2", 2, 32, 16, 8192, 8192, 128, bf16,
         True, 4096, 50.0),
        ("gemma2_global_cap50_b2", 2, 32, 16, 8192, 8192, 128, bf16, True, 0,
         50.0),
        # nemotron-4-15b (GQA 6:1) and chameleon-34b (GQA 8:1)
        ("nemotron_gqa6", 4, 48, 8, 512, 512, 128, bf16, True, 0, 0.0),
        ("chameleon_gqa8", 4, 64, 8, 512, 512, 128, bf16, True, 0, 0.0),
    ]
    worst, worst_by_route, worst_d80 = 0.0, {}, 0.0
    timed = {}
    for name, b, hq, hkv, sq, sk, d, dt, causal, window, cap in cases:
        q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
        opts = dict(causal=causal, window=window, logit_cap=cap)
        route = fa.route(dt, d)
        got, launched, seen = routes_of_call(
            torch, fa, fa._lib(),
            lambda: fa.flash_attention_bhsd(q, k, v, **opts))
        faults = route_faults({route: 1}, launched, seen)
        if faults:
            fail(f"flash_attention_bhsd case {name}: the wrapper's route is "
                 f"{route}; " + "; ".join(faults))
        want = fa.flash_attention_plain(q, k, v, **opts)
        # f32: the kernel sums in another order than the plain version;
        # bf16: both round the f32 result to bf16 once (tests/test_kernels)
        tol = 1e-4 if dt == f32 else 2e-2
        err = (got.float() - want.float()).abs()
        bad = err > tol + tol * want.float().abs()
        max_err = float(err.max())
        ok = bool(torch.isfinite(got).all()) and not bool(bad.any())
        extra = {}
        if route in prior_libs:    # the old route's error at this case
            old_route, lib = prior_libs[route]
            old, old_launched, old_seen = routes_of_call(
                torch, fa, lib, lambda: prior(q, k, v, opts))
            faults = route_faults({old_route: 1}, old_launched, old_seen)
            if faults:
                fail(f"{FLASH_OLD_ROUTES[route][1]} build at case {name}: "
                     + "; ".join(faults))
            old_err = (old.float() - want.float()).abs()
            extra.update(prior_route=old_route,
                         prior_max_abs_err=float(old_err.max()))
            if dt == f32:           # both f32 builds within the tolerance
                extra["prior_ok"] = bool(torch.isfinite(old).all()) and \
                    not bool((old_err > tol + tol * want.float().abs())
                             .any())
                ok = ok and extra["prior_ok"]
            del old, old_err
        emit("kernel_check", kernel="flash_attention_bhsd", case=name,
             shape=[b, hq, hkv, sq, sk, d], dtype=str(dt), route=route,
             routes_launched=launched, routes_seen=seen, causal=causal,
             window=window, cap=cap,
             max_abs_err=max_err, tol=tol, ok=ok, **extra)
        if not ok:
            fail(f"flash_attention_bhsd case {name}: max_abs_err {max_err}, "
                 f"old route {extra.get('prior_max_abs_err')}")
        worst_by_route[route] = max(worst_by_route.get(route, 0.0), max_err)
        if d == 80 and dt == bf16:
            worst_d80 = max(worst_d80, max_err)
        if name in FLASH_PATH_CASES:
            worst = max(worst, max_err)
            timed[name] = (q, k, v, opts)
    times = {}
    for name, (q, k, v, opts) in timed.items():
        route = fa.route(q.dtype, q.shape[3])
        calls = {"kernel": lambda: fa.flash_attention_bhsd(q, k, v, **opts),
                 "prior": lambda: prior(q, k, v, opts)}
        runs = {"kernel": [], "prior": []}
        for which in (("kernel", "prior", "prior", "kernel")
                      if route in prior_libs else ("kernel", "kernel")):
            runs[which].append(cuda_ms(calls[which]))
        kernel_runs, prior_runs = runs["kernel"], runs["prior"]
        kernel_ms = sum(kernel_runs) / len(kernel_runs)
        prior_ms = sum(prior_runs) / len(prior_runs) if prior_runs else None
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **opts))
        library, library_note = library_attention(torch, fa, q, k, v, opts)
        library_ms = cuda_ms(library) if library else None
        bound_ms, bound_by = attention_bound_ms(q, k, opts["causal"],
                                                opts["window"])
        times[name] = dict(shape=list(q.shape), kv_heads=k.shape[1],
                           dtype=str(q.dtype), route=route,
                           causal=opts["causal"], window=opts["window"],
                           cap=opts["logit_cap"],
                           kernel_ms=kernel_ms, kernel_ms_runs=kernel_runs,
                           prior_route=(FLASH_OLD_ROUTES[route][0]
                                        if prior_runs else None),
                           prior_ms=prior_ms, prior_ms_runs=prior_runs,
                           plain_ms=plain_ms, library_ms=library_ms,
                           library=library_note, bound_ms=bound_ms,
                           bound_by=bound_by)
        emit("kernel_time", kernel="flash_attention_bhsd", case=name,
             **times[name])
    t = times["path"]
    entry = {"name": "flash_attention_bhsd", "route": "cuda",
             "kernel_route": t["route"], "kernel_routes": list(fa.ROUTES),
             "prior_ms": t["prior_ms"],
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:83",
             "max_abs_err": worst, "max_err": worst, "ms": t["kernel_ms"],
             "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"], "path_shapes": times}
    z = times["d80_bf16_mha"]
    d80 = {"name": "flash_attention_bhsd/wgmma_bf16_d80", "route": "cuda",
           "kernel_route": z["route"],
           "source": "src/repro_torch/csrc/flash_attention.cu "
                     "(flash_wgmma_kernel<80, ...>; hopper.cuh desc_sw32, "
                     "wgmma_rs_n16_tb)",
           "replaces": "src/repro/kernels/flash_attention.py:83",
           "shape": "zamba2-2.7b shared block: B4 32/32 heads S512 D80 bf16 "
                    "causal",
           "max_abs_err": worst_d80,
           "ms": z["kernel_ms"], "prior_route": z["prior_route"],
           "prior_ms": z["prior_ms"], "plain_ms": z["plain_ms"],
           "bound_ms": z["bound_ms"], "bound_by": z["bound_by"],
           "library_ms": z["library_ms"], "library": z["library"]}
    w = times["whisper_enc_f32"]
    x3 = {"name": "flash_attention_bhsd/mma_3xtf32", "route": "cuda",
          "kernel_route": w["route"],
          "source": "src/repro_torch/csrc/flash_attention.cu "
                    "(flash_3xtf32_kernel; f32_split.cuh)",
          "replaces": "src/repro/kernels/flash_attention.py:83",
          "shape": "whisper-large-v3 encoder: B4 20/20 heads S64 D64 f32 "
                   "non-causal",
          "max_abs_err": worst_by_route.get(w["route"], 0.0),
          "ms": w["kernel_ms"], "prior_route": w["prior_route"],
          "prior_ms": w["prior_ms"], "plain_ms": w["plain_ms"],
          "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
          "library_ms": w["library_ms"], "library": w["library"]}
    return entry, d80, x3


def library_attention(torch, fa, q, k, v, opts) -> tuple:
    """One PyTorch call that computes the kernel's function on these
    inputs, and its name: SDPA where there is no cap and no window;
    with them, ``flex_attention`` (compiled) with a tanh-softcap score
    and a causal sliding-window block mask, held to the plain version
    first.  (None, reason) where it does not compile or disagrees."""
    import torch.nn.functional as F
    if not opts["logit_cap"] and not opts["window"]:
        return (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=opts["causal"],
            enable_gqa=q.shape[1] != k.shape[1])), "sdpa"
    cap, window, causal = opts["logit_cap"], opts["window"], opts["causal"]
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def score_mod(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap) if cap else score

        def mask_mod(b, h, qi, ki):
            keep = (ki <= qi) if causal else (ki >= 0)
            return keep & (qi - ki < window) if window else keep

        mask = create_block_mask(mask_mod, None, None, q.shape[2],
                                 k.shape[2], device=q.device)
        flex = torch.compile(flex_attention)

        def call():
            return flex(q, k, v, score_mod=score_mod, block_mask=mask,
                        enable_gqa=q.shape[1] != k.shape[1])
        err = float((call().float()
                     - fa.flash_attention_plain(q, k, v, **opts).float()
                     ).abs().max())
    except Exception as exc:  # noqa: BLE001 - reported as "none"
        return None, f"none: flex_attention failed: {type(exc).__name__}"
    if not err <= 2e-2:
        return None, f"none: flex_attention differs by {err}"
    return call, f"flex_attention (max_abs_err {err})"


def ssd_bound_ms(x, b, chunk: int) -> tuple:
    """Least time for the card: x, dt, B, C read and y, the state written
    once over HBM rate vs the FLOPs (the causal half of each chunk's C B^T
    and its product with x, the inter-chunk term, the state update) over
    the dtype's peak."""
    B, H, S, P = x.shape
    N = b.shape[3]
    es = x.element_size()
    nbytes = ((2 * x.numel() + 2 * b.numel() + B * H * N * P) * es
              + B * H * S * 4 + H * 4)
    pairs = chunk * (chunk + 1) // 2
    flops = B * H * (S // chunk) * (2 * pairs * (N + P)
                                    + 4 * chunk * N * P)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS[str(x.dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def ssd_wgmma_flops(B: int, H: int, G: int, S: int, N: int, chunk: int,
                    heads: int) -> int:
    """The ``wgmma_bf16`` route's own tensor-core work at this shape,
    counted as its kernels issue it (m64n64k16 products, the hi + lo
    splits included), with ``heads`` heads a y work item: the state kernel
    N / 64 x 8 products per 64-row tile and chunk; the y kernel, per query
    tile i and chunk c, C B^T (i + 1) x N / 16 products once for the
    item's heads, and per head its (i + 1) x 8 intra-chunk products and,
    for c > 0, 2 x N / 16 for C S_c."""
    nt, chunks, k16 = -(-chunk // 64), S // chunk, N // 16
    products = B * H * chunks * (N // 64) * nt * 8
    for c in range(chunks):
        for i in range(nt):
            products += B * H // heads * (
                (i + 1) * k16 + heads * ((i + 1) * 8 + (2 * k16 if c else 0)))
    return products * 2 * 64 * 64 * 16


def phase_ssd_kernel(torch, ss):
    """SSD kernel vs its plain version on the card; times at the paths'
    shapes, with the mma_bf16 route's (``prior_ms``, the ``-DSSD_FORCE_MMA``
    build, in turns with the new route), each route's device time by
    kernel from a profile of 10 calls and its host time a call
    (``host_us``).  No single PyTorch call computes the
    SSD scan, so there is no library time."""
    import torch.nn.functional as F
    lib, prior_lib = ss._lib(), ss._lib(SSD_MMA_DEFINES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    # name, B, H, G, S, P, N, chunk, dtype, decay
    cases = [
        ("mamba2_path", 4, 64, 1, 512, 64, 128, 256, bf16, "normal"),
        ("zamba2_path", 4, 80, 1, 512, 64, 64, 256, bf16, "normal"),
        # tests/test_kernels.py::TestSSDScan, groups pre-broadcast (G = H)
        ("t_1x1_s32_c8", 1, 1, 1, 32, 8, 4, 8, f32, "normal"),
        ("t_2x3_s64_c16", 2, 3, 3, 64, 16, 8, 16, f32, "normal"),
        ("t_1x2_s128_c32", 1, 2, 2, 128, 32, 16, 32, f32, "normal"),
        ("t_2x1_s64_c64", 2, 1, 1, 64, 8, 8, 64, f32, "normal"),
        ("groups_2_of_4", 2, 4, 2, 64, 16, 8, 16, f32, "normal"),
        ("single_chunk", 2, 4, 1, 256, 64, 128, 256, f32, "normal"),
        # tiles and P slices cut short: chunk 96, P 40, N 48
        ("ragged_c96_p40_n48", 2, 3, 1, 192, 40, 48, 96, f32, "normal"),
        ("strong_decay", 2, 4, 1, 512, 64, 128, 256, f32, "strong"),
        ("weak_decay", 2, 4, 1, 512, 64, 128, 256, f32, "weak"),
        # the tensor-core routes at the options above (mma_bf16 at P 16 and
        # P 40, wgmma_bf16 at P 64)
        ("groups_2_of_4_bf16", 2, 4, 2, 64, 16, 8, 16, bf16, "normal"),
        ("single_chunk_bf16", 2, 4, 1, 256, 64, 128, 256, bf16, "normal"),
        ("ragged_c96_p40_n48_bf16", 2, 3, 1, 192, 40, 48, 96, bf16,
         "normal"),
        ("strong_decay_bf16", 2, 4, 1, 512, 64, 128, 256, bf16, "strong"),
        ("weak_decay_bf16", 2, 4, 1, 512, 64, 128, 256, bf16, "weak"),
        # the wgmma route's edges: chunks that are no multiple of its
        # 64-row tiles (TMA zero fill, clipped stores) with 3 heads a group
        # (one head a y work item), and groups with 16-row chunks
        ("ragged_c96_p64_n64_bf16", 2, 3, 1, 192, 64, 64, 96, bf16,
         "normal"),
        ("groups_2_of_4_c16_p64_bf16", 2, 4, 2, 64, 64, 128, 16, bf16,
         "normal"),
    ]
    for b, g, s, chunk in ((4, 1, 512, 256), (2, 3, 192, 96), (1, 2, 64, 16)):
        if lib.ssd_scan_scratch_floats(b, g, s, chunk) != \
                ss.scratch_numel(b, g, s, chunk):
            fail(f"scratch size of ({b}, {g}, {s}, {chunk}) differs between "
                 f"the kernel and the wrapper")
    for b, h, s, p, n, chunk in ((4, 64, 512, 64, 128, 256),
                                 (4, 80, 512, 64, 64, 256),
                                 (2, 3, 192, 64, 64, 96)):
        if lib.ssd_scan_state_scratch_bytes(b, h, s, p, n, chunk) != \
                ss.state_scratch_bytes(b, h, s, p, n, chunk):
            fail(f"state scratch size of ({b}, {h}, {s}, {p}, {n}, {chunk}) "
                 f"differs between the kernel and the wrapper")

    def prior(x, dt, a, bm, cm, chunk):
        return ss.launch(prior_lib, x, dt, a, bm, cm, chunk, "mma_bf16")

    worst, timed = 0.0, {}
    for name, b, h, g, s, p, n, chunk, dt_, decay in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (0.5 * rand(b, h, s, p)).to(dt_)
        dt = F.softplus(rand(b, h, s))
        a = -torch.exp(0.3 * rand(h))
        if decay == "strong":       # exp(cum) underflows within a chunk
            a, dt = torch.full_like(a, -8.0), dt + 4.0
        elif decay == "weak":       # almost no decay across 512 steps
            a = -1e-3 * torch.exp(0.3 * rand(h))
        bm = (0.5 * rand(b, g, s, n)).to(dt_)
        cm = (0.5 * rand(b, g, s, n)).to(dt_)
        route = ss.route(dt_, p, n)
        (y, st), launched, seen, _ = ssd_kernels_of_call(
            torch, ss, lib, lambda: ss.ssd_scan_bhsd(x, dt, a, bm, cm, chunk))
        faults = route_faults(ss.route_kernels({route: 1}), launched, seen)
        if faults:
            fail(f"ssd_scan_bhsd case {name}: the wrapper's route is {route}; "
                 + "; ".join(faults))
        y0, st0 = ss.ssd_scan_plain(x, dt, a, bm, cm, chunk)
        # f32: the kernel sums in another order than the plain version;
        # bf16: both round the f32 result to bf16 once
        tol = 1e-4 if dt_ == f32 else 2e-2

        def max_err_ok(outs):
            max_err, ok = 0.0, True
            for got, want in zip(outs, (y0, st0)):
                err = (got.float() - want.float()).abs()
                max_err = max(max_err, float(err.max()))
                ok = ok and bool(torch.isfinite(got).all()) and not bool(
                    (err > tol + tol * want.float().abs()).any())
            return max_err, ok
        max_err, ok = max_err_ok((y, st))
        extra = {}
        if route == "wgmma_bf16":    # the old route's error at this case
            old, old_launched, old_seen, _ = ssd_kernels_of_call(
                torch, ss, prior_lib, lambda: prior(x, dt, a, bm, cm, chunk))
            faults = route_faults(ss.route_kernels({"mma_bf16": 1}),
                                  old_launched, old_seen)
            if faults:
                fail(f"{SSD_MMA_DEFINES} build at case {name}: "
                     + "; ".join(faults))
            extra["prior_max_abs_err"] = max_err_ok(old)[0]
            del old
        emit("kernel_check", kernel="ssd_scan_bhsd", case=name,
             shape=[b, h, g, s, p, n], chunk=chunk, dtype=str(dt_),
             route=route, kernels_launched=launched, kernels_seen=seen,
             decay=decay, max_abs_err=max_err, tol=tol, ok=ok, **extra)
        if not ok:
            fail(f"ssd_scan_bhsd case {name}: max_abs_err {max_err}")
        if name.endswith("_path"):
            worst = max(worst, max_err)
            timed[name] = (x, dt, a, bm, cm, chunk)
    times = {}
    for name, args in timed.items():
        x, bm, chunk = args[0], args[3], args[5]
        route = ss.route(x.dtype, x.shape[3], bm.shape[3])
        calls = {"kernel": lambda: ss.ssd_scan_bhsd(*args),
                 "prior": lambda: prior(*args)}
        runs = {"kernel": [], "prior": []}
        for which in (("kernel", "prior", "prior", "kernel")
                      if route == "wgmma_bf16" else ("kernel", "kernel")):
            runs[which].append(cuda_ms(calls[which]))
        kernel_ms = sum(runs["kernel"]) / len(runs["kernel"])
        prior_ms = (sum(runs["prior"]) / len(runs["prior"])
                    if runs["prior"] else None)
        split = ssd_kernels_of_call(torch, ss, lib, calls["kernel"], 10)[3]
        prior_split = (ssd_kernels_of_call(torch, ss, prior_lib,
                                           calls["prior"], 10)[3]
                       if runs["prior"] else None)
        host = {k: host_us(torch, fn) for k, fn in calls.items()
                if runs[k]}
        plain_ms = cuda_ms(lambda: ss.ssd_scan_plain(*args))
        bound_ms, bound_by = ssd_bound_ms(x, bm, chunk)
        B, H, S, P = x.shape
        G, N = bm.shape[1], bm.shape[3]
        heads = 2 if (H // G) % 2 == 0 else 1
        flops = (ssd_wgmma_flops(B, H, G, S, N, chunk, heads)
                 if route == "wgmma_bf16" else None)
        times[name] = dict(shape=list(x.shape) + [G, N], chunk=chunk,
                           dtype=str(x.dtype), route=route,
                           kernel_ms=kernel_ms, kernel_ms_runs=runs["kernel"],
                           kernel_split_ms=split,
                           prior_route="mma_bf16" if runs["prior"] else None,
                           prior_ms=prior_ms, prior_ms_runs=runs["prior"],
                           prior_split_ms=prior_split,
                           host_us=host.get("kernel"),
                           prior_host_us=host.get("prior"),
                           kernel_mma_flops=flops, plain_ms=plain_ms,
                           library_ms=None, bound_ms=bound_ms,
                           bound_by=bound_by)
        emit("kernel_time", kernel="ssd_scan_bhsd", case=name,
             note="no single PyTorch call computes the SSD scan",
             **times[name])
    t = times["mamba2_path"]
    return {"name": "ssd_scan_bhsd", "route": "cuda",
            "kernel_route": t["route"], "kernel_routes": list(ss.ROUTES),
            "prior_ms": t["prior_ms"],
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:74",
            "max_abs_err": worst, "max_err": worst, "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "path_shapes": times}


# the decode kernel's device functions, as a profile names them (the
# splitk routes' and mma_bf16's)
DECODE_KERNELS = ("decode_attention_kernel", "decode_attention_mma_kernel")


def decode_kernels_seen(torch, events) -> int:
    """Decode-attention launches in a profile's ``key_averages()``."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.count for e in events if e.device_type == cuda
               and any(f"{n}<" in e.key for n in DECODE_KERNELS))


def decode_bound_ms(b: int, nq: int, nkv: int, d: int, rows: int,
                    elem_bytes: int) -> tuple:
    """Least time for the card: the visible K and V rows and q read once,
    the f32 output written once, over HBM rate, vs QK^T and PV over those
    rows (4 x B x nq x D a row) at the f32 peak (the kernel's math)."""
    nbytes = (2 * b * rows * nkv * d + b * nq * d) * elem_bytes \
        + b * nq * d * 4
    flops = 4 * b * nq * d * rows
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS["torch.float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def decode_attention_calls(cfg) -> int:
    """Decode-kernel calls in one decode step: one per attention layer (the
    hybrid: per call of its shared block; encdec: self and cross)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period
    return cfg.num_layers * (2 if cfg.family == "encdec" else 1)


def decode_graphs_a_slot(cfg, decode_steps: int) -> int:
    """Decode graphs a serve slot captures (``train.steps.DecodeStep``):
    one, and one more for the first step where the prefill leaves the SSM
    state in a dtype narrower than f32 (the bf16 ssm and hybrid paths: that
    step reads it and writes the f32 state of the later steps); none past
    the steps a microbatch runs."""
    narrow = cfg.family in ("ssm", "hybrid") and cfg.dtype != "float32"
    return min(max(decode_steps - 1, 0), 2 if narrow else 1)


def serve_runs(cfg, apps: int, decode_steps: int,
               slots: Optional[int] = None) -> dict:
    """How a serve run of ``apps`` microbatches (all its sessions') runs its
    steps: for the prefill and the decode step, the executions the kernel
    wrappers see on the host (eager calls and captures) and those the
    device runs (eager calls and replays), and each kind of graph's
    captures and replays.

    ``slots=None``: the parent's route (each prefill eager into a fresh
    cache; each decode app its own graph: an eager first step, one
    capture, replays).  Else the slots' route (``launch.serve.SlotPool``):
    each of ``slots`` slots runs its first prefill eagerly and captures its
    graph, later microbatches replay it; each slot captures its decode graphs
    (``decode_graphs_a_slot``) after an eager step each, and every other
    step of every microbatch is a replay."""
    steps = max(decode_steps - 1, 0)
    if slots is None:
        dcap, pcap, eager = apps * min(steps, 1), 0, apps
    else:
        dcap = slots * decode_graphs_a_slot(cfg, decode_steps)
        pcap = eager = slots
    return {"prefill": {"host": eager + pcap, "device": apps},
            "decode": {"host": 2 * dcap, "device": apps * steps},
            "graphs": {"prefill": {"captures": pcap,
                                   "replays": apps - eager},
                       "decode": {"captures": dcap,
                                  "replays": apps * steps - dcap}}}


def expected_decode_launches(cfg, apps: int, decode_steps: int,
                             runs: Optional[dict] = None) -> dict:
    """Decode-kernel launches of ``apps`` decode apps of ``decode_steps``
    tokens (``decode_steps - 1`` steps each), run as ``runs``
    (``serve_runs``; default the parent's route: the first step eager,
    then one capture, then replays): on the host, the wrapper's count (the
    eager steps and the captures); on the device (``kernel_launches``),
    every executed step (the eager steps and the replays)."""
    runs = runs or serve_runs(cfg, apps, decode_steps)
    calls = decode_attention_calls(cfg)
    return {w: calls * runs["decode"][w] for w in ("host", "device")}


def decode_route(torch, cfg, da) -> str:
    """The decode kernel's route on a path: the model dtype's, by its
    query heads a kv head and head dim (whisper's self and cross caches
    share them; an attention-free model, which launches none, counts on
    one head's route)."""
    group = cfg.num_heads // cfg.num_kv_heads if cfg.num_kv_heads else 1
    return da.route(cfg.torch_dtype, group, cfg.resolved_head_dim)


def decode_device_delta(da, before: dict, route: str) -> int:
    """Decode launches the device counted since ``before`` on ``route``;
    fails if another route counted any."""
    after = da.kernel_launches(da._lib())
    other = {r: after[r] - before[r] for r in after
             if r != route and after[r] != before[r]}
    if other:
        fail(f"decode launches on {other}, expected {route} only")
    return after[route] - before[route]


# name, B, nq, nkv, T, D, pos, window, cap, all_rows (each in f32 and bf16)
DECODE_OPTION_CASES = [
    ("gqa1_d128", 2, 4, 4, 300, 128, 211, 0, 0.0, False),
    ("gqa2_d64_last_row", 2, 8, 4, 300, 64, 299, 0, 0.0, False),
    ("gqa3_d80", 2, 6, 2, 300, 80, 150, 0, 0.0, False),
    ("gqa6_d128_cap50", 2, 12, 2, 257, 128, 256, 0, 50.0, False),
    ("gqa8_d64", 2, 16, 2, 200, 64, 150, 0, 0.0, False),
    # two chunks of 6 query heads a kv head (command-r-plus-104b's group)
    ("gqa12_d128", 2, 24, 2, 300, 128, 250, 0, 0.0, False),
    # the window's 300 rows over five splits, its first not on an edge
    ("window300_cap5_d80", 2, 4, 2, 400, 80, 350, 300, 5.0, False),
    # pos in the first split: splits 2..4 empty
    ("pos9_first_split_d128", 2, 4, 4, 512, 128, 9, 0, 0.0, False),
    ("pos0_d16_gqa8", 1, 8, 1, 200, 16, 0, 0, 0.0, False),
    ("all_rows_d64", 2, 8, 8, 300, 64, 0, 0, 0.0, True),
    ("d256_gqa2", 1, 2, 1, 100, 256, 99, 0, 0.0, False),
    ("strided_kv_d128", 2, 8, 2, 300, 128, 200, 0, 0.0, False),
]
# each serve path's decode shapes (bf16, the cache at prompt + 16 rows, the
# last position): (name, B, nq, nkv, T, D, window, cap, all_rows)
DECODE_PATH_CASES = [
    ("codeqwen", 4, 32, 32, 528, 128, 0, 0.0, False),
    ("gemma2_local", 2, 32, 16, 8208, 128, 4096, 50.0, False),
    ("gemma2_global", 2, 32, 16, 8208, 128, 0, 50.0, False),
    ("nemotron", 4, 48, 8, 528, 128, 0, 0.0, False),
    ("chameleon", 4, 64, 8, 528, 128, 0, 0.0, False),
    ("granite", 4, 24, 8, 528, 64, 0, 0.0, False),
    ("whisper_self", 4, 20, 20, 528, 64, 0, 0.0, False),
    ("whisper_cross", 4, 20, 20, 66, 64, 0, 0.0, True),
    ("zamba2", 4, 32, 32, 528, 80, 0, 0.0, False),
]


def library_decode(torch, da, q, k, v, pos: int, opts: dict) -> tuple:
    """One PyTorch call that computes the decode on these inputs, and its
    name: SDPA with ``enable_gqa`` and a boolean row mask on the (B, H, 1,
    D) / (B, Hkv, T, D) views of q and the cache; with a cap, a compiled
    ``flex_attention`` with a tanh score and the row mask as a block mask.
    Held to the plain version first (2e-2: its output is bf16); (None,
    reason) where it fails or disagrees."""
    import torch.nn.functional as F
    t = k.shape[1]
    window, cap = opts["window"], opts["logit_cap"]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    gqa = q.shape[1] != k.shape[2]
    rows = torch.arange(t, device=q.device)
    keep = (rows >= 0) if opts["all_rows"] else (rows <= pos)
    if window:
        keep = keep & (pos - rows < window)
    try:
        if not cap:
            mask = keep[None, None, None]

            def call():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=gqa)
            name = "sdpa"
        else:
            from torch.nn.attention.flex_attention import (create_block_mask,
                                                           flex_attention)

            def score_mod(score, b, h, qi, ki):
                return cap * torch.tanh(score / cap)

            def mask_mod(b, h, qi, ki):
                m = ki <= pos
                return m & (pos - ki < window) if window else m

            block = create_block_mask(mask_mod, None, None, 1, t,
                                      device=q.device)
            flex = torch.compile(flex_attention)

            def call():
                return flex(qs, ks, vs, score_mod=score_mod,
                            block_mask=block, enable_gqa=gqa)
            name = "flex_attention"
        want = da.decode_attention_plain(q, k, v, torch.tensor(pos),
                                         **opts)
        err = float((call()[:, :, 0].float() - want).abs().max())
    except Exception as exc:  # noqa: BLE001 - reported as "none"
        return None, f"none: {type(exc).__name__}: {str(exc)[:120]}"
    if not err <= 2e-2:
        return None, f"none: {name} differs by {err}"
    return call, f"{name} (max_abs_err {err})"


def decode_routes(torch, da, dtype, d: int) -> list:
    """Every decode route that takes a cache of this dtype and head dim:
    f32 ``splitk_f32``; bf16 ``splitk_bf16`` and, at D a multiple of 16,
    ``mma_bf16``."""
    if dtype == torch.float32:
        return ["splitk_f32"]
    return ["splitk_bf16"] + (["mma_bf16"] if d % 16 == 0 else [])


def phase_decode_kernel(torch, da):
    """The decode kernel against its plain version on the card: every
    option case in f32 and in bf16, then each serve path's decode shape
    (bf16, the last position), each on every route that takes its dtype
    and head dim (``decode_routes``): the wrapper's call on the route
    ``route(dtype, group, D)`` names, each other route launched directly
    (``da.launch``) with its own split rule; each launch's route read from
    the library's own device counter (one launch, on that route), each
    held to 2e-5 x max|V| (both f32 outputs of the same inputs: only the
    order of the sums, the exponential and, on ``mma_bf16``, the hi + lo
    halves of P differ).  Timed per case (``cuda_ms``), the routes in
    turns (each, then each in reverse): every route, the plain version,
    the bound (``decode_bound_ms``); at the path shapes also one library
    call (``library_decode``) and the host time of a wrapper call.
    ``prior_ms``: the old ``splitk_bf16`` route's time where the wrapper
    takes ``mma_bf16``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    lib = da._lib()
    cases = [(f"{n}_{dt}", b, nq, nkv, t, d, pos, w, cap, rows, dtype)
             for n, b, nq, nkv, t, d, pos, w, cap, rows in
             DECODE_OPTION_CASES
             for dt, dtype in (("f32", torch.float32),
                               ("bf16", torch.bfloat16))]
    cases += [(f"{n}_path", b, nq, nkv, t, d, t - 1, w, cap, rows,
               torch.bfloat16)
              for n, b, nq, nkv, t, d, w, cap, rows in DECODE_PATH_CASES]
    worst, times, checked = 0.0, {}, {}
    for name, b, nq, nkv, t, d, pos, window, cap, all_rows, dt in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q = rand(b, nq, d)
        if name.startswith("strided_kv"):     # K and V of one wider tensor
            kv = rand(b, t, nkv, 2 * d + 8)
            k, v = kv[..., :d], kv[..., d + 8:]
        else:
            k, v = rand(b, t, nkv, d), rand(b, t, nkv, d)
        at = torch.tensor(pos, device="cuda")
        opts = dict(window=window, logit_cap=cap, all_rows=all_rows)
        route = da.route(dt, nq // nkv, d)
        want = da.decode_attention_plain(q, k, v, at, **opts)
        vmax = float(v.float().abs().max())
        tol = 2e-5 * vmax
        calls, per_route, ok = {}, {}, True
        for r in decode_routes(torch, da, dt, d):
            splits = da.splits_for(lib, r, q, k, window, all_rows)
            if r == route:
                calls[r] = (lambda: da.decode_attention(q, k, v, at, **opts))
            else:
                def call(r=r, splits=splits):
                    out = torch.empty(q.shape, dtype=torch.float32,
                                      device="cuda")
                    da.launch(lib, q, k, v, None if all_rows else at, out,
                              window, cap, splits, r)
                    return out
                calls[r] = call
            before = da.kernel_launches(lib)
            got = calls[r]()
            torch.cuda.synchronize()
            launched = {x: n - before[x] for x, n in
                        da.kernel_launches(lib).items() if n != before[x]}
            max_err = float((got - want).abs().max())
            r_ok = bool(torch.isfinite(got).all()) and max_err <= tol \
                and launched == {r: 1}
            ok = ok and r_ok
            per_route[r] = dict(splits=splits, max_abs_err=max_err,
                                routes_launched=launched, ok=r_ok)
            if name.endswith("_path"):
                worst = max(worst, max_err)
            del got
        order = list(calls)
        ms = {r: [] for r in order}
        for r in order + order[::-1]:
            ms[r].append(cuda_ms(calls[r]))
        for r in order:
            per_route[r]["cuda_ms"] = sum(ms[r]) / len(ms[r])
            per_route[r]["cuda_ms_turns"] = ms[r]
        lo, end = da.visible_rows(pos, t, window, all_rows)
        rows = end - lo
        bound_ms, bound_by = decode_bound_ms(b, nq, nkv, d, rows,
                                             q.element_size())
        kernel_ms = per_route[route]["cuda_ms"]
        plain_ms = cuda_ms(lambda: da.decode_attention_plain(q, k, v, at,
                                                             **opts))
        row = dict(shape=[b, nq, nkv, t, d], dtype=str(dt), route=route,
                   pos=pos, window=window, cap=cap, all_rows=all_rows,
                   splits=per_route[route]["splits"], visible_rows=rows,
                   routes_launched=per_route[route]["routes_launched"],
                   max_abs_err=max(x["max_abs_err"]
                                   for x in per_route.values()),
                   tol=tol, ok=ok, cuda_ms=kernel_ms,
                   prior_ms=(per_route["splitk_bf16"]["cuda_ms"]
                             if route == "mma_bf16" else None),
                   routes=per_route, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / kernel_ms)
        if name.endswith("_path"):
            library, note = library_decode(torch, da, q, k, v, pos, opts)
            row.update(library_ms=cuda_ms(library) if library else None,
                       library=note,
                       host_us=host_us(torch, lambda: da.decode_attention(
                           q, k, v, at, **opts)))
            times[name] = row
        else:
            checked[name] = row
        emit("kernel_check", kernel="decode_attention", case=name, **row)
        if not ok:
            fail(f"decode_attention case {name}: tol {tol}, by route "
                 f"{per_route} (the wrapper's route {route})")
        del q, k, v, want
    t = times["codeqwen_path"]
    # each route at the first path shape the wrapper sends to it (f32:
    # the first option case)
    by_route = {}
    for name, row in list(times.items()) + list(checked.items()):
        if row["route"] not in by_route:
            by_route[row["route"]] = dict(
                shape=name, ms=row["cuda_ms"], prior_ms=row["prior_ms"],
                bound_ms=row["bound_ms"], plain_ms=row["plain_ms"],
                library_ms=row.get("library_ms"), splits=row["splits"])
    return {"name": "decode_attention", "route": "cuda",
            "kernel_route": t["route"], "kernel_routes": list(da.ROUTES),
            "by_route": by_route, "prior_ms": t["prior_ms"],
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/models/attention.py:149 (jnp inside "
                        "jax.jit, src/repro/launch/serve.py:76; no Pallas "
                        "kernel)",
            "max_abs_err": worst, "max_err": worst, "ms": t["cuda_ms"],
            "kernel_ms": t["cuda_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "path_shapes": times}


# The train step's fused update (``kernels/optimizer.py``): the checks' lr
# and clip; AdamW's other hyperparameters are ``adamw_update``'s defaults,
# which ``make_train_step`` takes
ADAMW_HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
OPT_CHECK_LR = 3e-4
OPT_MAX_NORM = 1.0
OPT_F32_PRESETS = ("tiny", "lm100m")
# drawn leaves whose sqrt(v_hat) sits near eps: a multiple of 8 elements
# (16-byte vectors), one that is not (a tail of n % 8, one element a
# thread of block 0), and views one element in (unaligned pointers)
OPT_DRAWN = (("vec", 1 << 20, 0), ("tail", (1 << 20) + 5, 0),
             ("unaligned", 1 << 20, 1))
OPT_SOURCE = "src/repro_torch/csrc/optimizer.cu"
OPT_REPLACES = {
    "adamw_update": "src/repro/optim/adamw.py:36 adamw_update (jnp inside "
                    "jax.jit, src/repro/launch/train.py:96; no Pallas "
                    "kernel)",
    "sumsq": "src/repro/optim/adamw.py:28 clip_by_global_norm's sum of "
             "squares (jnp inside jax.jit, src/repro/launch/train.py:96; "
             "no Pallas kernel)"}
OPT_SHAPE = "codeqwen1.5-7b 16 layers"


# the train kernels by part, each of which ``plain_kernels`` can send to
# its plain version on the card
PLAIN_PARTS = ("attention", "norms", "fused", "add_norm", "gated_norm",
               "gate", "loss", "optimizer")


@contextlib.contextmanager
def plain_kernels(parts):
    """The plain versions of the train kernels of ``parts`` on the card,
    every other part on its kernels: ``attention`` the training
    attention's (``kernels.train_attention.takes_kernel`` answers False);
    ``norms`` the RMSNorm's and RoPE's (``kernels.norm_rope.takes_kernel``
    answers False); ``fused`` the fused entry points' unfused ops
    (``takes_fused`` answers False: the adds, silu and the product, RoPE's
    bias adds, then the route of ``norms``); ``add_norm`` and
    ``gated_norm`` the block's add norm and the SSM's gated norm alone
    (their callers take ``add_rms_norm_plain`` / ``gated_rms_norm_plain``);
    ``gate`` and ``loss`` the gate's and the loss's (``kernels.gated_mlp``
    and ``kernels.cross_entropy`` answer False); ``optimizer`` the update's
    and the global norm's (``optim.adamw`` is shown no kernel device)."""
    import types

    from repro_torch.kernels import cross_entropy as CE
    from repro_torch.kernels import gated_mlp as GM
    from repro_torch.kernels import norm_rope as NR
    from repro_torch.kernels import train_attention as TA
    from repro_torch.models import common as C
    from repro_torch.models import model as MM
    from repro_torch.models import ssm as SM
    from repro_torch.optim import adamw as A

    def no(*args, **kwargs):
        return False
    patches = {"attention": [(TA, "takes_kernel", no)],
               "norms": [(NR, "takes_kernel", no)],
               "fused": [(NR, "takes_fused", no)],
               "add_norm": [(MM, "add_rms_norm", C.add_rms_norm_plain)],
               "gated_norm": [(SM, "gated_rms_norm",
                               C.gated_rms_norm_plain)],
               "gate": [(GM, "takes_kernel", no)],
               "loss": [(CE, "takes_kernel", no)],
               "optimizer": [(A, "K", types.SimpleNamespace(
                   takes_kernel=no))]}
    todo = [p for part in parts for p in patches[part]]
    real = [(mod, name, getattr(mod, name)) for mod, name, _ in todo]
    for mod, name, fn in todo:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in reversed(real):
            setattr(mod, name, fn)


def plain_optimizer():
    """The optimizer's plain versions on the card, for the checks and the
    parent's columns only: ``optim.adamw`` is shown no kernel device, so
    it runs as it did before its kernels."""
    return plain_kernels(("optimizer",))


def plain_train_attention():
    """The training attention's plain ops on the card, for step 1's plain
    grads and the FLOP-counted steps (``FlopCounterMode`` cannot see a
    ctypes launch): ``models.attention._attend`` is shown no kernel
    device, so it runs as it did before the kernels."""
    return plain_kernels(("attention",))


def same_bits(torch, a, b) -> bool:
    """Equal shapes, dtypes and bits (NaNs and signed zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(ints), b.view(ints))


def check_update(torch, A, opt, leaves4, step, lr, scale) -> dict:
    """Each leaf (p, g, m, v) through the port's entry points, against
    ``adamw_update_`` under ``plain_optimizer`` (the plain version, in
    place on the leaf itself), p, m and v to the bit: at ``step``,
    ``adamw_update_`` (the kernel in place) on copies; at the next step,
    from the leaf as the plain version left it, ``adamw_update`` (the
    kernel out of place), which must leave its inputs' bits as they were
    (their ``sumsq``, which repeats itself to the bit).  One copy of a
    leaf is alive at a time; the leaves end two steps on."""
    bad, n, worst = [], 0, 0.0

    def plain(p, g, m, v, at):
        with plain_optimizer():       # a copy: it advances the step
            A.adamw_update_(p, g, A.AdamWState(at.clone(), m, v), lr=lr,
                            scale=scale)

    def compare(form, got, want):
        nonlocal worst
        for name, a, b in zip("pmv", got, want):
            if not same_bits(torch, a, b):
                worst = max(worst, float((a.float() - b.float()).abs()
                                         .nan_to_num(float("inf")).max()))
                bad.append(f"leaf {i} {name} {form}")
    for i, (p, g, m, v) in enumerate(leaves4):
        ins = (p.clone(), m.clone(), v.clone())
        A.adamw_update_(ins[0], g, A.AdamWState(step.clone(), ins[1],
                                                ins[2]), lr=lr, scale=scale)
        plain(p, g, m, v, step)
        compare("in_place", ins, (p, m, v))
        del ins
        sums = [opt.sumsq([t]) for t in (p, m, v)]
        new_p, new_state = A.adamw_update(
            p, g, A.AdamWState(step + 1, m, v), lr=lr, scale=scale)
        if not all(same_bits(torch, a, opt.sumsq([t]))
                   for a, t in zip(sums, (p, m, v))):
            bad.append(f"leaf {i} out_of_place wrote its inputs")
        out = (new_p, new_state.m, new_state.v)
        del new_p, new_state
        plain(p, g, m, v, step + 1)
        compare("out_of_place", out, (p, m, v))
        del out
        n += p.numel()
    return {"leaves": len(leaves4), "elements": n, "bitwise": not bad,
            "differ": bad[:8], "max_abs_err": worst}


def stage_peak(torch, peaks: dict, stage: str) -> None:
    """The device memory peak since the last stage, under ``stage``."""
    torch.cuda.synchronize()
    peaks[stage] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()


def check_sumsq(torch, A, opt, grads) -> dict:
    """``sumsq`` of the grads three times: the same bits each time, within
    1e-6 relative of an f64 sum of the same grads (slice by slice)."""
    gs = list(grads)
    runs = [opt.sumsq(gs) for _ in range(3)]
    want = sum(float(s.double().square().sum()) for g in gs
               for s in A.slices(g))
    got = float(runs[0])
    rel = abs(got - want) / want if want else abs(got)
    repeat = all(same_bits(torch, r, runs[0]) for r in runs[1:])
    return {"sumsq": got, "f64": want, "abs_err": abs(got - want),
            "rel_err": rel, "repeatable": repeat,
            "ok": rel <= 1e-6 and repeat}


def drawn_update_case(torch, A, opt, gen, n, off, p_dt, g_dt, scale):
    """One drawn leaf of ``n`` elements (views ``off`` elements in) whose
    sqrt(v_hat) sits near eps at step 2: grads log-uniform in 1e-11..1e-7
    with random signs, v in [0, 1e-18), m ~ 1e-8."""
    def draw(fn, dt, s):
        return (fn((n + off,), generator=gen, device="cuda") * s).to(dt)[off:]
    mag = torch.exp(torch.empty((n + off,), device="cuda").uniform_(
        math.log(1e-11), math.log(1e-7), generator=gen))
    sign = torch.randint(0, 2, (n + off,), generator=gen, device="cuda")
    g = (mag * (2 * sign - 1)).to(g_dt)[off:]
    p = draw(torch.randn, p_dt, 0.02)
    m = draw(torch.randn, torch.float32, 1e-8)
    v = draw(torch.rand, torch.float32, 1e-18)
    step = torch.ones((), dtype=torch.int32, device="cuda")
    lr = torch.tensor(OPT_CHECK_LR, device="cuda")
    row = check_update(torch, A, opt, [(p, g, m, v)], step, lr, scale)
    row.update(sumsq=check_sumsq(torch, A, opt, [g]))
    return row


def real_update_case(torch, A, opt, cfg, batch: int, seq: int,
                     remat: bool):
    """``cfg``'s seeded state on the card, the grads of one real backward
    (``forward_train``, as the train step takes them) and one kernel update
    to fill m and v; then each leaf at step 2 (``check_update``) and
    ``sumsq`` of the grads.  Returns the check and the state, grads, step,
    lr and clip scale for timing."""
    from repro_torch.data import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train import train_state_init
    from repro_torch.train.steps import _grads
    from repro_torch.tree import leaves
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    peaks = {}
    stage_peak(torch, peaks, "before")
    state = train_state_init(cfg, gen, device="cuda")
    b = _batch_to(torch, synthetic_batch(7, 0, 0, batch, seq,
                                         cfg.vocab_size), "cuda")
    _, grads = _grads(lambda params, mb: M.forward_train(
        params, cfg, mb, remat=remat)[0], state.params, b)
    del b, _
    stage_peak(torch, peaks, "backward")
    lr = torch.tensor(OPT_CHECK_LR, device="cuda")
    scale = A.clip_scale(A.global_norm(grads), OPT_MAX_NORM)
    params, opt_state = A.adamw_update_(state.params, grads, state.opt,
                                        lr=lr, scale=scale)
    row = check_update(torch, A, opt, list(zip(
        leaves(params), leaves(grads), leaves(opt_state.m),
        leaves(opt_state.v))), opt_state.step, lr, scale)
    stage_peak(torch, peaks, "check_update")
    row.update(sumsq=check_sumsq(torch, A, opt, leaves(grads)),
               config=cfg.name, layers=cfg.num_layers,
               dtype=str(cfg.torch_dtype), peaks=peaks)
    stage_peak(torch, peaks, "check_sumsq")
    return row, (params, grads, opt_state, lr, scale)


def optimizer_bound_ms(params, grads) -> dict:
    """Bytes each function must move at 3.35 TB/s against its f32 work at
    67 TFLOP/s (the larger bounds it): the update reads p and g in their
    dtype and m, v in f32 once and writes p, m and v once (22 bytes a bf16
    parameter) and does ~16 f32 operations an element (3 divides and a
    square root among them); ``sumsq`` reads each grad once and does 2."""
    from repro_torch.tree import leaves
    ps, gs = leaves(params), leaves(grads)
    n = sum(p.numel() for p in ps)
    upd = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16)
              for p, g in zip(ps, gs))
    ss = sum(g.numel() * g.element_size() for g in gs)
    out = {}
    for name, nbytes, flops in (("adamw_update", upd, 16 * n),
                                ("sumsq", ss, 2 * n)):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_PEAK_FLOPS["torch.float32"] * 1e3
        out[name] = dict(bytes=nbytes, flops=flops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
    return out


def library_adamw(torch, params, grads, opt_state, lr_value: float):
    """``torch._fused_adamw_`` on the same tensors (grads made contiguous
    first: it takes only the params' strides), in place, or None and why:
    it takes moments in the params' dtype only (bf16 params with f32
    moments it refuses), and whatever else it refuses."""
    from repro_torch.tree import leaves
    ps = leaves(params)
    gs = [g.contiguous() for g in leaves(grads)]
    ms, vs = leaves(opt_state.m), leaves(opt_state.v)
    if any(p.dtype != m.dtype for p, m in zip(ps, ms)) or \
            any(g.dtype != p.dtype for p, g in zip(ps, gs)):
        return None, ("torch._fused_adamw_ takes no moments of another "
                      "dtype than the params")
    steps = [torch.ones((), device="cuda") for _ in ps]
    hp = ADAMW_HP

    def call():
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=lr_value,
                            beta1=hp["b1"], beta2=hp["b2"],
                            weight_decay=hp["weight_decay"], eps=hp["eps"],
                            amsgrad=False, maximize=False)
    try:
        call()
    except RuntimeError as err:
        return None, f"torch._fused_adamw_ refused: {err}"
    return call, "torch._fused_adamw_"


def library_norm(torch, grads):
    """One call that computes each grad's f32 norm: ``torch._foreach_norm``
    with an f32 result where it takes ``dtype``, else
    ``torch.linalg.vector_norm(..., dtype=torch.float32)`` per grad."""
    from repro_torch.tree import leaves
    gs = leaves(grads)
    try:
        torch._foreach_norm(gs, 2, dtype=torch.float32)
        return (lambda: torch._foreach_norm(gs, 2, dtype=torch.float32),
                "torch._foreach_norm(dtype=float32)")
    except (TypeError, RuntimeError):
        return (lambda: [torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in gs],
                "torch.linalg.vector_norm(dtype=float32) per grad")


def time_optimizer(torch, A, opt, params, grads, opt_state, lr, scale,
                   lr_value: float) -> dict:
    """Each kernel over the whole state (``adamw_update`` one launch a
    leaf, in place; ``sumsq`` one launch over every grad), the
    plain version (``plain_optimizer``) and the library call, CUDA events
    (``cuda_ms``); the kernel and the plain version in turns."""
    from repro_torch.tree import leaves
    hp = ADAMW_HP
    c1, c2 = A._bias_corrections(opt_state.step + 1, hp["b1"], hp["b2"])
    four = list(zip(leaves(params), leaves(grads), leaves(opt_state.m),
                    leaves(opt_state.v)))
    gs = leaves(grads)

    def kernel():
        for p, g, m, v in four:
            opt.adamw_update(p, g, m, v, c1, c2, lr, hp["b1"], hp["b2"],
                             hp["eps"], hp["weight_decay"], scale,
                             inplace=True)

    def plain():
        with plain_optimizer():
            A.adamw_update_(params, grads, opt_state, lr=lr, scale=scale)

    def plain_norm():
        with plain_optimizer():
            A.global_norm(grads)
    bounds = optimizer_bound_ms(params, grads)
    out, peaks = {}, {}
    for name, fast, slow, iters in (
            ("adamw_update", kernel, plain, (10, 3)),
            ("sumsq", lambda: opt.sumsq(gs), plain_norm, (20, 3))):
        ms = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            fn, it = (fast, iters[0]) if which == "kernel" \
                else (slow, iters[1])
            ms[which].append(cuda_ms(fn, iters=it, warmup=1))
        out[name] = dict(ms=sum(ms["kernel"]) / 2,
                         plain_ms=sum(ms["plain"]) / 2, turns=ms,
                         **bounds[name])
        stage_peak(torch, peaks, name)
    for name, (call, note) in (
            ("adamw_update", library_adamw(torch, params, grads, opt_state,
                                           lr_value)),
            ("sumsq", library_norm(torch, grads))):
        out[name].update(library_ms=cuda_ms(call, iters=10, warmup=1)
                         if call else None, library=note)
        stage_peak(torch, peaks, f"library_{name}")
    for row in out.values():
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    out["peaks"] = peaks
    return out


def phase_optimizer_kernel(torch, opt) -> list:
    """The train step's two kernels against their plain versions on the
    card, through the port's entry points (``optim.adamw``), bit for bit:
    (a) drawn leaves whose sqrt(v_hat) sits near eps, every (params,
    grads) dtype pair, with and without the clip factor, aligned, with a
    tail and unaligned; (b) the f32 presets' states (tiny, lm100m) with
    the grads of one real backward; (c) codeqwen1.5-7b at full width cut to
    16 layers (``TRAIN_FULL``): its state, the grads of one rematerialised
    backward, leaf by leaf (one leaf's copies alive at a time: the state
    and grads alone take ~54 GB).  ``sumsq`` within 1e-6 relative of an
    f64 sum and the same bits over 3 calls in each.  Then each kernel over
    the whole 16-layer state (and lm100m's) against its bound, the plain
    version and the library call.  Returns the kernels line's two
    entries."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import PRESETS
    from repro_torch.optim import adamw as A
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    t0 = time.monotonic()
    rows, failed = {}, []

    def checked(name, row):
        rows[name] = row
        ok = row["bitwise"] and row["sumsq"]["ok"]
        emit("kernel_check", kernel="optimizer", case=name, ok=ok, **row)
        if not ok:
            failed.append(name)
    dtypes = (torch.float32, torch.bfloat16)
    for case, n, off in OPT_DRAWN:
        for p_dt in dtypes:
            for g_dt in dtypes:
                for clip in (None, 0.37):
                    scale = None if clip is None else \
                        torch.tensor(clip, device="cuda")
                    name = (f"{case}_{opt.adamw_route(p_dt, g_dt)}"
                            f"{'_clip' if clip else ''}")
                    checked(name, drawn_update_case(
                        torch, A, opt, gen, n, off, p_dt, g_dt, scale))
    for preset in OPT_F32_PRESETS:
        row, held = real_update_case(torch, A, opt, PRESETS[preset], 4, 128,
                                     remat=False)
        checked(preset, row)
        if preset == "lm100m":
            f32_times = time_optimizer(torch, A, opt, *held, OPT_CHECK_LR)
        del held
    gc.collect()
    torch.cuda.empty_cache()
    f = TRAIN_FULL
    cfg = dataclasses.replace(get_config("codeqwen15_7b"),
                              num_layers=f["layers"])
    row, full = real_update_case(torch, A, opt, cfg, f["batch"], f["seq"],
                                 remat=True)
    checked("codeqwen_16", row)
    times = time_optimizer(torch, A, opt, *full, OPT_CHECK_LR)
    peak = max(*row["peaks"].values(), *times["peaks"].values())
    del full
    gc.collect()
    torch.cuda.empty_cache()
    emit("optimizer_times", config=cfg.name, layers=cfg.num_layers,
         full_width=times, lm100m=f32_times, max_memory_allocated=peak,
         seconds=time.monotonic() - t0)
    if failed:
        fail(f"optimizer kernels differ from the plain version: {failed}")
    worst = {"adamw_update": max(r["max_abs_err"] for r in rows.values()),
             "sumsq": max(r["sumsq"]["abs_err"] for r in rows.values())}
    entries = []
    for name in ("adamw_update", "sumsq"):
        t = times[name]
        entries.append({
            "name": name, "route": "cuda",
            "kernel_route": "bf16_bf16" if name == "adamw_update" else "bf16",
            "kernel_routes": list(opt.ADAMW_ROUTES if name == "adamw_update"
                                  else opt.SUMSQ_ROUTES),
            "source": OPT_SOURCE, "replaces": OPT_REPLACES[name],
            "shape": OPT_SHAPE, "max_abs_err": worst[name],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "f32_lm100m": f32_times[name]})
    return entries


# The train step's attention kernels (``kernels/train_attention.py``).
TA_SOURCE = "src/repro_torch/csrc/train_attention.cu"
TA_REPLACES = ("src/repro/models/attention.py:118 (_gqa_scores, softcap, the "
               "mask, jax.nn.softmax, _gqa_out: jnp inside jax.jit, "
               "src/repro/launch/train.py:96; no Pallas kernel)")
TA_SHAPE = "codeqwen1.5-7b train: B8 32/32 heads S512 D128 causal bf16"
# (name, B, S, T, Hq, Hkv, D, q dtype, k and v dtype, causal, window, cap):
# every option of the kernels, f32 and bf16, the train paths' shapes;
# "path" is codeqwen1.5-7b's train attention and "lm100m_f32" lm100m's
# through the engine (8 x 128 tokens), both also timed
TA_CASES = (
    ("gqa6_d128_bf16", 2, 200, 200, 12, 2, 128, "bf16", "bf16", True, 0, 0.0),
    ("gqa3_d64_bf16", 2, 200, 200, 6, 2, 64, "bf16", "bf16", True, 0, 0.0),
    ("mha_d80_bf16", 2, 136, 136, 4, 4, 80, "bf16", "bf16", True, 0, 0.0),
    ("window4096_cap50_d128_bf16", 1, 4200, 4200, 4, 2, 128, "bf16", "bf16",
     True, 4096, 50.0),
    ("cap50_d128_bf16", 1, 300, 300, 4, 2, 128, "bf16", "bf16", True, 0,
     50.0),
    ("cross_d64_bf16", 2, 100, 150, 4, 4, 64, "bf16", "bf16", False, 0, 0.0),
    ("cross_d64_mixed", 2, 100, 150, 4, 4, 64, "bf16", "f32", False, 0, 0.0),
    ("encoder_d64_f32", 2, 150, 150, 4, 4, 64, "f32", "f32", False, 0, 0.0),
    ("gqa6_d128_f32", 2, 200, 200, 12, 2, 128, "f32", "f32", True, 0, 0.0),
    ("d64_f32", 2, 200, 200, 4, 4, 64, "f32", "f32", True, 0, 0.0),
    ("window100_cap50_d128_f32", 1, 300, 300, 4, 2, 128, "f32", "f32", True,
     100, 50.0),
    ("d16_f32", 2, 72, 72, 4, 4, 16, "f32", "f32", True, 0, 0.0),
    ("lm100m_f32", 8, 128, 128, 12, 12, 64, "f32", "f32", True, 0, 0.0),
    # the wgmma_bf16 route's own edges: S not a multiple of its 128-row
    # items at D 64, a window and a cap crossing its 64-key tiles at D 64,
    # non-causal S != T at D 128, q read by head-major strides (a (B, H, S,
    # D) tensor's transposed view) at D 64 and 128
    ("len200_d64_bf16", 2, 200, 200, 4, 4, 64, "bf16", "bf16", True, 0,
     0.0),
    ("window100_cap50_d64_bf16", 1, 300, 300, 4, 2, 64, "bf16", "bf16",
     True, 100, 50.0),
    ("cross_d128_bf16", 2, 100, 150, 4, 4, 128, "bf16", "bf16", False, 0,
     0.0),
    ("q_head_major_d128_bf16", 2, 200, 200, 6, 2, 128, "bf16", "bf16", True,
     0, 0.0),
    ("q_head_major_d64_bf16", 2, 136, 136, 4, 4, 64, "bf16", "bf16", False,
     0, 0.0),
    ("path", 8, 512, 512, 32, 32, 128, "bf16", "bf16", True, 0, 0.0),
    # zamba2-2.7b's shared block in its train step (D 80: mma_bf16)
    ("zamba2_train", 8, 512, 512, 32, 32, 80, "bf16", "bf16", True, 0, 0.0),
)
TA_TIMED = ("path", "lm100m_f32", "zamba2_train")
TA_ZAMBA2_SHAPE = "zamba2-2.7b train: B8 32/32 heads S512 D80 causal bf16"
# Tolerance against the plain version computed in f32 from the same
# values (autograd on the plain ops, f32 leaves): a bf16 result is one
# rounding of an f32 value, so within 2^-8 |b| (half an ulp) plus
# TA_REL_TOL x max|b| for the kernel's f32 sums in another order and P and
# dS as hi + lo halves (~2^-17 of each term); an f32 result within
# TA_REL_TOL x max|b|
TA_REL_TOL = 1e-5
TA_BF16_ULP = 2.0 ** -8


def ta_within(torch, got, want) -> dict:
    """``got`` (a kernel result in its dtype) against ``want`` (the plain
    version in f32) at the stated tolerance."""
    w = want.detach().float()
    err = (got.detach().float() - w).abs()
    scale = float(w.abs().max())
    tol = TA_REL_TOL * scale + (TA_BF16_ULP * w.abs()
                                if got.dtype == torch.bfloat16 else 0.0)
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float(err.max()) / scale if scale else 0.0,
            "ok": bool((err <= tol).all())}


def ta_plain(torch, ta, q, k, v, do, opts) -> tuple:
    """The plain version on f32 leaves of the same values: o, the
    log-sum-exp of each row (B, Hq, S) and the grads (dq, dk, dv), f32."""
    from repro_torch.kernels.ref import gqa_scores, softcap
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    o = ta.train_attention_plain(*leaves, **opts)
    grads = torch.autograd.grad(o, leaves, do.float())
    with torch.no_grad():
        s = softcap(gqa_scores(leaves[0], leaves[1]), opts["logit_cap"])
        S, T = s.shape[-2:]
        rows = torch.arange(S, device=s.device)[:, None]
        cols = torch.arange(T, device=s.device)[None, :]
        seen = torch.ones((S, T), dtype=torch.bool, device=s.device)
        if opts["causal"]:
            seen &= cols <= rows
        if opts["window"]:
            seen &= rows - cols < opts["window"]
        lse = s.masked_fill(~seen, -1e30).logsumexp(-1)
        lse = lse.reshape(q.shape[0], q.shape[2], S)
    return o.detach(), lse, grads


def ta_inputs(torch, case, gen) -> tuple:
    """q, k, v of a case, drawn from ``gen``; with one dtype and S == T,
    views of one fused (B, S, Hq + 2 Hkv, D) tensor, read by strides; a
    "q_head_major" case's q the (B, S, H, D) view of a (B, H, S, D)
    tensor."""
    name, B, S, T, Hq, Hkv, D, qdt, kvdt, *_ = case
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    if name.startswith("q_head_major"):
        q = torch.randn((B, Hq, S, D), device="cuda", generator=gen)
        k = torch.randn((B, T, Hkv, D), device="cuda", generator=gen)
        v = torch.randn((B, T, Hkv, D), device="cuda", generator=gen)
        return (q.to(dts[qdt]).transpose(1, 2), k.to(dts[kvdt]),
                v.to(dts[kvdt]))
    if qdt == kvdt and S == T:
        x = torch.randn((B, S, Hq + 2 * Hkv, D), device="cuda",
                        generator=gen).to(dts[qdt])
        return x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:]
    q = torch.randn((B, S, Hq, D), device="cuda", generator=gen)
    k = torch.randn((B, T, Hkv, D), device="cuda", generator=gen)
    v = torch.randn((B, T, Hkv, D), device="cuda", generator=gen)
    return q.to(dts[qdt]), k.to(dts[kvdt]), v.to(dts[kvdt])


def ta_runs(torch, ta, q, k, v, do, opts, lib) -> tuple:
    """Three calls' (o, dq, dk, dv) and one more forward's log-sum-exp:
    through the port's entry point (``train_attention``, the autograd
    function) with ``lib`` None, else through ``lib``'s launches
    (``train_attention_forward`` / ``_backward``, the old route's build;
    the f32 routes' inputs upcast as the entry point upcasts them)."""
    kq, kk, kv = (t.float() if ta.route(q.dtype, k.dtype, q.shape[3])
                  in ta.F32_ROUTES else t for t in (q, k, v))
    runs = []
    for _ in range(3):
        if lib is None:
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = ta.train_attention(*leaves, **opts)
            runs.append((o.detach(), *torch.autograd.grad(o, leaves, do)))
            del o, leaves
        else:
            o, o32, lse = ta.train_attention_forward(kq, kk, kv, **opts,
                                                     lib=lib)
            runs.append((o, *ta.train_attention_backward(
                kq, kk, kv, o32, lse, do, **opts, lib=lib)))
    lse = ta.train_attention_forward(kq, kk, kv, **opts, lib=lib)[2]
    return runs, lse


def ta_check(torch, ta, case, gen, prior_libs=None) -> dict:
    """One case through the port's entry point three times: o and the
    grads the same bits each time and within the tolerance of the plain
    version, the log-sum-exp too (one more forward launch); each launch
    counted on the device by route.  Where the wrapper's route has an old
    route's build in ``prior_libs`` (route -> (old route, library):
    ``wgmma_bf16`` -> ``mma_bf16``, -DTRAIN_ATTN_FORCE_MMA; ``mma_3xtf32``
    -> ``scalar_f32``, -DTRAIN_ATTN_FORCE_SCALAR), the same again through
    that library's launches, on the old route (``row["prior"]``)."""
    *_, causal, window, cap = case
    opts = dict(causal=causal, window=window, logit_cap=cap)
    q, k, v = ta_inputs(torch, case, gen)
    r = ta.route(q.dtype, k.dtype, q.shape[3])
    odt = torch.float32 if r in ta.F32_ROUTES else q.dtype
    do = torch.randn(q.shape, device="cuda", generator=gen).to(odt)
    po, plse, pgrads = ta_plain(torch, ta, q, k, v, do, opts)

    def check(lib, route) -> dict:
        counter = ta._lib() if lib is None else lib
        before = ta.kernel_launches(counter)
        runs, lse = ta_runs(torch, ta, q, k, v, do, opts, lib)
        torch.cuda.synchronize()
        after = ta.kernel_launches(counter)
        want = {kn: {rn: (4 if kn == "forward" else 3) * (rn == route) * (
            kn != "delta" or rn not in ta.DELTA_IN_DQ)
            for rn in ta.ROUTES} for kn in ta.KERNELS}
        launched = {kn: {rn: after[kn][rn] - before[kn][rn]
                         for rn in ta.ROUTES} for kn in ta.KERNELS}
        got = dict(zip(("o", "dq", "dk", "dv"), runs[0]))
        row = {n: ta_within(torch, got[n], w)
               for n, w in zip(("o", "dq", "dk", "dv"), (po, *pgrads))}
        row["lse"] = ta_within(torch, lse, plse)
        row.update(
            route=route,
            out_dtypes={n: str(t.dtype) for n, t in got.items()},
            repeatable=all(same_bits(torch, a, b) for run in runs[1:]
                           for a, b in zip(run, runs[0])),
            device_launches=launched, launches_ok=launched == want)
        row["ok"] = (all(row[n]["ok"] for n in ("o", "lse", "dq", "dk",
                                                 "dv"))
                     and row["repeatable"] and row["launches_ok"])
        return row

    row = check(None, r)
    row.update(shape=list(case[1:7]), dtypes=list(case[7:9]),
               causal=causal, window=window, cap=cap,
               q_strides=list(q.stride()))
    if r in (prior_libs or {}):
        old_route, lib = prior_libs[r]
        row["prior"] = check(lib, old_route)
        row["ok"] = row["ok"] and row["prior"]["ok"]
    return row


def ta_bounds(q, k, causal: bool, window: int) -> dict:
    """Least times at 3.35 TB/s and the dtype's peak: the forward reads q,
    k, v once and writes o and the f32 log-sum-exp (4 FLOP x D a visible
    pair: Q K^T and P V); the backward reads q, k, v, o, dO and the
    log-sum-exp and writes dq, dk, dv (10 FLOP x D a pair: Q K^T again,
    dO V^T, P^T dO, dS K, dS^T Q)."""
    b, s, hq, d = q.shape
    pairs = visible_pairs(s, k.shape[1], causal, window)
    es = q.element_size()
    lse = b * hq * s * 4
    out = {}
    for name, nbytes, flops in (
            ("forward", (2 * q.numel() + 2 * k.numel()) * es + lse,
             4 * b * hq * d * pairs),
            ("backward", (4 * q.numel() + 4 * k.numel()) * es + lse,
             10 * b * hq * d * pairs)):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_PEAK_FLOPS[str(q.dtype)] * 1e3
        out[name] = dict(bytes=nbytes, flops=flops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
    out["fwd_bwd"] = dict(bound_ms=out["forward"]["bound_ms"]
                          + out["backward"]["bound_ms"])
    return out


def ta_times(torch, ta, case, gen, prior_libs=None) -> dict:
    """At a case's shape: the forward, the backward and both, each on the
    kernels (``train_attention_forward`` / ``_backward``), on the old route
    where the kernels' route has one in ``prior_libs`` (``ta_check``'s:
    kernel, old, old, kernel), the plain
    route (autograd on the plain ops, leaves of the case's dtype, as
    training runs it: kernel, plain, plain, kernel) and the library call
    (SDPA on (B, H, S, D) views, causal, timed only: in the case's dtype,
    where bf16 rounds P to bf16, and on f32 upcasts of the same values,
    the function the kernels compute), CUDA events."""
    import torch.nn.functional as F
    *_, causal, window, cap = case
    opts = dict(causal=causal, window=window, logit_cap=cap)
    q, k, v = (t.contiguous() for t in ta_inputs(torch, case, gen))
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    o, o32, lse = ta.train_attention_forward(q, k, v, **opts)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    po = ta.train_attention_plain(*leaves, **opts)
    bh = [t.detach().transpose(1, 2).requires_grad_(True)
          for t in (q, k, v)]
    lo = F.scaled_dot_product_attention(*bh, is_causal=causal)
    do_bh = do.transpose(1, 2)
    bh32 = [t.detach().float().transpose(1, 2).requires_grad_(True)
            for t in (q, k, v)]
    lo32 = F.scaled_dot_product_attention(*bh32, is_causal=causal)
    do_bh32 = do.float().transpose(1, 2)
    prior_lib = (prior_libs or {}).get(
        ta.route(q.dtype, k.dtype, q.shape[3]), (None, None))[1]
    prior = prior_lib is not None
    if prior:
        _, p32, plse = ta.train_attention_forward(q, k, v, **opts,
                                                  lib=prior_lib)

    def k_fwd():
        ta.train_attention_forward(q, k, v, **opts)

    def k_bwd():
        ta.train_attention_backward(q, k, v, o32, lse, do, **opts)

    def k_both():
        _, a32, alse = ta.train_attention_forward(q, k, v, **opts)
        ta.train_attention_backward(q, k, v, a32, alse, do, **opts)

    def o_fwd():
        ta.train_attention_forward(q, k, v, **opts, lib=prior_lib)

    def o_bwd():
        ta.train_attention_backward(q, k, v, p32, plse, do, **opts,
                                    lib=prior_lib)

    def o_both():
        _, a32, alse = ta.train_attention_forward(q, k, v, **opts,
                                                  lib=prior_lib)
        ta.train_attention_backward(q, k, v, a32, alse, do, **opts,
                                    lib=prior_lib)

    def p_fwd():
        ta.train_attention_plain(*leaves, **opts)

    def p_bwd():
        torch.autograd.grad(po, leaves, do.float(), retain_graph=True)

    def p_both():
        torch.autograd.grad(ta.train_attention_plain(*leaves, **opts),
                            leaves, do.float())

    def l_fwd():
        F.scaled_dot_product_attention(*bh, is_causal=causal)

    def l_bwd():
        torch.autograd.grad(lo, bh, do_bh, retain_graph=True)

    def l_both():
        torch.autograd.grad(F.scaled_dot_product_attention(
            *bh, is_causal=causal), bh, do_bh)

    def f_fwd():
        F.scaled_dot_product_attention(*bh32, is_causal=causal)

    def f_bwd():
        torch.autograd.grad(lo32, bh32, do_bh32, retain_graph=True)

    def f_both():
        torch.autograd.grad(F.scaled_dot_product_attention(
            *bh32, is_causal=causal), bh32, do_bh32)
    out = {}
    for part, fast, old, slow, lib_fn, lib32_fn in (
            ("forward", k_fwd, o_fwd, p_fwd, l_fwd, f_fwd),
            ("backward", k_bwd, o_bwd, p_bwd, l_bwd, f_bwd),
            ("fwd_bwd", k_both, o_both, p_both, l_both, f_both)):
        turns = {"kernel": [], "prior": [], "plain": []}
        calls = {"kernel": fast, "prior": old, "plain": slow}
        order = ["kernel", "plain", "plain", "kernel"]
        if prior:
            order = ["kernel", "prior", "prior", "kernel"] + order
        for which in order:
            turns[which].append(cuda_ms(calls[which],
                                        iters=10 if which == "plain" else 20,
                                        warmup=2))
        out[part] = dict(
            ms=sum(turns["kernel"]) / len(turns["kernel"]),
            prior_ms=(sum(turns["prior"]) / 2 if prior else None),
            plain_ms=sum(turns["plain"]) / 2, turns=turns,
            library_ms=cuda_ms(lib_fn, iters=20, warmup=2),
            library_f32_ms=cuda_ms(lib32_fn, iters=20, warmup=2))
    return out


def phase_train_attention_kernel(torch, ta) -> list:
    """The training attention kernels against their plain version on the
    card, through the port's entry point (``train_attention``): every case
    of ``TA_CASES`` (causal and not, window 4096 with cap 50, GQA 6:1 and
    3:1, D 16 to 128, S != T, S not a multiple of the tile, bf16, f32 and
    bf16 q against f32 k and v, q read by strides), o, the log-sum-exp and
    dq, dk, dv within the stated tolerance of the plain version, the same
    bits over 3 calls, each launch counted on the device by route; the
    cases on ``wgmma_bf16`` and ``mma_3xtf32`` also on their old route's
    build (``TA_OLD_ROUTES``: ``mma_bf16``, ``scalar_f32``), held to the
    same; one case's tensors alive at a time.  Then the forward, the
    backward and both at the ``TA_TIMED`` shapes against the bound, the old
    route, the plain route and SDPA.  Returns the kernels line's two
    entries at the path shape, lm100m's f32 times beside them, and the
    ``mma_3xtf32`` route's two at lm100m's shape and the ``mma_bf16``
    route's two at zamba2's (launches filled in by the train phase)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    t0 = time.monotonic()
    prior_libs = {r: (old, ta._lib(defs))
                  for r, (old, defs) in TA_OLD_ROUTES.items()}
    failed = []
    worst = {r: {"forward": 0.0, "backward": 0.0} for r in ta.ROUTES}
    for case in TA_CASES:
        row = ta_check(torch, ta, case, gen, prior_libs)
        emit("kernel_check", kernel="train_attention", case=case[0], **row)
        if not row["ok"]:
            failed.append(case[0])
        w = worst[row["route"]]
        w["forward"] = max(w["forward"], row["o"]["max_abs_err"],
                           row["lse"]["max_abs_err"])
        w["backward"] = max(w["backward"], *(
            row[n]["max_abs_err"] for n in ("dq", "dk", "dv")))
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        fail(f"train_attention differs from the plain version: {failed}")
    timed = {}
    for case in TA_CASES:
        if case[0] not in TA_TIMED:
            continue
        q, k, _ = ta_inputs(torch, case, gen)
        bounds = ta_bounds(q, k, case[9], case[10])
        del q, k, _
        timed[case[0]] = dict(bounds=bounds,
                              times=ta_times(torch, ta, case, gen,
                                             prior_libs))
        gc.collect()
        torch.cuda.empty_cache()
    emit("train_attention_times", shape=TA_SHAPE, **timed,
         seconds=time.monotonic() - t0)
    bounds, times = timed["path"]["bounds"], timed["path"]["times"]
    lm = timed["lm100m_f32"]
    entries, x3 = [], []
    lm_route = ta.route(torch.float32, torch.float32, 64)
    for name, part in (("train_attention_forward", "forward"),
                       ("train_attention_backward", "backward")):
        t, b = times[part], bounds[part]
        route = ta.route(torch.bfloat16, torch.bfloat16, 128)
        entry = {
            "name": name, "route": "cuda", "kernel_route": route,
            "kernel_routes": list(ta.ROUTES), "source": TA_SOURCE,
            "replaces": TA_REPLACES, "shape": TA_SHAPE,
            "max_abs_err": worst[route][part], "ms": t["ms"],
            "kernel_ms": t["ms"],
            "prior_route": "mma_bf16", "prior_ms": t["prior_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": t["library_ms"],
            "library": f"F.scaled_dot_product_attention {part} (bf16 P; "
                       f"timed only)",
            "library_f32_ms": t["library_f32_ms"],
            "library_f32": f"F.scaled_dot_product_attention {part} on f32 "
                           f"upcasts (the kernels' function; timed only)",
            "f32_lm100m": dict(lm["times"][part],
                               bound_ms=lm["bounds"][part]["bound_ms"])}
        if part == "backward":
            entry.update(
                kernels="delta, dQ, dK dV (one launch each a call; on "
                        "mma_3xtf32 dQ with delta, dK dV)",
                fwd_bwd_ms=times["fwd_bwd"]["ms"],
                fwd_bwd_prior_ms=times["fwd_bwd"]["prior_ms"],
                fwd_bwd_plain_ms=times["fwd_bwd"]["plain_ms"],
                fwd_bwd_library_ms=times["fwd_bwd"]["library_ms"],
                fwd_bwd_bound_ms=bounds["fwd_bwd"]["bound_ms"])
        entries.append(entry)
        lt, lb = lm["times"][part], lm["bounds"][part]
        x3.append({
            "name": f"{name}/{lm_route}", "route": "cuda",
            "kernel_route": lm_route,
            "source": f"{TA_SOURCE} ({part}: "
                      + ("fwd_3xtf32_kernel" if part == "forward" else
                         "dq_3xtf32_kernel with delta, dkdv_3xtf32_kernel")
                      + "; f32_split.cuh)",
            "replaces": TA_REPLACES,
            "shape": "lm100m train: B8 12/12 heads S128 D64 causal f32",
            "max_abs_err": worst[lm_route][part], "ms": lt["ms"],
            "prior_route": TA_OLD_ROUTES[lm_route][0],
            "prior_ms": lt["prior_ms"], "plain_ms": lt["plain_ms"],
            "bound_ms": lb["bound_ms"], "bound_by": lb["bound_by"],
            "library_ms": lt["library_ms"],
            "library": f"F.scaled_dot_product_attention {part} on f32 "
                       f"(TF32 off; timed only)",
            "fwd_bwd_ms": lm["times"]["fwd_bwd"]["ms"],
            "fwd_bwd_prior_ms": lm["times"]["fwd_bwd"]["prior_ms"],
            "fwd_bwd_library_ms": lm["times"]["fwd_bwd"]["library_ms"],
            "fwd_bwd_bound_ms": lm["bounds"]["fwd_bwd"]["bound_ms"]})
        # D = 80 runs only in zamba2's shared block: its own lines, their
        # launches on that route
        zb = timed["zamba2_train"]
        zt, zr = zb["times"][part], zb["bounds"][part]
        z_route = ta.route(torch.bfloat16, torch.bfloat16, 80)
        x3.append({
            "name": f"{name}/{z_route}", "route": "cuda",
            "kernel_route": z_route,
            "source": f"{TA_SOURCE} ({part}: "
                      + ("fwd_mma_kernel" if part == "forward" else
                         "delta_kernel, dq_mma_kernel, dkdv_mma_kernel")
                      + "; tensor_core.cuh)",
            "replaces": TA_REPLACES, "shape": TA_ZAMBA2_SHAPE,
            "max_abs_err": worst[z_route][part], "ms": zt["ms"],
            "plain_ms": zt["plain_ms"], "bound_ms": zr["bound_ms"],
            "bound_by": zr["bound_by"], "library_ms": zt["library_ms"],
            "library": f"F.scaled_dot_product_attention {part} (bf16 P; "
                       f"timed only)",
            "library_f32_ms": zt["library_f32_ms"],
            "fwd_bwd_ms": zb["times"]["fwd_bwd"]["ms"],
            "fwd_bwd_library_ms": zb["times"]["fwd_bwd"]["library_ms"],
            "fwd_bwd_bound_ms": zb["bounds"]["fwd_bwd"]["bound_ms"]})
    return entries, x3


# RMSNorm and RoPE (``kernels/norm_rope.py``): every rms_norm and
# apply_rope on CUDA tensors, forward and backward, on every train and
# serve path
NR_SOURCE = "src/repro_torch/csrc/norm_rope.cu"
NR_REPLACES = {
    "rms_norm_fwd": "src/repro/models/common.py:167 rms_norm (jnp inside "
                    "jax.jit, src/repro/launch/train.py:96 and "
                    "src/repro/launch/serve.py:75-76; no Pallas kernel)",
    "rms_norm_bwd": "src/repro/models/common.py:167 rms_norm's vjp "
                    "(jax.grad inside jax.jit, src/repro/launch/train.py:96;"
                    " no Pallas kernel)",
    "rope": "src/repro/models/common.py:196 apply_rope and its vjp (jnp "
            "inside jax.jit; no Pallas kernel)"}
NR_SHAPE = {"rms_norm_fwd": "codeqwen1.5-7b train: B8 S512 d4096 bf16",
            "rms_norm_bwd": "codeqwen1.5-7b train: B8 S512 d4096 bf16",
            "rope": "codeqwen1.5-7b train: q and k B8 S512 32/32 heads x "
                    "128 bf16"}
# name, shape, x dtype, scale dtype, x at an unaligned address: the paths'
# widths (d_model, the SSM's gated norm over d_inner in f32, chameleon's
# qk-norm over (B, S, H, hd)), command-r-plus's 12,288 (rows in passes,
# several rows a backward chunk), decode's (B, 1, d), odd widths
NR_NORM_CASES = (
    ("codeqwen_train", (8, 512, 4096), "bf16", "bf16", False),
    ("codeqwen_decode", (4, 1, 4096), "bf16", "bf16", False),
    ("mamba2_gated_f32", (4, 512, 4096), "f32", "bf16", False),
    ("lm100m_f32", (8, 128, 768), "f32", "f32", False),
    ("mamba2_2048", (4, 64, 2048), "bf16", "bf16", False),
    ("zamba2_2560", (4, 64, 2560), "bf16", "bf16", False),
    ("zamba2_gated_5120", (4, 64, 5120), "f32", "bf16", False),
    ("granite_1536", (4, 64, 1536), "bf16", "bf16", False),
    ("whisper_enc_1280", (4, 64, 1280), "f32", "bf16", False),
    ("gemma2_4608", (2, 64, 4608), "bf16", "bf16", False),
    ("nemotron_decode_6144", (4, 1, 6144), "bf16", "bf16", False),
    ("chameleon_8192", (4, 16, 8192), "bf16", "bf16", False),
    ("command_r_12288", (4, 128, 12288), "bf16", "bf16", False),
    ("command_r_decode_12288_f32", (4, 1, 12288), "f32", "f32", False),
    ("chameleon_qk_128", (4, 64, 64, 128), "bf16", "bf16", False),
    ("odd_17_f32", (3, 7, 17), "f32", "f32", False),
    ("odd_83_bf16", (5, 83), "bf16", "bf16", False),
    ("unaligned_4096_bf16", (6, 4096), "bf16", "bf16", True),
    ("unaligned_8192_f32", (3, 8192), "f32", "bf16", True),
    ("unaligned_12288_bf16", (600, 12288), "bf16", "bf16", True),
    ("odd_12289_f32", (3, 12289), "f32", "bf16", False),
)
# name, B, S, q heads, k heads (0: q alone), head dim, dtype, first position
NR_ROPE_CASES = (
    ("codeqwen_train", 8, 512, 32, 32, 128, "bf16", 0),
    ("codeqwen_decode", 4, 1, 32, 32, 128, "bf16", 527),
    ("granite_gqa3_d64", 4, 512, 24, 8, 64, "bf16", 0),
    ("zamba2_d80", 4, 64, 32, 32, 80, "bf16", 0),
    ("gemma2_8192", 1, 8192, 32, 16, 128, "bf16", 0),
    ("chameleon_gqa8", 4, 64, 64, 8, 128, "bf16", 0),
    ("lm100m_f32", 8, 128, 12, 12, 64, "f32", 0),
    ("shifted_hd18_f32", 2, 33, 3, 1, 18, "f32", 3),
    ("shifted_hd18_bf16", 2, 33, 3, 1, 18, "bf16", 3),
    ("q_alone_bf16", 2, 16, 4, 0, 32, "bf16", 0),
)
NR_DTYPES = {"f32": "float32", "bf16": "bfloat16"}
NR_THETA = 1e6                  # codeqwen1.5-7b's rope_theta


def ulp_diff(torch, got, want) -> int:
    """The largest distance in units in the last place between two tensors
    of one float dtype (their bits as ordered integers)."""
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]

    def ordered(t):
        b = t.contiguous().view(ints).long()
        top = 1 << (8 * got.element_size() - 1)
        return torch.where(b < 0, -(b + top), b)
    return int((ordered(got) - ordered(want)).abs().max())


def nr_norm_inputs(torch, shape, x_dt, s_dt, unaligned, gen):
    dt = {k: getattr(torch, v) for k, v in NR_DTYPES.items()}
    n, numel = shape[-1], math.prod(shape)
    # one element in: an address 2 or 4 bytes past a 16-byte boundary
    base = torch.randn(numel + 1, generator=gen, device="cuda").to(dt[x_dt])
    x = (base[1:] if unaligned else base[:numel]).view(shape)
    scale = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(dt[s_dt])
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt[x_dt])
    return x, scale, dy


def nr_norm_check(torch, nr, C, case, gen) -> dict:
    """A norm case: the forward and the backward (dx, dscale) against the
    plain versions on f32 upcasts of the same values (``ta_within``), the
    same bits over 3 calls, one device launch each per call."""
    name, shape, x_dt, s_dt, unaligned = case
    x, scale, dy = nr_norm_inputs(torch, shape, x_dt, s_dt, unaligned, gen)
    if unaligned and x.data_ptr() % 16 == 0:
        fail(f"norm case {name}: x is aligned")
    lib = nr._lib()
    before = nr.kernel_launches(lib)
    ys = [nr.rms_norm_fwd(x, scale) for _ in range(3)]
    grads = [nr.rms_norm_bwd(x, scale, dy) for _ in range(3)]
    torch.cuda.synchronize()
    after = nr.kernel_launches(lib)
    route = nr.norm_route(x.dtype, scale.dtype)
    bwd = nr.backward_route("", x, scale, (dy,))
    launched = nr_launched(before, after, route, bwd)
    want_y = C.rms_norm_plain(x.float(), scale.float())
    want_dx, want_ds = nr.rms_norm_bwd_plain(x.float(), scale.float(),
                                             dy.float())
    row = {"shape": list(shape), "x": x_dt, "scale": s_dt,
           "unaligned": unaligned, "route": route, "backward_route": bwd,
           **nr_plans(nr, lib, "", x, scale, (dy,)),
           "forward": ta_within(torch, ys[0], want_y),
           "dx": ta_within(torch, grads[0][0], want_dx),
           "dscale": ta_within(torch, grads[0][1], want_ds),
           "repeats": all(same_bits(torch, y, ys[0]) for y in ys)
           and all(same_bits(torch, a, grads[0][0])
                   and same_bits(torch, b, grads[0][1]) for a, b in grads),
           "device_launches": launched}
    row["ok"] = (row["forward"]["ok"] and row["dx"]["ok"]
                 and row["dscale"]["ok"] and row["repeats"]
                 and row["plan_agrees"]
                 and launched == dict.fromkeys(launched, 3))
    return row


def nr_launched(before: dict, after: dict, route: str, bwd: str) -> dict:
    """The device launches between two counts of a norm case's calls: the
    forward's and the dscale kernel's on the instance ``route``, the
    backward's rows on their route ``bwd``."""
    return {k: after[k][r] - before[k][r] for k, r in (
        ("rms_norm_fwd", route), ("rms_norm_bwd", bwd),
        ("rms_norm_dscale", route))}


def nr_plans(nr, lib, prologue, x, scale, tensors, stride_bytes=16) -> dict:
    """A norm case's backward plan as the wrapper works it out
    (``nr.bwd_plan``: the route by the width, the dtype and the alignment,
    the chunks of rows, the ring's stages) and as the library does on this
    card (``nr.card_plan``: also the rows' kernel's registers, spills and
    resident blocks an SM); ``plan_agrees`` if both choose the same
    route, threads a row, stages and ring."""
    n = x.shape[-1]
    vec = nr.vec_rows(n, (x, scale, *tensors), stride_bytes)
    mine = nr.bwd_plan(x.numel() // n, n, vec, x.dtype, prologue)
    card = nr.card_plan(lib, prologue, x.dtype, scale.dtype, n, vec)
    keys = ("route", "threads_per_row", "stages", "ring_bytes")
    return {"plan": mine, "card_plan": card,
            "plan_agrees": all(mine[k] == card[k] for k in keys)}


def nr_rope_inputs(torch, case, gen):
    name, b, s, hq, hk, hd, dt, first = case
    dtype = getattr(torch, NR_DTYPES[dt])
    xs = [torch.randn((b, s, h, hd), generator=gen, device="cuda")
          .to(dtype) for h in (hq, hk) if h]
    dys = [torch.randn_like(x.float()).to(dtype) for x in xs]
    if s == 1:           # a decode step's position: a (B, 1) view of one
        pos = torch.full((), first, dtype=torch.int64,
                         device="cuda").view(1, 1).expand(b, 1)
    else:
        pos = (torch.arange(s, device="cuda") + first).expand(b, s)
    return xs, dys, pos


def nr_rope_check(torch, nr, C, case, gen) -> dict:
    """A RoPE case: q and k (one launch) forward and backward against the
    plain rotation and ``rope_bwd_plain`` on the card: the same bits, or
    within 1 bf16 ulp (f32: ``ta_within`` of an f32 plain result) where
    the card's cosf / sinf differ from torch's; the same bits over 3
    calls; one device launch a call."""
    name, b, s, hq, hk, hd, dt, first = case
    xs, dys, pos = nr_rope_inputs(torch, case, gen)
    freqs = C.rope_freqs(hd, NR_THETA, torch.device("cuda"))
    lib = nr._lib()
    before = nr.kernel_launches(lib)["rope"]
    outs = [nr.rope(xs, pos, freqs) for _ in range(3)]
    backs = [nr.rope(dys, pos, freqs, backward=True) for _ in range(3)]
    torch.cuda.synchronize()
    after = nr.kernel_launches(lib)["rope"]
    launched = {r: after[r] - before[r] for r in after
                if after[r] != before[r]}
    row = {"B": b, "S": s, "heads": [hq, hk], "head_dim": hd, "dtype": dt,
           "first_position": first, "device_launches": launched}
    ok = launched == {nr.rope_route(xs[0].dtype): 3,
                      nr.rope_route(xs[0].dtype, True): 3}
    for part, got, want in (
            ("forward", outs[0],
             [C.apply_rope_plain(x, pos, NR_THETA) for x in xs]),
            ("backward", backs[0],
             [nr.rope_bwd_plain(d, pos, NR_THETA) for d in dys])):
        same = all(same_bits(torch, g, w) for g, w in zip(got, want))
        ulps = max(ulp_diff(torch, g, w) for g, w in zip(got, want))
        row[part] = {"same_bits": same, "max_ulp": ulps,
                     "max_abs_err": max(float((g.float() - w.float()).abs()
                                              .max())
                                        for g, w in zip(got, want))}
        if dt == "bf16":
            ok = ok and ulps <= 1
        else:
            f32 = [C.apply_rope_plain(x.float(), pos, NR_THETA) for x in xs] \
                if part == "forward" else want
            ok = ok and all(ta_within(torch, g, w)["ok"]
                            for g, w in zip(got, f32))
    row["repeats"] = all(same_bits(torch, a, c) for o in (outs, backs)
                         for other in o for a, c in zip(other, o[0]))
    row["ok"] = ok and row["repeats"]
    return row


def nr_bounds(tensors_in, tensors_out, flops: int) -> dict:
    """Bytes (each input read and each output written once) at 3.35 TB/s
    against ``flops`` f32 operations at 67 TFLOP/s; the larger bounds."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors_in, *tensors_out))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS["torch.float32"] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nr_times(torch, nr, C, gen) -> dict:
    """At codeqwen1.5-7b's train shape (bf16): the norm's forward and
    backward and RoPE's (q and k together) forward and backward, each in
    turns with its plain version (kernel, plain, plain, kernel; the plain
    backward is autograd's over the plain ops, as the parent ran it),
    beside its bound and the library call: ``F.rms_norm`` on the f32
    upcast with weight 1 + scale (forward; its autograd backward), none
    for RoPE (no PyTorch call computes it); and the host's microseconds a
    call through ``models.common`` at a decode step's shape, kernel and
    plain (``host_us``)."""
    import torch.nn.functional as F
    x, scale, dy = nr_norm_inputs(torch, (8, 512, 4096), "bf16", "bf16",
                                  False, gen)
    n = x.shape[-1]
    xs, dys, pos = nr_rope_inputs(torch, NR_ROPE_CASES[0], gen)
    freqs = C.rope_freqs(128, NR_THETA, torch.device("cuda"))
    xl = x.detach().requires_grad_()
    sl = scale.detach().requires_grad_()
    y_plain = C.rms_norm_plain(xl, sl)
    xf = x.float().requires_grad_()
    w = (1.0 + scale.float()).requires_grad_()
    y_lib = F.rms_norm(xf, (n,), w, 1e-6)
    dyf = dy.float()
    ql = [t.detach().requires_grad_() for t in xs]
    r_plain = [C.apply_rope_plain(t, pos, NR_THETA) for t in ql]
    rows = x.numel() // n
    hd, pairs = 128, sum(t.numel() for t in xs) // 2
    cases = {
        "rms_norm_fwd": (
            lambda: nr.rms_norm_fwd(x, scale),
            lambda: C.rms_norm_plain(x, scale),
            lambda: F.rms_norm(xf.detach(), (n,), w.detach(), 1e-6),
            nr_bounds((x, scale), (x,), 4 * x.numel() + 2 * rows)),
        "rms_norm_bwd": (
            lambda: nr.rms_norm_bwd(x, scale, dy),
            lambda: torch.autograd.grad(y_plain, (xl, sl), dy,
                                        retain_graph=True),
            lambda: torch.autograd.grad(y_lib, (xf, w), dyf,
                                        retain_graph=True),
            nr_bounds((x, dy, scale), (x, scale), 10 * x.numel())),
        "rope": (
            lambda: nr.rope(xs, pos, freqs),
            lambda: [C.apply_rope_plain(t, pos, NR_THETA) for t in xs],
            None,
            nr_bounds((*xs, pos, freqs), xs,
                      6 * pairs + 40 * pos.numel() * (hd // 2))),
        "rope_backward": (
            lambda: nr.rope(dys, pos, freqs, backward=True),
            lambda: torch.autograd.grad(r_plain, ql, dys,
                                        retain_graph=True),
            None,
            nr_bounds((*dys, pos, freqs), dys,
                      6 * pairs + 40 * pos.numel() * (hd // 2))),
    }
    out = {}
    for name, (fast, slow, lib_call, bound) in cases.items():
        ms = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            ms[which].append(cuda_ms(fast if which == "kernel" else slow,
                                     iters=20, warmup=2))
        row = dict(ms=sum(ms["kernel"]) / 2, plain_ms=sum(ms["plain"]) / 2,
                   turns=ms, library_ms=(cuda_ms(lib_call, iters=20,
                                                 warmup=2)
                                         if lib_call else None), **bound)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        out[name] = row
    out["rms_norm_fwd"]["library"] = ("torch.nn.functional.rms_norm on the "
                                      "f32 upcast, weight 1 + scale (the "
                                      "upcasts outside the timed call)")
    out["rms_norm_bwd"]["library"] = ("autograd of torch.nn.functional."
                                      "rms_norm on the f32 upcast")
    out["rms_norm_bwd"]["backward_route"] = nr.backward_route(
        "", x, scale, (dy,))
    for k in ("rope", "rope_backward"):
        out[k]["library"] = "none: no PyTorch call computes RoPE"
    # the host's time a call through the model's entry points at a decode
    # step's shape (the serve's eager steps and prefills pay it)
    xd, sd, _ = nr_norm_inputs(torch, (4, 1, 4096), "bf16", "bf16", False,
                               gen)
    (qd, kd), _, pd = nr_rope_inputs(torch, NR_ROPE_CASES[1], gen)
    # ("launch": the launch function called alone, without the autograd
    # function that the entry points go through)
    out["host_us"] = {
        "rms_norm": {"kernel": host_us(torch, lambda: C.rms_norm(xd, sd)),
                     "launch": host_us(torch,
                                       lambda: nr.rms_norm_fwd(xd, sd)),
                     "plain": host_us(torch,
                                      lambda: C.rms_norm_plain(xd, sd))},
        "rope_qk": {"kernel": host_us(torch, lambda: C.apply_rope_qk(
                        qd, kd, pd, NR_THETA)),
                    "launch": host_us(torch, lambda: nr.rope(
                        (qd, kd), pd, C.rope_freqs(qd.shape[-1], NR_THETA,
                                                   qd.device))),
                    "plain": host_us(torch, lambda: [
                        C.apply_rope_plain(t, pd, NR_THETA)
                        for t in (qd, kd)])}}
    return out


# The fused instances: the norm behind its add and gate prologues, RoPE
# with the q and k biases
NR_FUSED_REPLACES = {
    "add_rms_norm_fwd": "src/repro/models/model.py:186-190 (h + a, the "
                        "attention's output bias at src/repro/models/"
                        "attention.py:131, then rms_norm; also :216-220, "
                        ":264-273, :404-407: jnp inside jax.jit, fused by "
                        "XLA; no Pallas kernel)",
    "add_rms_norm_bwd": "src/repro/models/model.py:186-190 the adds' and "
                        "rms_norm's vjp (jax.grad inside jax.jit, "
                        "src/repro/launch/train.py:96; no Pallas kernel)",
    "gated_rms_norm_fwd": "src/repro/models/ssm.py:150, :200 rms_norm(y * "
                          "jax.nn.silu(z)) (jnp inside jax.jit; no Pallas "
                          "kernel)",
    "gated_rms_norm_bwd": "src/repro/models/ssm.py:150 its vjp (jax.grad "
                          "inside jax.jit; no Pallas kernel)",
    "rope_bias": "src/repro/models/attention.py:56-57 q + bq, k + bk, then "
                 "src/repro/models/common.py:196 apply_rope, and their vjp "
                 "(jnp inside jax.jit; no Pallas kernel)"}
NR_FUSED_SHAPE = {
    "add_rms_norm_fwd": "codeqwen1.5-7b train: h, a (8, 512, 4096) bf16, "
                        "bias and scale bf16",
    "add_rms_norm_bwd": "codeqwen1.5-7b train: h', dy, dres (8, 512, 4096) "
                        "bf16, bias and scale bf16",
    "gated_rms_norm_fwd": "mamba2-1.3b prefill: y (4, 512, 4096) bf16, z "
                          "its slice of the (4, 512, 8512) projection",
    "gated_rms_norm_bwd": "mamba2-1.3b prefill shape: y, z, dy (4, 512, "
                          "4096) bf16, z a slice",
    "rope_bias": "codeqwen1.5-7b train: q and k B8 S512 32/32 heads x 128 "
                 "bf16, their biases bf16"}
# name, shape, x dtype, scale dtype, bias dtype (None: no bias), x at an
# unaligned address: every (x, scale) pair, with and without a bias (f32
# x with a bf16 bias: whisper's f32 encoder), the paths' widths, rows in
# passes (command-r-plus's 12,288), odd widths
NR_ADD_CASES = (
    ("codeqwen_train", (8, 512, 4096), "bf16", "bf16", "bf16", False),
    ("codeqwen_decode", (4, 1, 4096), "bf16", "bf16", "bf16", False),
    ("granite_1536", (4, 64, 1536), "bf16", "bf16", None, False),
    ("whisper_enc_1280", (4, 64, 1280), "f32", "bf16", "bf16", False),
    ("whisper_dec_1280", (4, 64, 1280), "bf16", "bf16", "bf16", False),
    ("lm100m_f32", (8, 128, 768), "f32", "f32", None, False),
    ("f32_bias_f32", (3, 7, 64), "f32", "f32", "f32", False),
    ("bf16_f32_scale", (4, 64, 2048), "bf16", "f32", None, False),
    ("zamba2_2560", (4, 64, 2560), "bf16", "bf16", None, False),
    ("command_r_12288", (4, 128, 12288), "bf16", "bf16", None, False),
    ("wide_12288_f32_bias", (3, 12288), "f32", "bf16", "bf16", False),
    ("unaligned_4096_bf16", (6, 4096), "bf16", "bf16", "bf16", True),
    ("odd_83_bf16", (5, 83), "bf16", "bf16", "bf16", False),
    ("odd_12289_f32", (3, 12289), "f32", "f32", "f32", False),
)
# name, shape (y's), the projection's width (z its first columns), x
# dtype, scale dtype, z at an unaligned address: mamba2's and zamba2's
# prefill and decode shapes, every dtype pair, a row stride not a
# multiple of 16 bytes, rows in passes, and z drawn 40 times wider
# (``NR_GATE_Z_SCALE``: exp(-z) past f32's range, where the staged route's
# silu divides as the compiler's IEEE division does rather than by its
# fast path)
NR_GATE_CASES = (
    ("mamba2_prefill", (4, 512, 4096), 8512, "bf16", "bf16", False),
    ("mamba2_decode", (4, 1, 4096), 8512, "bf16", "bf16", False),
    ("zamba2_prefill", (4, 512, 5120), 10448, "bf16", "bf16", False),
    ("zamba2_decode", (4, 1, 5120), 10448, "bf16", "bf16", False),
    ("f32_f32", (2, 16, 4096), 8512, "f32", "f32", False),
    ("f32_bf16", (2, 16, 256), 600, "f32", "bf16", False),
    ("bf16_f32", (2, 16, 256), 600, "bf16", "f32", False),
    ("odd_stride_bf16", (3, 5, 96), 101, "bf16", "bf16", False),
    ("wide_12288_bf16", (2, 12288), 12288, "bf16", "bf16", False),
    ("unaligned_4096_bf16", (6, 4096), 4096, "bf16", "bf16", True),
    ("z_x40_bf16", (4, 64, 4096), 8512, "bf16", "bf16", False),
)
NR_GATE_Z_SCALE = {"z_x40_bf16": 40.0}
# RoPE with q and k biases: every case of NR_ROPE_CASES
NR_ROPE_BIAS_CASES = NR_ROPE_CASES


def nr_within(torch, got, want, roundings: int, extra=None) -> dict:
    """``got`` against ``want``, both in the result's dtype from a chain of
    ``roundings`` roundings to it: bf16 within roundings x 2^-8 (|want| +
    |extra|) + 1e-5 max|want|, f32 within 1e-5 max(|want|, |extra|)
    (``extra``: a summand of ``want`` whose rounding the sum may cancel:
    the norm's dx beside the residual grad).  bf16 also reports the
    largest distance in ulps (``max_ulp``) and the most roundings of
    2^-8 (|want| + |extra|) that an element's error needs beyond the
    1e-5 floor (``roundings_used``, against ``roundings``)."""
    w = want.detach().float()
    e = extra.detach().float().abs() if extra is not None else 0.0
    err = (got.detach().float() - w).abs()
    scale = max(float(w.abs().max()),
                float(e.max()) if extra is not None else 0.0)
    row = {"max_abs_err": float(err.max()),
           "max_rel_err": float(err.max()) / scale if scale else 0.0}
    if got.dtype == torch.bfloat16:
        unit = TA_BF16_ULP * (w.abs() + e)
        tol = roundings * unit + TA_REL_TOL * scale
        need = (err - TA_REL_TOL * scale).clamp(min=0.0)
        used = torch.where(need > 0, need / unit, torch.zeros_like(need))
        row.update(max_ulp=ulp_diff(torch, got, want.to(got.dtype)),
                   roundings_used=float(used.max()), roundings=roundings)
    else:
        tol = TA_REL_TOL * scale
    row["ok"] = bool((err <= tol).all())
    return row


def nr_gate_faults(torch, nr, y, z, scale, dy, want) -> dict:
    """Two planted faults of the gate's backward, emulated in plain ops,
    each held to the gate case's tolerance (``nr_within``, 4 and 6
    roundings): y's grad without its silu(z) factor (dg for dg silu(z)),
    and z's without silu's z sigma(z) (1 - sigma(z)) term (dg y sigma(z)).
    A check that lets either pass cannot see such a kernel."""
    import torch.nn.functional as F
    dg, _ = nr.rms_norm_bwd_plain(y * F.silu(z), scale, dy)
    return {"dy_without_silu": nr_within(torch, dg, want[0], 4),
            "dz_without_silu_slope": nr_within(
                torch, (dg * y * torch.sigmoid(z)).to(z.dtype), want[1], 6)}


def nr_draw(torch, shape, dt, unaligned, gen):
    """randn of ``shape`` in ``dt`` (f32 or bf16 name), at an address one
    element past a 16-byte boundary with ``unaligned``."""
    numel = math.prod(shape)
    base = torch.randn(numel + 1, generator=gen, device="cuda").to(
        getattr(torch, NR_DTYPES[dt]))
    return (base[1:] if unaligned else base[:numel]).view(shape)


def nr_add_inputs(torch, case, gen):
    name, shape, x_dt, s_dt, b_dt, unaligned = case
    n = shape[-1]
    h, a, dy, dres = (nr_draw(torch, shape, x_dt, unaligned, gen)
                      for _ in range(4))
    scale = nr_draw(torch, (n,), s_dt, False, gen) * 0.1
    bias = None if b_dt is None else nr_draw(torch, (n,), b_dt, False,
                                             gen) * 0.1
    return h, a, scale, bias, dy, dres


def nr_add_check(torch, nr, C, case, gen) -> dict:
    """An add norm case: h' equal to the plain adds ``h + (a + bias)`` on
    the card to the bit, also written over a (the serve steps' call), the
    normed rows within the norm's tolerance of
    the plain version on f32 upcasts (and, reported, whether they equal
    the unfused norm kernel's on h'); the backward's dh within two
    roundings of the plain one (``add_rms_norm_bwd_plain``: dres + the
    rounded dx), dscale within the tolerance, the bias grad within one
    rounding of the sum of the kernel's dh; the same bits over 3 calls;
    one device launch of each kernel a call."""
    name, shape, x_dt, s_dt, b_dt, unaligned = case
    h, a, scale, bias, dy, dres = nr_add_inputs(torch, case, gen)
    n = shape[-1]
    if unaligned and h.data_ptr() % 16 == 0:
        fail(f"add norm case {name}: h is aligned")
    b_dtype = None if bias is None else bias.dtype
    lib = nr._lib()
    before = nr.kernel_launches(lib)
    outs = [nr.add_rms_norm_fwd(h, a, scale, bias) for _ in range(3)]
    grads = [nr.add_rms_norm_bwd(outs[0][0], scale, dy, dres, b_dtype)
             for _ in range(3)]
    torch.cuda.synchronize()
    after = nr.kernel_launches(lib)
    route = nr.norm_route(h.dtype, scale.dtype, "add")
    bwd = nr.backward_route("add", outs[0][0], scale, (dy, dres))
    launched = nr_launched(before, after, route, bwd)
    hp_want = h + (a if bias is None else a + bias)
    hp, x = outs[0]
    # the serve steps' call (after the counted ones): h' written over a
    # copy of a
    over = a.clone()
    in_place = nr.add_rms_norm_fwd(h, over, scale, bias, h_out=over)
    dx_ref, ds_ref = nr.rms_norm_bwd_plain(hp_want.float(), scale.float(),
                                           dy.float())
    dh, dscale, dbias = grads[0]
    row = {"shape": list(shape), "x": x_dt, "scale": s_dt, "bias": b_dt,
           "unaligned": unaligned, "route": route, "backward_route": bwd,
           **nr_plans(nr, lib, "add", hp, scale, (dy, dres)),
           "h_same_bits": same_bits(torch, hp, hp_want),
           "in_place_same_bits": same_bits(torch, over, hp_want)
           and same_bits(torch, in_place[1], x),
           "forward": ta_within(torch, x, C.rms_norm_plain(
               hp_want.float(), scale.float())),
           "forward_same_as_unfused": same_bits(
               torch, x, nr.rms_norm_fwd(hp_want, scale)),
           "dh": nr_within(torch, dh, dres + dx_ref.to(dres.dtype), 2,
                           extra=dx_ref),
           "dscale": ta_within(torch, dscale, ds_ref),
           "dbias": None if bias is None else ta_within(
               torch, dbias, dh.float().reshape(-1, n).sum(dim=0)),
           "repeats": all(same_bits(torch, o[i], outs[0][i])
                          for o in outs for i in (0, 1))
           and all(same_bits(torch, g[i], grads[0][i])
                   for g in grads for i in range(3 if bias is not None
                                                 else 2)),
           "device_launches": launched}
    row["ok"] = (row["h_same_bits"] and row["in_place_same_bits"]
                 and row["forward"]["ok"]
                 and row["dh"]["ok"] and row["dscale"]["ok"]
                 and (row["dbias"] is None or row["dbias"]["ok"])
                 and row["repeats"] and row["plan_agrees"]
                 and launched == dict.fromkeys(launched, 3))
    return row


def nr_gate_inputs(torch, case, gen):
    """y, z (the first n columns of a (..., width) projection), the scale
    and dy of a gate case."""
    name, shape, width, x_dt, s_dt, unaligned = case
    n, lead = shape[-1], shape[:-1]
    proj = nr_draw(torch, (*lead, width), x_dt, unaligned, gen)
    if name in NR_GATE_Z_SCALE:
        proj = proj * NR_GATE_Z_SCALE[name]
    y = nr_draw(torch, shape, x_dt, False, gen)
    scale = nr_draw(torch, (n,), s_dt, False, gen) * 0.1
    dy = nr_draw(torch, shape, x_dt, False, gen)
    return y, proj[..., :n], scale, dy


def nr_gate_check(torch, nr, C, case, gen) -> dict:
    """A gated norm case (z a slice of the projection, read by its row
    stride): the normed rows within the norm's tolerance of the plain
    version on the f32 upcast of the plain ops' ``y * silu(z)`` on the
    card (and, reported, whether they equal the unfused norm kernel's);
    y's and z's grads against autograd's roundings
    (``gated_rms_norm_bwd_plain`` on the card): the rounded dx of two
    f32 sums of other orders may differ by one ulp (two roundings), and
    each later rounding of both chains adds one, so y's within four and
    z's within six, and both planted faults of ``nr_gate_faults`` outside
    those limits; dscale within the tolerance; the same bits over 3
    calls; one device launch of each kernel a call."""
    import torch.nn.functional as F
    name, shape, width, x_dt, s_dt, unaligned = case
    y, z, scale, dy = nr_gate_inputs(torch, case, gen)
    if unaligned and z.data_ptr() % 16 == 0:
        fail(f"gate case {name}: z is aligned")
    lib = nr._lib()
    before = nr.kernel_launches(lib)
    outs = [nr.gated_rms_norm_fwd(y, z, scale) for _ in range(3)]
    grads = [nr.gated_rms_norm_bwd(y, z, scale, dy) for _ in range(3)]
    torch.cuda.synchronize()
    after = nr.kernel_launches(lib)
    route = nr.norm_route(y.dtype, scale.dtype, "gate")
    z2, z_stride = nr._rows_of(z, shape[-1])
    stride_bytes = z_stride * z2.element_size()
    bwd = nr.backward_route("gate", y, scale, (z2, dy), stride_bytes)
    launched = nr_launched(before, after, route, bwd)
    g = y * F.silu(z)
    want = nr.gated_rms_norm_bwd_plain(y, z, scale, dy)
    _, ds_ref = nr.rms_norm_bwd_plain(g.float(), scale.float(), dy.float())
    row = {"shape": list(shape), "width": width, "x": x_dt, "scale": s_dt,
           "unaligned": unaligned, "route": route, "backward_route": bwd,
           **nr_plans(nr, lib, "gate", y, scale, (z2, dy), stride_bytes),
           "forward": ta_within(torch, outs[0], C.rms_norm_plain(
               g.float(), scale.float())),
           "forward_same_as_unfused": same_bits(
               torch, outs[0], nr.rms_norm_fwd(g, scale)),
           "dy": nr_within(torch, grads[0][0], want[0], 4),
           "dz": nr_within(torch, grads[0][1], want[1], 6),
           "planted_faults": nr_gate_faults(torch, nr, y, z, scale, dy,
                                            want),
           "dscale": ta_within(torch, grads[0][2], ds_ref),
           "repeats": all(same_bits(torch, o, outs[0]) for o in outs)
           and all(same_bits(torch, gr[i], grads[0][i])
                   for gr in grads for i in range(3)),
           "device_launches": launched}
    row["ok"] = (row["forward"]["ok"] and row["dy"]["ok"]
                 and row["dz"]["ok"] and row["dscale"]["ok"]
                 and not any(f["ok"]
                             for f in row["planted_faults"].values())
                 and row["repeats"] and row["plan_agrees"]
                 and launched == dict.fromkeys(launched, 3))
    return row


def nr_rope_bias_check(torch, nr, C, case, gen) -> dict:
    """A RoPE case with q and k biases: the forward against the plain
    rotation of the plain adds ``x + b`` on the card (the same bits, or
    within 1 bf16 ulp; f32: ``ta_within``; and, reported, whether it
    equals the unfused RoPE kernel's), the backward's rotated grads as
    ``nr_rope_check`` holds them, each bias's grad within one rounding of
    the sum of the kernel's rotated grads; the same bits over 3 calls;
    one device launch of RoPE and of the dscale kernel a call."""
    name, b, s, hq, hk, hd, dt, first = case
    xs, dys, pos = nr_rope_inputs(torch, case, gen)
    bs = [nr_draw(torch, tuple(x.shape[-2:]), dt, False, gen) * 0.1
          for x in xs]
    freqs = C.rope_freqs(hd, NR_THETA, torch.device("cuda"))
    lib = nr._lib()
    before = nr.kernel_launches(lib)
    outs = [nr.rope(xs, pos, freqs, biases=bs) for _ in range(3)]
    backs = [nr.rope(dys, pos, freqs, backward=True, biases=bs)
             for _ in range(3)]
    torch.cuda.synchronize()
    after = nr.kernel_launches(lib)
    launched = {f"{k}/{r}": after[k][r] - before[k][r]
                for k in ("rope", "rms_norm_dscale") for r in after[k]
                if after[k][r] != before[k][r]}
    fwd, bwd = (nr.rope_route(xs[0].dtype, w, True) for w in (False, True))
    row = {"B": b, "S": s, "heads": [hq, hk], "head_dim": hd, "dtype": dt,
           "first_position": first, "device_launches": launched}
    ok = launched == {f"rope/{fwd}": 3, f"rope/{bwd}": 3,
                      f"rms_norm_dscale/{nr.dscale_route(bwd)}": 3}
    added = [x + bb for x, bb in zip(xs, bs)]
    row["forward_same_as_unfused"] = all(
        same_bits(torch, g, w) for g, w in zip(outs[0],
                                               nr.rope(added, pos, freqs)))
    n = len(xs)
    for part, got, want in (
            ("forward", outs[0],
             [C.apply_rope_plain(x, pos, NR_THETA) for x in added]),
            ("backward", backs[0][:n],
             [nr.rope_bwd_plain(d, pos, NR_THETA) for d in dys])):
        ulps = max(ulp_diff(torch, g, w) for g, w in zip(got, want))
        row[part] = {"same_bits": all(same_bits(torch, g, w)
                                      for g, w in zip(got, want)),
                     "max_ulp": ulps,
                     "max_abs_err": max(float((g.float() - w.float()).abs()
                                              .max())
                                        for g, w in zip(got, want))}
        if dt == "bf16":
            ok = ok and ulps <= 1
        else:
            f32 = [C.apply_rope_plain(x.float(), pos, NR_THETA)
                   for x in added] if part == "forward" else want
            ok = ok and all(ta_within(torch, g, w)["ok"]
                            for g, w in zip(got, f32))
    row["bias_grads"] = [ta_within(torch, gb, go.float().reshape(
        -1, *go.shape[-2:]).sum(dim=0))
        for gb, go in zip(backs[0][n:], backs[0][:n])]
    row["repeats"] = all(same_bits(torch, a, c) for o in (outs, backs)
                         for other in o for a, c in zip(other, o[0]))
    row["ok"] = (ok and row["repeats"]
                 and all(r["ok"] for r in row["bias_grads"]))
    return row


def nr_fused_times(torch, nr, C, gen) -> dict:
    """At the path shapes (``NR_FUSED_SHAPE``): each fused kernel (forward
    and backward) in turns with the parent's route (the unfused calls: the
    adds, or silu and the product, as ATen ops, then the norm or RoPE
    kernel; their backward by autograd over the norm's or RoPE's function)
    and the plain version (autograd's backward over the plain ops):
    kernel, parent, plain, plain, parent, kernel; beside the bound (each
    input read and each output written once) and, for the norms, the
    unfused library calls (the adds, then ``F.rms_norm`` in the inputs'
    dtype, weight 1 + scale).  No single PyTorch call computes any of
    them (``library_ms`` null)."""
    import torch.nn.functional as F
    out = {}
    # the add norm at codeqwen's train shape, with its bias
    h, a, scale, bias, dy, dres = nr_add_inputs(torch, NR_ADD_CASES[0], gen)
    n, rows = h.shape[-1], h.numel() // h.shape[-1]
    hp = h + (a + bias)
    w_lib = (1.0 + scale.float()).to(h.dtype)
    leaves = [t.detach().requires_grad_() for t in (h, a, scale, bias)]
    hl, al, sl, bl = leaves
    hp_plain = hl + (al + bl)
    plain_graph = (hp_plain, C.rms_norm_plain(hp_plain, sl))
    hp_parent = hl + (al + bl)
    parent_graph = (hp_parent, nr.RMSNorm.apply(hp_parent, sl, 1e-6))
    cases = {
        "add_rms_norm_fwd": (
            lambda: nr.add_rms_norm_fwd(h, a, scale, bias),
            lambda: nr.rms_norm_fwd(h + (a + bias), scale),
            lambda: C.add_rms_norm_plain(h, a, scale, bias),
            lambda: F.rms_norm(h + (a + bias), (n,), w_lib, 1e-6),
            nr_bounds((h, a, scale, bias), (h, h), 6 * h.numel() + 2 * rows)),
        "add_rms_norm_bwd": (
            lambda: nr.add_rms_norm_bwd(hp, scale, dy, dres, bias.dtype),
            lambda: torch.autograd.grad(parent_graph, leaves, (dres, dy),
                                        retain_graph=True),
            lambda: torch.autograd.grad(plain_graph, leaves, (dres, dy),
                                        retain_graph=True),
            None,
            nr_bounds((hp, dy, dres, scale), (h, scale, bias),
                      12 * h.numel()))}
    # the gated norm at mamba2's prefill shape, z a slice
    y, z, gscale, gdy = nr_gate_inputs(torch, NR_GATE_CASES[0], gen)
    gw_lib = (1.0 + gscale.float()).to(y.dtype)
    gleaves = [y.detach().requires_grad_(), z.detach().requires_grad_(),
               gscale.detach().requires_grad_()]
    yl, zl, gsl = gleaves
    g_plain = C.gated_rms_norm_plain(yl, zl, gsl)
    g_parent = nr.RMSNorm.apply(yl * F.silu(zl), gsl, 1e-6)
    cases.update({
        "gated_rms_norm_fwd": (
            lambda: nr.gated_rms_norm_fwd(y, z, gscale),
            lambda: nr.rms_norm_fwd(y * F.silu(z), gscale),
            lambda: C.gated_rms_norm_plain(y, z, gscale),
            lambda: F.rms_norm(y * F.silu(z), (y.shape[-1],), gw_lib, 1e-6),
            nr_bounds((y, z, gscale), (y,), 12 * y.numel())),
        "gated_rms_norm_bwd": (
            lambda: nr.gated_rms_norm_bwd(y, z, gscale, gdy),
            lambda: torch.autograd.grad(g_parent, gleaves, gdy,
                                        retain_graph=True),
            lambda: torch.autograd.grad(g_plain, gleaves, gdy,
                                        retain_graph=True),
            None,
            nr_bounds((y, z, gdy, gscale), (y, y, gscale),
                      30 * y.numel()))})
    # RoPE with biases at codeqwen's train shape
    xs, dys, pos = nr_rope_inputs(torch, NR_ROPE_CASES[0], gen)
    bs = [nr_draw(torch, tuple(x.shape[-2:]), "bf16", False, gen) * 0.1
          for x in xs]
    freqs = C.rope_freqs(128, NR_THETA, torch.device("cuda"))
    rleaves = [t.detach().requires_grad_() for t in (*xs, *bs)]
    added = [rleaves[0] + rleaves[2], rleaves[1] + rleaves[3]]
    r_plain = [C.apply_rope_plain(t, pos, NR_THETA) for t in added]
    r_parent = nr.Rope.apply(pos, freqs, *added)
    pairs = sum(t.numel() for t in xs) // 2
    rope_flops = 8 * pairs + 40 * pos.numel() * 64
    cases.update({
        "rope_bias": (
            lambda: nr.rope(xs, pos, freqs, biases=bs),
            lambda: nr.rope([x + b for x, b in zip(xs, bs)], pos, freqs),
            lambda: [C.apply_rope_plain(x + b, pos, NR_THETA)
                     for x, b in zip(xs, bs)],
            None, nr_bounds((*xs, *bs, pos, freqs), xs, rope_flops)),
        "rope_bias_backward": (
            lambda: nr.rope(dys, pos, freqs, backward=True, biases=bs),
            lambda: torch.autograd.grad(r_parent, rleaves, dys,
                                        retain_graph=True),
            lambda: torch.autograd.grad(r_plain, rleaves, dys,
                                        retain_graph=True),
            None, nr_bounds((*dys, pos, freqs), (*dys, *bs), rope_flops))})
    for name, (fast, parent, slow, unfused_lib, bound) in cases.items():
        calls = {"kernel": fast, "parent": parent, "plain": slow}
        ms = {w: [] for w in calls}
        for which in ("kernel", "parent", "plain", "plain", "parent",
                      "kernel"):
            ms[which].append(cuda_ms(calls[which], iters=20, warmup=2))
        row = dict(ms=sum(ms["kernel"]) / 2, parent_ms=sum(ms["parent"]) / 2,
                   plain_ms=sum(ms["plain"]) / 2, turns=ms, library_ms=None,
                   library="none: no single PyTorch call computes it",
                   unfused_library_ms=(cuda_ms(unfused_lib, iters=20,
                                               warmup=2)
                                       if unfused_lib else None), **bound)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        out[name] = row
    out["add_rms_norm_bwd"]["backward_route"] = nr.backward_route(
        "add", hp, scale, (dy, dres))
    z2, z_stride = nr._rows_of(z, y.shape[-1])
    out["gated_rms_norm_bwd"]["backward_route"] = nr.backward_route(
        "gate", y, scale, (z2, gdy), z_stride * z2.element_size())
    return out


def nr_fused_phase(torch, nr, C, gen) -> tuple:
    """The fused instances' checks (``NR_ADD_CASES``, ``NR_GATE_CASES``,
    ``NR_ROPE_BIAS_CASES``) and times (``nr_fused_times``): (the names of
    the failed cases, the largest error by kernels-line entry, the
    times)."""
    failed = []
    worst = dict.fromkeys(NR_FUSED_REPLACES, 0.0)
    for case in NR_ADD_CASES:
        row = nr_add_check(torch, nr, C, case, gen)
        emit("kernel_check", kernel="add_norm", case=case[0], **row)
        worst["add_rms_norm_fwd"] = max(worst["add_rms_norm_fwd"],
                                        row["forward"]["max_abs_err"])
        worst["add_rms_norm_bwd"] = max(
            worst["add_rms_norm_bwd"], row["dh"]["max_abs_err"],
            row["dscale"]["max_abs_err"],
            row["dbias"]["max_abs_err"] if row["dbias"] else 0.0)
        if not row["ok"]:
            failed.append(f"add norm {case[0]}")
    for case in NR_GATE_CASES:
        row = nr_gate_check(torch, nr, C, case, gen)
        emit("kernel_check", kernel="gated_norm", case=case[0], **row)
        worst["gated_rms_norm_fwd"] = max(worst["gated_rms_norm_fwd"],
                                          row["forward"]["max_abs_err"])
        worst["gated_rms_norm_bwd"] = max(
            worst["gated_rms_norm_bwd"], row["dy"]["max_abs_err"],
            row["dz"]["max_abs_err"], row["dscale"]["max_abs_err"])
        if not row["ok"]:
            failed.append(f"gated norm {case[0]}")
    for case in NR_ROPE_BIAS_CASES:
        row = nr_rope_bias_check(torch, nr, C, case, gen)
        emit("kernel_check", kernel="rope_bias", case=case[0], **row)
        worst["rope_bias"] = max(
            worst["rope_bias"], row["forward"]["max_abs_err"],
            row["backward"]["max_abs_err"],
            *(r["max_abs_err"] for r in row["bias_grads"]))
        if not row["ok"]:
            failed.append(f"rope with biases {case[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    return failed, worst, nr_fused_times(torch, nr, C, gen)


def phase_norm_rope_kernel(torch, nr) -> list:
    """The norm and RoPE kernels against their plain versions on the card
    (``NR_NORM_CASES``, ``NR_ROPE_CASES``: the paths' widths and heads,
    decode's (B, 1), odd widths, an unaligned x, f32 and bf16, a scale of
    the other dtype), forward and backward, the same bits over 3 calls,
    one device launch a kernel a call; then each timed at codeqwen's train
    shape (``nr_times``).  Returns the kernels line's three entries."""
    from repro_torch.models import common as C
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    t0 = time.monotonic()
    failed, worst = [], {"rms_norm_fwd": 0.0, "rms_norm_bwd": 0.0,
                         "rope": 0.0}
    rope_bits = {"forward": True, "backward": True}
    rope_ulps = {"forward": 0, "backward": 0}
    for case in NR_NORM_CASES:
        row = nr_norm_check(torch, nr, C, case, gen)
        emit("kernel_check", kernel="norm", case=case[0], **row)
        worst["rms_norm_fwd"] = max(worst["rms_norm_fwd"],
                                    row["forward"]["max_abs_err"])
        worst["rms_norm_bwd"] = max(worst["rms_norm_bwd"],
                                    row["dx"]["max_abs_err"],
                                    row["dscale"]["max_abs_err"])
        if not row["ok"]:
            failed.append(f"norm {case[0]}")
    for case in NR_ROPE_CASES:
        row = nr_rope_check(torch, nr, C, case, gen)
        emit("kernel_check", kernel="rope", case=case[0], **row)
        for part in ("forward", "backward"):
            worst["rope"] = max(worst["rope"], row[part]["max_abs_err"])
            rope_bits[part] = rope_bits[part] and row[part]["same_bits"]
            rope_ulps[part] = max(rope_ulps[part], row[part]["max_ulp"])
        if not row["ok"]:
            failed.append(f"rope {case[0]}")
    fused_failed, fused_worst, fused_times = nr_fused_phase(torch, nr, C,
                                                            gen)
    failed += fused_failed
    gc.collect()
    torch.cuda.empty_cache()
    times = nr_times(torch, nr, C, gen)
    emit("norm_rope_times", shape=NR_SHAPE, times=times,
         rope_same_bits=rope_bits, rope_max_ulp=rope_ulps,
         seconds=time.monotonic() - t0)
    emit("norm_rope_fused_times", shape=NR_FUSED_SHAPE, times=fused_times)
    if failed:
        fail(f"norm / rope kernels differ from the plain versions: {failed}")
    entries = []
    for name in ("rms_norm_fwd", "rms_norm_bwd", "rope"):
        t = times[name]
        entry = {
            "name": name, "route": "cuda", "counter": name,
            "kernel_route": {"rope": "forward_bf16",
                             "rms_norm_bwd": "staged_bf16_bf16"}.get(
                                 name, "bf16_bf16"),
            "kernel_routes": list(
                nr.ROPE_ROUTES[:4] if name == "rope" else
                nr.STAGED_ROUTES[:4] + nr.NORM_ROUTES[:4]
                if name == "rms_norm_bwd" else nr.NORM_ROUTES[:4]),
            "source": NR_SOURCE + {
                "rms_norm_fwd": " (rms_norm_fwd_kernel)",
                "rms_norm_bwd": " (rms_norm_bwd_staged_kernel, the "
                                "register route's rms_norm_bwd_kernel, "
                                "rms_norm_dscale_kernel)",
                "rope": " (rope_kernel, forward and backward)"}[name],
            "replaces": NR_REPLACES[name], "shape": NR_SHAPE[name],
            "max_abs_err": worst[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": t["library"]}
        if name == "rope":
            b = times["rope_backward"]
            entry.update(backward_ms=b["ms"], backward_plain_ms=b["plain_ms"],
                         backward_bound_ms=b["bound_ms"],
                         same_bits=rope_bits, max_ulp=rope_ulps)
        entries.append(entry)
    # the fused instances: their kernel's counter on their own routes
    for name, (counter, prologue, kernel_name) in {
            "add_rms_norm_fwd": ("rms_norm_fwd", "add",
                                 "rms_norm_fwd_kernel, prologue kAdd"),
            "add_rms_norm_bwd": ("rms_norm_bwd", "add",
                                 "rms_norm_bwd_staged_kernel (the register "
                                 "route's rms_norm_bwd_kernel) and "
                                 "rms_norm_dscale_kernel, prologue kAdd"),
            "gated_rms_norm": ("rms_norm_fwd", "gate",
                               "rms_norm_fwd_kernel, prologue kGate; its "
                               "backward rms_norm_bwd_staged_kernel (the "
                               "register route's rms_norm_bwd_kernel) and "
                               "rms_norm_dscale_kernel, prologue kGate"),
            "rope_bias": ("rope", "bias",
                          "rope_kernel with biases, forward and backward, "
                          "and rms_norm_dscale_kernel for the biases' "
                          "grads")}.items():
        key = name if name in fused_times else name + "_fwd"
        t = fused_times[key]
        routes = [r for r in nr.KERNEL_ROUTES[counter]
                  if r.startswith((prologue + "_", f"staged_{prologue}_"))]
        entry = {
            "name": name, "route": "cuda", "counter": counter,
            "kernel_route": {"rope": "bias_forward_bf16",
                             "rms_norm_bwd": f"staged_{prologue}_bf16_bf16"}
            .get(counter, f"{prologue}_bf16_bf16"), "kernel_routes": routes,
            "source": f"{NR_SOURCE} ({kernel_name})",
            "replaces": NR_FUSED_REPLACES[key],
            "shape": NR_FUSED_SHAPE[key], "max_abs_err": fused_worst[key],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "parent_ms": t["parent_ms"],
            "unfused_library_ms": t["unfused_library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library": t["library"]}
        # a backward without a train path of its family on the card (the
        # gated norm's: no SSM trains there) is timed and checked beside its
        # forward, its launches counted under ``backward_launches``
        b = {"rope_bias": "rope_bias_backward",
             "gated_rms_norm": "gated_rms_norm_bwd"}.get(name)
        if b:
            b = fused_times[b]
            entry.update(backward_ms=b["ms"], backward_plain_ms=b["plain_ms"],
                         backward_parent_ms=b["parent_ms"],
                         backward_bound_ms=b["bound_ms"])
        if name == "gated_rms_norm":
            entry.update(
                backward_max_abs_err=fused_worst["gated_rms_norm_bwd"],
                backward_routes=[r for r in nr.BWD_ROUTES
                                 if r.startswith(("gate_", "staged_gate_"))])
        entries.append(entry)
    return entries


def norm_rope_calls(cfg, step: str) -> dict:
    """The norms and RoPE launches of one pass of ``cfg``: ``step``
    "forward" (``forward_train``'s or a prefill's) or "decode" (one decode
    step).  ``layer_norms``: the norms inside the layers (remat recomputes
    them): a block's attn and mlp norms, the cross norm of whisper's
    decoder, chameleon's q and k norms a q / k projection, the Mamba2
    layer's norm and its gated norm; ``outer_norms``: the final norm (and
    the encoder's); ``ropes``: one a self-attention call (q and k in one
    launch; none in whisper).  Of these, ``add_norms`` take the residual
    add (and the output bias) as their prologue (a block's norms after its
    first: ``models.model._block``), ``gate_norms`` the SSM's gate, and
    ``bias_ropes`` the q and k biases (``use_bias`` without qk-norm); the
    ``enc_*`` counts are the whisper encoder's share, whose x is the f32
    frames' dtype (``enc_layer_norms`` its layers' norms without a
    prologue, ``enc_add_norms`` with, ``enc_outer_norms`` its final
    norm); ``qk_norms`` and ``enc_qk_norms`` are the q and k norms among
    the layer norms (over the head dim; the rest over d_model, the gated
    norms over the SSM's inner width)."""
    from repro_torch.models import model as M
    qk = 2 if cfg.qk_norm else 0
    rope_bias = cfg.use_bias and not cfg.qk_norm
    out = {"layer_norms": (2 + qk) * cfg.num_layers, "outer_norms": 1,
           "ropes": cfg.num_layers, "add_norms": cfg.num_layers,
           "gate_norms": 0, "bias_ropes": cfg.num_layers * rope_bias,
           "qk_norms": qk * cfg.num_layers, "enc_layer_norms": 0,
           "enc_add_norms": 0, "enc_outer_norms": 0, "enc_qk_norms": 0}
    if cfg.family in ("ssm", "hybrid"):
        calls = M._shared_groups(cfg) if cfg.family == "hybrid" else 0
        out.update(layer_norms=2 * cfg.num_layers + (2 + qk) * calls,
                   ropes=calls, add_norms=calls, gate_norms=cfg.num_layers,
                   bias_ropes=calls * rope_bias, qk_norms=qk * calls)
    elif cfg.family == "encdec":
        # the forward's cross-attention projects q and k (their qk norms);
        # the decode step's reads the cached encoder K / V
        dec_qk = (2 * qk if step == "forward" else qk) * cfg.num_layers
        dec = 3 * cfg.num_layers + dec_qk
        enc_qk = qk * cfg.num_encoder_layers if step == "forward" else 0
        enc = 2 * cfg.num_encoder_layers + enc_qk if step == "forward" \
            else 0
        enc_add = cfg.num_encoder_layers if step == "forward" else 0
        out.update(layer_norms=dec + enc, ropes=0, bias_ropes=0,
                   outer_norms=2 if step == "forward" else 1,
                   add_norms=2 * cfg.num_layers + enc_add, qk_norms=dec_qk,
                   enc_layer_norms=enc - enc_add, enc_add_norms=enc_add,
                   enc_outer_norms=1 if step == "forward" else 0,
                   enc_qk_norms=enc_qk)
    return out


def norm_bwd_route(nr, x_dtype, scale_dtype, prologue: str, n: int,
                   stride_bytes: int = 16) -> str:
    """The route of a model's norm backward at width ``n`` (its rows
    aligned, as the model's activations are; ``stride_bytes``: the gated
    norm's z, a slice of the input projection, by its row stride)."""
    vec = n % nr.VEC == 0 and stride_bytes % 16 == 0
    staged = nr.bwd_plan(1, n, vec, x_dtype, prologue)["route"] == "staged"
    return nr.bwd_route(x_dtype, scale_dtype, prologue, staged)


def norm_rope_pass(nr, cfg, step: str, passes: int, forwards: int = 1,
                   backward: bool = False, fused: bool = True,
                   frames_dtype=None) -> dict:
    """The norm and RoPE kernels' launches by kernel and route
    (``nr.KERNEL_ROUTES``) of ``passes`` passes of ``cfg``
    (``norm_rope_calls``' ``step``), each with ``forwards`` forwards of
    the layers (2 under remat) and, with ``backward``, one backward: the
    norm's forward once a norm a forward (the outer norms once a pass),
    its backward and dscale once a norm a backward, RoPE once a
    self-attention call a forward and once a backward (the dscale kernel
    once more a backward with biases, for their grads); x in the model's
    dtype but for whisper's f32 encoder, the scale in the model's; the
    backward on the route its width takes (``norm_bwd_route``).
    ``fused`` False: the parent's route (``unfused_norm_rope``), every
    norm and rotation without a prologue (the unfused gated norm a plain
    one).  ``frames_dtype``: whisper's frames' dtype, and so its
    encoder's x dtype, where it is not f32 (a train input's: the
    config's dtype)."""
    import torch
    dt, enc = cfg.torch_dtype, frames_dtype or torch.float32
    c = norm_rope_calls(cfg, step)
    add, gate = ("add", "gate") if fused else ("", "")
    want = {k: dict.fromkeys(nr.KERNEL_ROUTES[k], 0) for k in nr.KERNELS}
    # the hybrid's Mamba layers sit in two checkpoints under remat (their
    # own and their group's, ``models.model.backbone``): their norm and
    # gated norm run one forward more
    nested = cfg.num_layers if cfg.family == "hybrid" and forwards > 1 \
        else 0
    d, hd = cfg.d_model, cfg.resolved_head_dim
    # the gated norm's width and z's row stride (the input projection's)
    gw, zw = 0, 0
    if cfg.family in ("ssm", "hybrid"):
        gw = cfg.ssm_inner
        zw = 2 * gw + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    # (prologue, x dtype, width, z's row stride, layer norms, outer norms,
    # norms of the nested layers)
    for pro, x, n, stride, layer, outer, more in (
            ("", dt, d, 0, c["layer_norms"] - c["add_norms"]
             - c["gate_norms"] - c["enc_layer_norms"] - c["qk_norms"],
             c["outer_norms"] - c["enc_outer_norms"], nested),
            ("", dt, hd, 0, c["qk_norms"], 0, 0),
            ("", enc, d, 0, c["enc_layer_norms"] - c["enc_qk_norms"],
             c["enc_outer_norms"], 0),
            ("", enc, hd, 0, c["enc_qk_norms"], 0, 0),
            (add, dt, d, 0, c["add_norms"] - c["enc_add_norms"], 0, 0),
            (add, enc, d, 0, c["enc_add_norms"], 0, 0),
            (gate, dt, gw, zw, c["gate_norms"], 0, nested)):
        if not layer + outer + more:
            continue
        r = nr.norm_route(x, dt, pro)
        want["rms_norm_fwd"][r] += passes * (layer * forwards + outer + more)
        if backward:
            want["rms_norm_dscale"][r] += passes * (layer + outer)
            b = norm_bwd_route(nr, x, dt, pro, n, stride
                               * torch.finfo(x).bits // 8 if pro == "gate"
                               else 16)
            want["rms_norm_bwd"][b] += passes * (layer + outer)
    biased = c["bias_ropes"] if fused else 0
    for bias, n in ((False, c["ropes"] - biased), (True, biased)):
        want["rope"][nr.rope_route(dt, False, bias)] += passes * n * forwards
        if backward:
            back = nr.rope_route(dt, True, bias)
            want["rope"][back] += passes * n
            if bias:
                want["rms_norm_dscale"][nr.dscale_route(back)] += passes * n
    return want


def _add_launches(want: dict, more: dict) -> None:
    for k, by in more.items():
        for r, n in by.items():
            want[k][r] += n


def expected_norm_rope_serve(cfg, n_micro: int, decode_steps: int,
                             runs: Optional[dict] = None,
                             nr=None) -> dict:
    """The norm and RoPE launches of a serve run, in all a kernel, on the
    host and on the device: a forward a prefill, a decode pass a decode
    step, as often as ``runs`` (``serve_runs``; default the parent's
    route) runs them there (the host its eager calls and captures, the
    device its eager calls and replays); no backward.  With ``nr`` (the
    wrapper module), by route too (``routes``: host and device, from
    ``norm_rope_pass``)."""
    runs = runs or serve_runs(cfg, n_micro, decode_steps)
    fwd, dec = norm_rope_calls(cfg, "forward"), norm_rope_calls(cfg, "decode")
    out = {}
    for name, per in (("rms_norm_fwd", lambda c: c["layer_norms"]
                       + c["outer_norms"]), ("rope", lambda c: c["ropes"])):
        out[name] = {w: runs["prefill"][w] * per(fwd)
                     + runs["decode"][w] * per(dec)
                     for w in ("host", "device")}
    for name in ("rms_norm_bwd", "rms_norm_dscale"):
        out[name] = {"host": 0, "device": 0}
    if nr is not None:
        for w in ("host", "device"):
            by = norm_rope_pass(nr, cfg, "forward", runs["prefill"][w])
            _add_launches(by, norm_rope_pass(nr, cfg, "decode",
                                             runs["decode"][w]))
            for k in out:
                out[k].setdefault("routes", {})[w] = by[k]
    return out


def fused_prefill_ops(cfg) -> dict:
    """The ATen ops a prefill of ``cfg`` runs fewer on the fused kernels
    than on the parent's route (``unfused_norm_rope``): each add norm's
    residual add and output bias add, each biased rotation's q and k bias
    adds, each gated norm's silu and product."""
    c = norm_rope_calls(cfg, "forward")
    return {"aten::add": c["add_norms"] * (1 + cfg.use_bias)
            + 2 * c["bias_ropes"],
            "aten::mul": c["gate_norms"], "aten::silu": c["gate_norms"]}


def kernel_steps(phase: str) -> list:
    """(config, steps, microbatches a step, forwards a layer, backward) of
    a phase's passes through every train-path kernel: every step of
    ``attention_steps`` (remat's recompute runs the layers' forwards
    again), and in the train phase two more full-width steps (the
    FLOP-counted one and step 1's grads on the plain attention) and
    ``forward_train``'s loss (no grad: one forward), and each family's
    FLOP-counted step and ``forward_train``'s loss (its step 1 on the
    plain route launches none).  The side columns'
    steps (``side_steps``) are not among them: the parent's run the
    unfused norms and rotations (``unfused_norm_rope``), the plain
    column's the gate's and the loss's plain ops (``plain_gate_loss``)."""
    import dataclasses

    from repro_torch.configs import get_config
    out = [(cfg, steps, micro, fwd, True)
           for cfg, steps, micro, fwd in attention_steps(phase)]
    if phase == "train":
        full = dataclasses.replace(get_config("codeqwen15_7b"),
                                   num_layers=TRAIN_FULL["layers"])
        out += [(full, 2, 1, 2, True), (full, 1, 1, 1, False)]
        # each family's FLOP-counted step and forward_train's loss
        out += [s for _, main, _ in family_configs()
                for s in ((main, family_steps()["flops"], 1, 2, True),
                          (main, 1, 1, 1, False))]
    return out


def gate_loss_steps(phase: str) -> list:
    """``kernel_steps`` and the parent column's (remat), which run the
    gate's and the loss's kernels too (the plain column's run none)."""
    return kernel_steps(phase) + [(cfg, n, 1, 2, True)
                                  for cfg, n in side_steps(phase, "parent")]


def expected_norm_rope_launches(nr, phase: str) -> dict:
    """The norm and RoPE kernels' launches a train, examples or dry-run
    phase must make, by kernel and route (``norm_rope_pass``): every step
    of ``kernel_steps`` and the plain column's (``side_steps``, remat) on
    the fused routes, the parent column's on the unfused ones."""
    want = {k: dict.fromkeys(nr.KERNEL_ROUTES[k], 0) for k in nr.KERNELS}
    steps = [(*s, True) for s in kernel_steps(phase)] + [
        (cfg, n, 1, 2, True, w == "plain") for w in TRAIN_SIDE
        for cfg, n in side_steps(phase, w)]
    for cfg, steps, micro, forwards, backward, fused in steps:
        _add_launches(want, norm_rope_pass(nr, cfg, "forward", micro * steps,
                                           forwards, backward, fused,
                                           frames_dtype=cfg.torch_dtype))
    return want


NORM_ROPE_LAUNCHES: dict = {}    # phase or path -> host and device counts


def route_turns(torch, cfg, params, batch, shape: dict, parent) -> dict:
    """``cfg``'s replayed prefill and replayed decode step at ``shape``'s
    microbatch (``batch``) on the kernels and under ``parent`` (a context
    manager that gives the parent's path), in turns (kernels, parent,
    parent, kernels): the medians of 3 prefills and of 8 replays a turn on
    the host clock, each ended by a synchronise; each turn captures its
    own prefill and decode graphs (a Python patch reaches a graph only at
    its capture), the prefill's on a cache of the turn's, the decode's
    on the cache its first step returned."""
    from repro_torch.models import model as M
    from repro_torch.train import make_decode_step, make_prefill_step
    s, steps = shape["prompt_len"], shape["decode_steps"]
    turns = {w: {"prefill_ms": [], "decode_step_ms": []}
             for w in ("kernels", "parent")}
    for which in ("kernels", "parent", "parent", "kernels"):
        with (parent() if which == "parent" else contextlib.nullcontext()):
            prefill_step = make_prefill_step(cfg)
            cache = M.init_cache(cfg, batch["tokens"].shape[0], s + steps,
                                 device="cuda")
            first, _ = prefill_step(params, batch, cache=cache)
            tok, decode_one = first[:, None], make_decode_step(cfg)
            turns[which]["prefill_ms"].append(step_ms(
                torch, lambda: prefill_step(params, batch, cache=cache),
                3)[0])
            _, cache = decode_one(params, cache, tok, s)
            turns[which]["decode_step_ms"].append(step_ms(
                torch, lambda: decode_one(params, cache, tok, s), 8)[0])
            decode_one.close()
            prefill_step.close()
        del first, cache, tok, decode_one, prefill_step
    return dict(turns=turns, **{f"{w}_{k}": sum(v) / 2
                                for w, t in turns.items()
                                for k, v in t.items()})


def phase_serve_parent(torch) -> None:
    """``--serve-parent``: each serve path's prefill and replayed decode
    step at full width and depth (``phase_steps``' batch), on the fused
    norm and RoPE kernels and on the parent's route (``unfused_norm_rope``:
    the adds, silu and product as ATen ops), in turns (``route_turns``),
    and on the gate's kernel against its plain ops (``plain_gate_loss``);
    the moe path's also on its MoE kernels
    against the slot-scan route (``slot_scan_moe``) and the block's plain
    route (``plain_moe``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import model as M
    for arch in PATHS:
        cfg, shape = get_config(arch), serve_shape(arch)
        mb, s = shape["microbatch"], shape["prompt_len"]
        params = M.init_params(cfg, device="cuda")
        batch = prompt_batch(cfg, torch.from_numpy(
            np.random.default_rng(2).integers(0, cfg.vocab_size,
                                              size=(mb, s))).cuda())
        emit("serve_parent", config=cfg.name, microbatch=mb, prompt_len=s,
             **route_turns(torch, cfg, params, batch, shape,
                           unfused_norm_rope))
        emit("gate_parent", config=cfg.name, microbatch=mb, prompt_len=s,
             **route_turns(torch, cfg, params, batch, shape,
                           plain_gate_loss))
        if cfg.family == "moe":     # and on the slot-scan and plain routes
            emit("moe_parent", config=cfg.name, microbatch=mb, prompt_len=s,
                 threads=[t.name for t in threading.enumerate()],
                 slot_scan=route_turns(torch, cfg, params, batch,
                                       shape, slot_scan_moe),
                 plain=route_turns(torch, cfg, params, batch, shape,
                                   plain_moe))
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()


def norm_rope_window(nr):
    """Counts the norm and RoPE kernels' launches from this call on: the
    host's (the wrappers' counts, set to 0 here: ``nr.host_launches``)
    and the device's.  The returned ``check(what, want)`` fails unless
    each kernel's launches in all equal ``want``
    (``expected_norm_rope_serve``'s host and device totals, and by route
    where it gives ``routes``), or, with ``want`` by route
    (``expected_norm_rope_launches``), the device equals it by route, and
    the host too where no train step was captured in the window; it keeps
    the counts in ``NORM_ROPE_LAUNCHES[what]``."""
    fns = {"rms_norm_fwd": nr.rms_norm_fwd, "rms_norm_bwd": nr.rms_norm_bwd,
           "rope": nr.rope}
    _zero_counts(fns)
    lib = nr._lib()
    graphs_at = train_graph_counts()
    before = nr.kernel_launches(lib)

    def check(what: str, want: dict) -> None:
        after = nr.kernel_launches(lib)
        device = {k: {r: n - before[k][r] for r, n in by.items()}
                  for k, by in after.items()}
        host = nr.host_launches()
        NORM_ROPE_LAUNCHES[what] = {"host": host, "device": device}
        emit("norm_rope_launches", what=what, host=host, device=device,
             expected=want)
        if all("host" in w for w in want.values()):
            got = {k: {"host": sum(host[k].values()),
                       "device": sum(device[k].values())} for k in want}
            # the host counts eager calls and captures, the device eager
            # calls and replays: both on the same routes
            bad = got != {k: {w: v[w] for w in ("host", "device")}
                          for k, v in want.items()} or any(
                {r for r, n in host[k].items() if n}
                != {r for r, n in device[k].items() if n} for k in host)
            bad = bad or any(
                host[k] != v["routes"]["host"]
                or device[k] != v["routes"]["device"]
                for k, v in want.items() if "routes" in v)
        else:
            # a captured train step launches on the host and not on the
            # device, its replays the other way round: the host is held
            # only where no train step was captured
            captured = graph_delta(graphs_at)["captures"] > 0
            bad = device != want or (not captured and host != want)
        if bad:
            fail(f"{what}: norm / rope launches host {host}, device "
                 f"{device}, expected {want}")
    return check


MOE_SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"
MOE_KERNELS = ("moe_slots", "moe_dispatch", "moe_combine", "moe_route")
MOE_REPLACES = {
    "moe_route": "src/repro/models/moe.py:62-81 (softmax, lax.top_k, the "
                 "gates' renormalisation, the aux loss, one_hot, cumsum, "
                 "take_along_axis, keep; jnp inside jax.jit, "
                 "src/repro/launch/serve.py:75-76; no Pallas kernel)",
    "moe_slots": "src/repro/models/moe.py:73-81 (slot positions: one_hot, "
                 "cumsum, take_along_axis, keep; jnp inside jax.jit, "
                 "src/repro/launch/serve.py:75-76; no Pallas kernel)",
    "moe_dispatch": "src/repro/models/moe.py:84-91 (token rows and "
                    "buf.at[...].add(mode='drop'); jnp inside jax.jit; no "
                    "Pallas kernel)",
    "moe_combine": "src/repro/models/moe.py:106-111 (gather, where and the "
                   "gate-weighted einsum over k; jnp inside jax.jit; no "
                   "Pallas kernel)"}
# the device kernel of each kernel, and the kernels line's route of each
# entry (the slot scan has none: it left the path)
MOE_DEVICE_KERNELS = {"moe_route": "moe_route_kernel",
                      "moe_slots": "moe_slots_kernel",
                      "moe_dispatch": "moe_dispatch_kernel",
                      "moe_combine": "moe_combine_kernel"}
MOE_ENTRY_ROUTES = {"moe_route": "f32", "moe_dispatch": "bf16",
                    "moe_combine": "bf16"}
MOE_SHAPE = "granite-moe-3b-a800m prefill: g4 sg512 k8 e40 cap128 d1536 bf16"
MOE_CAPACITY_FACTOR = 1.25      # granite's and grok's
MOE_REL_TOL = 1e-6
# name, groups, tokens a group, k, experts, d, dtype, skew (a bias falling
# with the expert's number: the first experts overflow), unaligned (x and
# the experts' output one element past a 16-byte boundary), ties (each odd
# expert's logit equal to the even one's before it: equal probabilities,
# the lower expert first)
MOE_CASES = (
    ("granite_prefill", 4, 512, 8, 40, 1536, "bf16", 0.0, False, False),
    ("granite_decode", 1, 4, 8, 40, 1536, "bf16", 0.0, False, False),
    ("grok_width", 2, 512, 2, 8, 6144, "bf16", 0.0, False, False),
    ("granite_overflow", 4, 512, 8, 40, 1536, "bf16", 0.5, False, False),
    ("granite_f32", 4, 512, 8, 40, 1536, "f32", 0.0, False, False),
    ("g64_sg32", 64, 32, 8, 40, 1536, "bf16", 0.0, False, False),
    ("granite_smoke_f32", 2, 24, 4, 8, 64, "f32", 0.0, False, False),
    ("grok_smoke_f32", 2, 24, 2, 4, 64, "f32", 0.0, False, False),
    ("odd_d77_bf16", 2, 64, 4, 8, 77, "bf16", 0.0, False, False),
    ("unaligned_f32", 2, 64, 4, 8, 64, "f32", 0.0, True, False),
    ("e256_k8", 2, 300, 8, 256, 128, "bf16", 0.02, False, False),
    ("granite_ties", 4, 512, 8, 40, 1536, "bf16", 0.0, False, True),
    ("decode_ties", 1, 4, 8, 40, 1536, "bf16", 0.0, False, True),
    ("e256_ties_overflow", 2, 300, 8, 256, 128, "bf16", 0.02, False, True),
)


def moe_capacity(sg: int, k: int, e: int) -> int:
    from types import SimpleNamespace

    from repro_torch.models.moe import expert_capacity
    return expert_capacity(SimpleNamespace(
        top_k=k, num_experts=e, capacity_factor=MOE_CAPACITY_FACTOR), sg)


def moe_inputs(torch, case, gen) -> dict:
    """A case's router logits (g, sg, e) f32 and their plain routing (idx,
    f32 gates), tokens x (g, sg, d) and an experts' output (g, e, cap, d)
    laid out e-major, as the experts' einsum returns it."""
    from repro_torch.kernels import moe_dispatch as md
    name, g, sg, k, e, d, dt, skew, unaligned, ties = case
    dtype = getattr(torch, NR_DTYPES[dt])
    cap = moe_capacity(sg, k, e)
    logits = torch.randn((g, sg, e), generator=gen, device="cuda") - skew * \
        torch.arange(e, device="cuda")
    if ties:
        logits[..., 1::2] = logits[..., 0::2]
    idx, gates = md.moe_route_plain(logits, k, cap)[:2]

    def drawn(*shape):
        n = math.prod(shape)
        t = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        return (t[1:] if unaligned else t[:n]).view(*shape)
    x = drawn(g, sg, d)
    out_buf = drawn(e, g, cap, d).permute(1, 0, 2, 3)
    return dict(logits=logits, k=k, idx=idx, gates=gates, x=x,
                out_buf=out_buf, e=e, cap=cap)


def moe_within(torch, got, want) -> dict:
    """``got`` (its dtype) against ``want`` (f32): within 1e-6 x
    max|want|, and in bf16 2^-8 |want| more (one rounding to bf16: at
    most half an ulp)."""
    w = want.float()
    err = (got.float() - w).abs()
    scale = float(w.abs().max())
    tol = MOE_REL_TOL * scale + (TA_BF16_ULP * w.abs()
                                 if got.dtype == torch.bfloat16 else 0.0)
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float(err.max()) / scale if scale else 0.0,
            "ok": bool((err <= tol).all())}


def slot_scan_route(torch, md, logits, k: int, cap: int) -> tuple:
    """The slot-scan route of the logits, as ``models.moe`` ran it before
    ``moe_route``: the router's softmax, ``topk``, renormalisation and aux
    loss as torch ops, then ``moe_slots`` (a block a group) and its
    group-major map."""
    import torch.nn.functional as F
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    pos, keep, src = md.moe_slots(idx, e, cap)
    return idx, gates, pos, keep, src, aux


def plain_copy_dispatch(md, x, src):
    """The dispatch on the ``-DMOE_DISPATCH_FORCE_PLAIN_COPY`` build (a
    vector a load, default stores: the copy before the batched streaming
    one), into ``src``'s layout, counted by no wrapper; off the card the
    wrapper's plain version."""
    if x.device.type != "cuda":
        return md.moe_dispatch(x, src)
    return md.launch_dispatch(md._lib(md.FORCE_PLAIN_COPY_DEFINES), x, src)


@contextlib.contextmanager
def slot_scan_moe():
    """The MoE block's kernel route before ``moe_route`` (the parent's
    path): ``models.moe`` calls the same kernels, with ``moe_route``
    replaced by ``slot_scan_route``, whose group-major map gives a
    group-major buffer, so the experts' einsums copy it into e-major, and
    the dispatch by ``plain_copy_dispatch``."""
    import torch
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models import moe as MoE

    class SlotScan:
        def __getattr__(self, name):
            return getattr(md, name)

        @staticmethod
        def moe_route(logits, k, cap):
            return slot_scan_route(torch, md, logits, k, cap)

        @staticmethod
        def moe_dispatch(x, src):
            return plain_copy_dispatch(md, x, src)
    real = MoE.MD
    MoE.MD = SlotScan()
    try:
        yield
    finally:
        MoE.MD = real


def moe_expected_check(md, dtype: str, n: int = 3) -> dict:
    """The device launches ``moe_check`` makes, by kernel and route: n of
    the route, the slots and the combine, n of the dispatch a map
    layout."""
    want = {k: dict.fromkeys(md.ROUTES[k], 0) for k in md.KERNELS}
    want["moe_route"]["f32"] = n
    want["moe_slots"]["int64"] = n
    want["moe_combine"][dtype] = n
    want["moe_dispatch"][dtype] = 2 * n
    return want


def moe_check(torch, md, case, gen) -> dict:
    """A case through the kernels, each called 3 times: ``moe_route``'s
    idx, pos, keep and src equal to ``moe_route_plain``'s (``torch.equal``),
    its gates and aux within 1e-6 x max|want|; ``moe_slots``' pos, keep and
    src equal to ``moe_slots_plain``'s; the buffer from each map (e-major
    and group-major), on the kernel and on ``plain_copy_dispatch``, equal
    to ``moe_dispatch_plain``'s and laid out as its map; y within 1e-6 x max|y| (bf16: + 2^-8 |y|) of the
    plain combine's f32 sum; the same bits over the 3 calls; the device's
    launches exact by kernel and route."""
    a = moe_inputs(torch, case, gen)
    logits, k, idx, gates, x, out_buf, e, cap = (a[n] for n in (
        "logits", "k", "idx", "gates", "x", "out_buf", "e", "cap"))
    lib = md._lib()
    before = md.kernel_launches(lib)
    routes = [md.moe_route(logits, k, cap) for _ in range(3)]
    slots = [md.moe_slots(idx, e, cap) for _ in range(3)]
    e_src, g_src = routes[0][4], slots[0][2]
    bufs = {f"{n}{m}": [fn(x, s) for _ in range(3)]
            for n, fn in (("", md.moe_dispatch),
                          ("plain_copy/", lambda x, s: plain_copy_dispatch(
                              md, x, s)))
            for m, s in (("e_major", e_src), ("group_major", g_src))}
    pos, keep = slots[0][:2]
    ys = [md.moe_combine(out_buf, idx, pos, keep, gates, x.dtype)
          for _ in range(3)]
    torch.cuda.synchronize()
    after = md.kernel_launches(lib)
    dtype = md.route(x.dtype)
    launched = {n: {r: c - before[n][r] for r, c in by.items()}
                for n, by in after.items()}
    want_launched = moe_expected_check(md, dtype)
    p_route = md.moe_route_plain(logits, k, cap)
    p_pos, p_keep, p_src = md.moe_slots_plain(idx, e, cap)
    p_buf = md.moe_dispatch_plain(x, p_src)
    y_f32 = md.moe_combine_plain(out_buf, idx, p_pos, p_keep, gates,
                                 torch.float32)
    got = routes[0]
    kept = int(p_route[3].sum())
    row = {"shape": dict(g=case[1], sg=case[2], k=k, e=e, cap=cap,
                         d=case[5]), "dtype": case[6],
           "unaligned": case[8], "ties": case[9], "route": dtype,
           "kept": kept, "dropped": p_route[3].numel() - kept,
           "route_equal": {n: bool(torch.equal(got[i], p_route[i]))
                           for i, n in ((0, "idx"), (2, "pos"), (3, "keep"),
                                        (4, "src"))},
           "gates": moe_within(torch, got[1], p_route[1]),
           "aux": moe_within(torch, got[5], p_route[5]),
           "slots_equal": bool(torch.equal(slots[0][0], p_pos)
                               and torch.equal(slots[0][1], p_keep)
                               and torch.equal(g_src, p_src)),
           "buf_equal": {m: bool(torch.equal(b[0], p_buf))
                         for m, b in bufs.items()},
           "buf_layout": {m: bool(
               (b[0].transpose(0, 1) if m.endswith("e_major") else b[0])
               .is_contiguous()) for m, b in bufs.items()},
           "y": moe_within(torch, ys[0], y_f32),
           "repeats": all(all(same_bits(torch, u, v)
                                  if u.is_floating_point()
                                  else torch.equal(u, v)
                                  for u, v in zip(r, routes[0]))
                          for r in routes)
           and all(all(torch.equal(u, v) for u, v in zip(s, slots[0]))
                   for s in slots)
           and all(same_bits(torch, b, bs[0])
                   for bs in bufs.values() for b in bs)
           and all(same_bits(torch, y, ys[0]) for y in ys),
           "device_launches": launched,
           # every launch leaves the route's persistent state zero
           "state_zero": all(int(t.count_nonzero()) == 0
                             for t in md._STATES.values())}
    row["ok"] = (all(row["route_equal"].values()) and row["gates"]["ok"]
                 and row["state_zero"]
                 and row["aux"]["ok"] and row["slots_equal"]
                 and all(row["buf_equal"].values())
                 and all(row["buf_layout"].values()) and row["y"]["ok"]
                 and row["repeats"] and launched == want_launched
                 and (case[7] == 0.0 or row["dropped"] > 0))
    return row


def moe_bound(tensors, extra_bytes: int = 0) -> dict:
    """Bytes (each input read and each output written once, ``extra``
    more) at 3.35 TB/s; the kernels do no arithmetic worth a bound."""
    nbytes = extra_bytes + sum(t.numel() * t.element_size() for t in tensors)
    return dict(bytes=nbytes, bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
                bound_by="bytes")


def launches_of(torch, fn) -> dict:
    """The launches one call of ``fn`` makes: the CUDA runtime's launch and
    memset calls on the host, by name, and the device kernels a profile
    shows (a profile can lose device records: it may show fewer)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    return {"host": {e.key: e.count for e in events
                     if e.device_type != cuda and ("LaunchKernel" in e.key
                                                   or "Memset" in e.key)},
            "device": {e.key[:60]: e.count for e in events
                       if e.device_type == cuda}}


def moe_times(torch, md, gen) -> dict:
    """At granite's prefill shape (``MOE_CASES[0]``), each in turns with
    the route it replaces (new, old, old, new), beside its byte bound, its
    plain version and the nearest library call: ``moe_route`` against
    the slot-scan route's glue (``slot_scan_route``: softmax, topk,
    renormalisation, aux loss and ``moe_slots``), with the device launches
    of each; the dispatch into the e-major buffer against
    ``plain_copy_dispatch`` into the group-major one (the slot-scan
    route's; library: ``index_select`` of the token rows), and each of
    the two into each layout; logits to the experts' (e, g * cap, d) input, both
    (the slot-scan route's with the einsum's copy into e-major); ``moe_slots`` and ``moe_combine`` against their
    plain versions; the route, the dispatch and the combine together
    against the plain route's glue."""
    from repro_torch.models import moe as MoE
    a = moe_inputs(torch, MOE_CASES[0], gen)
    logits, k, x, out_buf, e, cap = (a[n] for n in (
        "logits", "k", "x", "out_buf", "e", "cap"))
    g, sg, d = x.shape
    idx, gates, pos, keep, src, aux = md.moe_route(logits, k, cap)
    g_src = md.moe_slots(idx, e, cap)[2]
    buf = md.moe_dispatch(x, src)
    y = md.moe_combine(out_buf, idx, pos, keep, gates, x.dtype)
    kept = int(keep.sum())
    rows = (g_src.long().clamp_min(0) + sg * torch.arange(
        g, device="cuda")[:, None, None]).reshape(-1)
    flat_x = x.reshape(g * sg, d)
    row_bytes = d * x.element_size()
    route_bound = moe_bound((logits, idx, gates, pos, keep, src, aux))
    slots_bound = moe_bound((idx, pos, keep, g_src))
    dispatch_bound = moe_bound((x, src, buf))
    combine_bound = moe_bound((idx, pos, keep, gates, y), kept * row_bytes)
    to_experts_bound = moe_bound((logits, x, buf))

    def new_to_experts():
        s = md.moe_route(logits, k, cap)[4]
        return md.moe_dispatch(x, s).transpose(0, 1).reshape(e, g * cap, d)

    def old_to_experts():
        s = slot_scan_route(torch, md, logits, k, cap)[4]
        return plain_copy_dispatch(md, x, s).permute(1, 0, 2, 3).reshape(
            e, g * cap, d)

    def kernels():
        i, gt, p, kp, s, _ = md.moe_route(logits, k, cap)
        md.moe_dispatch(x, s)
        return md.moe_combine(out_buf, i, p, kp, gt, x.dtype)

    def plain_route():
        i, gt, p, kp, s, _ = md.moe_route_plain(logits, k, cap)
        MoE.dispatch_ops(x, i, e, cap)
        return md.moe_combine_plain(out_buf, i, p, kp, gt, x.dtype)
    both = sum(b["bytes"] for b in (route_bound, dispatch_bound,
                                     combine_bound))
    # name: (new, old or None, plain, library call or None, bound)
    cases = {
        "moe_route": (lambda: md.moe_route(logits, k, cap),
                      lambda: slot_scan_route(torch, md, logits, k, cap),
                      lambda: md.moe_route_plain(logits, k, cap), None,
                      route_bound),
        "moe_dispatch": (lambda: md.moe_dispatch(x, src),
                         lambda: plain_copy_dispatch(md, x, g_src),
                         lambda: md.moe_dispatch_plain(x, src),
                         lambda: flat_x.index_select(0, rows),
                         dispatch_bound),
        "logits_to_experts": (new_to_experts, old_to_experts, None, None,
                              to_experts_bound),
        "moe_slots": (lambda: md.moe_slots(idx, e, cap), None,
                      lambda: md.moe_slots_plain(idx, e, cap), None,
                      slots_bound),
        "moe_combine": (lambda: md.moe_combine(out_buf, idx, pos, keep,
                                               gates, x.dtype), None,
                        lambda: md.moe_combine_plain(out_buf, idx, pos, keep,
                                                     gates, x.dtype),
                        None, combine_bound),
        "all_three": (kernels, None, plain_route, None,
                      dict(bytes=both, bound_ms=both / H100_BYTES_PER_S * 1e3,
                           bound_by="bytes")),
    }
    out = {}
    for name, (fast, old, plain, lib_call, bound) in cases.items():
        slow = old or plain
        ms = {"kernel": [], "other": []}
        for which in ("kernel", "other", "other", "kernel"):
            ms[which].append(cuda_ms(fast if which == "kernel" else slow,
                                     iters=20, warmup=2))
        row = dict(ms=sum(ms["kernel"]) / 2, turns=ms,
                   old_ms=sum(ms["other"]) / 2 if old else None,
                   plain_ms=(sum(ms["other"]) / 2 if not old else
                             cuda_ms(plain, iters=20, warmup=2)
                             if plain else None),
                   library_ms=(cuda_ms(lib_call, iters=20, warmup=2)
                               if lib_call else None), **bound)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        out[name] = row
    out["moe_dispatch"]["library"] = ("torch.index_select of the token rows "
                                      "(no zero rows for empty slots)")
    # the same three with x just read, as the prefill's router product
    # leaves it (in L2), whatever an earlier call left there: each call
    # after a sum of x, less the sum's own time, in turns
    touch = lambda: x.sum()                                     # noqa: E731
    layouts = {"e_major": lambda: md.moe_dispatch(x, src),
               "group_major": lambda: md.moe_dispatch(x, g_src),
               "plain_copy_e_major": lambda: plain_copy_dispatch(md, x, src),
               "plain_copy_group_major": lambda: plain_copy_dispatch(
                   md, x, g_src),
               "index_select": lambda: flat_x.index_select(0, rows)}
    turns = {n: [] for n in layouts}
    for n in (*layouts, *reversed(layouts)):
        turns[n].append(cuda_ms(layouts[n], iters=20, warmup=2))
    out["moe_dispatch"]["layouts_ms"] = {n: sum(t) / 2
                                         for n, t in turns.items()}
    out["moe_dispatch"]["layouts_turns"] = turns
    warm = {"e_major": lambda: md.moe_dispatch(x, src),
            "plain_copy_group_major": lambda: plain_copy_dispatch(
                md, x, g_src),
            "index_select": lambda: flat_x.index_select(0, rows)}
    turns = {n: [] for n in warm}
    for n in (*warm, *reversed(warm)):
        fn = warm[n]
        turns[n].append(cuda_ms(lambda: (touch(), fn()), iters=20,
                                warmup=2) - cuda_ms(touch, iters=20,
                                                    warmup=2))
    out["moe_dispatch"]["x_warm_ms"] = {n: sum(t) / 2
                                        for n, t in turns.items()}
    out["moe_dispatch"]["x_warm_turns"] = turns
    out["moe_dispatch"]["old"] = ("the plain copy (a vector a load, default "
                                  "stores) into the group-major buffer")
    out["moe_route"]["old"] = ("the slot-scan route: softmax, topk, "
                               "renormalisation, aux loss, moe_slots")
    out["logits_to_experts"]["old"] = ("the slot-scan route: the glue, the "
                                       "plain copy into the group-major "
                                       "buffer and the einsum's copy into "
                                       "e-major")
    for name in ("moe_route", "moe_slots", "moe_combine", "all_three",
                 "logits_to_experts"):
        out[name]["library"] = "none: no one PyTorch call computes it"
    out["all_three"]["plain"] = ("models.moe's plain route: the router's "
                                 "ops, dispatch_ops and moe_combine_plain, "
                                 "the experts excluded")
    out["launches_a_call"] = {
        "moe_route": launches_of(
            torch, lambda: md.moe_route(logits, k, cap)),
        "slot_scan_route": launches_of(
            torch, lambda: slot_scan_route(torch, md, logits, k, cap))}
    out["kept_slots"] = kept
    # the host's microseconds a layer's glue takes to return, the kernels,
    # the slot-scan route's and the plain route's ops (20 calls: the plain
    # ops' launches stay within the device's queue), at the prefill's shape
    # and at the decode step's (its eager first step and its capture pay
    # it; replays do not)
    dec = moe_inputs(torch, MOE_CASES[1], gen)

    def old_kernels():
        i, gt, p, kp, s, _ = slot_scan_route(torch, md, logits, k, cap)
        plain_copy_dispatch(md, x, s)
        return md.moe_combine(out_buf, i, p, kp, gt, x.dtype)

    def dec_kernels():
        i, gt, p, kp, s, _ = md.moe_route(dec["logits"], dec["k"],
                                          dec["cap"])
        md.moe_dispatch(dec["x"], s)
        return md.moe_combine(dec["out_buf"], i, p, kp, gt, dec["x"].dtype)
    out["host_us"] = {"prefill_kernels": host_us(torch, kernels, iters=20),
                      "prefill_slot_scan": host_us(torch, old_kernels,
                                                 iters=20),
                      "prefill_plain": host_us(torch, plain_route, iters=20),
                      "decode_kernels": host_us(torch, dec_kernels)}
    return out


def phase_moe_kernel(torch, md) -> list:
    """The MoE kernels against their plain versions on the card
    (``MOE_CASES``: granite's prefill and decode shapes, grok's width, a
    forced overflow, f32, 64 groups of 32 tokens, the smoke widths, an odd
    d, unaligned rows, 256 experts, exact ties), then timed at granite's
    prefill shape (``moe_times``).  Returns the kernels line's entries, one
    a kernel of the serve path (``moe_slots``, the slot scan, left the path
    for ``moe_route``: it is checked and timed here, and not listed)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    t0 = time.monotonic()
    failed, worst = [], {"y": 0.0, "gates": 0.0}
    for case in MOE_CASES:
        row = moe_check(torch, md, case, gen)
        emit("kernel_check", kernel="moe_dispatch", case=case[0], **row)
        for n in worst:
            worst[n] = max(worst[n], row[n]["max_abs_err"])
        if not row["ok"]:
            failed.append(case[0])
    gc.collect()
    torch.cuda.empty_cache()
    times = moe_times(torch, md, gen)
    emit("moe_times", shape=MOE_SHAPE, times=times,
         seconds=time.monotonic() - t0)
    if failed:
        fail(f"MoE kernels differ from the plain versions: {failed}")
    entries = []
    for name in (n for n in md.KERNELS if n != "moe_slots"):
        t = times[name]
        entries.append({
            "name": name, "route": "cuda",
            "kernel_route": MOE_ENTRY_ROUTES[name],
            "kernel_routes": list(md.ROUTES[name]),
            "source": f"{MOE_SOURCE} ({MOE_DEVICE_KERNELS[name]})",
            "replaces": MOE_REPLACES[name], "shape": MOE_SHAPE,
            "max_abs_err": {"moe_combine": worst["y"],
                            "moe_route": worst["gates"]}.get(name, 0.0),
            "ms": t["ms"], "kernel_ms": t["ms"], "old_ms": t["old_ms"],
            "old_route": t.get("old"), "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "all_three_ms": times["all_three"]["ms"],
            "all_three_plain_ms": times["all_three"]["plain_ms"],
            "all_three_bound_ms": times["all_three"]["bound_ms"],
            "logits_to_experts_ms": times["logits_to_experts"]["ms"],
            "logits_to_experts_old_ms": times["logits_to_experts"]["old_ms"],
            **({"layouts_ms": t["layouts_ms"]} if "layouts_ms" in t else {})})
    return entries


def moe_serve_routes(md, cfg) -> dict:
    """The route of each MoE kernel a serve path of ``cfg`` launches: the
    route's one, the dispatch's and the combine's the model's dtype."""
    dt = md.route(cfg.torch_dtype)
    return {"moe_route": "f32", "moe_dispatch": dt,
            "moe_combine": dt, "moe_slots": "int64"}


def expected_moe_serve(cfg, n_micro: int, decode_steps: int,
                       runs: Optional[dict] = None) -> dict:
    """Each MoE kernel's launches in a serve run, on the host and on the
    device: the route, the dispatch and the combine once a MoE layer a
    prefill and a decode step, counted as ``expected_norm_rope_serve``
    counts them (``runs``); the slot scan of the router's idx none (the
    route took its place)."""
    runs = runs or serve_runs(cfg, n_micro, decode_steps)
    layers = cfg.num_layers if cfg.family == "moe" else 0
    per = {w: layers * (runs["prefill"][w] + runs["decode"][w])
           for w in ("host", "device")}
    return {name: dict(per) if name != "moe_slots"
            else {"host": 0, "device": 0} for name in MOE_KERNELS}


MOE_LAUNCHES: dict = {}     # phase or path -> host and device counts


def moe_window(md, routes: Optional[dict] = None):
    """Counts the MoE kernels' launches from this call on, on the host
    (the wrappers' counts, set to 0 here) and on the device.  The returned
    ``check(what, want)`` fails unless each kernel's launches in all equal
    ``want`` (``expected_moe_serve``'s host and device totals), or with
    ``routes`` (``moe_serve_routes``) any launch lies on another route
    than its kernel's; it keeps the counts in ``MOE_LAUNCHES[what]``."""
    fns = {name: getattr(md, name) for name in md.KERNELS}
    _zero_counts(fns)
    lib = md._lib()
    before = md.kernel_launches(lib)

    def check(what: str, want: dict) -> None:
        after = md.kernel_launches(lib)
        device = {k: {r: n - before[k][r] for r, n in by.items()}
                  for k, by in after.items()}
        host = {k: dict(fn.launches_by_route) for k, fn in fns.items()}
        MOE_LAUNCHES[what] = {"host": host, "device": device}
        emit("moe_launches", what=what, host=host, device=device,
             expected=want, routes=routes)
        got = {k: {"host": sum(host[k].values()),
                   "device": sum(device[k].values())} for k in want}
        stray = routes is not None and any(
            n for k in routes for by in (host[k], device[k])
            for r, n in by.items() if r != routes[k])
        if got != want or stray:
            fail(f"{what}: MoE launches host {host}, device {device}, "
                 f"expected {want} on {routes}")
    return check


MOE_IDLE = dict.fromkeys(MOE_KERNELS, {"host": 0, "device": 0})


@contextlib.contextmanager
def plain_moe():
    """The MoE block's plain route on the card (the path before the MoE
    kernels): ``models.model``'s blocks call ``moe_block`` with
    ``use_kernel`` forced off, so the routing and the dispatch run as
    torch ops."""
    from repro_torch.models import model as M
    real = M.moe_block
    M.moe_block = lambda *a, **kw: real(*a, **{**kw, "use_kernel": False})
    try:
        yield
    finally:
        M.moe_block = real


GL_SOURCE = {"gate": "src/repro_torch/csrc/gated_mlp.cu",
             "loss": "src/repro_torch/csrc/cross_entropy.cu"}
# the gate's two kernels and the loss's three (its forward's row kernel and
# the sum of the rows, one launch function)
GL_KERNELS = ("gated_act_fwd", "gated_act_bwd", "cross_entropy_fwd",
              "cross_entropy_sum", "cross_entropy_bwd")
GL_REPLACES = {
    "gated_act_fwd": "src/repro/models/model.py:93-94 _mlp's gate(h) * g "
                     "and the experts' src/repro/models/moe.py:98-100 (jnp "
                     "inside jax.jit, src/repro/launch/train.py:96, "
                     "serve.py:75-76; no Pallas kernel)",
    "gated_act_bwd": "the vjp of src/repro/models/model.py:93-94 and "
                     "moe.py:98-100 (jax.grad inside jax.jit, "
                     "src/repro/launch/train.py:96; no Pallas kernel)",
    "cross_entropy_fwd": "src/repro/models/model.py:323 logits_fn's "
                         "softcap(logits.astype(f32)) and :339 "
                         "cross_entropy (src/repro/models/common.py:185-188,"
                         " :218-227; jnp inside jax.jit, "
                         "src/repro/launch/train.py:96; no Pallas kernel)",
    "cross_entropy_bwd": "their vjp (jax.grad inside jax.jit, "
                         "src/repro/launch/train.py:96; no Pallas kernel)"}
GL_SHAPE = {"gate": "codeqwen1.5-7b train: a, b (8, 512, 13440) bf16, "
                    "swiglu",
            "loss": "codeqwen1.5-7b train: logits (8, 512, 92416) bf16, "
                    "cap 0"}
# name, shape, activation, dtype, layout: contiguous, unaligned (one
# element in) or e_major (the MoE experts' (g, e, c, f) product, a view of
# an (e, g, c, f) tensor): the paths' d_ff (decode's (B, 1), granite's
# experts, gemma2's 36,864), grok's geglu, the f32 train presets, odd
# widths
GATE_CASES = (
    ("codeqwen_train", (8, 512, 13440), "swiglu", "bf16", "contiguous"),
    ("codeqwen_decode", (4, 1, 13440), "swiglu", "bf16", "contiguous"),
    ("granite_experts", (4, 40, 128, 512), "swiglu", "bf16", "e_major"),
    ("gemma2_prefill", (2, 64, 36864), "swiglu", "bf16", "contiguous"),
    ("grok_geglu", (2, 16, 32768), "geglu", "bf16", "contiguous"),
    ("lm100m_f32", (8, 128, 3072), "swiglu", "f32", "contiguous"),
    ("geglu_f32", (4, 64, 2048), "geglu", "f32", "contiguous"),
    ("odd_33_f32", (3, 7, 33), "geglu", "f32", "contiguous"),
    ("odd_83_bf16", (5, 83), "swiglu", "bf16", "contiguous"),
    ("unaligned_bf16", (6, 4096), "geglu", "bf16", "unaligned"),
    ("unaligned_f32", (3, 8192), "swiglu", "f32", "unaligned"),
)
# name, rows, width, vocab_size, cap, dtype, logits at an unaligned
# address: codeqwen's train shape, gemma2's capped 256,000, granite's
# padded vocab, the f32 presets, odd widths (one element a thread); every
# case has labels -1, at and past the width and (where the vocab is padded)
# in [vocab_size, width)
LOSS_CASES = (
    ("codeqwen_train", (8, 512), 92416, 92416, 0.0, "bf16", False),
    ("gemma2_capped", (2, 256), 256000, 256000, 30.0, "bf16", False),
    ("granite_padded", (4, 64), 49408, 49155, 0.0, "bf16", False),
    ("lm100m_f32", (8, 128), 2048, 2048, 0.0, "f32", False),
    ("capped_f32", (4, 33), 1024, 1000, 30.0, "f32", False),
    ("odd_1001_f32", (3, 5), 1001, 990, 30.0, "f32", False),
    ("odd_999_bf16", (3, 5), 999, 999, 0.0, "bf16", False),
    ("unaligned_bf16", (4, 16), 4096, 4000, 30.0, "bf16", True),
)
GL_F32_TOL = 1e-6       # f32 gate results: within 1e-6 x max|plain|
GL_LOSS_TOL = 2e-6      # the loss and lse: within 2e-6 relative
# f32 loss grads: within 1e-6 relative of the f64 reference, and 1e-7 of
# its largest (the label's exp(c - lse) - 1 cancels where p is near 1)
GL_GRAD_REL, GL_GRAD_FLOOR = 1e-6, 1e-7


def unfused_norm_rope():
    """The parent's route on the card: the fused entry points
    (``models.common``'s ``add_rms_norm``, ``gated_rms_norm`` and
    ``apply_rope_qk`` with biases) are shown no kernel device, so they run
    the bias and residual adds, silu and the product as ATen ops, then the
    norm and RoPE kernels, as they did before the fusion."""
    return plain_kernels(("fused",))


def plain_gate_loss():
    """The gate's and the loss's plain ops on the card (their parent's path):
    ``models.common``'s ``gated_act`` and ``capped_cross_entropy`` are shown
    no kernel device, so they run ``act(a) * b`` and ``cross_entropy(
    softcap(logits.float()))`` as they did before the kernels."""
    return plain_kernels(("gate", "loss"))


def gl_gate_inputs(torch, case, gen):
    name, shape, activation, dt, layout = case
    dtype = getattr(torch, NR_DTYPES[dt])

    def draw():
        if layout == "e_major":
            return (3 * torch.randn((shape[1], shape[0], *shape[2:]),
                                    generator=gen, device="cuda")).to(
                dtype).transpose(0, 1)
        n = math.prod(shape)
        # one element in: an address 2 or 4 bytes past a 16-byte boundary
        base = (3 * torch.randn(n + 1, generator=gen, device="cuda")).to(
            dtype)
        return (base[1:] if layout == "unaligned" else base[:n]).view(shape)
    return draw(), draw(), draw()


def gl_compare(torch, got, want) -> dict:
    """A kernel result against the plain version's in its dtype: the same
    bits, or (bf16) at most one ulp apart, or (f32) within ``GL_F32_TOL``
    x max|want|."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    row = {"same_bits": same_bits(torch, got, want),
           "max_ulp": ulp_diff(torch, got, want), "max_abs_err": err}
    row["ok"] = row["same_bits"] or (row["max_ulp"] <= 1 if
                                     got.dtype == torch.bfloat16 else
                                     err <= GL_F32_TOL * scale)
    return row


def gl_gate_check(torch, gm, case, gen) -> dict:
    """A gate case: forward and backward against the plain version on the
    card (``gl_compare``), the same bits over 3 calls, one device launch a
    call on the case's route, the output in the inputs' layout."""
    name, shape, activation, dt, layout = case
    a, b, dy = gl_gate_inputs(torch, case, gen)
    if layout == "unaligned" and a.data_ptr() % 16 == 0:
        fail(f"gate case {name}: a is aligned")
    lib = gm._lib()
    before = gm.kernel_launches(lib)
    ys = [gm.gated_act_fwd(a, b, activation) for _ in range(3)]
    grads = [gm.gated_act_bwd(a, b, dy, activation) for _ in range(3)]
    torch.cuda.synchronize()
    after = gm.kernel_launches(lib)
    r = gm.route(activation, a.dtype)
    launched = {k: after[k][r] - before[k][r] for k in gm.KERNELS}
    want_da, want_db = gm.gated_act_bwd_plain(a, b, dy, activation)
    row = {"shape": list(shape), "activation": activation, "dtype": dt,
           "layout": layout, "route": r,
           "vectorised": gm.vectorised((a, b, ys[0])),
           "forward": gl_compare(torch, ys[0],
                                 gm.gated_act_plain(a, b, activation)),
           "da": gl_compare(torch, grads[0][0], want_da),
           "db": gl_compare(torch, grads[0][1], want_db),
           "repeats": all(same_bits(torch, y, ys[0]) for y in ys)
           and all(same_bits(torch, p, grads[0][0])
                   and same_bits(torch, q, grads[0][1]) for p, q in grads),
           "same_layout": ys[0].stride() == a.stride()
           and grads[0][0].stride() == a.stride(),
           "device_launches": launched}
    row["ok"] = (row["forward"]["ok"] and row["da"]["ok"] and row["db"]["ok"]
                 and row["repeats"] and row["same_layout"]
                 and launched == dict.fromkeys(launched, 3))
    return row


def gl_loss_inputs(torch, case, gen, masked: bool = True):
    name, rows, width, vocab, cap, dt, unaligned = case
    dtype = getattr(torch, NR_DTYPES[dt])
    n = math.prod(rows) * width
    base = (4 * torch.randn(n + 1, generator=gen, device="cuda")).to(dtype)
    logits = (base[1:] if unaligned else base[:n]).view(*rows, width)
    labels = torch.randint(0, vocab, rows, generator=gen, device="cuda")
    if masked:
        flat = labels.view(-1)
        flat[0], flat[1], flat[2] = -1, width, width + 1000
        if vocab < width and flat.numel() > 3:
            flat[3] = vocab + (width - vocab) // 2
    return logits, labels


def gl_loss_reference(torch, ce, logits, labels, cap: float, vocab: int,
                      g) -> tuple:
    """(lse, grad) in f64 from the plain route's f32 capped logits on the
    card (x times the f32 reciprocal of the cap, tanh, times the cap: the
    kernels' bits) and its f32 tanh: exp(c - lse) less one at the label,
    times the cap's 1 - tanh^2, times the mask and g / max(kept, 1)."""
    from repro_torch.kernels.ref import softcap
    x = logits.float()
    c = softcap(x, cap).double()
    lse = torch.logsumexp(c, -1, keepdim=True)
    lab = labels.long()
    mask = (lab >= 0) & (lab < vocab)
    w = g.double() / mask.sum().clamp_min(1) * mask
    grad = torch.exp(c - lse) * w[..., None]
    grad = grad.scatter_add(-1, lab.clamp(0, x.shape[-1] - 1)[..., None],
                            -w[..., None])
    if cap:
        t = torch.tanh(x * ce.inv_cap(cap)).double()
        grad = grad * (1 - t * t)
    return lse.view(-1), grad


def gl_grad_compare(torch, got, want64) -> dict:
    """A loss grad against the f64 reference: bf16 at most one ulp from
    its rounding, f32 within ``GL_GRAD_REL`` x |want| + ``GL_GRAD_FLOOR``
    x max|want|."""
    err = (got.double() - want64).abs()
    row = {"max_abs_err": float(err.max()),
           "max_ulp": ulp_diff(torch, got, want64.to(got.dtype))}
    if got.dtype == torch.bfloat16:
        row["ok"] = row["max_ulp"] <= 1
    else:
        tol = (GL_GRAD_REL * want64.abs()
               + GL_GRAD_FLOOR * float(want64.abs().max()))
        row["ok"] = bool((err <= tol).all())
    return row


def gl_loss_check(torch, ce, case, gen) -> dict:
    """A loss case: the loss within ``GL_LOSS_TOL`` relative of the plain
    version's on the card, lse (value + remainder) within it of an f64
    log-sum-exp, the kept count exact, the grad of an upstream 0.7
    against the f64 reference (``gl_grad_compare``; beside it the plain
    backward formula's f32 result), the same bits over 3 calls, one device
    launch a kernel a call."""
    name, rows, width, vocab, cap, dt, unaligned = case
    logits, labels = gl_loss_inputs(torch, case, gen)
    if unaligned and logits.data_ptr() % 16 == 0:
        fail(f"loss case {name}: logits are aligned")
    g = torch.full((), 0.7, device="cuda")
    lib = ce._lib()
    before = ce.kernel_launches(lib)
    outs = [ce.cross_entropy_fwd(logits, labels, cap, vocab)
            for _ in range(3)]
    grads = [ce.cross_entropy_bwd(logits, labels, outs[0][1], g,
                                  outs[0][2], cap, vocab) for _ in range(3)]
    torch.cuda.synchronize()
    after = ce.kernel_launches(lib)
    r = ce.route(logits.dtype)
    launched = {k: after[k][r] - before[k][r] for k in ce.KERNELS}
    loss, lse, denom = outs[0]
    want = ce.capped_cross_entropy_plain(logits, labels, cap, vocab)
    want_lse, want_grad = gl_loss_reference(torch, ce, logits, labels, cap,
                                            vocab, g)
    kept = int(((labels >= 0) & (labels < vocab)).sum())
    lse_err = float(((lse.double().sum(-1) - want_lse).abs()
                     / want_lse.abs()).max())
    row = {"rows": list(rows), "width": width, "vocab_size": vocab,
           "cap": cap, "dtype": dt, "unaligned": unaligned, "route": r,
           "loss": float(loss), "plain_loss": float(want),
           "loss_rel_err": abs(float(loss) - float(want)) / abs(float(want)),
           "lse_max_rel_err": lse_err,
           "kept": kept, "denominator": float(denom),
           "grad": gl_grad_compare(torch, grads[0], want_grad),
           "grad_vs_plain_formula": gl_compare(
               torch, grads[0], ce.capped_cross_entropy_bwd_plain(
                   logits, labels, cap, vocab, g)),
           "repeats": all(same_bits(torch, o[i], outs[0][i]) for o in outs
                          for i in range(3))
           and all(same_bits(torch, x, grads[0]) for x in grads),
           "device_launches": launched}
    row["ok"] = (row["loss_rel_err"] <= GL_LOSS_TOL
                 and lse_err <= GL_LOSS_TOL and float(denom) == max(kept, 1)
                 and row["grad"]["ok"] and row["repeats"]
                 and launched == dict.fromkeys(launched, 3))
    return row


def gl_times(torch, gm, ce, gen) -> dict:
    """At codeqwen1.5-7b's train shape (bf16): the gate's forward and
    backward and the loss's forward, backward and both, each in turns with
    its plain version (kernel, plain, plain, kernel; the plain backwards
    are autograd's over the plain ops, as the parent ran them), beside its
    bound (``nr_bounds``: bytes at 3.35 TB/s against f32 operations at 67
    TFLOP/s) and the library call: none for the gate (no one PyTorch call
    computes act(a) * b), ``F.cross_entropy`` on the f32 upcast for the
    loss (cap 0; the upcast outside the timed call; its autograd backward);
    and the host's microseconds a call through ``models.common`` at a
    decode step's gate (``host_us``)."""
    import torch.nn.functional as F
    from repro_torch.models import common as C
    a, b, dy = gl_gate_inputs(torch, GATE_CASES[0], gen)
    al, bl = a.detach().requires_grad_(), b.detach().requires_grad_()
    y_plain = gm.gated_act_plain(al, bl, "swiglu")
    n = a.numel()
    case = LOSS_CASES[0]
    logits, labels = gl_loss_inputs(torch, case, gen, masked=False)
    vocab = case[3]
    g = torch.ones((), device="cuda")
    loss, lse, denom = ce.cross_entropy_fwd(logits, labels, 0.0, vocab)
    leaf = logits.detach().requires_grad_()
    loss_plain = ce.capped_cross_entropy_plain(leaf, labels, 0.0, vocab)
    xf = logits.float().view(-1, vocab).requires_grad_()
    flat = labels.view(-1)
    loss_lib = F.cross_entropy(xf, flat)
    m = logits.numel()

    def both_kernel():
        _, l_, d_ = ce.cross_entropy_fwd(logits, labels, 0.0, vocab)
        return ce.cross_entropy_bwd(logits, labels, l_, g, d_, 0.0, vocab)

    def both_plain():
        return torch.autograd.grad(ce.capped_cross_entropy_plain(
            leaf, labels, 0.0, vocab), leaf)

    def both_library():
        return torch.autograd.grad(F.cross_entropy(xf, flat), xf)
    cases = {
        "gated_act_fwd": (
            lambda: gm.gated_act_fwd(a, b, "swiglu"),
            lambda: gm.gated_act_plain(a, b, "swiglu"), None,
            nr_bounds((a, b), (a,), 5 * n)),
        "gated_act_bwd": (
            lambda: gm.gated_act_bwd(a, b, dy, "swiglu"),
            lambda: torch.autograd.grad(y_plain, (al, bl), dy,
                                        retain_graph=True), None,
            nr_bounds((a, b, dy), (a, b), 12 * n)),
        "cross_entropy_fwd": (
            lambda: ce.cross_entropy_fwd(logits, labels, 0.0, vocab),
            lambda: ce.capped_cross_entropy_plain(logits, labels, 0.0,
                                                  vocab),
            lambda: F.cross_entropy(xf.detach(), flat),
            nr_bounds((logits, labels), (lse,), 4 * m)),
        "cross_entropy_bwd": (
            lambda: ce.cross_entropy_bwd(logits, labels, lse, g, denom, 0.0,
                                         vocab),
            lambda: torch.autograd.grad(loss_plain, leaf, retain_graph=True),
            lambda: torch.autograd.grad(loss_lib, xf, retain_graph=True),
            nr_bounds((logits, labels, lse), (logits,), 4 * m)),
        "cross_entropy_both": (
            both_kernel, both_plain, both_library,
            nr_bounds((logits, labels), (lse, logits), 8 * m)),
    }
    out = {}
    for name, (fast, slow, lib_call, bound) in cases.items():
        ms = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            ms[which].append(cuda_ms(fast if which == "kernel" else slow,
                                     iters=20, warmup=2))
        row = dict(ms=sum(ms["kernel"]) / 2, plain_ms=sum(ms["plain"]) / 2,
                   turns=ms, library_ms=(cuda_ms(lib_call, iters=20,
                                                 warmup=2)
                                         if lib_call else None), **bound)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        out[name] = row
    for k in ("gated_act_fwd", "gated_act_bwd"):
        out[k]["library"] = "none: no one PyTorch call computes act(a) * b"
    out["cross_entropy_fwd"]["library"] = (
        "torch.nn.functional.cross_entropy on the f32 upcast (cap 0; the "
        "upcast outside the timed call)")
    out["cross_entropy_bwd"]["library"] = ("autograd of torch.nn.functional"
                                           ".cross_entropy on the f32 upcast")
    out["cross_entropy_both"]["library"] = "both of those"
    # the loss's own memory: the peak of requested bytes over a forward and
    # a backward, above what was allocated before (the logits, labels)
    out["cross_entropy_both"]["peak_bytes"] = {}
    for which, fn in (("kernel", both_kernel), ("plain", both_plain),
                      ("library", both_library)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out["cross_entropy_both"]["peak_bytes"][which] = (
            torch.cuda.memory_stats()["requested_bytes.all.peak"] - base)
    ad, bd, _ = gl_gate_inputs(torch, GATE_CASES[1], gen)
    out["host_us"] = {
        "gated_act": {"kernel": host_us(torch, lambda: C.gated_act(
                          ad, bd, "swiglu")),
                      "plain": host_us(torch, lambda: gm.gated_act_plain(
                          ad, bd, "swiglu"))}}
    return out


def phase_gate_loss_kernel(torch, gm, ce) -> list:
    """The gate's and the loss's kernels against their plain versions on
    the card (``GATE_CASES``, ``LOSS_CASES``), forward and backward, the
    same bits over 3 calls, one device launch a kernel a call; then each
    timed at codeqwen's train shape (``gl_times``).  Returns the kernels
    line's four entries."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    t0 = time.monotonic()
    failed = []
    worst = dict.fromkeys(("gated_act_fwd", "gated_act_bwd",
                           "cross_entropy_fwd", "cross_entropy_bwd"), 0.0)
    bits = {"forward": True, "backward": True}
    ulps = {"forward": 0, "backward": 0}
    for case in GATE_CASES:
        row = gl_gate_check(torch, gm, case, gen)
        emit("kernel_check", kernel="gated_act", case=case[0], **row)
        worst["gated_act_fwd"] = max(worst["gated_act_fwd"],
                                     row["forward"]["max_abs_err"])
        worst["gated_act_bwd"] = max(worst["gated_act_bwd"],
                                     row["da"]["max_abs_err"],
                                     row["db"]["max_abs_err"])
        bits["forward"] = bits["forward"] and row["forward"]["same_bits"]
        bits["backward"] = (bits["backward"] and row["da"]["same_bits"]
                            and row["db"]["same_bits"])
        ulps["forward"] = max(ulps["forward"], row["forward"]["max_ulp"])
        ulps["backward"] = max(ulps["backward"], row["da"]["max_ulp"],
                               row["db"]["max_ulp"])
        if not row["ok"]:
            failed.append(f"gate {case[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    for case in LOSS_CASES:
        row = gl_loss_check(torch, ce, case, gen)
        emit("kernel_check", kernel="cross_entropy", case=case[0], **row)
        worst["cross_entropy_fwd"] = max(worst["cross_entropy_fwd"],
                                         abs(row["loss"]
                                             - row["plain_loss"]))
        worst["cross_entropy_bwd"] = max(worst["cross_entropy_bwd"],
                                         row["grad"]["max_abs_err"])
        if not row["ok"]:
            failed.append(f"loss {case[0]}")
        gc.collect()
        torch.cuda.empty_cache()
    times = gl_times(torch, gm, ce, gen)
    emit("gate_loss_times", shape=GL_SHAPE, times=times,
         gate_same_bits=bits, gate_max_ulp=ulps,
         seconds=time.monotonic() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        fail(f"gate / loss kernels differ from the plain versions: {failed}")
    entries = []
    for name in ("gated_act_fwd", "gated_act_bwd", "cross_entropy_fwd",
                 "cross_entropy_bwd"):
        t = times[name]
        gate = name.startswith("gated")
        entry = {
            "name": name, "route": "cuda",
            "kernel_route": "silu_bf16" if gate else "bf16",
            "kernel_routes": list(gm.ROUTES if gate else ce.ROUTES),
            "source": GL_SOURCE["gate" if gate else "loss"] + {
                "gated_act_fwd": " (gated_act_fwd_kernel)",
                "gated_act_bwd": " (gated_act_bwd_kernel)",
                "cross_entropy_fwd": " (cross_entropy_fwd_kernel, "
                                     "cross_entropy_sum_kernel)",
                "cross_entropy_bwd": " (cross_entropy_bwd_kernel)"}[name],
            "replaces": GL_REPLACES[name],
            "shape": GL_SHAPE["gate" if gate else "loss"],
            "max_abs_err": worst[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": t["library"]}
        if gate:
            entry.update(same_bits=bits, max_ulp=ulps)
        else:
            both = times["cross_entropy_both"]
            entry.update(both_ms=both["ms"], both_plain_ms=both["plain_ms"],
                         both_bound_ms=both["bound_ms"],
                         both_library_ms=both["library_ms"])
        entries.append(entry)
    return entries


def gate_calls(cfg, step: str = "forward") -> int:
    """The gated activations of one pass of ``cfg``: ``step`` "forward"
    (``forward_train``'s or a prefill's) or "decode" (one decode step):
    one a gated MLP call (each layer's MLP or MoE block; the hybrid's
    shared block a call; whisper's encoder in the forward too), none for
    a non-gated activation (gelu, relu2) or the SSM family."""
    from repro_torch.models import model as M
    if cfg.activation not in ("swiglu", "geglu") or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return M._shared_groups(cfg)
    if cfg.family == "encdec" and step == "forward":
        return cfg.num_layers + cfg.num_encoder_layers
    return cfg.num_layers


def expected_gate_serve(cfg, n_micro: int, decode_steps: int,
                        runs: Optional[dict] = None) -> dict:
    """The gate's and the loss's launches in a serve run, in all a kernel,
    on the host and on the device: the gate's forward as
    ``expected_norm_rope_serve`` counts the norm's (``runs``: a prefill
    one forward, a decode step one decode pass); no backward, no loss."""
    runs = runs or serve_runs(cfg, n_micro, decode_steps)
    fwd, dec = gate_calls(cfg, "forward"), gate_calls(cfg, "decode")
    out = {k: {"host": 0, "device": 0} for k in GL_KERNELS}
    out["gated_act_fwd"] = {w: runs["prefill"][w] * fwd
                            + runs["decode"][w] * dec
                            for w in ("host", "device")}
    return out


def gate_loss_step(gm, ce, cfg, passes: int, forwards: int,
                   backward: bool) -> dict:
    """The gate's and the loss's launches by kernel and route of
    ``passes`` ``forward_train`` passes of ``cfg`` (each with
    ``forwards`` forwards of the layers: 2 under remat; with
    ``backward``, one backward): the gate once a gated call a layer
    forward and once a backward, the loss's kernels once a pass."""
    dt = cfg.torch_dtype
    want = {k: dict.fromkeys(gm.ROUTES if k.startswith("gated")
                             else ce.ROUTES, 0) for k in GL_KERNELS}
    calls = gate_calls(cfg, "forward")
    if calls:
        r = gm.route(cfg.activation, dt)
        want["gated_act_fwd"][r] += passes * calls * forwards
        if backward:
            want["gated_act_bwd"][r] += passes * calls
    r = ce.route(dt)
    for k in ("cross_entropy_fwd", "cross_entropy_sum") + (
            ("cross_entropy_bwd",) if backward else ()):
        want[k][r] += passes
    return want


def expected_gate_loss_launches(gm, ce, phase: str) -> dict:
    """The gate's and the loss's launches a train, examples or dry-run
    phase must make, by kernel and route (``gate_loss_steps``: every step,
    the parent column's among them)."""
    want = {k: dict.fromkeys(gm.ROUTES if k.startswith("gated")
                             else ce.ROUTES, 0) for k in GL_KERNELS}
    for cfg, steps, micro, forwards, backward in gate_loss_steps(phase):
        for k, by in gate_loss_step(gm, ce, cfg, steps * micro, forwards,
                                    backward).items():
            for r, n in by.items():
                want[k][r] += n
    return want


GATE_LOSS_LAUNCHES: dict = {}    # phase or path -> host and device counts


def gate_loss_window(gm, ce):
    """Counts the gate's and the loss's launches from this call on, on
    the host (the wrappers' counts, set to 0 here; the loss's forward
    stands for its sum kernel too) and on the device.  The returned
    ``check(what, want)`` fails unless each kernel's launches in all equal
    ``want`` (``expected_gate_serve``'s host and device totals), or, with
    ``want`` by route (``expected_gate_loss_launches``), the device equals
    it by route, and the host too where no train step was captured in the
    window; it keeps the counts in ``GATE_LOSS_LAUNCHES[what]``."""
    fns = {"gated_act_fwd": gm.gated_act_fwd,
           "gated_act_bwd": gm.gated_act_bwd,
           "cross_entropy_fwd": ce.cross_entropy_fwd,
           "cross_entropy_bwd": ce.cross_entropy_bwd}
    _zero_counts(fns)
    libs = gm._lib(), ce._lib()

    def device_now():
        return {**gm.kernel_launches(libs[0]),
                **ce.kernel_launches(libs[1])}
    graphs_at = train_graph_counts()
    before = device_now()

    def check(what: str, want: dict) -> None:
        device = {k: {r: n - before[k][r] for r, n in by.items()}
                  for k, by in device_now().items()}
        host = {k: dict(fn.launches_by_route) for k, fn in fns.items()}
        host["cross_entropy_sum"] = dict(host["cross_entropy_fwd"])
        GATE_LOSS_LAUNCHES[what] = {"host": host, "device": device}
        emit("gate_loss_launches", what=what, host=host, device=device,
             expected=want)
        if all("host" in w for w in want.values()):
            got = {k: {"host": sum(host[k].values()),
                       "device": sum(device[k].values())} for k in want}
            # the host counts eager calls and captures, the device eager
            # calls and replays: both on the same routes
            bad = got != want or any(
                {r for r, n in host[k].items() if n}
                != {r for r, n in device[k].items() if n} for k in host)
        else:
            # a captured train step launches on the host and not on the
            # device, its replays the other way round: the host is held
            # only where no train step was captured
            captured = graph_delta(graphs_at)["captures"] > 0
            bad = device != want or (not captured and host != want)
        if bad:
            fail(f"{what}: gate / loss launches host {host}, device "
                 f"{device}, expected {want}")
    return check


PATHS = ("codeqwen15_7b", "mamba2_1_3b", "zamba2_2_7b",
         "granite_moe_3b_a800m", "whisper_large_v3", "gemma2_27b",
         "nemotron_4_15b", "chameleon_34b")
# the paths whose prefill is profiled again on the parent's route
# (``fused_ops_check``): every prologue and block kind once (codeqwen's
# biases, granite's experts, mamba2's gate, zamba2's shared block beside
# its gate); the other dense paths repeat codeqwen's blocks
FUSED_OPS_PATHS = ("codeqwen15_7b", "mamba2_1_3b", "zamba2_2_7b",
                   "granite_moe_3b_a800m")


def expected_launches(torch, cfg, n_micro: int, fa, ss, da=None,
                      decode_steps: int = 0, runs: Optional[dict] = None,
                      where: str = "host") -> dict:
    """Kernel launches one serve run must make, by kernel and route: flash
    once per attention layer (or per call of the hybrid's shared block, or
    per whisper encoder layer) a prefill, SSD once per Mamba2 layer a
    prefill, counted ``where`` (the host: the wrappers' eager calls and
    captures; the device: eager calls and replays) as ``runs`` runs the
    prefills (``serve_runs``; default the parent's route: each of the
    ``n_micro`` prefills eager).  The route follows the inputs'
    dtype (the model's, except in whisper's encoder, where the serve's f32
    frames promote the activations to f32, as JAX does) and, for flash,
    the head dim, for the SSD scan its head dim P and state size N.  With
    ``da``, the decode kernel's launches (``expected_decode_launches``),
    on the model dtype's route."""
    runs = runs or serve_runs(cfg, n_micro, decode_steps)
    n_micro = runs["prefill"][where]
    dt, hd = cfg.torch_dtype, cfg.resolved_head_dim
    want = {"flash_attention_bhsd": dict.fromkeys(fa.ROUTES, 0),
            "ssd_scan_bhsd": dict.fromkeys(ss.ROUTES, 0)}
    if da is not None:
        want["decode_attention"] = dict.fromkeys(da.ROUTES, 0)
        want["decode_attention"][decode_route(torch, cfg, da)] = \
            expected_decode_launches(cfg, 0, decode_steps, runs)[where]
    flash = want["flash_attention_bhsd"]
    if cfg.family in ("ssm", "hybrid"):
        want["ssd_scan_bhsd"][ss.route(dt, cfg.ssm_headdim,
                                       cfg.ssm_state)] += (cfg.num_layers
                                                           * n_micro)
    if cfg.family == "hybrid":
        flash[fa.route(dt, hd)] += (cfg.num_layers
                                    // cfg.shared_attn_period * n_micro)
    elif cfg.family != "ssm":
        flash[fa.route(dt, hd)] += cfg.num_layers * n_micro
    if cfg.family == "encdec":
        enc_dt = torch.promote_types(torch.float32, dt)
        flash[fa.route(enc_dt, hd)] += cfg.num_encoder_layers * n_micro
    return want


def phase_serve(torch, arch, mods):
    """One serve path.  ``mods`` maps a kernel's name to its module, whose
    wrapper of that name holds the launch counts.  Returns the launches of
    each kernel, in all and by route, over the full-width serve run, for
    ``DRYRUN_PREFILL`` the plain-route prefill's FLOPs and times
    (``prefill_on_card``; else None), and for ``MODES_PATH`` the engine
    modes' launches (``phase_serve_modes``; else None)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels import gated_mlp as gm
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import norm_rope as nr
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import model as M

    # small reference: the smoke config on the card (kernel route, f32)
    # gives exactly the CPU's greedy tokens (plain route) on equal weights;
    # ssm_chunk=8 makes the SSD scan cross chunks in a 24-token prompt, and
    # a local window's prompt runs 16 tokens past it
    smoke = get_smoke_config(arch)
    if smoke.family in ("ssm", "hybrid"):
        smoke = dataclasses.replace(smoke, ssm_chunk=8)
    cpu_params = M.init_params(smoke, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    small = dict(num_requests=4, microbatch=2,
                 prompt_len=smoke.local_window + 16 if smoke.local_window
                 else 24, decode_steps=6)
    ref = run_serving(smoke, device="cpu", params=cpu_params, **small)
    _zero_graph_counts()
    got = run_serving(smoke, device="cuda", params=gpu_params, **small)
    graphs = _graph_counts()
    same = bool((ref["responses"] == got["responses"]).all())
    emit("serve_reference", config=smoke.name, **small,
         local_window=smoke.local_window, tokens_equal=same,
         slots=got["slots"], graphs=graphs)
    if not same:
        fail(f"{smoke.name} served on the card differs from the CPU")
    check_graphs(smoke.name, graphs, slot_runs(smoke, small, got))

    cfg = get_config(arch)
    shape = serve_shape(arch)
    t0 = time.monotonic()
    params = M.init_params(cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    emit("init", config=cfg.name, family=cfg.family, layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, seconds=init_s,
         bytes=sum(t.numel() * t.element_size() for t in _leaves(params)))

    steps = phase_steps(torch, cfg, params, shape,
                        mods["flash_attention_bhsd"], mods["ssd_scan_bhsd"],
                        mods["decode_attention"],
                        fused_ops=arch in FUSED_OPS_PATHS)
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    phase_decode_graph(torch, cfg, params, shape, kernels,
                       mods["decode_attention"])
    card = (prefill_on_card(torch, cfg, params, steps)
            if arch == DRYRUN_PREFILL else None)

    phase_prefill_graph(torch, cfg, params, shape)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    _zero_graph_counts()
    window = serve_window(torch, mods)
    norm_rope_check = norm_rope_window(nr)
    moe_check = moe_window(md, moe_serve_routes(md, cfg))
    gate_loss_check = gate_loss_window(gm, ce)
    res = run_serving(cfg, device="cuda", params=params, **shape)
    runs = slot_runs(cfg, shape, res)
    n_micro = shape["num_requests"] // shape["microbatch"]
    norm_rope_check(arch, expected_norm_rope_serve(
        cfg, n_micro, shape["decode_steps"], runs, nr))
    gate_loss_check(arch, expected_gate_serve(
        cfg, n_micro, shape["decode_steps"], runs))
    moe_check(arch, expected_moe_serve(cfg, n_micro, shape["decode_steps"],
                                       runs))
    graphs = _graph_counts()
    resp = res["responses"]
    row = window(cfg, runs, cfg.name)
    emit("serve", config=cfg.name, layers=cfg.num_layers, **shape,
         local_window=cfg.local_window, responses_shape=list(resp.shape),
         wall_s=res["wall_s"], gen_tokens_per_s=res["gen_tokens_per_s"],
         prefill_s=res["prefill_s"], decode_s=res["decode_s"],
         app_ms=res["app_ms"], slots=res["slots"], graphs=graphs,
         expected_graphs=runs["graphs"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         max_memory_reserved=torch.cuda.max_memory_reserved(), **row)
    if tuple(resp.shape) != (shape["num_requests"], shape["decode_steps"]):
        fail(f"responses shape {resp.shape}")
    check_graphs(cfg.name, graphs, runs)
    if resp.min() < 0 or resp.max() >= cfg.vocab_size:
        fail("token ids outside the vocabulary")
    modes = (phase_serve_modes(torch, cfg, params, resp, mods)
             if arch == MODES_PATH else None)
    del res
    gc.collect()                # the engine's drops hold the KV caches
    torch.cuda.empty_cache()
    serve_steady(torch, arch, cfg, params, shape, resp)
    check_full_width_logits(torch, M, cfg, params, shape,
                            LOGITS_ROWS.get(arch, shape["microbatch"]))
    return row, card, modes


PREFILL_TURNS = ("eager", "graph", "graph", "eager")
STEADY = dict(sessions=3, max_concurrent=1)
# gemma2's 2 x 8192-token prefills take 1.4 s each: 2 sessions there
STEADY_BY_PATH = {"gemma2_27b": dict(sessions=2, max_concurrent=1)}
STEADY_TURNS = ("slots", "parent")


def same_tree_bits(torch, a: dict, b: dict) -> dict:
    """Whether two cache trees hold the same tensors to the bit: the names
    of the leaves that differ (dtype, shape or any bit)."""
    def flat(t, pre=""):
        for k, v in sorted(t.items()):
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", v
    fa_, fb = dict(flat(a)), dict(flat(b))
    bad = sorted(k for k in fa_.keys() | fb.keys()
                 if k not in fa_ or k not in fb
                 or fa_[k].dtype != fb[k].dtype
                 or fa_[k].shape != fb[k].shape
                 or not same_bits(torch, fa_[k], fb[k]))
    return {"leaves": len(fa_), "differ": bad}


def phase_prefill_graph(torch, cfg, params, shape: dict) -> dict:
    """The path's prefill through its CUDA graph (``PrefillGraph``) on a
    serve slot's cache, against the eager prefill into a fresh cache (the
    parent's): the slot first serves another prompt (its eager prefill and
    the capture) and a microbatch's ``decode_steps - 1`` decode steps,
    which leave its KV rows past the prompt, its conv window and its f32
    state written; then the replay of this prompt must give the eager
    prefill's next token and every cache tensor to the bit (rows it does
    not write zeroed).  Printed: the prefill's host ms eager (into the
    slot's cache, ``graph=False``) and replayed, in turns
    (``PREFILL_TURNS``, one call after a warm one a turn), each one's
    device busy ms and idle share from one profiled call and the replay's
    device span, the capture's ms, and the peaks of allocated, requested
    and reserved bytes."""
    import numpy as np

    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import model as M
    from repro_torch.train import make_decode_step, make_prefill_step
    mb, s, steps = (shape["microbatch"], shape["prompt_len"],
                    shape["decode_steps"])
    max_seq = s + steps

    def batch_of(seed: int) -> dict:
        return prompt_batch(cfg, torch.from_numpy(
            np.random.default_rng(seed).integers(
                0, cfg.vocab_size, size=(mb, s)).astype(np.int32)).cuda())

    batch, other = batch_of(5), batch_of(6)
    eager = make_prefill_step(cfg, graph=False)
    out = dict(config=cfg.name, microbatch=mb, prompt_len=s, max_seq=max_seq)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = M.init_cache(cfg, mb, max_seq, device="cuda")
    want_tok, want = eager(params, batch, max_seq)
    step, decode = make_prefill_step(cfg, graph=True), make_decode_step(cfg)
    tok, _ = step(params, other, cache=cache)
    t, c = tok[:, None], cache
    for i in range(steps - 1):
        t, c = decode(params, c, t, s + i)
    decode.close()
    del t, c, decode
    got_tok, _ = step(params, batch, cache=cache)
    torch.cuda.synchronize()
    bits = same_tree_bits(torch, cache, want)
    out.update(next_token_equal=bool(torch.equal(got_tok, want_tok)),
               cache_bits=bits, capture_ms=step.graph.capture_ms)
    del want, want_tok
    if not out["next_token_equal"] or bits["differ"]:
        emit("prefill_graph", **out)
        fail(f"{cfg.name}: the replayed prefill differs from the eager "
             f"one: next token equal {out['next_token_equal']}, cache "
             f"leaves {bits['differ']}")
    columns = {"eager": lambda: eager(params, batch, cache=cache),
               "graph": lambda: step(params, batch, cache=cache)}
    times = {w: [] for w in columns}
    for which in PREFILL_TURNS:
        times[which].append(step_ms(torch, columns[which], 1)[0])
    for which, fn in columns.items():
        out[f"{which}_ms"] = sum(times[which]) / len(times[which])
        out[f"{which}_ms_turns"] = times[which]
        prof = profile_call(torch, fn,
                            f"profile_{cfg.name}_prefill_{which}.txt")
        out[f"{which}_profile"] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share", "top")}
    out["graph_device_span_ms"] = device_span_ms(torch, columns["graph"])
    step.close()
    out.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
               max_memory_reserved=torch.cuda.max_memory_reserved(),
               requested_peak=torch.cuda.memory_stats().get(
                   "requested_bytes.all.peak"))
    emit("prefill_graph", **out)
    del cache, columns
    gc.collect()
    torch.cuda.empty_cache()
    return out


class ParentDecodeStep:
    """The parent's decode step of one microbatch: its first step on the
    cache eager (a bf16 SSM state promoted in the cache), then one capture,
    then replays (``DecodeGraph`` on the cache), freed when it ends."""

    def __init__(self, cfg):
        self.cfg, self.graph = cfg, None

    def __call__(self, params, cache, tokens, pos):
        import torch

        from repro_torch.train.steps import DecodeGraph
        with torch.inference_mode():
            if self.graph is None:
                self.graph = DecodeGraph(self.cfg, params, cache, tokens,
                                         pos, True)
                return self.graph.first, cache
            return self.graph.replay(tokens, pos), cache

    def close(self) -> None:
        if self.graph is not None:
            self.graph.release()
        self.graph = None


def parent_route(torch, cfg, params, shape: dict, n: int) -> dict:
    """The parent's route, driven directly, without the engine: ``n``
    sessions of ``run_serving``'s prompts one after another, each
    microbatch's prefill eager into a new cache and its decode steps
    through a decode graph of its own (``ParentDecodeStep``), both freed
    when its steps end; each app ended by a synchronise, as
    ``run_serving`` times its apps.  One microbatch runs at a time, so
    its apps overlap no other's.  Returns the wall, tokens a second, each
    app's ms in order, the caches made and the last session's tokens."""
    import numpy as np

    from repro_torch.launch.serve import prompt_batch
    from repro_torch.train import make_prefill_step
    mb, s, steps = (shape["microbatch"], shape["prompt_len"],
                    shape["decode_steps"])
    reqs = shape["num_requests"]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(reqs, s)).astype(np.int32)
    prefill = make_prefill_step(cfg, graph=False)
    out = {"app_ms": {"prefill": [], "decode": []}, "slots": 0}
    t_start = time.monotonic()
    for _ in range(n):
        rows = []
        for i in range(0, reqs, mb):
            t0 = time.monotonic()
            batch = prompt_batch(cfg, torch.from_numpy(
                prompts[i:i + mb]).cuda())
            tok, cache = prefill(params, batch, s + steps)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            decode, toks = ParentDecodeStep(cfg), [tok[:, None]]
            try:
                for j in range(steps - 1):
                    t, cache = decode(params, cache, toks[-1], s + j)
                    toks.append(t)
                rows.append(torch.cat(toks, dim=1).cpu().numpy())
            finally:
                decode.close()
            out["app_ms"]["prefill"].append((t1 - t0) * 1e3)
            out["app_ms"]["decode"].append((time.monotonic() - t1) * 1e3)
            out["slots"] += 1
            del batch, cache, toks
    out["wall_s"] = time.monotonic() - t_start
    out["gen_tokens_per_s"] = n * reqs * steps / out["wall_s"]
    out["responses"] = np.concatenate(rows)
    return out


def serve_steady(torch, arch: str, cfg, params, shape: dict,
                 tokens) -> dict:
    """The path served in steady state: ``STEADY``'s sessions (or
    ``STEADY_BY_PATH``'s) one after another, through a resident manager on
    the slots (the first session's microbatches capture the slots' graphs,
    the later ones replay them) and on the parent's route
    (``parent_route``), in turns (``STEADY_TURNS``).  Each run's tokens
    must equal the serve run's (``tokens``), the slots' graphs the slots'
    (``check_graphs``).  Printed a run: wall, tokens a second, each
    prefill and decode app's ms in the order they ended, captures and
    replays, the slots (the parent's: the caches it made), the peaks of
    allocated, requested and reserved bytes."""
    from repro_torch.launch.serve import run_serving
    runs_by = {"slots": [], "parent": []}
    steady = STEADY_BY_PATH.get(arch, STEADY)
    n = steady["sessions"]
    for which in STEADY_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_graph_counts()
        if which == "parent":
            res = parent_route(torch, cfg, params, shape, n)
        else:
            res = run_serving(cfg, device="cuda", params=params, **shape,
                              **steady)
        graphs = _graph_counts()
        row = dict(route=which, wall_s=res["wall_s"],
                   gen_tokens_per_s=res["gen_tokens_per_s"],
                   app_ms=res["app_ms"], slots=res["slots"], graphs=graphs,
                   tokens_equal=bool((res["responses"] == tokens).all()),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   max_memory_reserved=torch.cuda.max_memory_reserved(),
                   requested_peak=torch.cuda.memory_stats().get(
                       "requested_bytes.all.peak"))
        runs_by[which].append(row)
        if not row["tokens_equal"]:
            emit("serve_steady", config=cfg.name, **shape, **steady,
                 runs=runs_by)
            fail(f"{cfg.name}: the {which} route's steady-state tokens "
                 "differ from the serve run's")
        if which == "slots":
            check_graphs(f"{cfg.name} steady", graphs,
                         slot_runs(cfg, shape, res, n))
    n_micro = shape["num_requests"] // shape["microbatch"]

    def later(rows, kind):
        # the apps of the sessions after the first: steady state
        return [ms for r in rows for ms in r["app_ms"][kind][n_micro:]]

    summary = {w: {"wall_s": sum(r["wall_s"] for r in rows) / len(rows),
                   "gen_tokens_per_s": sum(r["gen_tokens_per_s"]
                                           for r in rows) / len(rows),
                   "steady_prefill_ms": statistics.median(
                       later(rows, "prefill")),
                   "steady_decode_ms": statistics.median(
                       later(rows, "decode"))}
               for w, rows in runs_by.items()}
    emit("serve_steady", config=cfg.name, **shape, **steady,
         summary=summary, runs=runs_by)
    return summary


def serve_window(torch, mods):
    """Counts the flash, SSD and decode kernels' launches from this call on:
    on the host (the wrappers' counts, set to 0 here) and on the device
    (each library's counters).  The returned ``check(cfg, runs, name)``
    fails unless the wrappers counted by route what ``expected_launches``
    counts on the host for ``cfg``'s ``runs`` (``serve_runs``: eager calls
    and captures) and the libraries what it counts on the device (eager
    calls and replays: flash by route, the SSD scan by device kernel,
    decode on its route; ``route_faults``), and returns the counts read:
    the launches by kernel and route on the device, which are the path's
    executed calls (the SSD scan's by route from its kernels,
    ``ssd_routes``), and the host's beside them."""
    fa, ss = mods["flash_attention_bhsd"], mods["ssd_scan_bhsd"]
    da = mods["decode_attention"]
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    _zero_counts(kernels)
    before = {n: m.kernel_launches(m._lib()) for n, m in mods.items()}

    def check(cfg, runs: dict, name: str) -> dict:
        launches, by_route = _read_counts(kernels)
        after = {n: m.kernel_launches(m._lib()) for n, m in mods.items()}
        device = {n: {r: c - before[n][r] for r, c in by.items()}
                  for n, by in after.items()}
        want = {w: expected_launches(torch, cfg, 0, fa, ss, da, 0, runs, w)
                for w in ("host", "device")}
        faults = []
        if by_route != want["host"]:
            faults.append(f"the wrappers counted {by_route}, expected "
                          f"{want['host']}")
        for n, expect in (("flash_attention_bhsd",
                           want["device"]["flash_attention_bhsd"]),
                          ("ssd_scan_bhsd", ss.route_kernels(
                              want["device"]["ssd_scan_bhsd"])),
                          ("decode_attention",
                           want["device"]["decode_attention"])):
            got = {r: c for r, c in device[n].items() if c}
            faults += [f"{n}: {f}" for f in route_faults(
                {r: c for r, c in expect.items() if c}, got, {})]
        if faults:
            fail(f"{name}: " + "; ".join(faults))
        read = {**device,
                "ssd_scan_bhsd": ssd_routes(ss, device["ssd_scan_bhsd"])}
        return {"launches": {n: sum(by.values()) for n, by in read.items()},
                "launches_by_route": read,
                "host_launches": launches, "host_launches_by_route": by_route,
                "device_launches": device}
    return check


def ssd_routes(ss, by_kernel: dict) -> dict:
    """The SSD scan's calls by route from its device kernels' launches
    (``ss.kernel_launches``): a call launches each of its route's kernels
    once, so a route's calls are its first kernel's launches."""
    return {r: by_kernel[ks[0]] for r, ks in ss.ROUTE_KERNELS.items()}


MODES_PATH = "codeqwen15_7b"
SERVE_STATS = PROFILE_DIR / "serve_stats.json"


def phase_serve_modes(torch, cfg, params, tokens, mods) -> dict:
    """The serve driver's other engine modes on ``MODES_PATH`` at full
    width, with the weights and the requests of its serve run: (1) the
    compiled substrate, (2) streaming token delivery (the chunk lane from
    ``gen`` to ``assemble``), (3) 3 sessions through a resident
    ``EngineManager``, 2 at a time in threads that share the card (the
    sessions' microbatches take the slots the earlier ones gave back), (4)
    one session with ``stats_json``.  Each run's tokens must equal the
    object substrate's (``tokens``); each kernel must launch as often as
    the run's slots imply (``serve_window``), counted from 0 just before
    the run, and each slot capture its graphs once (``check_graphs``); the
    sessions run must hit the template cache twice; the stats run must
    write its spans and wall beside the metrics snapshot.  Returns each
    mode's launches by kernel (``serve_window``'s row)."""
    import numpy as np

    from repro_torch.launch.serve import run_serving
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    SERVE_STATS.unlink(missing_ok=True)
    modes = (("compiled", dict(execution="compiled")),
             ("streaming", dict(streaming=True)),
             ("sessions", dict(sessions=3, max_concurrent=2)),
             ("stats_json", dict(stats_json=str(SERVE_STATS))))
    out = {}
    for mode, kw in modes:
        sessions = kw.get("sessions", 1)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        _zero_graph_counts()
        window = serve_window(torch, mods)
        res = run_serving(cfg, device="cuda", params=params, **SERVE, **kw)
        runs = slot_runs(cfg, SERVE, res, sessions)
        graphs = _graph_counts()
        same = bool(np.array_equal(res["responses"], tokens))
        launches = window(cfg, runs, f"{cfg.name} {mode}")
        row = dict(mode=mode, config=cfg.name, options=kw, **SERVE,
                   wall_s=res["wall_s"],
                   gen_tokens_per_s=res["gen_tokens_per_s"],
                   prefill_s=res["prefill_s"], decode_s=res["decode_s"],
                   app_ms=res["app_ms"], slots=res["slots"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   tokens_equal=same, graphs=graphs,
                   expected_graphs=runs["graphs"], **launches)
        if sessions > 1:
            row.update({k: res[k] for k in (
                "sessions", "sessions_per_s", "p50_session_s",
                "p99_session_s", "template_hits")})
        if mode == "stats_json":
            dump = json.loads(SERVE_STATS.read_text())
            row["stats_keys"] = sorted(dump)
            row["stats_spans"] = dump.get("spans")
            if dump.get("wall_s") != res["wall_s"] or "metrics" not in dump \
                    or "execute" not in {sp["name"] for sp in
                                         dump.get("spans", [])}:
                fail(f"serve stats {SERVE_STATS}: {dump}")
        emit("serve_mode", **row)
        if not same:
            fail(f"{cfg.name} {mode}: tokens differ from the object "
                 f"substrate's")
        if sessions > 1 and res["template_hits"] != sessions - 1:
            fail(f"{cfg.name} {mode}: {res['template_hits']} template hits")
        check_graphs(f"{cfg.name} {mode}", graphs, runs)
        out[mode] = launches
    return out


def prefill_on_card(torch, cfg, params, steps: dict) -> dict:
    """One serve microbatch's prefill on the plain route (torch ops, the
    dry-run's route): its FLOPs under ``FlopCounterMode``, once, and its
    time, warm, median of 3, beside the kernel route's and the bound from
    ``phase_steps``."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.serve import prompt_batch
    from repro_torch.train import make_prefill_step
    mb, s = SERVE["microbatch"], SERVE["prompt_len"]
    plain = make_prefill_step(cfg, use_kernel=False, graph=False)
    batch = prompt_batch(cfg, torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size,
                                          size=(mb, s))).cuda())
    plain(params, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.monotonic()
        plain(params, batch)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    with FlopCounterMode(display=False) as flops:
        plain(params, batch)
    torch.cuda.synchronize()
    return {"flops": flops.get_total_flops(), "batch": mb, "seq": s,
            "plain_prefill_ms": sorted(times)[1],
            "kernel_prefill_ms": steps["prefill_ms"],
            "prefill_bound_ms": steps["prefill_bound_ms"]}


def check_full_width_logits(torch, M, cfg, params, shape: dict, rows: int):
    """Full-width prefill logits through the kernels vs the plain torch
    route, on the seeded weights (whisper with the serve's zero frames),
    for ``rows`` prompts of the path's length; the check's peak memory is
    printed.

    The dense paths are held to 5% of the plain route's logit range and
    to its top-1 token on every row whose top two it does not tie.

    bf16: both routes round activations to bf16 (2^-8 relative) at other
    points (the SSD kernel route rounds y before adding D x, the torch route
    rounds the carried states), and the residual layers carry the
    difference.  Over 32 dense layers that stays within 5% of the logit
    range, which the dense path is held to.  Over the 48 and 54 Mamba2
    layers of these random-weight models any two bf16 routes drift apart
    by 16-40% of the range (the plain route alone drifts that far from its
    own f32 run), so the ssm and hybrid paths are held instead to: the same
    weights in f32, kernel route vs plain route, within 1e-3 of the range
    (another order of f32 sums); and the bf16 kernel route no further from
    the f32 logits than twice the bf16 plain route is.  The moe path is
    held the same way: its routing is discontinuous, and a bf16 rounding
    difference that swaps a token's k-th and (k+1)-th expert, or which
    token an expert drops at capacity, moves logits by more than 5%."""
    import dataclasses

    import numpy as np
    from repro_torch.launch.serve import prompt_batch
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(rows, shape["prompt_len"]))).cuda()
    batch = prompt_batch(cfg, tokens)
    torch.cuda.reset_peak_memory_stats()

    def logits(p, c, use_kernel):
        with torch.inference_mode():
            return M.prefill(p, c, batch, use_kernel=use_kernel)[0]

    lk, lp = logits(params, cfg, True), logits(params, cfg, False)
    rule = top1_rule(torch, cfg, lk, lp)
    finite = rule.pop("finite")
    dense_ok = rule.pop("ok")
    out = dict(config=cfg.name, rows=rows, prompt_len=shape["prompt_len"],
               finite=finite, **rule)
    if cfg.family not in ("ssm", "hybrid", "moe"):
        emit("prefill_kernel_vs_plain", **out,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        if not finite:
            fail(f"{cfg.name}: non-finite logits at full width")
        if not dense_ok:
            fail(f"{cfg.name}: kernel-route logits differ from the plain "
                 f"route by {out['max_abs_diff']} (top-1 agreement "
                 f"{out['top1_agreement']}, {out['tied_rows']} rows tied)")
        return
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(params, lambda t: t.float())
    lk32, lp32 = logits(p32, cfg32, True), logits(p32, cfg32, False)
    del p32
    diff32 = float((lk32 - lp32).abs().max())
    scale32 = float(lp32.abs().max())
    bf16_kernel_err = float((lk - lp32).abs().max())
    bf16_plain_err = float((lp - lp32).abs().max())
    emit("prefill_kernel_vs_plain", **out, f32_max_abs_diff=diff32,
         f32_max_abs_logit=scale32,
         f32_top1_agreement=float(
             (lk32.argmax(-1) == lp32.argmax(-1)).float().mean()),
         bf16_kernel_vs_f32=bf16_kernel_err,
         bf16_plain_vs_f32=bf16_plain_err)
    if not (finite and bool(torch.isfinite(lk32).all())):
        fail(f"{cfg.name}: non-finite logits at full width")
    if diff32 > 1e-3 * scale32:
        fail(f"{cfg.name}: f32 kernel-route logits differ from the plain "
             f"route by {diff32}")
    if bf16_kernel_err > 2 * bf16_plain_err:
        fail(f"{cfg.name}: bf16 kernel route is {bf16_kernel_err} from the "
             f"f32 logits, the plain route {bf16_plain_err}")


def step_bounds(cfg, params, mb: int, s: int, max_seq: int) -> dict:
    """The least time of the two serve steps on the card, from the work
    they must do (a microbatch of ``mb`` prompts of ``s`` tokens, the cache
    allocated at ``max_seq``).

    Prefill, operations: 2 x the parameters each token passes through x
    the tokens, plus QK^T and PV over the visible pairs, plus the head for
    the last position only, at the bf16 peak; work whose inputs are f32 at
    the f32 peak, the two times summed (the decoder waits for the encoder).
    - dense, vlm: every layer parameter; causal pairs.
    - moe: the non-expert parameters (the f32 router included) plus
      top_k / E of the expert parameters; causal pairs.
    - ssm, hybrid: every layer parameter, the SSD scan's FLOPs per Mamba2
      layer, the hybrid's shared block (parameters and causal pairs) at
      each call.
    - encdec: f32 (the serve's f32 frames promote them): the encoder's
      parameters over the frames with non-causal pairs, the cross K/V
      projections over the frames, the tokens x frames cross pairs; bf16:
      the rest of the decoder's parameters over the tokens, causal pairs.
    A local layer's pairs are those its window leaves visible.
    Decode, bytes: the weights the step reads once (moe: the non-expert
    weights plus min(E, B x top_k) experts a layer; encdec: not the
    encoder's), the KV cache up to the new position (a local layer: its
    window of it), the whole cross cache
    (the reference attends over its zero rows too), the f32 SSM state read
    and written."""
    def numel(tree):
        return sum(t.numel() for t in _leaves(tree))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    from repro_torch.models.model import layer_windows
    L, hd = cfg.num_layers, cfg.resolved_head_dim
    es = params["embed"].element_size()
    layer_params = numel(params["layers"])
    attn = 4 * mb * cfg.num_heads * hd * visible_pairs(s, s, True, 0)
    kv_bytes = 2 * mb * (s + 1) * cfg.num_kv_heads * hd * es
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        # a local layer's queries see their window, its decode reads it
        windows = layer_windows(cfg)
        pairs = {w: visible_pairs(s, s, True, w) for w in set(windows)}
        attn_all = sum(4 * mb * cfg.num_heads * hd * pairs[w]
                       for w in windows)
        kv_all = sum(2 * mb * min(s + 1, w or s + 1) * cfg.num_kv_heads
                     * hd * es for w in windows)
    bf16 = 2 * mb * cfg.d_model * cfg.padded_vocab
    f32 = 0
    decode_bytes = nbytes(params)
    if cfg.family == "moe":
        experts = {k: v for k, v in params["layers"]["moe"].items()
                   if k != "router"}
        e, k = cfg.num_experts, cfg.top_k
        layer_params += numel(experts) * (k / e - 1)
        decode_bytes -= nbytes(experts) * (1 - min(e, mb * k) / e)
    if cfg.family == "encdec":
        t = max(s // cfg.encoder_ratio, 1)
        cross_kv = numel({n: params["layers"]["cross"][n]
                          for n in ("wk", "wv", "bk", "bv")})
        f32 += (2 * numel(params["enc_layers"]) * mb * t
                + cfg.num_encoder_layers * 4 * mb * cfg.num_heads * hd
                * visible_pairs(t, t, False, 0)
                + 2 * cross_kv * mb * t
                + L * 4 * mb * cfg.num_heads * hd * s * t)
        layer_params -= cross_kv
        decode_bytes -= nbytes({n: params[n]
                                for n in ("enc_layers", "enc_norm")})
        decode_bytes += (L * 2 * mb * max(max_seq // cfg.encoder_ratio, 1)
                         * cfg.num_kv_heads * hd * es)
    bf16 += 2 * layer_params * mb * s
    if cfg.family not in ("ssm", "hybrid"):
        bf16 += attn_all
        decode_bytes += kv_all
    else:
        h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        q = min(cfg.ssm_chunk, s)
        bf16 += L * mb * h * (s // q) * (q * (q + 1) * (n + p)
                                         + 4 * q * n * p)
        decode_bytes += 2 * L * mb * h * n * p * 4
    if cfg.family == "hybrid":
        groups = L // cfg.shared_attn_period
        bf16 += groups * (2 * numel(params["shared"]) * mb * s + attn)
        decode_bytes += groups * kv_bytes
    prefill_ms = (bf16 / H100_PEAK_FLOPS["torch.bfloat16"]
                  + f32 / H100_PEAK_FLOPS["torch.float32"]) * 1e3
    return {"prefill_bound_ms": prefill_ms,
            "decode_bound_ms": decode_bytes / H100_BYTES_PER_S * 1e3,
            "prefill_bf16_flops": bf16, "prefill_f32_flops": f32,
            "decode_bytes": decode_bytes}


def step_ms(torch, fn, n: int) -> tuple:
    """(median, all) host ms of ``n`` calls of ``fn``, each ended by a
    device synchronise, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def device_span_ms(torch, fn) -> float:
    """Device ms from an event recorded before one call of ``fn`` to one
    recorded after it, on the current stream: a CUDA graph's replay is
    its kernels back to back, so this is its device time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_steps(torch, cfg, params, shape: dict, fa, ss, da, *,
                fused_ops: bool = False):
    """The serve path's prefill and decode steps alone, without the engine
    (the prefill eager, ``graph=False``, so that its profile holds the
    wrappers' counts; its graph is ``phase_prefill_graph``'s; decode
    through its CUDA graph, the default on CUDA, on the cache its first
    step returns, taken before the timing: the warm call captures it, the
    timed ones replay it):
    warm, each call on the host clock ended by a device synchronise; then a
    torch.profiler trace of one call of each (summary printed, full tables
    written under ``chiprun_out/chip_smoke/``), in which the flash wrapper's
    launches by route (module ``fa``) and the SSD wrapper's (``ss``, as
    device kernels) must be those their libraries made and no fewer than
    the profile's kernels (``route_faults``); the profiled decode step (a
    replay) must launch the decode kernel once per attention call, as
    counted on the device (``da.kernel_launches``), and a profile may show
    no more.  ``fused_ops``: the prefill profiled again on the parent's
    route (``fused_ops_check``)."""
    import numpy as np
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.train import make_decode_step, make_prefill_step
    mb, s, steps = (shape["microbatch"], shape["prompt_len"],
                    shape["decode_steps"])
    prefill_step = make_prefill_step(cfg, graph=False)
    decode_one = make_decode_step(cfg)
    batch = prompt_batch(cfg, torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size,
                                          size=(mb, s))).cuda())
    first, cache = prefill_step(params, batch, s + steps)
    tok = first[:, None]
    # the steady step: a bf16 SSM cache's first step (a graph of its own)
    # returns the cache with the later steps' f32 state
    _, cache = decode_one(params, cache, tok, s)

    def prefill():
        prefill_step(params, batch, s + steps)

    def decode():
        decode_one(params, cache, tok, s)

    out = {}
    for name, fn, n in (("prefill", prefill, 3), ("decode_step", decode, 8)):
        out[name + "_ms"], out[name + "_ms_all"] = step_ms(torch, fn, n)
    out.update(step_bounds(cfg, params, mb, s, s + steps))
    emit("steps", config=cfg.name, microbatch=mb, prompt_len=s, **out)
    flash, lib = fa.flash_attention_bhsd, fa._lib()
    ssd, ssd_lib = ss.ssd_scan_bhsd, ss._lib()
    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        _zero_counts({"flash": flash, "ssd": ssd})
        before = fa.kernel_launches(lib)
        ssd_before = ss.kernel_launches(ssd_lib)
        decode_before = da.kernel_launches(da._lib())
        moe_prefill = cfg.family == "moe" and name == "prefill"
        prof = profile_call(torch, fn, f"profile_{cfg.name}_{name}.txt",
                            copies=moe_prefill)
        if name == "prefill":
            prefill_prof = prof
        launched = launch_delta(fa, lib, before)
        ssd_launched = launch_delta(ss, ssd_lib, ssd_before)
        decode_launched = decode_device_delta(
            da, decode_before, decode_route(torch, cfg, da))
        want_decode = decode_attention_calls(cfg) if name == "decode_step" \
            else 0
        counted = {r: n for r, n in flash.launches_by_route.items() if n}
        ssd_counted = {r: n for r, n in ssd.launches_by_route.items() if n}
        emit("profile", config=cfg.name, step=name,
             flash_launches_by_route=counted,
             flash_library_launches_by_route=launched,
             ssd_launches_by_route=ssd_counted,
             ssd_library_launches_by_kernel=ssd_launched,
             decode_device_launches=decode_launched, **prof)
        faults = route_faults(counted, launched, prof["flash_routes_seen"])
        faults += route_faults(ss.route_kernels(ssd_counted), ssd_launched,
                               prof["ssd_kernels_seen"])
        if decode_launched != want_decode or \
                prof["decode_kernels_seen"] > want_decode:
            faults.append(f"the device counted {decode_launched} decode "
                          f"launches, the profile shows "
                          f"{prof['decode_kernels_seen']}, expected "
                          f"{want_decode}")
        if cfg.family == "moe" and name == "prefill":
            left = {k: v for k, v in prof["ops"].items()
                    if k in MOE_PLAIN_OPS}
            if left:
                faults.append(f"the MoE's plain ops ran: {left}")
        if faults:
            fail(f"{cfg.name} {name}: the flash wrapper counted {counted}, "
                 f"the SSD wrapper {ssd_counted}; " + "; ".join(faults))
    decode_one.close()
    if fused_ops:
        out["fused_ops"] = fused_ops_check(torch, cfg, prefill, prefill_prof)
    if cfg.family == "moe":
        out["moe_parent"] = moe_parent(torch, cfg, params, batch, shape,
                                       prefill, prefill_prof)
    return out


def fused_ops_check(torch, cfg, prefill, kernel_prof: dict) -> dict:
    """The prefill profiled on the parent's route (``unfused_norm_rope``,
    table ``profile_<config>_prefill_parent.txt``): the fused kernels'
    prefill (``kernel_prof``) must run exactly ``fused_prefill_ops`` fewer
    ATen adds, products and silus (every other add stays: the block-end
    adds, v's bias)."""
    with unfused_norm_rope():
        parent = profile_call(torch, prefill,
                              f"profile_{cfg.name}_prefill_parent.txt")
    calls = {w: {op: p["ops"].get(op, {}).get("calls", 0)
                 for op in FUSED_OPS}
             for w, p in (("kernels", kernel_prof), ("parent", parent))}
    fewer = {op: calls["parent"][op] - calls["kernels"][op]
             for op in FUSED_OPS}
    row = {"calls": calls, "fewer": fewer,
           "expected": fused_prefill_ops(cfg),
           "device_busy_ms": {"kernels": kernel_prof["device_busy_ms"],
                              "parent": parent["device_busy_ms"]},
           "device_ms": {w: {op: p["ops"].get(op, {}).get("device_ms", 0.0)
                             for op in FUSED_OPS}
                         for w, p in (("kernels", kernel_prof),
                                      ("parent", parent))}}
    emit("fused_ops", config=cfg.name, **row)
    if fewer != row["expected"]:
        fail(f"{cfg.name} prefill: ATen ops {calls}, expected "
             f"{row['expected']} fewer on the fused kernels than on the "
             "parent's route")
    return row


def moe_parent(torch, cfg, params, batch, shape: dict, prefill,
               kernel_prof: dict) -> dict:
    """The MoE path's parent columns: a profile of one prefill on the
    slot-scan route (``slot_scan_moe``: the router's glue, the slot scan,
    the plain copy into the group-major buffer; table ``profile_<config>_
    prefill_slot_scan_moe.txt``) and on the block's plain route
    (``plain_moe``); the kernel route's prefill (``kernel_prof``) must run
    at least two ``aten::copy_`` calls a layer fewer than the slot-scan
    route's (the experts' einsums no longer copy the buffer into e-major;
    the copies of both by input shape); then the prefill and the replayed decode
    step on the kernels against the slot-scan route and the plain route,
    each in turns (``route_turns``), beside each route's device busy ms."""
    with slot_scan_moe():
        old = profile_call(torch, prefill,
                           f"profile_{cfg.name}_prefill_slot_scan_moe.txt",
                           copies=True)
    emit("profile", config=cfg.name, step="prefill_slot_scan_moe", **old)
    with plain_moe():
        prof = profile_call(torch, prefill,
                            f"profile_{cfg.name}_prefill_plain_moe.txt")
    emit("profile", config=cfg.name, step="prefill_plain_moe", **prof)
    copies = {w: p["ops"].get("aten::copy_", {}).get("calls", 0)
              for w, p in (("kernels", kernel_prof), ("slot_scan", old))}
    fewer = copies["slot_scan"] - copies["kernels"]
    emit("moe_copies", config=cfg.name, calls=copies,
         fewer_a_layer=fewer / cfg.num_layers,
         kernels_by_shape=kernel_prof["copies_by_shape"],
         slot_scan_by_shape=old["copies_by_shape"])
    if fewer < 2 * cfg.num_layers:
        fail(f"{cfg.name} prefill: aten::copy_ {copies}, expected at least "
             f"{2 * cfg.num_layers} fewer on the kernels than on the "
             "slot-scan route")
    busy = {"kernels": kernel_prof["device_busy_ms"],
            "slot_scan": old["device_busy_ms"],
            "plain": prof["device_busy_ms"]}
    row = {"device_busy_ms": busy,
           "slot_scan": route_turns(torch, cfg, params, batch, shape,
                                     slot_scan_moe),
           "plain": route_turns(torch, cfg, params, batch, shape,
                                plain_moe)}
    # the prefill is paced by the host: the threads alive beside it
    emit("moe_parent", config=cfg.name, microbatch=shape["microbatch"],
         prompt_len=shape["prompt_len"],
         threads=[t.name for t in threading.enumerate()], **row)
    return row


@contextlib.contextmanager
def beside_syncs(torch, counts: dict):
    """Run the body while another thread does what a serve node thread does
    beside a decode graph's capture: work on its current stream, a copy to
    the host, a synchronise of that stream (a capture in ``thread_local``
    mode must survive them; a device-wide synchronise it would not, which
    is why the serve apps synchronise their stream).  ``counts["syncs"]``
    gets the thread's rounds; an error in it fails the script."""
    stop, errors = threading.Event(), []

    def noise():
        try:
            y = torch.ones(1024, device="cuda")
            while not stop.is_set():
                (y * 2).cpu()
                torch.cuda.current_stream().synchronize()
                counts["syncs"] += 1
        except Exception as err:  # noqa: BLE001 - failed after the join
            errors.append(err)

    thread = threading.Thread(target=noise)
    counts["syncs"] = 0
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=60)
    if errors or thread.is_alive() or not counts["syncs"]:
        fail(f"the thread beside the capture: {errors or 'did not stop'} "
             f"after {counts['syncs']} rounds")


def phase_decode_graph(torch, cfg, params, shape: dict, kernels: dict, da
                       ) -> dict:
    """The path's decode step eager (``graph=False``) and through its CUDA
    graph (the default on CUDA), from one prefill's cache copied: one
    microbatch's ``decode_steps - 1`` steps each, as a decode app runs
    them (the graph's first step eager, then the capture, then replays;
    a bf16 SSM cache's first step is a graph of its own, captured after
    its eager step, ``decode_graphs_a_slot``), both through the decode
    kernel (the default on CUDA).

    The graph's steps (its capture among them) run while another thread
    copies to the host and synchronises its stream (``beside_syncs``).
    Held: the greedy tokens equal at every step; the last step's logits
    equal to the bit, or else within 5% of the eager logits' range (the
    dense paths' kernel-vs-plain tolerance) with the largest difference
    printed; one capture a graph; the decode kernel's launches exact, on the host
    (each eager step and the capture) and on the device (each executed
    step, the replays included), no other kernel; one eager step under
    ``torch.cuda.set_sync_debug_mode("error")`` (a synchronise in it
    raises); one step from the eager run's cache on the plain route
    (``use_kernel=False``) held to the kernel route's logits by the path's
    rule (``routes_agree``).  Printed: the decode-step ms eager and
    replayed (median of 8 after a warm call, host clock ended by a
    synchronise, at the cache's last row), the capture ms, each one's
    device busy ms and idle share from one profiled step beside the
    replay's device span by CUDA events (profile tables under
    ``PROFILE_DIR``), and the plain route's replayed step the same way
    (``prior_ms``: its graph captured after the kernel route's is
    released)."""
    import numpy as np
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.train import make_decode_step, make_prefill_step
    from repro_torch.train.steps import DecodeGraph
    mb, s, steps = (shape["microbatch"], shape["prompt_len"],
                    shape["decode_steps"])
    batch = prompt_batch(cfg, torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size,
                                          size=(mb, s))).cuda())
    first, cache = make_prefill_step(cfg, graph=False)(params, batch,
                                                        s + steps)
    del batch
    _zero_counts(kernels)
    captures = DecodeGraph.counts["captures"]
    decode_before = da.kernel_launches(da._lib())
    runs, noise = {}, {}
    for name, graph in (("eager", False), ("graph", True)):
        c = cache if graph else _tree_map(cache, lambda t: t.clone())
        step = make_decode_step(cfg, graph=graph)
        tok, toks = first[:, None], []
        with (beside_syncs(torch, noise) if graph
              else contextlib.nullcontext()):
            for i in range(steps - 1):
                tok, c = step(params, c, tok, s + i)
                toks.append(tok)
        runs[name] = dict(step=step, cache=c, tokens=torch.cat(toks, 1).cpu(),
                          logits=step.logits.clone())
    del cache
    eager, graph = runs["eager"], runs["graph"]
    captured = DecodeGraph.counts["captures"] - captures
    launches, _ = _read_counts(kernels)
    calls = decode_attention_calls(cfg)
    graphs = decode_graphs_a_slot(cfg, steps)
    want = dict.fromkeys(launches, 0)
    want["decode_attention"] = calls * (steps - 1 + 2 * graphs)
    want_device = calls * 2 * (steps - 1)
    decode_device = decode_device_delta(da, decode_before,
                                        decode_route(torch, cfg, da))
    same_by_step = (eager["tokens"] == graph["tokens"]).all(0).tolist()
    bitwise = bool(torch.equal(eager["logits"], graph["logits"]))
    diff = float((eager["logits"] - graph["logits"]).abs().max())
    scale = float(eager["logits"].abs().max())
    finite = bool(torch.isfinite(graph["logits"]).all())

    last, tok = s + steps - 1, first[:, None]
    routes = routes_agree(torch, cfg, params, eager["cache"], tok, last)

    def eager_step():
        eager["step"](params, eager["cache"], tok, last)

    def graph_step():
        graph["step"](params, graph["cache"], tok, last)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = dict(config=cfg.name, microbatch=mb, prompt_len=s,
               steps=steps - 1, tokens_equal_by_step=same_by_step,
               logits_bitwise_equal=bitwise, logits_max_abs_diff=diff,
               logits_max_abs=scale, logits_finite=finite,
               captures=captured, capture_ms=graph["step"].graph.capture_ms,
               syncs_beside_graph=noise["syncs"], launches=launches,
               expected_launches=want, decode_device_launches=decode_device,
               expected_decode_device_launches=want_device,
               sync_free_eager_step=True, plain_vs_kernel=routes)
    for name, fn in (("eager", eager_step), ("graph", graph_step)):
        out[f"{name}_ms"], out[f"{name}_ms_all"] = step_ms(torch, fn, 8)
        prof = profile_call(torch, fn,
                            f"profile_{cfg.name}_decode_{name}.txt")
        out[f"{name}_profile"] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share", "top")}
    out["graph_device_span_ms"] = device_span_ms(torch, graph_step)
    graph["step"].close()
    # the plain route's replayed step, its graph captured on the same cache
    # once the kernel route's is released (gemma2's serve is at 79 GB)
    plain = make_decode_step(cfg, graph=True, use_kernel=False)

    def plain_step():
        plain(params, graph["cache"], tok, last)

    plain_before = da.kernel_launches(da._lib())
    out["prior_route"] = "plain"
    out["prior_ms"], out["prior_ms_all"] = step_ms(torch, plain_step, 8)
    prof = profile_call(torch, plain_step,
                        f"profile_{cfg.name}_decode_graph_plain.txt")
    out["prior_profile"] = {k: prof[k] for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "top")}
    out["prior_device_span_ms"] = device_span_ms(torch, plain_step)
    plain.close()
    plain_launched = decode_device_delta(da, plain_before,
                                         decode_route(torch, cfg, da))
    out["prior_decode_device_launches"] = plain_launched
    emit("decode_graph", **out)
    if not all(same_by_step):
        fail(f"{cfg.name}: the decode graph's tokens differ from the eager "
             f"step's at steps {same_by_step}")
    if not finite or (not bitwise and diff > 0.05 * scale):
        fail(f"{cfg.name}: the decode graph's last logits differ from the "
             f"eager step's by {diff} (range {scale})")
    if captured != graphs or launches != want \
            or decode_device != want_device or plain_launched:
        fail(f"{cfg.name}: decode made {captured} captures and launched "
             f"{launches} (expected {want}), the device counted "
             f"{decode_device} decode launches (expected {want_device}), "
             f"the plain route {plain_launched}")
    if not routes["ok"]:
        fail(f"{cfg.name}: the plain route's decode step differs from the "
             f"kernel route's: {routes}")
    return out


def top1_rule(torch, cfg, lk, lp) -> dict:
    """The dense paths' rule for kernel-route logits ``lk`` against the
    plain route's ``lp``: within 5% of the plain logits' range, and the
    same top-1 token on every row whose top two the plain route does not
    tie (within one unit in the last place of the model's dtype, to which
    the head's product is rounded)."""
    diff = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    same = lk.argmax(-1) == lp.argmax(-1)
    top2 = lp.float().topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ulp = torch.finfo(cfg.torch_dtype).eps * torch.exp2(
        torch.floor(torch.log2(top2[..., 0].abs())))
    tied = margin <= ulp
    out = dict(finite=bool(torch.isfinite(lk).all()), max_abs_diff=diff,
               max_abs_logit=scale,
               top1_agreement=float(same.float().mean()),
               top1_margins=margin.flatten().tolist(),
               tied_rows=int(tied.sum()),
               top1_agree_untied=bool((same | tied).all()))
    out["ok"] = (out["finite"] and diff <= 0.05 * scale
                 and out["top1_agree_untied"])
    return out


def routes_agree(torch, cfg, params, cache, tok, pos: int) -> dict:
    """One eager decode step at ``pos`` from ``cache`` on the kernel route
    and on the plain route (``use_kernel=False``), held by the path's rule
    of ``check_full_width_logits``: the dense paths by ``top1_rule``; the
    ssm, hybrid and moe paths by the same step in f32 (the weights and
    the cache cast), the two routes within 1e-3 of the f32 logits' range,
    and the bf16 kernel route no further from the f32 plain logits than
    twice the bf16 plain route.  Each step writes the cache's row ``pos``
    (the same for both routes: every layer writes its row before it
    reads it); the SSM state, which a step advances, is put back after
    each."""
    import dataclasses

    from repro_torch.train import make_decode_step

    def logits(c, p, kcfg, use_kernel):
        step = make_decode_step(kcfg, graph=False, use_kernel=use_kernel)
        with torch.inference_mode():
            saved = _tree_map(c["ssm"], lambda t: t.clone()) \
                if "ssm" in c else None
            step(p, c, tok, pos)
            for k, t in (saved or {}).items():
                c["ssm"][k].copy_(t)
        return step.logits.float()

    lk = logits(cache, params, cfg, True)
    lp = logits(cache, params, cfg, False)
    out = top1_rule(torch, cfg, lk, lp)
    if cfg.family not in ("ssm", "hybrid", "moe"):
        return out
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(params, lambda t: t.float())
    c32 = _tree_map(cache, lambda t: t.float())
    lk32 = logits(c32, p32, cfg32, True)
    lp32 = logits(c32, p32, cfg32, False)
    del p32, c32
    diff32 = float((lk32 - lp32).abs().max())
    scale32 = float(lp32.abs().max())
    out.update(f32_max_abs_diff=diff32, f32_max_abs_logit=scale32,
               bf16_kernel_vs_f32=float((lk - lp32).abs().max()),
               bf16_plain_vs_f32=float((lp - lp32).abs().max()))
    out["ok"] = (out["finite"] and bool(torch.isfinite(lk32).all())
                 and diff32 <= 1e-3 * scale32
                 and out["bf16_kernel_vs_f32"]
                 <= 2 * out["bf16_plain_vs_f32"])
    return out


def profile_call(torch, fn, table_name: str, split=None,
                 copies: bool = False, replay=None) -> dict:
    """One call of ``fn`` under torch.profiler, ended by a device
    synchronise: its wall ms, device busy ms and idle share, the ten
    device kernels with the most time, the flash launches by route
    (``flash_routes_seen``), the SSD launches by device kernel
    (``ssd_kernels_seen``) and the device time of the MoE dispatch's and
    the SSD scan's index ops and of the SSD scan's layout copies
    (``WATCHED_OPS``), where the call ran them (full table to
    ``table_name`` under ``PROFILE_DIR``); with ``split`` (a model's
    widths, ``train_dims``), a train step's device time by part and its
    elementwise time by op family (``train_split``, shapes recorded; the
    kernels' shares by name under ``by_kernel``); with ``replay`` (such a
    profile of an eager step), a replayed train step split the same way
    (``replay_split``); with ``copies``, the ``aten::copy_`` calls by their
    input shapes (``copies_by_shape``)."""
    from torch.profiler import ProfilerActivity, profile
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=split is not None or copies) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    (PROFILE_DIR / table_name).write_text(table)
    # device kernels only: op-level rows repeat their kernels' time
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted(((_self_device_us(e) / 1e3, e.count, e.key)
                  for e in events if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)),
                 reverse=True)
    busy_ms = sum(d for d, _, _ in dev)
    watched = {e.key: {"device_ms": _device_us(e) / 1e3, "calls": e.count}
               for e in events if e.key in WATCHED_OPS
               and e.device_type != cuda}
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
               top=[{"op": k[:100], "device_ms": d, "calls": c}
                    for d, c, k in dev[:10]], ops=watched,
               flash_routes_seen=flash_routes_seen(torch, events),
               ssd_kernels_seen=ssd_kernels_seen(torch, events),
               decode_kernels_seen=decode_kernels_seen(torch, events))
    if split is not None:
        out["split"], out["by_kernel"] = train_split(torch, prof, busy_ms,
                                                     split)
    if replay is not None:
        out["split"] = replay_split(torch, prof, busy_ms,
                                    replay["by_kernel"])
    if copies:
        out["copies_by_shape"] = sorted(
            ({"shapes": str(e.input_shapes)[:120], "calls": e.count,
              "device_ms": _device_us(e) / 1e3}
             for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::copy_" and e.device_type != cuda),
            key=lambda r: -r["device_ms"])
    return out


def profile_kernels(torch, fn, table_name: str, by_kernel: dict,
                    ranges: bool = False) -> dict:
    """One call of ``fn`` under torch.profiler, ended by a device
    synchronise, read from the profiler's raw events without its op tree
    (``prof.events()`` builds that in Python, ~7 s a 100,000 events: a
    full-depth eager step of mamba2 or zamba2 records several times that):
    its wall ms, device busy ms and idle share (1 - busy / wall,
    unclamped: kernels that overlap could make it negative), the ten
    device kernels with the most time (all of them by name to
    ``table_name``), the busy time split by part in ``by_kernel``'s
    proportions (an eager profile's ``train_split``: ``split_by_name``),
    and with ``ranges`` each ``TRAIN_SCOPE`` range's device ms read from
    the events themselves (``range_parts``: ``fn`` under
    ``scoped_plain_ops``)."""
    from torch.profiler import ProfilerActivity, profile
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    kernels = [(e.name(), e.duration_ns() / 1e6) for e in events
               if e.device_type() == cuda and not e.is_user_annotation()]
    busy_ms = sum(ms for _, ms in kernels)
    by_name: dict = {}
    for name, ms in kernels:
        ms_n = by_name.setdefault(name, [0.0, 0])
        ms_n[0] += ms
        ms_n[1] += 1
    top = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                 reverse=True)
    (PROFILE_DIR / table_name).write_text("".join(
        f"{ms:12.3f} ms {n:7d} {name}\n" for ms, n, name in top))
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / wall_ms,
               top=[{"op": k[:100], "device_ms": d, "calls": c}
                    for d, c, k in top[:10]],
               split=split_by_name(kernels, busy_ms, by_kernel))
    if ranges:
        out["range_ms"] = range_parts(torch, events)
    return out


# A train step's device time by part (``train_split``): the optimizer's
# and the global norm's ops (under ``scoped_optimizer``'s ranges), the
# plain SSD scan's and the plain MoE glue's ops and their backward
# (``scoped_plain_ops``' ranges, ``PLAIN_OPS_PARTS``), the GEMMs by their inputs' dtype (bf16: the projections and the head; f32:
# the plain training attention's einsums, which upcast q, k and v), the
# training attention kernels, the norm and RoPE kernels, the gate's and the
# loss's kernels, the rest
# (elementwise, reductions, copies; remat's recompute included) split by op
# family (``ELEMENTWISE_FAMILIES``, from the op's input shapes; the d_model
# family also by op, ``RESIDUAL_OPS``), device time no op claims, and idle
TRAIN_PARTS = ("optimizer", "global_norm", "ssd_plain", "moe_plain",
               "gemm_bf16", "gemm_f32", "attention_kernels",
               "norm_rope_kernels", "gate_kernels", "loss_kernels",
               "elementwise")
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
            "aten::addbmm", "aten::_addmm_activation")
TRAIN_SCOPE = "train_step/"
BACKWARD_NODE = "autograd::engine::evaluate_function: "
# An elementwise op's family by the shapes of its inputs, the first rule
# that one input meets (``op_family``): the attention core's S x S scores
# (the plain route's scale, cap, mask, softmax and their backward), the
# loss and the head (vocab), the MLP's gate (d_ff), RoPE and the
# attention's upcasts ((B, S, heads, head_dim), RoPE's halves (B, S, heads,
# head_dim / 2) too), the norms and residual adds (d_model rows), and casts
# and copies (the rest, also split by op); an add (``RESIDUAL_OPS``) with a
# projection's bias among its inputs (a (d_model,) or (heads, head_dim)
# row) is a bias add (the forward's; the bias grads' sums stay with their
# input's family)
ELEMENTWISE_FAMILIES = ("attention_core", "loss_head", "mlp_gate",
                        "bias_adds", "rope_upcasts", "norms_residual",
                        "casts_copies")
# the d_model family's adds: the residual adds and the grads' accumulation;
# its other ops are the plain norms' (upcast, square, mean, rsqrt,
# products, cast, and their backward)
RESIDUAL_OPS = ("aten::add", "aten::add_")


# the hand-written kernels no ATen op launches: their device time goes to
# their part by name
NAMED_KERNEL_PARTS = {"adamw_update_kernel": "optimizer",
                      "sumsq_kernel": "global_norm",
                      "fwd_wgmma_kernel": "attention_kernels",
                      "dq_wgmma_kernel": "attention_kernels",
                      "dkdv_wgmma_kernel": "attention_kernels",
                      "fwd_mma_kernel": "attention_kernels",
                      "dq_mma_kernel": "attention_kernels",
                      "dkdv_mma_kernel": "attention_kernels",
                      "fwd_f32_kernel": "attention_kernels",
                      "dq_f32_kernel": "attention_kernels",
                      "dkdv_f32_kernel": "attention_kernels",
                      "fwd_3xtf32_kernel": "attention_kernels",
                      "dq_3xtf32_kernel": "attention_kernels",
                      "dkdv_3xtf32_kernel": "attention_kernels",
                      "delta_kernel": "attention_kernels",
                      "rms_norm_fwd_kernel": "norm_rope_kernels",
                      "rms_norm_bwd_kernel": "norm_rope_kernels",
                      "rms_norm_bwd_staged_kernel": "norm_rope_kernels",
                      "rms_norm_dscale_kernel": "norm_rope_kernels",
                      "rope_kernel": "norm_rope_kernels",
                      "gated_act_fwd_kernel": "gate_kernels",
                      "gated_act_bwd_kernel": "gate_kernels",
                      "cross_entropy_fwd_kernel": "loss_kernels",
                      "cross_entropy_sum_kernel": "loss_kernels",
                      "cross_entropy_bwd_kernel": "loss_kernels"}


def train_dims(cfg, seq: int) -> dict:
    """The widths ``op_family`` tells the families apart by."""
    return dict(seq=seq, heads=(cfg.num_heads, cfg.num_kv_heads),
                head_dim=cfg.resolved_head_dim, d_model=cfg.d_model,
                d_ff=cfg.d_ff, vocab=cfg.vocab_size)


def op_family(shapes, dims: dict, op: str = "") -> str:
    """The family (``ELEMENTWISE_FAMILIES``) of an op (named ``op``) with
    input ``shapes`` at a model's ``dims``."""
    shapes = [tuple(x) for x in shapes if x]
    s = dims["seq"]
    biases = {(dims["d_model"],), *((h, dims["head_dim"])
                                    for h in dims["heads"])}
    if op in RESIDUAL_OPS and any(x in biases for x in shapes):
        return "bias_adds"
    rules = (("attention_core", lambda x: len(x) >= 2 and x[-2:] == (s, s)),
             ("loss_head", lambda x: x[-1] == dims["vocab"]),
             ("mlp_gate", lambda x: x[-1] == dims["d_ff"]),
             ("rope_upcasts", lambda x: len(x) >= 2 and x[-2] in dims["heads"]
              and x[-1] in (dims["head_dim"], dims["head_dim"] // 2)),
             ("norms_residual", lambda x: x[-1] == dims["d_model"]))
    for family, meets in rules:
        if any(meets(x) for x in shapes):
            return family
    return "casts_copies"


def gemm_dtypes(prof) -> dict:
    """Each GEMM op's input dtypes by its correlation id (a
    ``FunctionEvent``'s ``id``), from the profiler's own events (a
    ``FunctionEvent`` has no dtypes in every release).  Fails the phase
    where they cannot be read: a kernel's name need not say its dtype."""
    try:
        return {ev.correlation_id(): " ".join(ev.dtypes())
                for ev in prof.profiler.kineto_results.events()
                if ev.name() in GEMM_OPS}
    except (AttributeError, RuntimeError, TypeError) as err:
        fail(f"train_profile: the profiler's GEMM dtypes cannot be read "
             f"({type(err).__name__}: {err})")


def _forward_op(event) -> bool:
    """An op that autograd recorded in a forward (its node's sequence
    number, no forward thread: a backward's ops have one)."""
    return event.sequence_nr >= 0 and not event.fwd_thread


def scoped_nodes(prof) -> dict:
    """The autograd nodes made inside a ``TRAIN_SCOPE`` range (the forward
    ops of ``scoped_optimizer`` and ``scoped_plain_ops``): (forward
    thread, sequence number) -> part.  The backward runs each node on
    autograd's thread outside the range, under an
    ``autograd::engine::evaluate_function`` event with the node's forward
    thread and sequence number (``train_part``).  An op that makes no node
    records the number the thread's next node will take, so a number's
    node is made by the last op to record it (a composite op's children
    share its number and its range); numbers no backward ran are left
    out."""
    events = prof.events()
    ran = {(e.fwd_thread, e.sequence_nr) for e in events
           if e.name.startswith(BACKWARD_NODE)}
    last = {}
    for e in events:
        key = (e.thread, e.sequence_nr)
        if _forward_op(e) and key in ran and (
                key not in last
                or e.time_range.start >= last[key].time_range.start):
            last[key] = e
    out = {}
    for key, e in last.items():
        scope = e.cpu_parent
        while scope is not None and not scope.name.startswith(TRAIN_SCOPE):
            scope = scope.cpu_parent
        if scope is not None:
            out[key] = scope.name[len(TRAIN_SCOPE):]
    return out


def range_parts(torch, events) -> dict:
    """The device ms of each ``TRAIN_SCOPE`` range's ops and their
    backward, from a profile's raw events (``kineto_results.events()``),
    without the op tree that ``prof.events()`` builds (linked as
    ``torch.autograd.profiler`` links them): ``train_part``'s
    rule (the innermost range around an op, or the range around the
    forward op whose backward node runs it: ``scoped_nodes``' link, no
    forward op between the node and the op) on each thread's events nested
    by their times, each device kernel given to the op that launched it
    (its linked correlation id).  The hand-written kernels
    (``NAMED_KERNEL_PARTS``) are left out, as ``train_split`` leaves
    them."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu, kernels = [], []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not any(
                    k in e.name() for k in NAMED_KERNEL_PARTS):
                kernels.append((e.linked_correlation_id(),
                                e.duration_ns() / 1e6))
        elif (e.linked_correlation_id() == 0 and not e.is_async()
              and e.start_thread_id() == e.end_thread_id()):
            # the ops and ranges (a runtime call links to its op instead)
            cpu.append(e)
    ran = {(e.fwd_thread_id(), e.sequence_nr()) for e in cpu
           if e.name().startswith(BACKWARD_NODE)}
    by_thread: dict = {}
    for e in cpu:
        by_thread.setdefault(e.start_thread_id(), []).append(e)
    # each op's innermost range (with its depth), innermost scoped
    # backward node (with its depth) and deepest forward op
    frames = {}
    for thread, evs in by_thread.items():
        evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack = []
        for e in evs:
            while stack and stack[-1][0] <= e.start_ns():
                stack.pop()
            ann, bwd, fwd = stack[-1][1] if stack else (None, None, -1)
            depth = len(stack)
            name = e.name()
            if e.is_user_annotation() and name.startswith(TRAIN_SCOPE):
                ann = (name[len(TRAIN_SCOPE):], depth)
            if e.sequence_nr() >= 0 and not e.fwd_thread_id():
                fwd = depth
            if name.startswith(BACKWARD_NODE):
                bwd = ((e.fwd_thread_id(), e.sequence_nr()), depth)
            frames[e.correlation_id()] = (thread, e, ann, bwd, fwd)
            stack.append((e.end_ns(), (ann, bwd, fwd)))
    # the node a (thread, number) is made by: the last forward op to record
    # it, inside its range or none
    nodes, last = {}, {}
    for thread, e, ann, _, fwd in frames.values():
        key = (thread, e.sequence_nr())
        if fwd >= 0 and not e.fwd_thread_id() and key in ran and (
                key not in last or e.start_ns() >= last[key]):
            last[key] = e.start_ns()
            nodes[key] = ann[0] if ann else None
    out: dict = {}
    for corr, ms in kernels:
        frame = frames.get(corr)
        if frame is None:
            continue
        _, _, ann, bwd, fwd = frame
        part = None
        if bwd and fwd < bwd[1] and nodes.get(bwd[0]) and (
                not ann or ann[1] < bwd[1]):
            part = nodes[bwd[0]]
        elif ann:
            part = ann[0]
        if part:
            out[part] = out.get(part, 0.0) + ms
    return out


def train_part(event, dtypes: dict, nodes: Optional[dict] = None) -> str:
    """The part of a train step an op's device kernels belong to: the
    ``scoped_optimizer`` or ``scoped_plain_ops`` range around it, or
    around the forward op whose backward node runs it (``nodes``, from
    ``scoped_nodes``; an op remat's recompute runs under a backward node
    is a forward op and takes its own range), else a GEMM by its inputs'
    dtype (``gemm_dtypes``; the phase fails where none was recorded),
    else ``elementwise``."""
    scope, forward = event, False
    while scope is not None:
        if scope.name.startswith(TRAIN_SCOPE):
            return scope.name[len(TRAIN_SCOPE):]
        forward = forward or _forward_op(scope)
        if nodes and not forward and scope.name.startswith(BACKWARD_NODE):
            part = nodes.get((scope.fwd_thread, scope.sequence_nr))
            if part:
                return part
        scope = scope.cpu_parent
    if event.name in GEMM_OPS:
        seen = dtypes.get(event.id)
        if not seen:
            fail(f"train_profile: no dtypes recorded for {event.name} "
                 f"(id {event.id})")
        return "gemm_bf16" if re.search(r"bfloat16|bf16", seen, re.I) \
            else "gemm_f32"
    return "elementwise"


def train_split(torch, prof, busy_ms: float, dims: dict) -> tuple:
    """A profiled train step's device ms by ``TRAIN_PARTS``: each ATen
    op's kernels by ``train_part`` (the scoped ranges' backward nodes
    linked by ``scoped_nodes``), the hand-written kernels by name
    (``NAMED_KERNEL_PARTS``); ``elementwise`` also by op family
    (``op_family`` of the op's name and input shapes, recorded);
    ``unattributed``, busy time none of them claims; each part's and
    family's top four kernels; ``norms_residual`` split into its ``adds``
    (``RESIDUAL_OPS``) and its ``other_ops``; ``casts_copies`` by ATen op
    (``casts_copies_by_op``; ``by_kernel`` keeps each kernel's share of an
    op as ``casts_copies:<op>``, which ``replay_split`` carries to a
    replay)."""
    cpu = torch.autograd.DeviceType.CPU
    dtypes = gemm_dtypes(prof)
    nodes = scoped_nodes(prof)
    parts = dict.fromkeys(TRAIN_PARTS, 0.0)
    families = dict.fromkeys(ELEMENTWISE_FAMILIES, 0.0)
    residual = {"adds": 0.0, "other_ops": 0.0}
    casts: dict = {}
    names = {p: {} for p in TRAIN_PARTS + ELEMENTWISE_FAMILIES}
    by_kernel: dict = {}

    def share(name, key, ms):
        got = by_kernel.setdefault(name, {})
        got[key] = got.get(key, 0.0) + ms

    def add(part, name, ms):
        parts[part] += ms
        names[part][name[:90]] = names[part].get(name[:90], 0.0) + ms
        share(name, part, ms)

    def named(kernel):
        return next((p for k, p in NAMED_KERNEL_PARTS.items()
                     if k in kernel), None)
    for e in prof.events():
        if e.device_type != cpu:
            part = named(e.name)
            if part:
                add(part, e.name, (e.time_range.end
                                   - e.time_range.start) / 1e3)
            continue
        for k in e.kernels:
            if named(k.name):
                continue
            part = train_part(e, dtypes, nodes)
            add(part, k.name, k.duration / 1e3)
            if part == "elementwise":
                fam = op_family(getattr(e, "input_shapes", None) or [],
                                dims, e.name)
                families[fam] += k.duration / 1e3
                share(k.name, fam, k.duration / 1e3)
                if fam == "norms_residual":
                    residual["adds" if e.name in RESIDUAL_OPS
                             else "other_ops"] += k.duration / 1e3
                if fam == "casts_copies":
                    casts[e.name] = casts.get(e.name, 0.0) + k.duration / 1e3
                    share(k.name, f"casts_copies:{e.name}",
                          k.duration / 1e3)
                names[fam][f"{e.name} {k.name}"[:90]] = names[fam].get(
                    f"{e.name} {k.name}"[:90], 0.0) + k.duration / 1e3
    out = dict(parts)
    out["elementwise_families"] = families
    out["norms_residual_split"] = residual
    out["casts_copies_by_op"] = dict(sorted(casts.items(),
                                            key=lambda kv: -kv[1]))
    out["unattributed"] = max(0.0, busy_ms - sum(parts.values()))
    out["top"] = {p: sorted(names[p].items(), key=lambda kv: -kv[1])[:4]
                  for p in TRAIN_PARTS + ELEMENTWISE_FAMILIES}
    return out, by_kernel


def replay_split(torch, prof, busy_ms: float, by_kernel: dict) -> dict:
    """A profiled graph replay's device ms by ``TRAIN_PARTS`` and
    elementwise family, as ``train_split`` gives an eager step's: a
    replay's kernels have no ATen op above them (the graph launches them),
    so each kernel's time goes to the parts and families its name took in
    an eager step of the same work (``by_kernel``, from ``train_split``),
    in that step's proportions (``casts_copies`` by op too);
    ``unattributed``, the time of names the eager step did not run."""
    cpu = torch.autograd.DeviceType.CPU
    return split_by_name([(e.name, (e.time_range.end - e.time_range.start)
                           / 1e3) for e in prof.events()
                          if e.device_type != cpu], busy_ms, by_kernel)


def split_by_name(kernels: list, busy_ms: float, by_kernel: dict) -> dict:
    """``replay_split`` of device kernels given as (name, ms) pairs."""
    parts = dict.fromkeys(TRAIN_PARTS, 0.0)
    families = dict.fromkeys(ELEMENTWISE_FAMILIES, 0.0)
    casts: dict = {}
    unknown: dict = {}
    for name, ms in kernels:
        got = by_kernel.get(name)
        in_parts = sum(got.get(p, 0.0) for p in TRAIN_PARTS) if got else 0
        if not in_parts:
            unknown[name[:90]] = unknown.get(name[:90], 0.0) + ms
            continue
        for p in TRAIN_PARTS:
            parts[p] += ms * got.get(p, 0.0) / in_parts
        in_families = sum(got.get(f, 0.0) for f in ELEMENTWISE_FAMILIES)
        for f in ELEMENTWISE_FAMILIES:
            if in_families:
                families[f] += (ms * got.get("elementwise", 0.0) / in_parts
                                * got.get(f, 0.0) / in_families)
        ops = {k.split(":", 1)[1]: v for k, v in got.items()
               if k.startswith("casts_copies:")}
        if ops and in_families:
            cc = (ms * got.get("elementwise", 0.0) / in_parts
                  * got.get("casts_copies", 0.0) / in_families)
            for op, v in ops.items():
                casts[op] = casts.get(op, 0.0) + cc * v / sum(ops.values())
    out = dict(parts)
    out["elementwise_families"] = families
    out["casts_copies_by_op"] = dict(sorted(casts.items(),
                                            key=lambda kv: -kv[1]))
    out["unattributed"] = max(0.0, busy_ms - sum(parts.values()))
    out["unknown_kernels"] = sorted(unknown.items(),
                                    key=lambda kv: -kv[1])[:6]
    return out


def span_ms(spans: list, steps: int, skip: int = 0) -> dict:
    """The median over ``steps`` steps (the first ``skip`` left out) of
    each part's device ms a step, from ``scoped_optimizer``'s events (the
    steps synchronised, so every event has completed)."""
    per = len(spans) // steps
    by_step = [{} for _ in range(steps)]
    for i, (part, start, end) in enumerate(spans):
        d = by_step[i // per]
        d[part] = d.get(part, 0.0) + start.elapsed_time(end)
    kept = by_step[skip:]
    return {part: sorted(d[part] for d in kept)[len(kept) // 2]
            for part in kept[0]}


@contextlib.contextmanager
def scoped_optimizer(spans=None):
    """The train step's global norm and AdamW update (``train.steps``'s
    ``global_norm``, ``adamw_update``, ``adamw_update_``) each under a
    profiler range ``train_step/<part>``, for ``train_split``; with a list
    ``spans``, each call's (part, start, end) CUDA events appended to it
    (``span_ms``: the part's device span in an unprofiled step)."""
    import torch
    from torch.profiler import record_function

    from repro_torch.train import steps as S
    names = {"global_norm": "global_norm", "adamw_update": "optimizer",
             "adamw_update_": "optimizer"}
    real = {n: getattr(S, n) for n in names}

    def scoped(fn, part):
        def run(*args, **kwargs):
            if spans is not None:
                ends = [torch.cuda.Event(enable_timing=True)
                        for _ in range(2)]
                ends[0].record()
            with record_function(TRAIN_SCOPE + part):
                out = fn(*args, **kwargs)
            if spans is not None:
                ends[1].record()
                spans.append((part, *ends))
            return out
        return run
    for n, part in names.items():
        setattr(S, n, scoped(real[n], part))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(S, n, fn)


# the plain ops a train step runs where the serve steps run kernels, by
# part: Mamba2's chunked SSD scan; the MoE block's routing (softmax, top-k,
# the gates, the aux loss), slot positions and dispatch, and its combine
PLAIN_OPS_PARTS = (("ssd_plain", "repro_torch.models.ssm", "ssd_chunked"),
                   ("moe_plain", "repro_torch.kernels.moe_dispatch",
                    "route_plain"),
                   ("moe_plain", "repro_torch.models.moe", "dispatch_ops"),
                   ("moe_plain", "repro_torch.kernels.moe_dispatch",
                    "moe_combine_plain"))


@contextlib.contextmanager
def scoped_plain_ops():
    """Each of ``PLAIN_OPS_PARTS``' functions under a profiler range
    ``train_step/<part>`` (its forward ops; their backward nodes are
    linked to it by ``scoped_nodes``), for ``train_split``."""
    import importlib

    from torch.profiler import record_function
    real = [(importlib.import_module(m), n) for _, m, n in PLAIN_OPS_PARTS]
    fns = [getattr(mod, n) for mod, n in real]

    def scoped(fn, part):
        def run(*args, **kwargs):
            with record_function(TRAIN_SCOPE + part):
                return fn(*args, **kwargs)
        return run
    for (part, _, _), (mod, n), fn in zip(PLAIN_OPS_PARTS, real, fns):
        setattr(mod, n, scoped(fn, part))
    try:
        yield
    finally:
        for (mod, n), fn in zip(real, fns):
            setattr(mod, n, fn)


# the MoE dispatch (slot cumsum, scatter_add write, gather read), the MoE
# router's glue (softmax, topk, the aux loss's means), every copy (the
# experts' einsums copy a group-major buffer into e-major), the SSD scan's
# cumsum and the four copies into the SSD kernel's layout (the
# ``ssd_scan_layout`` range of ``kernels/ops.py``), by their device time
# under the op
# the ATen ops that the fused norm and RoPE kernels take over (the
# residual and bias adds, the SSM gate's silu and product:
# ``fused_prefill_ops``)
FUSED_OPS = ("aten::add", "aten::mul", "aten::silu")
WATCHED_OPS = ("aten::cumsum", "aten::scatter_add", "aten::gather",
               "aten::index_put_", "aten::index", "aten::topk",
               "aten::softmax", "aten::mean", "aten::copy_",
               "ssd_scan_layout") + FUSED_OPS
# the MoE block's plain ops and the slot-scan route's router glue, which
# a prefill
# through its kernels runs none of
MOE_PLAIN_OPS = ("aten::cumsum", "aten::scatter_add", "aten::gather",
                 "aten::topk", "aten::softmax", "aten::mean")


TRAIN_FULL = dict(layers=16, batch=8, seq=512, peak_lr=3e-4)
# the order of the full-width steps, in turns on one donated state: the
# step through its CUDA graph (the main path; its first step is the eager
# warm-up and captures), the same step eager (``graph=False``, the
# parent's path), eager on the parent's route (``unfused_norm_rope``: the
# adds that the norm and RoPE kernels now take as ATen ops, for its time
# and its peak check), and eager on the gate's and the loss's plain ops
# (``plain_gate_loss``, PR 31's parent, for its peak check)
TRAIN_TURNS = ("graph", "graph", "eager", "eager", "parent", "parent",
               "plain", "plain", "graph", "graph", "eager", "eager",
               "parent", "plain")
# each column's steps left out of its median: the graph's first (the
# warm-up and the capture), the eager column's first (its allocations,
# after the graph's pool took the released cache)
TRAIN_SKIP = {"graph": 1, "eager": 1, "parent": 0, "plain": 0}
# each side column's context on the card
TRAIN_SIDE = {"parent": unfused_norm_rope, "plain": plain_gate_loss}
TRAIN_ENGINE = dict(steps=40, shards=2, batch_per_shard=4, seq=128,
                    ckpt_every=20, resume_steps=4)
# run_training(lm100m) without checkpoints, eager and through the graph
TRAIN_ENGINE_TURNS = ("graph", "eager", "eager", "graph")
TRAIN_PARITY = (dict(), dict(num_microbatches=2), dict(compress=True))
TRAIN_PARITY_STEPS = 4
# replayed against eager steps from equal states: the first step is the
# graph's warm-up, the rest replays
TRAIN_GRAPH_BITS_STEPS = 4
TRAIN_PACE_STEPS = 5        # lm100m: host-clock steps each way, replays
TRAIN_LM = ("lm20m", 200)   # examples/torch/train_lm.py's preset and steps
# the other five families' train paths at full width, on 8 x 512 tokens
# (whisper's frames (8, 64, d_model) in the config's dtype, the reference's
# train input, src/repro/configs/__init__.py:84-87): (config, layers; 0 all
# of them: chameleon-34b cut to 4 of 48, 3.84 B params, under codeqwen's
# 16-layer 4.47 B)
TRAIN_FAMILIES = (("mamba2_1_3b", 0), ("zamba2_2_7b", 0),
                  ("granite_moe_3b_a800m", 0), ("whisper_large_v3", 0),
                  ("chameleon_34b", 4))
FAMILY_TRAIN = dict(batch=8, seq=512, peak_lr=3e-4)
# a family's steps in turns on one donated state: through its CUDA graph
# (the first the warm-up, which captures; the rest replays) and eager;
# each column's median over the steps past its first (3 each)
FAMILY_TURNS = ("graph", "eager") * 4
FAMILY_SKIP = {"graph": 1, "eager": 1}
# step 1 against the plain route (``plain_route``: every train kernel's
# plain version), one rule for every family (``train_family``'s checks),
# relative limits: (1) the path's step-1 loss within ``loss`` of the plain
# route's in the config's dtype (codeqwen's limit, ``train_full_width``),
# and its grad norm within ``f32`` of the same step's on the kernels
# outside the path (``step1_on_routes``); (2) at the path's depth in f32
# (the same rounded params upcast, every activation unrounded): the
# kernels' loss, grad norm and grads (over every leaf) within ``f32`` of the
# f32 plain route's; (3) at the path's depth in the config's dtype: the
# kernels' grads no farther from the f32 plain route's than ``err_ratio``
# x the plain route's; (4) at the bits check's depth (full width) in the
# config's dtype: the kernels' loss and grad norm within ``loss`` and
# ``grad_norm`` of the plain route's (codeqwen's limits).  The grad norm in
# the config's dtype is not held at the path's depth: at 48 and 54 SSM
# layers, on an H100, every bf16 route's grads are 0.82-1.15 of their
# length away from the f32 grads, and any one kernel part moved to its
# plain version moves zamba2's grad norm by up to 8% (``--step1-routes``)
FAMILY_LIMITS = dict(loss=1e-3, grad_norm=1e-2, f32=1e-3, err_ratio=1.1)


def family_configs() -> list:
    """(arch, the train path's config, the bits check's config) of each
    of ``TRAIN_FAMILIES``: full width; the bits check's depth two states
    fit at (2 layers, whisper's encoder too; zamba2 one group of
    ``shared_attn_period`` Mamba2 layers and its shared block)."""
    import dataclasses

    from repro_torch.configs import get_config
    out = []
    for arch, layers in TRAIN_FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        two = {"num_layers": cfg.shared_attn_period
               if cfg.family == "hybrid" else 2}
        if cfg.family == "encdec":
            two["num_encoder_layers"] = 2
        out.append((arch, cfg, dataclasses.replace(cfg, **two)))
    return out


def family_steps() -> dict:
    """A family's steps on the kernels by kind: ``main`` its path's steps
    through the train kernels (the turns, one profiled eager step and one
    profiled replay; a graph's warm-up and replays launch on the device,
    its capture on the host only), ``flops`` the FLOP-counted eager step
    (the plain attention, the other kernels), ``bits`` the bits check's
    (eager and through the graph, and one profiled eager step), ``step1``
    step 1's grads on the kernels (no update: ``step1_on_routes``) at each
    of the path's depth in f32 and in the config's dtype and the bits
    check's depth in the config's dtype; step 1's plain grads run no
    kernel."""
    return {"main": len(FAMILY_TURNS) + 2, "flops": 1,
            "bits": 2 * TRAIN_GRAPH_BITS_STEPS + 1, "step1": 1}


def full_width_steps(which: str) -> int:
    """Full-width steps of a ``TRAIN_TURNS`` column: its turns and one
    profiled step."""
    return TRAIN_TURNS.count(which) + 1


def lm100m_steps() -> int:
    """lm100m's train steps on the card in the train phase: the engine's
    checkpointed run, the plain loop through the graph and eager, the
    resumed run, the engine's turns, the bits check (eager and graph) and
    the pacing steps (eager, graph and bare replays)."""
    e = TRAIN_ENGINE
    return (e["steps"] * (3 + len(TRAIN_ENGINE_TURNS)) + e["resume_steps"]
            + 2 * TRAIN_GRAPH_BITS_STEPS + 3 * TRAIN_PACE_STEPS)


def expected_train_graphs(phase: str) -> dict:
    """The train step's CUDA graph captures and replays each part of a
    phase must make (``TrainGraph.counts``): a graph step object captures
    on its first step and replays every later one."""
    e = TRAIN_ENGINE
    if phase == "examples":
        return {"train_lm": {"captures": 1, "replays": TRAIN_LM[1] - 1}}
    if phase != "train":
        return {}
    runs = len([t for t in TRAIN_ENGINE_TURNS if t == "graph"])
    return {
        "parity": {"captures": len(TRAIN_PARITY),
                   "replays": len(TRAIN_PARITY) * (TRAIN_PARITY_STEPS - 1)},
        "bits": {"captures": 3,
                 "replays": 3 * (TRAIN_GRAPH_BITS_STEPS - 1)
                 + 2 * TRAIN_PACE_STEPS},
        # the checkpointed run, the plain loop, the resumed run, the turns
        "engine": {"captures": 3 + runs,
                   "replays": (2 + runs) * (e["steps"] - 1)
                   + e["resume_steps"] - 1},
        "full_width": {"captures": 1,
                       "replays": full_width_steps("graph") - 1},
        "remat": {"captures": 2, "replays": 2},
        # each family's path (its graph turns and a profiled replay) and
        # its bits check
        "families": {"captures": 2 * len(TRAIN_FAMILIES),
                     "replays": len(TRAIN_FAMILIES)
                     * (FAMILY_TURNS.count("graph")
                        + TRAIN_GRAPH_BITS_STEPS - 1)}}


def optimizer_steps(phase: str) -> list:
    """(config, train steps on the card) of a phase's runs: each step
    launches both optimizer kernels once a param leaf (a graph's warm-up
    and its replays on the device; its capture none)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import PRESETS
    if phase == "train":
        full = dataclasses.replace(get_config("codeqwen15_7b"),
                                   num_layers=TRAIN_FULL["layers"])
        return [(PRESETS["tiny"], len(TRAIN_PARITY) * TRAIN_PARITY_STEPS
                 + 2 * TRAIN_GRAPH_BITS_STEPS),
                (PRESETS["lm100m"], lm100m_steps()),
                # the four columns' timed and profiled steps, and the
                # FLOP-counted one (step 1's plain grads launch none)
                (full, sum(full_width_steps(w) for w in TRAIN_SKIP) + 1),
                # the bits check (eager and graph); remat on, off
                (dataclasses.replace(full, num_layers=2),
                 2 * TRAIN_GRAPH_BITS_STEPS + 4),
                *((cfg, n) for _, main, bits in family_configs()
                  for cfg, n in ((main, family_steps()["main"]
                                  + family_steps()["flops"]),
                                 (bits, family_steps()["bits"])))]
    if phase == "examples":
        preset, steps = TRAIN_LM
        return [(PRESETS[preset], steps)]
    return []


def expected_optimizer_launches(torch, opt, phase: str) -> dict:
    """The optimizer kernels' launches a phase must make, by kernel and
    route (``optimizer_steps``): a train step on the card launches
    ``adamw_update`` once a param leaf and ``sumsq`` once over every grad
    (``sumsq_plan``: one launch up to ``SUMSQ_LEAVES`` leaves), on the
    route of the params' and grads' dtypes (one microbatch, or f32 params:
    the grads have the params' dtype): each leaf's own (the SSM's
    ``A_log``, ``D`` and ``dt_bias`` and the MoE router stay f32 in a bf16
    model), a ``sumsq`` launch ``mixed`` where its leaves' dtypes
    differ."""
    from repro_torch.models import model as M
    want = {"adamw_update": dict.fromkeys(opt.ADAMW_ROUTES, 0),
            "sumsq": dict.fromkeys(opt.SUMSQ_ROUTES, 0)}
    for cfg, steps in optimizer_steps(phase):
        leaves = [(t.numel(), t.dtype) for t in _leaves(M.init_params(
            cfg, torch.Generator(), device="meta"))]
        for _, dt in leaves:
            want["adamw_update"][opt.adamw_route(dt, dt)] += steps
        for first, n, _ in opt.sumsq_plan(leaves):
            want["sumsq"][opt.sumsq_route(
                dt for _, dt in leaves[first:first + n])] += steps
    return want


def attention_steps(phase: str) -> list:
    """(config, train steps on the card, microbatches a step, forward
    launches a layer) of a phase's runs on the training attention kernels:
    remat's recompute launches a second forward; every step launches one
    backward a layer and microbatch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import PRESETS
    if phase == "train":
        full = dataclasses.replace(get_config("codeqwen15_7b"),
                                   num_layers=TRAIN_FULL["layers"])
        two = dataclasses.replace(full, num_layers=2)
        return [*((PRESETS["tiny"], TRAIN_PARITY_STEPS,
                   kw.get("num_microbatches", 1), 2) for kw in TRAIN_PARITY),
                (PRESETS["tiny"], 2 * TRAIN_GRAPH_BITS_STEPS, 2, 2),
                # run_training's steps do not remat, nor the bits check's
                (PRESETS["lm100m"], lm100m_steps(), 1, 1),
                # the graph's and the eager columns' timed and profiled
                # steps (the FLOP-counted step and step 1's grads run the
                # plain attention, the side columns are ``side_steps``)
                # and each family's (``family_steps``)
                (full, full_width_steps("graph")
                 + full_width_steps("eager"), 1, 2),
                (two, 2 * TRAIN_GRAPH_BITS_STEPS + 2, 1, 2),
                (two, 2, 1, 1),               # remat off
                # each family's (its FLOP-counted step runs the plain
                # attention), and its step 1's grads on the kernels
                *((cfg, n + family_steps()["step1"], 1, 2)
                  for _, main, bits in family_configs()
                  for cfg, n in ((main, family_steps()["main"]),
                                 (bits, family_steps()["bits"]),
                                 (dataclasses.replace(main, dtype="float32"),
                                  0)))]
    if phase == "examples":
        preset, steps = TRAIN_LM
        return [(PRESETS[preset], steps, 1, 1)]
    return []


def attention_calls(cfg) -> int:
    """Full-sequence attention calls in one ``forward_train``."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period
    if cfg.family == "encdec":
        return cfg.num_encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def expected_attention_launches(ta, phase: str,
                                steps: Optional[list] = None) -> dict:
    """The training attention's launches a phase must make, by call
    (forward; backward: its delta, dQ and dK dV kernels once each) and
    route (``attention_steps``, on the route of the model's dtype and head
    dim)."""
    want = {n: dict.fromkeys(ta.ROUTES, 0) for n in
            ("train_attention_forward", "train_attention_backward")}
    for cfg, steps, micro, forwards in (attention_steps(phase)
                                        if steps is None else steps):
        if not attention_calls(cfg):          # the SSM family
            continue
        dt = cfg.torch_dtype
        r = ta.route(dt, dt, cfg.resolved_head_dim)
        n = attention_calls(cfg) * steps * micro
        want["train_attention_forward"][r] += n * forwards
        want["train_attention_backward"][r] += n
    return want


def side_steps(phase: str, which: str) -> list:
    """(config, steps) of the train step's side column ``which`` in
    ``phase`` (``train_full_width``, ``TRAIN_SIDE``: ``parent``, the
    unfused norms and rotations of ``unfused_norm_rope``; ``plain``, the
    gate's and the loss's plain ops of ``plain_gate_loss``; each beside
    every other kernel, its timed steps and one profiled, remat; its
    optimizer launches are among ``optimizer_steps``')."""
    import dataclasses

    from repro_torch.configs import get_config
    if phase != "train":
        return []
    return [(dataclasses.replace(get_config("codeqwen15_7b"),
                                 num_layers=TRAIN_FULL["layers"]),
             full_width_steps(which))]


def expected_train_launches(torch, mods, phase: str) -> dict:
    """The optimizer's and the training attention's expected launches: the
    phase's steps, and the training attention's in the train step's
    side columns (``side_steps``)."""
    ta = mods["train_attention_forward"]
    want = {**expected_optimizer_launches(torch, mods["adamw_update"],
                                          phase),
            **expected_attention_launches(ta, phase)}
    more = expected_attention_launches(
        ta, phase, steps=[(c, n, 1, 2) for w in TRAIN_SIDE
                          for c, n in side_steps(phase, w)])
    for k, by in more.items():
        want[k] = {r: n + by[r] for r, n in want[k].items()}
    return want


def device_counts(mods) -> tuple:
    """The optimizer's and the training attention's device counters."""
    opt, ta = mods["adamw_update"], mods["train_attention_forward"]
    return opt.kernel_launches(opt._lib()), ta.kernel_launches(ta._lib())


def device_delta(mods, before: tuple) -> dict:
    """Device launches since ``before`` (``device_counts``): the optimizer
    kernels by name, the training attention by call (its forward kernel;
    its backward's kernels, which must agree: delta, dQ and dK dV once
    each, on ``DELTA_IN_DQ``'s route dQ and dK dV and no delta)."""
    after = device_counts(mods)
    folded = mods["train_attention_forward"].DELTA_IN_DQ
    opt, ta = ({k: {r: n - b[k][r] for r, n in by.items()}
                for k, by in a.items()} for a, b in zip(after, before))
    delta = {r: 0 if r in folded else n for r, n in ta["dq"].items()}
    if not (ta["delta"] == delta and ta["dkdv"] == ta["dq"]):
        fail(f"the training attention's backward kernels launched "
             f"unequally: {ta}")
    return {**opt, "train_attention_forward": ta["forward"],
            "train_attention_backward": ta["dq"]}


def check_phase_launches(phase: str, launches: dict, by_route: dict,
                         device: dict, want: dict, host: bool) -> None:
    """No serve kernel launched (flash, SSD, decode); each kernel of
    ``want`` (the optimizer's, the training attention's) exactly ``want``
    by route on the device and, with ``host`` (no train step was captured
    in the phase: a capture launches on the host and not on the device, a
    replay the other way round), on the host too."""
    others = {n: c for n, c in launches.items() if n not in want}
    if any(others.values()):
        fail(f"the {phase} phase launched kernels: {others}")
    got = {n: by_route[n] for n in want}
    if {n: device[n] for n in want} != want or (host and got != want):
        fail(f"the {phase} phase's train kernel launches: host {got}, "
             f"device {device}, expected {want}")


def train_graph_counts() -> dict:
    from repro_torch.train.steps import TrainGraph
    return dict(TrainGraph.counts)


def graph_delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in train_graph_counts().items()}


def train_step_bound(cfg, params, batch: int, seq: int) -> dict:
    """The least time of one train step on the card, from the work it must
    do on ``batch`` sequences of ``seq`` tokens.

    Operations: 6 x the parameters a token passes through x the tokens
    (every layer parameter and the head, not the embedding gather; a MoE
    layer's experts at top_k / num_experts of theirs, its router's f32
    product; the hybrid's shared block once a call; whisper's encoder
    layers and its cross attention's K and V projections over the
    encoder's ``seq // encoder_ratio`` tokens), plus the attention's
    visible pairs (QK^T and PV, forward and backward: 12 x heads x
    head_dim a pair a call; whisper's encoder every pair, its cross
    attention S x T), plus Mamba2's chunked SSD products (each chunk's
    C B^T over the causal pairs in a chunk, once a group of B and C: the
    scan repeats a group's product for each of its heads, which the
    function does not need; a head's scores times x over those pairs, the
    chunk states and the states read back a token; forward and backward:
    3 x the forward's), each at the peak of its dtype's (989 TFLOP/s bf16,
    67 f32: the router, and the SSD scan but for C B^T, are f32 in the
    reference).  Remat's recomputed forward is not counted: the bound is
    the work the step needs.  Bytes: the optimizer reads and writes every
    parameter once: the param read and written and the grad read in the
    params' dtype, m and v read and written in f32 (22 B a param in
    bf16), at 3.35 TB/s.  The two times are added: the update waits for
    the last grad."""
    def numel(tree):
        return sum(t.numel() for t in _leaves(tree))
    from repro_torch.models import model as M
    f32, dt = "torch.float32", str(cfg.torch_dtype)
    flops = {dt: 0.0, f32: 0.0}
    tokens = batch * seq
    es = params["embed"].element_size()
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    layers = params["layers"]
    through = numel(layers) + head.numel()
    heads, hd = cfg.num_heads, cfg.resolved_head_dim

    def attention(calls, sq, sk, causal, window=0):
        flops[dt] += (calls * 12 * batch * heads * hd
                      * visible_pairs(sq, sk, causal, window))
    if cfg.family in ("dense", "vlm", "moe"):
        for w in set(M.layer_windows(cfg)):
            attention(M.layer_windows(cfg).count(w), seq, seq, True, w)
    if cfg.family == "moe":
        moe = layers["moe"]
        experts = numel(moe) - moe["router"].numel()
        through -= numel(moe) - experts * cfg.top_k // cfg.num_experts
        flops[f32] += 6 * moe["router"].numel() * tokens
    if cfg.family in ("ssm", "hybrid"):
        h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        q = min(cfg.ssm_chunk, seq)
        pairs = seq // q * visible_pairs(q, q, True, 0)
        mix = 3 * cfg.num_layers * batch
        flops[dt] += mix * cfg.ssm_groups * 2 * n * pairs     # C B^T
        flops[f32] += mix * h * (2 * p * pairs + 4 * n * p * seq)
    if cfg.family == "hybrid":
        calls = M._shared_groups(cfg)
        through += calls * numel(params["shared"])
        attention(calls, seq, seq, True)
    if cfg.family == "encdec":
        enc = max(seq // cfg.encoder_ratio, 1)
        kv = numel({k: v for k, v in layers["cross"].items()
                    if k in ("wk", "wv", "bk", "bv")})
        through -= kv
        flops[dt] += 6 * (numel(params["enc_layers"]) + kv) * batch * enc
        attention(cfg.num_encoder_layers, enc, enc, False)
        attention(cfg.num_layers, seq, seq, True)
        attention(cfg.num_layers, seq, enc, False)
    flops[dt] += 6 * through * tokens
    opt_bytes = numel(params) * (3 * es + 16)
    flops_ms = sum(n / H100_PEAK_FLOPS[k] * 1e3 for k, n in flops.items())
    bytes_ms = opt_bytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": flops_ms + bytes_ms, "bound_flops_ms": flops_ms,
            "bound_optimizer_ms": bytes_ms, "flops": sum(flops.values()),
            "flops_by_dtype": flops, "optimizer_bytes": opt_bytes,
            "params": numel(params), "params_through": through}


def _batch_to(torch, batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_parity(torch):
    """(a) The ``tiny`` preset's train step on the card against the port on
    the CPU, from one seeded state, 4 steps each with one and with two
    microbatches and with int8 compression: losses and grad norms within
    1e-4 relative (f32, TF32 off; the two devices sum in other orders)."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import PRESETS
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import tree_map
    cfg = PRESETS["tiny"]
    worst = 0.0
    for kw in TRAIN_PARITY:
        cpu = train_state_init(cfg, torch.Generator().manual_seed(0),
                               compress=kw.get("compress", False),
                               device="cpu")
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        step = make_train_step(cfg, peak_lr=1e-2, warmup_steps=1,
                               total_steps=8, **kw)
        rows = []
        for i in range(TRAIN_PARITY_STEPS):
            b = synthetic_batch(5, 0, i, 4, 32, cfg.vocab_size)
            cpu, mc = step(cpu, _batch_to(torch, b, "cpu"))
            gpu, mg = step(gpu, _batch_to(torch, b, "cuda"))
            for k in ("loss", "grad_norm"):
                want, got = float(mc[k]), float(mg[k])
                rel = abs(got - want) / abs(want)
                worst = max(worst, rel)
                rows.append({"step": i, "metric": k, "cpu": want,
                             "cuda": got, "rel_err": rel})
                if not (rel <= 1e-4):
                    fail(f"tiny {kw}: step {i} {k} {got} on the card, "
                         f"{want} on the CPU")
        emit("train_parity", config=cfg.name, options=kw,
             steps=TRAIN_PARITY_STEPS, rows=rows)
    return worst


@contextlib.contextmanager
def host_copies(state):
    """Another thread copying every leaf of ``state`` to the host, as the
    engine's checkpoint app does (``CheckpointManager.save_async``: a
    synchronous copy on that thread's stream), round after round while the
    block runs (the first round started before it); yields the list of
    rounds' (start, end) ``time.perf_counter`` pairs, whole once the block
    has ended."""
    from repro_torch.tree import leaves
    stop, started, spans = threading.Event(), threading.Event(), []

    def copy():
        while not stop.is_set():
            t0 = time.perf_counter()
            started.set()
            for t in leaves(state):
                t.to("cpu", copy=True)
            spans.append((t0, time.perf_counter()))
    worker = threading.Thread(target=copy, daemon=True)
    worker.start()
    started.wait()
    try:
        yield spans
    finally:
        stop.set()
        worker.join()


def bits_row(torch, i: int, eager_state, graph_state, em: dict,
             gm: dict) -> dict:
    """Step ``i`` of a bits check: the graph step's loss and grad norm and
    what differs from the eager step's (``differ``: the state's leaves by
    path, then the metrics, each to the bit)."""
    from repro_torch.tree import leaves, leaves_with_path
    bad = [path for (path, x), y in zip(leaves_with_path(eager_state),
                                        leaves(graph_state))
           if not same_bits(torch, x, y)]
    bad += [k for k in em if not same_bits(torch, em[k], gm[k])]
    return {"step": i, "replayed": i > 0, "loss": float(gm["loss"]),
            "grad_norm": float(gm["grad_norm"]), "differ": bad}


def train_graph_bits(torch) -> dict:
    """(b) Replayed steps equal eager steps to the bit: from equal states,
    ``TRAIN_GRAPH_BITS_STEPS`` steps eager (``graph=False``) and through
    the graph (``graph=True``: the first step the warm-up, which captures,
    the rest replays), each on its own batch: params, m, v, the step, the
    residual, the loss, the grad norm and the lr after every step.  On
    lm100m (f32, not donated: the engine's step), tiny (2 microbatches,
    int8 compression, donated) and codeqwen1.5-7b at full width cut to 2
    layers (bf16, remat, donated, 8 x 512 tokens); lm100m's first graph
    step (its warm-up and capture) runs beside another thread copying a
    state to the host (``host_copies``, the checkpoint app's copies), at
    least one round of which must overlap the capture.  Then lm100m's
    pacing:
    ``TRAIN_PACE_STEPS`` steps eager and through the graph on the host
    clock (each ended by a synchronise), and the replay's device span
    alone (``device_span_ms``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import PRESETS
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import leaves, tree_map
    two = dataclasses.replace(get_config("codeqwen15_7b"), num_layers=2)
    cases = (("lm100m", PRESETS["lm100m"], dict(remat=False), (8, 128)),
             ("tiny", PRESETS["tiny"], dict(num_microbatches=2,
                                            compress=True, donate=True),
              (4, 32)),
             ("codeqwen_2", two, dict(remat=True, donate=True), (8, 512)))
    out = {}
    for name, cfg, kw, (b, seq) in cases:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        eager_state = train_state_init(cfg, gen, device="cuda",
                                       compress=kw.get("compress", False))
        graph_state = tree_map(torch.clone, eager_state)
        steps = {g: make_train_step(cfg, peak_lr=1e-3, warmup_steps=1,
                                    total_steps=10, graph=g, **kw)
                 for g in (False, True)}
        rows, differ = [], []
        for i in range(TRAIN_GRAPH_BITS_STEPS):
            batch = _batch_to(torch, synthetic_batch(
                13, 0, i, b, seq, cfg.vocab_size), "cuda")
            eager_state, em = steps[False](eager_state, batch)
            if i == 0 and name == "lm100m":
                # the engine's checkpoint app copies a state to the host in
                # its own thread while the next step may be capturing: the
                # rounds that overlapped the capture (the first step's end)
                with host_copies(eager_state) as spans:
                    graph_state, gm = steps[True](graph_state, batch)
                    end = time.perf_counter()
                begin = end - steps[True].graph.capture_ms / 1e3
                beside = sum(t0 < end and t1 > begin for t0, t1 in spans)
                if beside < 1:
                    fail(f"{name}: no copy to the host ran beside the "
                         f"capture ({spans}, capture {begin}-{end})")
            else:
                graph_state, gm = steps[True](graph_state, batch)
            rows.append(bits_row(torch, i, eager_state, graph_state, em, gm))
            differ += [f"step {i}: {k}" for k in rows[-1]["differ"]]
        g = steps[True].graph
        out[name] = dict(dtype=cfg.dtype, options=kw, batch=b, seq=seq,
                         steps=rows, capture_ms=g.capture_ms,
                         replays=g.replays, bitwise=not differ,
                         leaves=len(leaves(graph_state)))
        if name == "lm100m":
            out[name]["host_copy_rounds_beside_capture"] = beside
        if name == "lm100m":
            batch = _batch_to(torch, synthetic_batch(
                13, 0, 0, b, seq, cfg.vocab_size), "cuda")

            def one(which):
                nonlocal eager_state, graph_state
                if which == "graph":
                    graph_state, _ = steps[True](graph_state, batch)
                else:
                    eager_state, _ = steps[False](eager_state, batch)
            pace = {}
            for which in ("eager", "graph"):
                times = []
                for _ in range(TRAIN_PACE_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    one(which)
                    torch.cuda.synchronize()
                    times.append((time.monotonic() - t0) * 1e3)
                pace[f"{which}_step_ms"] = sorted(times)[
                    TRAIN_PACE_STEPS // 2]
                pace[f"{which}_all"] = times
            # a replayed step's device span: the batch and the state copied
            # in, the replay, the state and the metrics copied out
            spans = [device_span_ms(torch, lambda: one("graph"))
                     for _ in range(TRAIN_PACE_STEPS)]
            pace.update(graph_device_ms=sorted(spans)[TRAIN_PACE_STEPS // 2],
                        graph_device_all=spans)
            out[name]["pace"] = pace
        for step in steps.values():
            step.close()
        del eager_state, graph_state, steps, g, em, gm
        gc.collect()
        torch.cuda.empty_cache()
        if differ:
            emit("train_graph_bits", case=name, **out[name])
            fail(f"{name}: replayed steps differ from eager ones: "
                 f"{differ[:8]}")
    emit("train_graph_bits", cases=out)
    return out


def train_engine(torch):
    """(c) ``run_training(lm100m)`` through the engine on the card, at the
    driver's defaults (its step through the train step's CUDA graph, not
    donated), with checkpoints under ``chiprun_out/``: its losses equal
    the same 40 steps run in a plain loop on the card (the same init,
    batches and step, without the engine) within 1e-4 relative; the last
    checkpoint restores bit for bit; a resumed run starts from the saved
    step.  The plain loop runs through the graph and eagerly
    (``graph=False``): their walls (the same host reads of the loss each
    step) say what the engine adds and what the graph takes away.  Then
    the engine without checkpoints, eager and through the graph in turns
    (``TRAIN_ENGINE_TURNS``), each run's losses within 1e-4 of the plain
    loop's.  Whether the loss falls is reported, not required: at these
    defaults the reference's own run does not lower it in 40 steps
    (``PERF.md``)."""
    import shutil

    import numpy as np
    from repro_torch.checkpointing import latest_step, load_checkpoint
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import PRESETS, run_training
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import leaves
    cfg = PRESETS["lm100m"]
    ckpt = PROFILE_DIR / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    e = TRAIN_ENGINE
    kw = dict(shards=e["shards"], batch_per_shard=e["batch_per_shard"],
              seq=e["seq"], device="cuda")
    saving = dict(ckpt_dir=str(ckpt), ckpt_every=e["ckpt_every"])
    torch.cuda.reset_peak_memory_stats()
    res = run_training(cfg, steps=e["steps"], **kw, **saving)
    peak = torch.cuda.max_memory_allocated()
    saved = latest_step(str(ckpt))
    _, back = load_checkpoint(str(ckpt), res["final_state"])
    exact = all(torch.equal(a, b) for a, b in
                zip(leaves(back), leaves(res["final_state"])))
    del back, res["final_state"]
    gc.collect()
    torch.cuda.empty_cache()

    # the same run without the engine: run_training's init, batch recipe
    # and step, one state alive at a time
    direct, direct_s = {}, {}
    for graph in (None, False):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        state = train_state_init(cfg, gen, device="cuda")
        step = make_train_step(cfg, peak_lr=1e-3,
                               warmup_steps=max(e["steps"] // 10, 1),
                               total_steps=e["steps"], remat=False,
                               graph=graph)
        which = "eager" if graph is False else "graph"
        direct[which] = []
        t0 = time.monotonic()
        for it in range(e["steps"]):
            parts = [synthetic_batch(17, s, it, e["batch_per_shard"],
                                     e["seq"], cfg.vocab_size)
                     for s in range(e["shards"])]
            batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])
                                         ).to("cuda") for k in parts[0]}
            state, m = step(state, batch)
            direct[which].append(float(m["loss"]))
        direct_s[which] = time.monotonic() - t0
        step.close()
        del state, m, step
    gc.collect()
    torch.cuda.empty_cache()
    losses = direct["graph"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], losses))
    tokens = e["shards"] * e["batch_per_shard"] * e["seq"]
    emit("train_engine", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, steps=e["steps"],
         tokens_per_step=tokens,
         wall_s=res["wall_s"], tokens_per_s=res["tokens_per_s"],
         first_loss=res["first_loss"], last_loss=res["last_loss"],
         loss_falls=res["last_loss"] < res["first_loss"],
         losses=res["losses"], direct_losses=losses, direct_s=direct_s,
         direct_tokens_per_s={w: tokens * e["steps"] / t
                              for w, t in direct_s.items()},
         direct_eager_equal=direct["eager"] == losses,
         max_rel_err_vs_direct=rel, drops=res["drops"],
         final_step=res["final_step"], checkpoint_step=saved,
         checkpoint_exact=exact, max_memory_allocated=peak)
    if not rel <= 1e-4:
        fail(f"lm100m through the engine: losses {res['losses']}, without "
             f"it {losses}")
    if direct["eager"] != losses:
        fail(f"lm100m's plain loop: eager losses {direct['eager']}, "
             f"through the graph {losses}")
    if saved != e["steps"] or res["final_step"] != e["steps"] or not exact:
        fail(f"lm100m checkpoint: saved step {saved}, final step "
             f"{res['final_step']}, restored exactly: {exact}")
    gc.collect()
    torch.cuda.empty_cache()
    again = run_training(cfg, steps=e["resume_steps"], resume=True, **kw,
                         **saving)
    emit("train_resume", config=cfg.name, start_step=again["start_step"],
         final_step=again["final_step"], wall_s=again["wall_s"],
         losses=again["losses"])
    if again["start_step"] != e["steps"] or \
            again["final_step"] != e["steps"] + e["resume_steps"]:
        fail(f"resume started at {again['start_step']}, ended at "
             f"{again['final_step']}")
    del again
    shutil.rmtree(ckpt)       # 1.4 GB a step: too large to keep

    # the engine without checkpoints, eager and through the graph in turns
    turns = {"graph": [], "eager": []}
    for which in TRAIN_ENGINE_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        run = run_training(cfg, steps=e["steps"], log_every=0, **kw,
                           graph=False if which == "eager" else None)
        worst = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                         losses))
        turns[which].append({"wall_s": run["wall_s"],
                             "tokens_per_s": run["tokens_per_s"],
                             "max_rel_err_vs_direct": worst})
        del run
        if not worst <= 1e-4:
            fail(f"lm100m through the engine, {which}: losses off the "
                 f"plain loop's by {worst} relative")
    emit("train_engine_turns", config=cfg.name, steps=e["steps"],
         tokens_per_step=tokens, order=list(TRAIN_ENGINE_TURNS),
         **{w: dict(runs=r, wall_s=sum(x["wall_s"] for x in r) / len(r),
                    tokens_per_s=sum(x["tokens_per_s"] for x in r) / len(r))
            for w, r in turns.items()},
         direct_s=direct_s)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_full_width(torch):
    """(d) codeqwen1.5-7b at full width, cut to 16 of 32 layers, one
    donated, rematerialised step on 8 x 512 tokens, repeated on one batch:
    the first loss equals ``forward_train``'s, step 1's loss and grad norm
    are the plain attention's (its grads of the same state and batch, under
    ``plain_train_attention``), the loss falls on the graph's steps, grad
    norms are finite.  Four columns in turns on one state
    (``TRAIN_TURNS``): the step through its CUDA graph (the main path; its
    first step the warm-up, which captures), the same step eager
    (``graph=False``), eager on the parent's route (``unfused_norm_rope``)
    and eager on the gate's and the loss's plain ops (``plain_gate_loss``),
    each timed on the host clock
    (the eager columns' optimizer and global norm device spans by CUDA
    events, ``scoped_optimizer``: under a graph a Python patch applies only
    at the capture) with its peaks of allocated, requested and reserved
    bytes; each column's first ``TRAIN_SKIP`` steps are left out of its
    median.  Then one step of each profiled: the eager ones split by part
    and elementwise family (``train_split``), the replay by its kernels'
    names in the eager step's proportions (``replay_split``: a replay's
    kernels have no ATen op above them), printed as the ``train_profile``
    line (idle: the column's step ms less its profiled busy time); and one
    eager step FLOP-counted on the plain attention (``FlopCounterMode``
    sees neither the kernels nor a replay).  The eager kernels' peak of
    requested bytes must not pass the parent route's, nor the plain gate
    and loss's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw as A
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.train.steps import _grads
    f = TRAIN_FULL
    cfg = dataclasses.replace(get_config("codeqwen15_7b"),
                              num_layers=f["layers"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = train_state_init(cfg, gen, device="cuda")
    batch = _batch_to(torch, synthetic_batch(
        7, 0, 0, f["batch"], f["seq"], cfg.vocab_size), "cuda")
    bound = train_step_bound(cfg, state.params, f["batch"], f["seq"])
    with torch.inference_mode():
        ref = float(M.forward_train(state.params, cfg, batch)[0])
    with plain_train_attention(), plain_optimizer():
        plain_loss, grads = _grads(lambda params, mb: M.forward_train(
            params, cfg, mb, remat=True)[0], state.params, batch)
        plain_first = {"loss": float(plain_loss),
                       "grad_norm": float(A.global_norm(grads))}
    del grads, plain_loss
    gc.collect()
    torch.cuda.empty_cache()
    dims = train_dims(cfg, f["seq"])
    steps = {g: make_train_step(cfg, peak_lr=f["peak_lr"], warmup_steps=1,
                                total_steps=10, remat=True, donate=True,
                                graph=g) for g in (True, False)}
    step_of = {"graph": steps[True], "eager": steps[False],
               "parent": steps[False], "plain": steps[False]}
    holder = [state]
    del state
    runs = {w: dict(times=[], spans=[], metrics=[], peaks=[], requested=[],
                    reserved=[]) for w in TRAIN_SKIP}
    for which in TRAIN_TURNS:
        run = runs[which]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with TRAIN_SIDE.get(which, contextlib.nullcontext)():
            t0 = time.monotonic()
            with (scoped_optimizer(run["spans"]) if which != "graph"
                  else contextlib.nullcontext()):
                holder[0], m = step_of[which](holder[0], batch)
            torch.cuda.synchronize()
        run["times"].append((time.monotonic() - t0) * 1e3)
        run["metrics"].append({k: float(v) for k, v in m.items()})
        run["peaks"].append(torch.cuda.max_memory_allocated())
        run["requested"].append(
            torch.cuda.memory_stats()["requested_bytes.all.peak"])
        run["reserved"].append(torch.cuda.max_memory_reserved())
    graph = steps[True].graph
    peak = max(runs["graph"]["peaks"])

    def one_step(which):
        def run():
            holder[0], _ = step_of[which](holder[0], batch)
        return run

    def profiled(which, plain, table: str) -> dict:
        """One eager step under ``plain`` (a context that selects plain
        versions, or none) profiled and split by part."""
        with plain(), scoped_optimizer():
            return profile_call(torch, one_step(which), table, split=dims)
    prof = profiled("eager", contextlib.nullcontext,
                    "profile_train_step_eager.txt")
    prof_side = {w: profiled(w, side, f"profile_train_step_{w}.txt")
                 for w, side in TRAIN_SIDE.items()}
    prof_graph = profile_call(torch, one_step("graph"),
                              "profile_train_step.txt", replay=prof)
    from torch.utils.flop_counter import FlopCounterMode
    with plain_train_attention(), \
            FlopCounterMode(display=False) as counted:     # one more step
        one_step("eager")()

    def column(which: str, prof_: dict) -> dict:
        run = runs[which]
        kept = run["times"][TRAIN_SKIP[which]:]
        ms = sorted(kept)[len(kept) // 2]
        return dict(step_ms=ms, step_ms_all=run["times"],
                    span_ms=(span_ms(run["spans"], len(run["times"]),
                                     skip=TRAIN_SKIP[which])
                             if run["spans"] else None),
                    profiled_wall_ms=prof_["wall_ms"],
                    device_busy_ms=prof_["device_busy_ms"],
                    idle_ms=max(0.0, ms - prof_["device_busy_ms"]),
                    max_memory_allocated=max(run["peaks"]),
                    max_memory_allocated_steps=run["peaks"],
                    requested_peak_steps=run["requested"],
                    requested_peak=max(run["requested"][1:]),
                    reserved_peak_steps=run["reserved"],
                    reserved_peak=max(run["reserved"]),
                    **prof_["split"])
    cols = {"graph": column("graph", prof_graph),
            "eager": column("eager", prof),
            **{w: column(w, p) for w, p in prof_side.items()}}
    cols["graph"].update(capture_ms=graph.capture_ms, replays=graph.replays)
    step_ms = cols["graph"]["step_ms"]
    card = {"flops": counted.get_total_flops(), "batch": f["batch"],
            "seq": f["seq"], "layers": cfg.num_layers, "step_ms": step_ms,
            "bound_ms": bound["bound_ms"],
            "bound_flops_ms": bound["bound_flops_ms"]}
    for step in steps.values():
        step.close()
    del holder, graph, steps, step_of
    gc.collect()
    torch.cuda.empty_cache()
    metrics, times = runs["graph"]["metrics"], runs["graph"]["times"]
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    free_gb = (torch.cuda.get_device_properties(0).total_memory - peak) / 1e9
    emit("train_profile", config=cfg.name, layers=cfg.num_layers,
         turns=list(TRAIN_TURNS), skip=TRAIN_SKIP, **cols,
         requested_peak_saved_bytes={
             w: cols[w]["requested_peak"] - cols["eager"]["requested_peak"]
             for w in TRAIN_SIDE})
    emit("train_step", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, batch=f["batch"], seq=f["seq"],
         remat=True, donate=True, graph=True, step_ms=step_ms,
         step_ms_all=times, eager_step_ms=cols["eager"]["step_ms"],
         tokens_per_s=f["batch"] * f["seq"] / step_ms * 1e3,
         forward_train_loss=ref, plain_attention_step_1=plain_first,
         losses=losses, grad_norms=norms,
         lrs=[m["lr"] for m in metrics], max_memory_allocated=peak,
         free_gb_at_peak=free_gb, **bound, profile=prof_graph)
    if abs(losses[0] - ref) > 1e-3 * abs(ref):
        fail(f"{cfg.name}: first step's loss {losses[0]}, forward_train "
             f"{ref}")
    # bf16 activations: the two routes' attention outputs differ by at most
    # one bf16 rounding an element, through 16 bf16 layers (the rule of
    # forward_train's check for the loss, train_remat's for the norm)
    if abs(losses[0] - plain_first["loss"]) > 1e-3 * abs(plain_first["loss"]) \
            or abs(norms[0] - plain_first["grad_norm"]) > \
            1e-2 * abs(plain_first["grad_norm"]):
        fail(f"{cfg.name}: step 1 on the kernels: loss {losses[0]}, grad "
             f"norm {norms[0]}; on the plain attention {plain_first}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name}: loss on the repeated batch {losses}")
    if not all(math.isfinite(n) for n in norms):
        fail(f"{cfg.name}: grad norms {norms}")
    if free_gb < 8:
        fail(f"{cfg.name}: {free_gb:.1f} GB free at the step's peak")
    # the fused norms save h' (which the unfused norm saved as its input)
    # and RoPE's biases no activation, the gate and loss kernels no more
    # than their plain ops: the eager step's peak of requested bytes (the
    # allocator's unsplit-block slack, up to 1 MiB a block, left out) must
    # not grow over the parent route's nor the plain gate and loss's, each
    # column's first step (the run's first-call allocations) left out
    for w, what in (("parent", "the parent's route"),
                    ("plain", "the plain gate and loss")):
        if cols["eager"]["requested_peak"] > cols[w]["requested_peak"]:
            fail(f"{cfg.name}: requested peak "
                 f"{cols['eager']['requested_peak']} bytes on the kernels, "
                 f"{cols[w]['requested_peak']} on {what}")
    return cfg, batch, card


def train_remat(torch, cfg, batch):
    """(d) At a 2-layer cut of the same width, two functional steps with
    and without remat from one state (the second a replay): loss and grad
    norm within 1e-2 relative (bf16; recomputation repeats the same ops, so
    they should be equal)."""
    import dataclasses

    from repro_torch.train import make_train_step, train_state_init
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = train_state_init(cfg2, gen, device="cuda")
    out = {}
    for remat in (True, False):
        step = make_train_step(cfg2, warmup_steps=1, remat=remat)
        new, m1 = step(state, batch)
        _, m2 = step(new, batch)
        out[remat] = [{k: float(m[k]) for k in ("loss", "grad_norm")}
                      for m in (m1, m2)]
        step.close()
        del m1, m2, new, _, step
    del state
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_remat", config=cfg2.name, layers=2, remat=out[True],
         no_remat=out[False])
    for i in range(2):
        for k in ("loss", "grad_norm"):
            a, b = out[True][i][k], out[False][i][k]
            if abs(a - b) > 1e-2 * abs(b):
                fail(f"remat changes step {i}'s {k}: {out}")


def plain_route():
    """Every train kernel's plain version on the card, for a family's step
    1 against the plain route (``plain_kernels`` of every part)."""
    return plain_kernels(PLAIN_PARTS)


def step1_grads(torch, cfg, params, batch, parts=()) -> tuple:
    """Step 1's loss (a float) and grads of ``params`` on ``batch``
    (``forward_train``, rematerialised, as a train step takes them), the
    kernels of ``parts`` on their plain versions (``plain_kernels``)."""
    from repro_torch.models import model as M
    from repro_torch.train.steps import _grads
    with plain_kernels(parts):
        loss, grads = _grads(lambda p_, mb: M.forward_train(
            p_, cfg, mb, remat=True)[0], params, batch)
    return float(loss), grads


def grad_norm(grads) -> float:
    """The global norm of ``grads`` by the optimizer's plain version."""
    from repro_torch.optim import adamw as A
    with plain_optimizer():
        return float(A.global_norm(grads))


def family_state(torch, cfg) -> tuple:
    """A family's step-1 params and batch on the card: params drawn in f32
    from seed 0 and rounded to ``cfg``'s dtypes (each leaf's own: the
    SSM's and the router's f32 leaves stay f32), and ``family_batch``'s
    batch of seed 7."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = tree_map(lambda t, r: t.to(r.dtype),
                      M.init_params(dataclasses.replace(cfg, dtype="float32"),
                                    gen, device="cuda"),
                      M.init_params(cfg, torch.Generator(), device="meta"))
    return params, family_batch(torch, cfg, 7)


# step 1's routes: (name, the parts on their plain versions, in f32)
STEP1_ROUTES = (("plain_f32", PLAIN_PARTS, True), ("kernels_f32", (), True),
                ("plain", PLAIN_PARTS, False), ("kernels", (), False))


def grad_errors(grads, ref) -> dict:
    """Each leaf's squared error against ``ref``'s grads and ``ref``'s
    squared norm (a stacked leaf's error by layer too)."""
    from repro_torch.tree import leaves_with_path
    out = {}
    for (path, g), (_, r) in zip(leaves_with_path(grads),
                                 leaves_with_path(ref)):
        d = (g.float() - r.float()).flatten(1 if g.dim() > 1 else 0)
        r = r.float().flatten(1 if g.dim() > 1 else 0)
        out[path] = dict(
            sq=float(d.square().sum()), ref_sq=float(r.square().sum()),
            by_row=(d.norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)
                    ).tolist() if g.dim() > 2 else None)
    return out


def step1_on_routes(torch, cfg, routes=STEP1_ROUTES) -> tuple:
    """Step 1 of ``cfg``'s family (``family_state``) on each of ``routes``
    ((name, plain parts, f32), ``STEP1_ROUTES``' form): its loss, grad
    norm, and its grads' error against the f32 plain route's and against
    the plain route's in the config's dtype, where those ran first
    (``err_<route>``: |g - g_ref| / |g_ref| over every leaf), with the
    three leaves of most squared error against the f32 plain route
    ((leaf, its error, its share)); and the loss and the grad norm
    relative to those routes'.  Returns (rows by route, each error by
    leaf)."""
    import dataclasses

    from repro_torch.tree import tree_map
    params, batch = family_state(torch, cfg)
    # the f32 routes read the same values upcast
    last_f32 = max((i for i, r in enumerate(routes) if r[2]), default=-1)
    if last_f32 >= 0:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        batch32 = {k: v.float() if v.is_floating_point() else v
                   for k, v in batch.items()}
    refs, rows, detail = {}, {}, {}
    for i, (name, parts, f32) in enumerate(routes):
        loss, grads = (step1_grads(torch, cfg32, params32, batch32, parts)
                       if f32 else step1_grads(torch, cfg, params, batch,
                                               parts))
        row = dict(loss=loss, grad_norm=grad_norm(grads))
        for ref in ("plain_f32", "plain"):
            if ref in refs:
                errs = grad_errors(grads, refs[ref])
                total = sum(e["sq"] for e in errs.values())
                row[f"err_{ref}"] = math.sqrt(
                    total / sum(e["ref_sq"] for e in errs.values()))
                if ref == "plain_f32":
                    row["top_err_plain_f32"] = [
                        [k, math.sqrt(e["sq"] / max(e["ref_sq"], 1e-30)),
                         e["sq"] / max(total, 1e-30)] for k, e in sorted(
                            errs.items(), key=lambda kv: -kv[1]["sq"])[:3]]
                detail[f"{name}_vs_{ref}"] = errs
        if name in ("plain_f32", "plain"):
            refs[name] = grads
        rows[name] = row
        del grads
        if i == last_f32:
            del params32, batch32
            gc.collect()
            torch.cuda.empty_cache()
    for row in rows.values():
        for k in ("loss", "grad_norm"):
            for ref in ("plain_f32", "plain"):
                if ref in rows:
                    row[f"{k}_vs_{ref}"] = ((row[k] - rows[ref][k])
                                            / rows[ref][k])
    del refs, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rows, detail


# the route search's parts, each sent alone to its plain version
# (``kernels_but_<part>``) or alone kept on its kernels (``plain_but_<part>``,
# the fused entry points' part with it where the part is one of them)
SEARCH_PARTS = ("attention", "norms", "add_norm", "gated_norm", "gate",
                "loss")


def step1_routes(torch) -> dict:
    """``--step1-routes``: each family's step 1 (``step1_on_routes``) at
    full width, at ``TRAIN_FAMILIES``' depth on ``STEP1_ROUTES`` and with
    each of ``SEARCH_PARTS`` alone moved to its plain version or alone
    kept on its kernels, and at the bits check's depth on
    ``STEP1_ROUTES``; every leaf's errors (each stacked leaf's by layer)
    to ``step1_routes.json``.  Returns the ``step1_routes`` lines."""
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    out, detail = {}, {}
    for _, cfg, bits_cfg in family_configs():
        routes = list(STEP1_ROUTES)
        for part in SEARCH_PARTS:
            both = {part, "fused"} if part.endswith("_norm") else {part}
            routes += [(f"kernels_but_{part}", (part,), False),
                       (f"plain_but_{part}", tuple(
                           p for p in PLAIN_PARTS if p not in both), False)]
        for c, rs in ((cfg, routes), (bits_cfg, STEP1_ROUTES)):
            t0 = time.monotonic()
            rows, detail[f"{c.name}_{c.num_layers}"] = step1_on_routes(
                torch, c, rs)
            out[f"{c.name}_{c.num_layers}"] = row = dict(
                config=c.name, layers=c.num_layers, routes=rows,
                seconds=time.monotonic() - t0)
            emit("step1_routes", **row)
    (PROFILE_DIR / "step1_routes.json").write_text(json.dumps(detail))
    return out


def family_batch(torch, cfg, seed: int, step: int = 0) -> dict:
    """A train batch of ``FAMILY_TRAIN``'s shape on the card (``seed``,
    ``step``: ``synthetic_batch``'s); encdec's ``frames`` (B, seq //
    encoder_ratio, d_model) drawn from a normal of the same seeds, in the
    config's dtype (the reference's train input)."""
    from repro_torch.data import synthetic_batch
    f = FAMILY_TRAIN
    batch = _batch_to(torch, synthetic_batch(
        seed, 0, step, f["batch"], f["seq"], cfg.vocab_size), "cuda")
    if cfg.family == "encdec":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed * 1000 + step)
        batch["frames"] = torch.randn(
            (f["batch"], max(f["seq"] // cfg.encoder_ratio, 1), cfg.d_model),
            generator=gen, device="cuda").to(cfg.torch_dtype)
    return batch


def family_bits(torch, cfg) -> tuple:
    """A family's replays against its eager steps to the bit, as
    ``train_graph_bits`` holds codeqwen's: from equal states at ``cfg``'s
    depth, ``TRAIN_GRAPH_BITS_STEPS`` donated, rematerialised steps eager
    and through the graph (the first the warm-up, which captures), each
    on its own batch: params, m, v, the step, the loss, the grad norm and
    the lr after every step.  Then one more eager step profiled and split
    by part (``train_split``, the plain SSD and MoE ops parts of their
    own: ``scoped_plain_ops``), whose kernels' shares by name split the
    full-depth steps' profiles (``profile_kernels``).  Returns (the bits
    check's row, that profile)."""
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import leaves, tree_map
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    eager_state = train_state_init(cfg, gen, device="cuda")
    graph_state = tree_map(torch.clone, eager_state)
    steps = {g: make_train_step(cfg, peak_lr=1e-3, warmup_steps=1,
                                total_steps=10, remat=True, donate=True,
                                graph=g) for g in (False, True)}
    rows, differ = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_GRAPH_BITS_STEPS):
        batch = family_batch(torch, cfg, 13, i)
        eager_state, em = steps[False](eager_state, batch)
        graph_state, gm = steps[True](graph_state, batch)
        rows.append(bits_row(torch, i, eager_state, graph_state, em, gm))
        differ += [f"step {i}: {k}" for k in rows[-1]["differ"]]
    out = dict(layers=cfg.num_layers, steps=rows,
               capture_ms=steps[True].graph.capture_ms,
               replays=steps[True].graph.replays, bitwise=not differ,
               leaves=len(leaves(graph_state)),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               reserved_peak=torch.cuda.max_memory_reserved())
    if cfg.family == "encdec":
        out["encoder_layers"] = cfg.num_encoder_layers
    steps[True].close()
    del graph_state, gm
    if differ:
        emit("train_family_bits", config=cfg.name, **out)
        fail(f"{cfg.name}: replayed steps differ from eager ones: "
             f"{differ[:8]}")

    def one():
        nonlocal eager_state
        eager_state, _ = steps[False](eager_state, batch)
    with scoped_optimizer(), scoped_plain_ops():
        prof = profile_call(torch, one, f"profile_train_{cfg.name}_"
                            f"{cfg.num_layers}_layers_eager.txt",
                            split=train_dims(cfg, FAMILY_TRAIN["seq"]))
    del eager_state, steps, em
    gc.collect()
    torch.cuda.empty_cache()
    return out, prof


# the parts that run once a step, not once a layer
STEP_PARTS = ("optimizer", "global_norm")


def layer_shares(by_kernel: dict) -> dict:
    """``train_split``'s shares of a shallow step's kernels, for a deeper
    step of the same layers: ``STEP_PARTS`` keep only their own kernels
    (``NAMED_KERNEL_PARTS``), their other ops' (the step counter, a
    grad's contiguous copy) moving to the elementwise casts and copies.
    Those ops run once a step under kernel names the layers' ops share,
    so a shallow step's proportions would give them a share of every
    layer's."""
    out = {}
    for name, got in by_kernel.items():
        got = dict(got)
        if not any(k in name for k in NAMED_KERNEL_PARTS):
            moved = sum(got.pop(p, 0.0) for p in STEP_PARTS)
            if moved:
                for k in ("elementwise", "casts_copies"):
                    got[k] = got.get(k, 0.0) + moved
        out[name] = got
    return out


def train_family(torch, cfg, bits_cfg) -> dict:
    """(e) One family's train path at full width (``TRAIN_FAMILIES``),
    donated, rematerialised steps on one ``FAMILY_TRAIN`` batch through
    the port's entry point (``make_train_step``), after its bits check at
    ``bits_cfg``'s depth (``family_bits``): the first loss equals
    ``forward_train``'s; step 1 is held against the plain route
    (``plain_route``, ``step1_on_routes``: the grads of the same state, an
    f32 init rounded to the config's dtypes, and batch) by
    ``FAMILY_LIMITS``' rule, in f32 and in the config's dtype at the
    path's depth and in the config's dtype at ``bits_cfg``'s; steps
    through the graph and eager in turns (``FAMILY_TURNS``; each column's
    first ``FAMILY_SKIP`` steps left out of its median), each on the host
    clock with its peaks of allocated, requested and reserved bytes; the
    loss falls on the graph's steps and every grad norm is finite.  Then
    one eager step (under ``scoped_plain_ops``' ranges, their device ms
    read from the events: ``range_ms``) and one replay profiled
    (``profile_kernels``: busy, and idle from each profiled step's own
    wall), each split by part in the proportions of the bits check's
    profiled eager step (the same layers, fewer of them: ``train_split``,
    the plain SSD and MoE ops parts of their own; ``layer_shares``), and
    one eager step FLOP-counted on the plain attention.  Returns its
    ``train_family`` line."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import TrainState
    t0 = time.monotonic()
    bits, bits_prof = family_bits(torch, bits_cfg)
    by_kernel = layer_shares(bits_prof.pop("by_kernel"))
    f = FAMILY_TRAIN
    # step 1 on the kernels and on the plain route (``step1_on_routes``):
    # in f32 and in the config's dtype at the path's depth, in the
    # config's dtype at the bits check's
    step1, _ = step1_on_routes(torch, cfg)
    shallow, _ = step1_on_routes(torch, bits_cfg, STEP1_ROUTES[2:])
    params, batch = family_state(torch, cfg)
    state = TrainState(params, adamw_init(params), None)
    del params
    bound = train_step_bound(cfg, state.params, f["batch"], f["seq"])
    with torch.inference_mode():
        ref = float(M.forward_train(state.params, cfg, batch)[0])
    steps = {g: make_train_step(cfg, peak_lr=f["peak_lr"], warmup_steps=1,
                                total_steps=10, remat=True, donate=True,
                                graph=g) for g in (True, False)}
    holder = [state]
    del state
    runs = {w: dict(times=[], metrics=[], peaks=[], requested=[],
                    reserved=[]) for w in FAMILY_SKIP}
    for which in FAMILY_TURNS:
        run = runs[which]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.monotonic()
        holder[0], m = steps[which == "graph"](holder[0], batch)
        torch.cuda.synchronize()
        run["times"].append((time.monotonic() - t1) * 1e3)
        run["metrics"].append({k: float(v) for k, v in m.items()})
        run["peaks"].append(torch.cuda.max_memory_allocated())
        run["requested"].append(
            torch.cuda.memory_stats()["requested_bytes.all.peak"])
        run["reserved"].append(torch.cuda.max_memory_reserved())
    del m
    graph = steps[True].graph

    def one_step(which):
        def run():
            holder[0], _ = steps[which == "graph"](holder[0], batch)
        return run
    t_prof = time.monotonic()
    with scoped_plain_ops():
        profs = {"eager": profile_kernels(
            torch, one_step("eager"), f"profile_train_{cfg.name}_eager.txt",
            by_kernel, ranges=True)}
    profs["graph"] = profile_kernels(torch, one_step("graph"),
                                     f"profile_train_{cfg.name}.txt",
                                     by_kernel)
    t_prof = time.monotonic() - t_prof
    with plain_train_attention(), \
            FlopCounterMode(display=False) as counted:
        one_step("eager")()

    def column(which: str) -> dict:
        run, prof = runs[which], profs[which]
        kept = run["times"][FAMILY_SKIP[which]:]
        ms = sorted(kept)[len(kept) // 2]
        return dict(step_ms=ms, step_ms_all=run["times"],
                    profiled_wall_ms=prof["wall_ms"],
                    device_busy_ms=prof["device_busy_ms"],
                    idle_ms=prof["wall_ms"] - prof["device_busy_ms"],
                    idle_share=prof["device_idle_share"],
                    max_memory_allocated=max(run["peaks"]),
                    requested_peak=max(run["requested"]),
                    reserved_peak=max(run["reserved"]),
                    max_memory_allocated_steps=run["peaks"],
                    requested_peak_steps=run["requested"],
                    reserved_peak_steps=run["reserved"],
                    top=prof["top"], **prof["split"])
    cols = {w: column(w) for w in ("graph", "eager")}
    # the split's plain-ops parts against their ranges' own device ms
    cols["eager"]["range_ms"] = profs["eager"]["range_ms"]
    cols["graph"].update(capture_ms=graph.capture_ms, replays=graph.replays)
    for step in steps.values():
        step.close()
    del holder, graph, steps
    gc.collect()
    torch.cuda.empty_cache()
    metrics = runs["graph"]["metrics"]
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    step_ms = cols["graph"]["step_ms"]
    lim = FAMILY_LIMITS
    plain, k32 = step1["plain"], step1["kernels_f32"]
    # the path's step 1 (the graph's warm-up) against the plain route
    first = {"loss": losses[0], "grad_norm": norms[0],
             "loss_vs_plain": (losses[0] - plain["loss"]) / plain["loss"],
             "grad_norm_vs_plain": ((norms[0] - plain["grad_norm"])
                                    / plain["grad_norm"])}
    first["grad_norm_vs_kernels"] = ((norms[0] - step1["kernels"]
                                      ["grad_norm"])
                                     / step1["kernels"]["grad_norm"])
    checks = {
        "loss": abs(first["loss_vs_plain"]) <= lim["loss"],
        "grad_norm": abs(first["grad_norm_vs_kernels"]) <= lim["f32"],
        "f32_loss": abs(k32["loss_vs_plain_f32"]) <= lim["f32"],
        "f32_grad_norm": abs(k32["grad_norm_vs_plain_f32"]) <= lim["f32"],
        "f32_grads": k32["err_plain_f32"] <= lim["f32"],
        "grads_vs_f32": (step1["kernels"]["err_plain_f32"]
                         <= lim["err_ratio"] * plain["err_plain_f32"]),
        "shallow_loss": (abs(shallow["kernels"]["loss_vs_plain"])
                         <= lim["loss"]),
        "shallow_grad_norm": (abs(shallow["kernels"]["grad_norm_vs_plain"])
                              <= lim["grad_norm"])}
    row = dict(config=cfg.name, family=cfg.family, layers=cfg.num_layers,
               d_model=cfg.d_model, batch=f["batch"], seq=f["seq"],
               remat=True, donate=True, turns=list(FAMILY_TURNS),
               skip=FAMILY_SKIP, step_ms=step_ms,
               eager_step_ms=cols["eager"]["step_ms"],
               tokens_per_s=f["batch"] * f["seq"] / step_ms * 1e3,
               forward_train_loss=ref, step_1=first, step_1_routes=step1,
               step_1_shallow=dict(layers=bits_cfg.num_layers, **shallow),
               limits=lim, checks=checks, losses=losses,
               grad_norms=norms, eager_losses=[
                   m["loss"] for m in runs["eager"]["metrics"]],
               lrs=[m["lr"] for m in metrics],
               counted_flops=counted.get_total_flops(),
               **bound, graph=cols["graph"], eager=cols["eager"],
               split_from=dict(layers=bits_cfg.num_layers, **bits_prof),
               profile_s=t_prof, bits=bits, seconds=time.monotonic() - t0)
    if cfg.family == "encdec":
        row.update(encoder_layers=cfg.num_encoder_layers,
                   frames=list(batch["frames"].shape),
                   frames_dtype=str(batch["frames"].dtype))
    emit("train_family", **row)
    if abs(losses[0] - ref) > 1e-3 * abs(ref):
        fail(f"{cfg.name}: first step's loss {losses[0]}, forward_train "
             f"{ref}")
    if not all(checks.values()):
        fail(f"{cfg.name}: step 1 against the plain route: "
             f"{[k for k, v in checks.items() if not v]} out of "
             f"FAMILY_LIMITS {lim}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name}: loss on the repeated batch {losses}")
    if not all(math.isfinite(n) for n in norms + [
            m["grad_norm"] for m in runs["eager"]["metrics"]]):
        fail(f"{cfg.name}: grad norms {norms}")
    return row


def train_families(torch) -> dict:
    """(e) Each of ``TRAIN_FAMILIES``' train paths (``train_family``), one
    state alive at a time."""
    out = {}
    for _, cfg, bits_cfg in family_configs():
        out[cfg.name] = train_family(torch, cfg, bits_cfg)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train(torch, mods) -> tuple:
    """The train paths on the card, after the serve paths, each step
    through the train step's CUDA graph unless named eager: tiny, lm100m,
    codeqwen1.5-7b at 16 layers, and the other five families' paths
    (``train_families``: mamba2, zamba2, granite-moe, whisper, chameleon
    at full width, chameleon cut in depth); no serve
    kernel may launch (flash, the SSD scan and decode have no backward;
    Mamba2's scan trains as torch ops, as the reference's does), the
    training attention exactly once a forward (twice under remat) and once
    a backward an attention call a microbatch, and the two optimizer
    kernels exactly once a param leaf a step on the card
    (``expected_train_launches``), counted on the device (a graph's
    warm-up and replays; its capture launches on the host only); each
    part's graph captures and replays as ``expected_train_graphs`` says
    (the ``train_graph`` line).  Returns each kernel's launches over the
    phase (host, in all and by route), the train kernels' device counts
    and the full-width train step's FLOPs and times."""
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels import gated_mlp as gm
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import norm_rope as nr
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    want = expected_train_launches(torch, mods, "train")
    _zero_counts(kernels)
    before = device_counts(mods)
    norm_rope_check = norm_rope_window(nr)
    moe_idle = moe_window(md)
    gate_loss_check = gate_loss_window(gm, ce)
    refused = check_kernel_guard(torch, mods)
    graphs = {}

    def counted(part, fn, *args):
        at = train_graph_counts()
        out = fn(*args)
        graphs[part] = graph_delta(at)
        return out
    worst = counted("parity", train_parity, torch)
    bits = counted("bits", train_graph_bits, torch)
    counted("engine", train_engine, torch)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, card = counted("full_width", train_full_width, torch)
    counted("remat", train_remat, torch, cfg, batch)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    families = counted("families", train_families, torch)
    launches, by_route = _read_counts(kernels)
    device = device_delta(mods, before)
    emit("train_graph", where="train", graphs=graphs,
         expected=expected_train_graphs("train"),
         bitwise={**{k: v["bitwise"] for k, v in bits.items()},
                  **{k: v["bits"]["bitwise"] for k, v in families.items()}})
    if graphs != expected_train_graphs("train"):
        fail(f"train step graphs {graphs}, expected "
             f"{expected_train_graphs('train')}")
    emit("train_launches", launches=launches,
         train_launches_by_route={n: by_route[n] for n in want},
         train_device_launches=device, expected_train_launches=want,
         guard_refused=refused, parity_max_rel_err=worst)
    check_phase_launches("train", launches, by_route, device, want,
                         host=False)
    norm_rope_check("train", expected_norm_rope_launches(nr, "train"))
    moe_idle("train", MOE_IDLE)
    gate_loss_check("train", expected_gate_loss_launches(gm, ce, "train"))
    return launches, device, card


DRYRUN_PREFILL = "codeqwen15_7b"       # its serve path counts a prefill
DRYRUN_CELL = ("mamba2_1_3b", "decode_32k")
REFERENCE_RECORD = (ROOT / "results" / "dryrun"
                    / "mamba2_1_3b__decode_32k__single.json")
DRYRUN_SMOKE_CELLS = (("mamba2_1_3b", "prefill_32k"),
                      ("granite_moe_3b_a800m", "decode_32k"),
                      ("codeqwen15_7b", "train_4k"),
                      ("zamba2_2_7b", "train_4k"))
DRYRUN_SMOKE_MESH = ((2, 4), ("data", "model"))


def phase_dryrun(torch, mods, cards: dict) -> dict:
    """The port's dry-run on the card's host, with every kernel count set
    to 0: (a) the cell of the one committed reference record on the
    256-rank fake mesh ends ok and agrees with that record on params,
    active params, chips, decisions and argument bytes per device; the
    smoke cells ``DRYRUN_SMOKE_CELLS`` on a (2, 4) fake mesh end ok under
    this host's torch; (b) and (c) the cost pass on the local 1-rank mesh
    counts, to the FLOP,
    what ``FlopCounterMode`` counted on the card for codeqwen1.5-7b's
    plain-route prefill (``prefill_on_card``) and its 16-layer donated,
    rematerialised train step (``train_full_width``), each printed with
    the roofline terms beside the measured times and the bounds; (d) no
    kernel launched.  Returns each kernel's launches over the phase."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels import gated_mlp as gm
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import norm_rope as nr
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import (LINK_BW, fake_process_group,
                                         make_local_mesh)
    from repro_torch.models.common import ShapeConfig
    from repro_torch.roofline import roofline_terms
    from repro_torch.sharding import AbstractMesh
    t0 = time.monotonic()
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    _zero_counts(kernels)
    before = device_counts(mods)
    norm_rope_check = norm_rope_window(nr)
    moe_idle = moe_window(md)
    gate_loss_check = gate_loss_window(gm, ce)

    arch, shape = DRYRUN_CELL
    rec = D.run_cell(arch, shape, False, PROFILE_DIR / "dryrun",
                     verbose=False)
    ref = json.loads(REFERENCE_RECORD.read_text())
    keys = ("params", "active_params", "chips", "decisions",
            "arg_bytes_per_device")
    got = {k: rec.get(k) for k in keys}
    emit("dryrun_cell", arch=arch, shape=shape, mesh="single",
         status=rec["status"], error=rec.get("error"), **got,
         reference={k: ref[k] for k in keys}, trace_s=rec.get("trace_s"),
         cost_pass_s=rec.get("cost_pass_s"), memory=rec.get("memory"),
         cost=rec.get("cost"), collectives=rec.get("collectives"),
         roofline=rec.get("roofline"), torch=rec.get("torch"),
         reshards=rec.get("reshards"))
    if rec["status"] != "ok":
        print(rec.get("traceback"), file=sys.stderr, flush=True)
        fail(f"dry-run of {arch} x {shape}: {rec.get('error')}")
    if got != {k: ref[k] for k in keys}:
        fail(f"dry-run of {arch} x {shape} differs from the reference "
             f"record: {got}")

    # the ops that torch 2.11's DTensor could not shard (the SSM conv's
    # pad, the MoE dispatch write, the embedding's backward): smoke cells
    # that run them end ok on this host's release
    for arch, shape in DRYRUN_SMOKE_CELLS:
        rec = D.run_cell(arch, shape, False, PROFILE_DIR / "dryrun_smoke",
                         verbose=False, cfg=get_smoke_config(arch),
                         mesh_axes=AbstractMesh(*DRYRUN_SMOKE_MESH))
        emit("dryrun_smoke_cell", arch=arch, shape=shape,
             mesh=list(DRYRUN_SMOKE_MESH[0]), torch=torch.__version__,
             status=rec["status"], error=rec.get("error"),
             trace_s=rec.get("trace_s"), cost_pass_s=rec.get("cost_pass_s"),
             cost=rec.get("cost"), collectives=rec.get("collectives"),
             reshards=rec.get("reshards"))
        if rec["status"] != "ok":
            print(rec.get("traceback"), file=sys.stderr, flush=True)
            fail(f"dry-run of the smoke {arch} x {shape} under torch "
                 f"{torch.__version__}: {rec.get('error')}")

    base = get_config(DRYRUN_PREFILL)
    nm1 = D.make_variant("nm1")
    with fake_process_group(1):
        mesh = make_local_mesh()
        for step, kind, cfg in (
                ("prefill", "prefill", base),
                ("train_step", "train",
                 D.at_depth(base, cards["train_step"]["layers"]))):
            card = cards[step]
            fake = D.costs(cfg, ShapeConfig(f"chip_{step}", card["seq"],
                                            card["batch"], kind), mesh, nm1)
            terms = roofline_terms(fake["flops"], fake["bytes_accessed"],
                                   fake["coll_total"], 1, PEAK_FLOPS_BF16,
                                   HBM_BW, LINK_BW)
            emit("dryrun_flops", config=cfg.name, step=step,
                 layers=cfg.num_layers, fake_flops=fake["flops"],
                 card_flops=card["flops"],
                 compute_term_ms=terms["compute_s"] * 1e3,
                 memory_term_ms=terms["memory_s"] * 1e3,
                 bytes_accessed=fake["bytes_accessed"], card=card)
            if fake["flops"] != card["flops"]:
                fail(f"{cfg.name} {step}: the fake pass counts "
                     f"{fake['flops']} FLOPs, the card {card['flops']}")
    launches, by_route = _read_counts(kernels)
    device = device_delta(mods, before)
    emit("dryrun_launches", launches=launches,
         train_device_launches=device, seconds=time.monotonic() - t0)
    check_phase_launches("dryrun", launches, by_route, device,
                         expected_train_launches(torch, mods, "dryrun"),
                         host=True)
    norm_rope_check("dryrun", expected_norm_rope_launches(nr, "dryrun"))
    moe_idle("dryrun", MOE_IDLE)
    gate_loss_check("dryrun", expected_gate_loss_launches(gm, ce, "dryrun"))
    return launches, device


EXAMPLES = ROOT / "examples" / "torch"
TRAIN_LM_CKPT = PROFILE_DIR / "train_lm_ckpt"


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch, mods) -> dict:
    """The port's examples, with every kernel count set to 0: (a)
    ``chiles_pipeline.main`` (numpy apps through the port's engine, as the
    reference's) recovers the injected source in band 2, its own check;
    (b) ``train_lm.py`` at its defaults (lm20m, 200 steps through the
    engine on the card, which keeps every step's state), checkpoints under
    ``chiprun_out/`` deleted after: the loss falls, its own check, and its
    steps went through one captured graph (``expected_train_graphs``); (c)
    no serve kernel launched, the training attention once a forward and
    once a backward a layer a step, the optimizer kernels once a param
    leaf a step, on the device.  Returns each kernel's launches over the
    phase and the train kernels' device counts."""
    import shutil

    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels import gated_mlp as gm
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import norm_rope as nr
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    want = expected_train_launches(torch, mods, "examples")
    _zero_counts(kernels)
    before = device_counts(mods)
    norm_rope_check = norm_rope_window(nr)
    moe_idle = moe_window(md)
    gate_loss_check = gate_loss_window(gm, ce)

    chiles = _load_example("chiles_pipeline")
    cubes = []

    class Reading(chiles.Pipeline):
        def __exit__(self, *exc):
            cubes.append(self.session.drops["final"].read())
            return super().__exit__(*exc)
    chiles.Pipeline = Reading
    t0 = time.monotonic()
    try:
        chiles.main()
    except AssertionError as err:
        fail(f"examples/torch/chiles_pipeline.py: {err}")
    peaks = cubes[0].max(axis=(1, 2))
    emit("example_chiles", seconds=time.monotonic() - t0,
         cube_shape=list(cubes[0].shape), band_peaks=peaks.tolist(),
         source_band=int(peaks.argmax()))

    train_lm = _load_example("train_lm")
    results = []
    run_training = train_lm.run_training

    def recording(*args, **kwargs):
        results.append(run_training(*args, **kwargs))
        return results[-1]
    train_lm.run_training = recording
    shutil.rmtree(TRAIN_LM_CKPT, ignore_errors=True)
    argv = sys.argv
    sys.argv = ["train_lm.py", "--ckpt-dir", str(TRAIN_LM_CKPT)]
    torch.cuda.reset_peak_memory_stats()
    at = train_graph_counts()
    try:
        train_lm.main()
    except AssertionError as err:
        fail(f"examples/torch/train_lm.py: {err}: {results[0]['losses']}")
    finally:
        sys.argv = argv
    res = results.pop()
    graphs = {"train_lm": graph_delta(at)}
    emit("train_graph", where="examples", graphs=graphs,
         expected=expected_train_graphs("examples"))
    if graphs != expected_train_graphs("examples"):
        fail(f"examples/torch/train_lm.py: train step graphs {graphs}, "
             f"expected {expected_train_graphs('examples')}")
    emit("example_train_lm", preset=TRAIN_LM[0], steps=len(res["losses"]),
         first_loss=res["first_loss"], last_loss=res["last_loss"],
         wall_s=res["wall_s"], tokens_per_s=res["tokens_per_s"],
         drops=res["drops"], final_step=res["final_step"],
         checkpoints=sorted(p.name for p in TRAIN_LM_CKPT.iterdir()),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    steps = len(res["losses"])
    del res
    shutil.rmtree(TRAIN_LM_CKPT)
    launches, by_route = _read_counts(kernels)
    device = device_delta(mods, before)
    emit("examples_launches", launches=launches,
         train_device_launches=device, expected_train_launches=want)
    if steps != TRAIN_LM[1]:
        fail(f"examples/torch/train_lm.py ran {steps} steps, expected "
             f"{TRAIN_LM[1]}")
    check_phase_launches("examples", launches, by_route, device, want,
                         host=False)
    norm_rope_check("examples", expected_norm_rope_launches(nr, "examples"))
    moe_idle("examples", MOE_IDLE)
    gate_loss_check("examples", expected_gate_loss_launches(gm, ce,
                                                            "examples"))
    return launches, device


def check_kernel_guard(torch, mods) -> list:
    """Every kernel wrapper refuses CUDA inputs that require grad (its
    output would carry no grad_fn)."""
    from repro_torch.kernels import moe_dispatch as md
    fa, ss = mods["flash_attention_bhsd"], mods["ssd_scan_bhsd"]
    da = mods["decode_attention"]
    q = torch.randn((1, 2, 16, 16), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    x = torch.randn((1, 2, 16, 8), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    bc = torch.randn((1, 1, 16, 8), device="cuda", dtype=torch.bfloat16)
    dt = torch.rand((1, 2, 16), device="cuda")
    a = -torch.rand((2,), device="cuda")
    idx = torch.zeros((1, 2, 1), device="cuda", dtype=torch.int64)
    gates = torch.ones((1, 2, 1), device="cuda")
    pos = torch.zeros((1, 2), device="cuda", dtype=torch.int32)
    keep = torch.ones((1, 2), device="cuda", dtype=torch.bool)
    calls = {"flash_attention_bhsd": lambda: fa.flash_attention_bhsd(
                 q, q.detach(), q.detach()),
             "ssd_scan_bhsd": lambda: ss.ssd_scan_bhsd(x, dt, a, bc, bc, 8),
             "decode_attention": lambda: da.decode_attention(
                 q[:, :, 0], q.detach().transpose(1, 2),
                 q.detach().transpose(1, 2), 3),
             # (moe_slots takes int64 experts only, which cannot need grad)
             "moe_route": lambda: md.moe_route(
                 torch.zeros((1, 2, 8), device="cuda", requires_grad=True),
                 2, 8),
             "moe_dispatch": lambda: md.moe_dispatch(
                 x[0], torch.zeros((2, 2, 8), device="cuda",
                                   dtype=torch.int32)),
             "moe_combine": lambda: md.moe_combine(
                 x, idx, pos, keep, gates, torch.bfloat16)}
    refused = []
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as err:
            if "no backward" in str(err):
                refused.append(name)
                continue
            raise
        fail(f"{name} took CUDA inputs that require grad")
    return refused


def serve_kernels_idle(mods):
    """A check to call after a train, dry-run or examples phase: flash, the
    SSD scan and decode launched nothing on the device since this call
    (the wrappers' host counts are ``check_phase_launches``')."""
    before = {n: m.kernel_launches(m._lib()) for n, m in mods.items()}

    def check(what: str) -> None:
        moved = {n: {r: c - before[n][r] for r, c in
                     m.kernel_launches(m._lib()).items() if c != before[n][r]}
                 for n, m in mods.items()}
        if any(moved.values()):
            fail(f"{what}: serve kernels launched on the device: {moved}")
    return check


def train_kernels_idle(mods):
    """A check to call after a serve path: the training attention and the
    optimizer kernels launched nothing since this call, on the host and on
    the device (serving records no autograd graph and updates nothing)."""
    names = ("adamw_update", "sumsq", "train_attention_forward",
             "train_attention_backward")
    kernels = {n: getattr(mods[n], n) for n in names}
    _zero_counts(kernels)
    before = device_counts(mods)

    def check(what: str) -> None:
        host = _read_counts(kernels)[0]
        device = device_delta(mods, before)
        if any(host.values()) or any(n for by in device.values()
                                     for n in by.values()):
            fail(f"{what}: train kernels launched while serving: host "
                 f"{host}, device {device}")
    return check


def _graph_counts() -> dict:
    from repro_torch.train.steps import DecodeGraph, PrefillGraph
    return {"prefill": dict(PrefillGraph.counts),
            "decode": dict(DecodeGraph.counts)}


def _zero_graph_counts() -> None:
    from repro_torch.train.steps import DecodeGraph, PrefillGraph
    DecodeGraph.counts.update(captures=0, replays=0)
    PrefillGraph.counts.update(captures=0, replays=0)


def slot_runs(cfg, shape: dict, res: dict, sessions: int = 1) -> dict:
    """``serve_runs`` of a serve run's result ``res`` at ``shape``: its
    microbatches over ``sessions`` sessions, on the slots it made."""
    apps = shape["num_requests"] // shape["microbatch"] * sessions
    if not 1 <= res["slots"] <= apps:
        fail(f"{cfg.name}: {res['slots']} cache slots for {apps} "
             "microbatches")
    return serve_runs(cfg, apps, shape["decode_steps"], res["slots"])


def check_graphs(name: str, graphs: dict, runs: dict) -> None:
    """A serve run went through its slots' graphs: each slot captured its
    prefill graph and its decode graphs once, and every other prefill and
    decode step replayed one (``serve_runs``)."""
    if graphs != runs["graphs"]:
        fail(f"{name}: graphs {graphs}, expected {runs['graphs']}")


def _zero_counts(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def _read_counts(kernels: dict) -> tuple:
    """Each kernel's launches, in all and by route."""
    return ({name: fn.launches for name, fn in kernels.items()},
            {name: dict(fn.launches_by_route)
             for name, fn in kernels.items()})


def _self_device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return us if us is not None else getattr(event, "self_cuda_time_total", 0)


def _device_us(event) -> float:
    """An op's device time, its kernels' included."""
    us = getattr(event, "device_time_total", None)
    return us if us is not None else getattr(event, "cuda_time_total", 0)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree_map(tree, fn):
    return {k: (_tree_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _tree_to(tree, device):
    return _tree_map(tree, lambda t: t.to(device))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gated_mlp as gm
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import norm_rope as nr
    from repro_torch.kernels import optimizer as opt
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import train_attention as ta

    t_start = time.monotonic()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    variants = [("flash_attention", MMA_DEFINES),
                ("flash_attention", fa.FORCE_SCALAR_DEFINES),
                ("ssd_scan", SSD_MMA_DEFINES),
                ("train_attention", ta.FORCE_MMA_DEFINES),
                ("train_attention", ta.FORCE_SCALAR_DEFINES),
                ("moe_dispatch", md.FORCE_PLAIN_COPY_DEFINES)]
    build_s = _build.build(variants=variants)
    builds = {n: (n, ()) for n in _build.KERNEL_SOURCES}
    builds.update({f"{n} {' '.join(d)}": (n, d) for n, d in variants})
    ptxas = {b: _build.ptxas_summary(*nd) for b, nd in builds.items()}
    emit("build", seconds=build_s, kernels=list(ptxas), ptxas=ptxas)
    faults = ptxas_faults(ptxas, {b: _build.build_log(*nd)
                                  for b, nd in builds.items()})
    if faults:
        fail(f"ptxas: {faults}")
    if "--step1-routes" in sys.argv[1:]:
        step1_routes(torch)
        emit("done", seconds=time.monotonic() - t_start)
        print(card_line(), flush=True)
        return 0
    if "--serve-parent" in sys.argv[1:]:
        phase_serve_parent(torch)
        emit("done", seconds=time.monotonic() - t_start)
        print(card_line(), flush=True)
        return 0

    flash_entry, flash_d80, flash_x3 = phase_kernel(torch, fa)
    entries = [flash_entry, phase_ssd_kernel(torch, ss),
               phase_decode_kernel(torch, da)]
    gc.collect()            # the plain versions' 8192-token scores
    torch.cuda.empty_cache()
    entries += phase_optimizer_kernel(torch, opt)
    ta_entries, ta_x3 = phase_train_attention_kernel(torch, ta)
    entries += ta_entries
    nr_entries = phase_norm_rope_kernel(torch, nr)
    moe_entries = phase_moe_kernel(torch, md)
    gc.collect()
    torch.cuda.empty_cache()
    gl_entries = phase_gate_loss_kernel(torch, gm, ce)
    if "--kernels-only" in sys.argv[1:]:
        emit("done", seconds=time.monotonic() - t_start)
        print(json.dumps({"kernels": entries + [flash_d80, flash_x3,
                                                 *ta_x3, *nr_entries,
                                                 *moe_entries,
                                                 *gl_entries]}),
              flush=True)
        return 0
    mods = {e["name"]: mod for e, mod in zip(entries, (fa, ss, da))}
    all_mods = {**mods, "adamw_update": opt, "sumsq": opt,
                "train_attention_forward": ta,
                "train_attention_backward": ta}
    by_path, routes, host_by_path, cards = {}, {}, {}, {}
    for arch in PATHS:
        idle = train_kernels_idle(all_mods)
        row, card, modes = phase_serve(torch, arch, mods)
        idle(arch)
        if card is not None:
            cards["prefill"] = card
        for path, r in ((arch, row), *((f"{arch}/{mode}", r) for mode, r
                                       in (modes or {}).items())):
            by_path[path] = r["launches"]
            routes[path] = r["launches_by_route"]
            host_by_path[path] = r["host_launches"]
        gc.collect()                    # free the model before the next
        torch.cuda.empty_cache()
    serve_idle = serve_kernels_idle(mods)
    train, train_device, cards["train_step"] = phase_train(torch, all_mods)
    gc.collect()
    torch.cuda.empty_cache()
    dry, dry_device = phase_dryrun(torch, all_mods, cards)
    examples, examples_device = phase_examples(torch, all_mods)
    serve_idle("the train, dry-run and examples phases")
    # flash, the SSD scan and decode run in CUDA graph replays (the
    # prefill's and the decode step's), which their wrappers do not see:
    # their launches are the device's count of executed calls on each
    # serve path (``serve_window``), the wrappers' (eager calls and
    # captures) beside them; the train, dry-run and examples phases launch
    # none
    for e in entries[:3]:
        n = e["name"]
        e["launches_by_path"] = {a: c[n] for a, c in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        e["host_launches_by_path"] = {a: c[n]
                                      for a, c in host_by_path.items()}
        e["host_launches"] = sum(e["host_launches_by_path"].values())
        e["launches_by_path"]["train"] = train[n]
        e["launches_by_path"]["dryrun"] = dry[n]
        e["launches_by_path"]["examples"] = examples[n]
        e["launches_by_route"] = {
            r: sum(routes[a][n][r] for a in routes)
            for r in routes[PATHS[0]][n]}
    # the optimizer and training attention kernels run on the train paths:
    # their launches are the device's count over the train phase (the main
    # path), by route
    for e in entries[3:]:
        n = e["name"]
        e["launches_by_route"] = train_device[n]
        e["launches_by_path"] = {
            p: sum(d[n].values()) for p, d in (
                ("train", train_device), ("dryrun", dry_device),
                ("examples", examples_device))}
        e["launches"] = e["launches_by_path"]["train"]
        e["host_launches_by_path"] = {"train": train[n], "dryrun": dry[n],
                                      "examples": examples[n]}
    # the f32 routes' own lines: their launches on that route alone (flash's
    # whisper encoder in the serve runs; the training attention's f32 train
    # paths on the device)
    x3 = flash_x3["kernel_route"]
    flash_x3["launches_by_path"] = {
        a: routes[a]["flash_attention_bhsd"][x3] for a in routes}
    flash_x3["launches"] = sum(flash_x3["launches_by_path"].values())
    # D = 80 runs only in zamba2's shared block: its launches on the route
    flash_d80["launches_by_path"] = {
        a: routes[a]["flash_attention_bhsd"][flash_d80["kernel_route"]]
        for a in routes if a == "zamba2_2_7b"}
    flash_d80["launches"] = sum(flash_d80["launches_by_path"].values())
    for e in ta_x3:
        n, r = e["name"].split("/")
        e["launches_by_path"] = {p: d[n][r] for p, d in (
            ("train", train_device), ("dryrun", dry_device),
            ("examples", examples_device))}
        e["launches"] = e["launches_by_path"]["train"]
    # the norm and RoPE kernels run on every train and serve path: their
    # launches are the device's counts over each serve run and the train,
    # dry-run and examples phases (the wrappers' beside them)
    for e in nr_entries:
        n, rs = e["counter"], e["kernel_routes"]
        counts = NORM_ROPE_LAUNCHES.items()
        e["launches_by_path"] = {w: sum(c["device"][n][r] for r in rs)
                                 for w, c in counts}
        e["host_launches_by_path"] = {w: sum(c["host"][n][r] for r in rs)
                                      for w, c in counts}
        e["launches_by_route"] = {
            r: sum(c["device"][n][r] for _, c in counts) for r in rs}
        e["launches"] = sum(e["launches_by_path"].values())
        if "backward_routes" in e:
            e["backward_launches"] = sum(
                c["device"]["rms_norm_bwd"][r] for _, c in counts
                for r in e["backward_routes"])
        if n == "rms_norm_bwd" or e["name"] == "rope_bias":
            ds = [nr.dscale_route(r) for r in rs
                  if n != "rope" or r.startswith("bias_backward")]
            e["dscale_launches"] = sum(
                c["device"]["rms_norm_dscale"][r] for _, c in counts
                for r in ds)
    # the MoE kernels run on granite's serve path: their launches are the
    # device's counts over each serve run (the prefills and every executed
    # decode step, replays included) and the train, dry-run and examples
    # phases (none), the wrappers' beside them
    for e in moe_entries:
        n = e["name"]
        counts = MOE_LAUNCHES.items()
        e["launches_by_path"] = {w: sum(c["device"][n].values())
                                 for w, c in counts}
        e["host_launches_by_path"] = {w: sum(c["host"][n].values())
                                      for w, c in counts}
        e["launches_by_route"] = {
            r: sum(c["device"][n][r] for _, c in counts)
            for r in e["kernel_routes"]}
        e["launches"] = sum(e["launches_by_path"].values())
    # the gate and the loss run on every train path, the gate also on every
    # gated serve path: their launches are the device's counts over each
    # serve run and the train, dry-run and examples phases (the wrappers'
    # beside them; the loss's forward counts its sum kernel's too)
    for e in gl_entries:
        n = e["name"]
        counts = GATE_LOSS_LAUNCHES.items()
        e["launches_by_path"] = {w: sum(c["device"][n].values())
                                 for w, c in counts}
        e["host_launches_by_path"] = {w: sum(c["host"][n].values())
                                      for w, c in counts}
        e["launches_by_route"] = {
            r: sum(c["device"][n][r] for _, c in counts)
            for r in e["kernel_routes"]}
        e["launches"] = sum(e["launches_by_path"].values())
        if n == "cross_entropy_fwd":
            e["sum_launches"] = sum(
                sum(c["device"]["cross_entropy_sum"].values())
                for _, c in counts)
    entries += [flash_d80, flash_x3, *ta_x3, *nr_entries, *moe_entries,
                *gl_entries]

    emit("done", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
