#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repo root with no arguments:

    python3 chip_smoke.py

(``--kernels-only`` stops after phase 3 and prints its kernels line but
no result line.)

Full profiler tables land in ``chiprun_out/chip_smoke/`` (gitignored).
Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: compile every CUDA kernel from ``src/repro_torch/csrc`` with nvcc,
   all at once; ptxas registers and spills per kernel instance.
3. kernel: each kernel against its plain PyTorch version on the card, at
   the serve paths' shapes and at every option case in f32 (scalar route)
   and in bf16 (tensor-core route); times of the kernel, the plain version
   and (where one exists) one library call at the path shapes, CUDA
   events: SDPA, or for a softcapped or windowed case a compiled
   ``flex_attention``.  Fails if ptxas reported a spill.
4. serve, for each of eight paths in turn: codeqwen1.5-7b (dense, flash
   kernel), mamba2-1.3b (ssm, SSD kernel), zamba2-2.7b (hybrid, both
   kernels), granite-moe-3b-a800m (moe, flash), whisper-large-v3 (encdec,
   flash in the encoder and the decoder), gemma2-27b (dense: local window
   4096 on alternate layers, softcaps), nemotron-4-15b (dense, GQA 6:1)
   and chameleon-34b (vlm, qk-norm).  A smoke config served on the card
   must give the CPU's tokens (a windowed one with prompts past its
   window).  Then the model at full width and depth (random weights from
   a seed): its prefill and decode steps timed alone, against their
   bounds, and profiled; then 8 requests x 16 tokens with 512-token
   prompts (gemma2: 4 x 16 with 8192-token prompts, past its window)
   through the engine, with every kernel count set to 0 just before and
   read just after: each kernel of the path must have launched exactly
   once per layer that runs it per microbatch, on the route its inputs'
   dtype selects (the full-width models are bf16; whisper's encoder runs
   f32, from the serve's f32 frames); and full-width prefill logits
   through the kernels must be finite and near the plain route's (gemma2:
   one 8192-token sequence).  codeqwen1.5-7b then serves the same
   requests in the serve driver's other engine modes (``serve_modes``):
   the compiled substrate, streaming delivery, 3 sessions 2 at a time
   through a resident manager, and a stats dump; each must give the
   object substrate's tokens and the expected launches.  Each model is
   freed before the next.
5. train, after the serve paths, with every kernel count set to 0:
   both kernel wrappers refuse CUDA inputs that require grad; (a) the
   ``tiny`` preset's train step on the card equals the port on the CPU
   over 4 steps (one and two microbatches, int8 compression); (b)
   ``run_training(lm100m)`` through the engine (40 steps x 1024 tokens,
   f32, checkpoints under ``chiprun_out/``) equals the same steps without
   the engine, its last checkpoint restores bit for bit and a resumed run
   starts from the saved step; (c) codeqwen1.5-7b at full width cut to 16
   layers, one donated, rematerialised bf16 step on 8 x 512 tokens: time
   against ``train_step_bound``, device busy and idle, peak memory, the
   first loss equal to ``forward_train``'s, the loss falling on the
   repeated batch, and at 2 layers remat on and off agreeing; (d) no
   kernel launched in the whole phase (training runs torch ops, as the
   reference trains with ``use_kernel=False``).
6. dryrun, with every kernel count set to 0: (a) the port's dry-run of
   mamba2-1.3b x decode_32k on the 256-rank fake mesh ends ok and agrees
   with the reference's committed record on params, chips, decisions and
   argument bytes, and four smoke cells (mamba2 prefill, granite decode,
   codeqwen and zamba2 train) end ok on a (2, 4) fake mesh under this
   host's torch; (b) its cost pass on a 1-rank mesh counts the same
   FLOPs as ``FlopCounterMode`` on the card for codeqwen1.5-7b's
   plain-route prefill (one serve microbatch, counted in phase 4) and
   (c) its 16-layer train step (one more step, counted in phase 5),
   printed with the roofline's terms beside the measured times; (d) no
   kernel launched.
7. examples, with every kernel count set to 0: ``examples/torch/``'s
   CHILES pipeline recovers its source in band 2, and ``train_lm.py`` at
   its defaults (lm20m, 200 steps through the engine) lowers the loss; no
   kernel launched.
8. the kernels line, the card line, then the result line.

It imports nothing of JAX or of the JAX package.  Without CUDA it exits 2.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls.

    The calls are queued behind a ~20 ms device sleep, so the device runs
    them back to back: without it, a kernel shorter than its wrapper's host
    time (the D=64 flash shapes, ~25 us) is timed at the host's pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)       # clock cycles: ~20 ms at 1.98 GHz
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


FLASH_PATH_CASES = ("path", "d80_bf16_mha", "granite_gqa3_d64_bf16",
                    "whisper_enc_f32", "whisper_dec_d64_bf16",
                    "gemma2_local_w4096_cap50", "gemma2_global_cap50",
                    "nemotron_gqa6", "chameleon_gqa8")


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


def phase_kernel(torch, fa):
    """Kernel vs plain version on the card; times at the path shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    # name, B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, cap
    cases = [
        ("path", 4, 32, 32, 512, 512, 128, bf16, True, 0, 0.0),
        ("gqa_4to1", 2, 32, 8, 256, 256, 128, bf16, True, 0, 0.0),
        ("ragged_17x33", 1, 4, 4, 17, 33, 8, f32, True, 0, 0.0),
        ("ragged_noncausal", 2, 2, 2, 48, 80, 32, f32, False, 0, 0.0),
        ("window16_cap50", 2, 4, 2, 200, 200, 64, f32, True, 16, 50.0),
        ("d80_f32", 2, 4, 2, 130, 130, 80, f32, True, 0, 0.0),
        ("noncausal", 2, 8, 2, 300, 300, 128, bf16, False, 0, 0.0),
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
        # D=128 runs other tiles (two m-tiles a warp): its masks and edges
        ("ragged_17x33_d128_bf16", 1, 4, 4, 17, 33, 128, bf16, True, 0, 0.0),
        ("window16_cap50_d128_bf16", 2, 4, 2, 200, 200, 128, bf16, True, 16,
         50.0),
        ("no_visible_key_d128_bf16", 1, 2, 1, 20, 10, 128, bf16, True, 3,
         0.0),
        # granite-moe-3b's prefill: GQA 3:1 at D=64
        ("granite_gqa3_d64_bf16", 4, 24, 8, 512, 512, 64, bf16, True, 0, 0.0),
        # whisper-large-v3's encoder (f32: the serve's f32 frames promote
        # it) and its decoder's prefill
        ("whisper_enc_f32", 4, 20, 20, 64, 64, 64, f32, False, 0, 0.0),
        ("whisper_dec_d64_bf16", 4, 20, 20, 512, 512, 64, bf16, True, 0,
         0.0),
        # gemma2-27b's prefill past its window: a local layer (window 4096)
        # and a global one, both capped at 50; one 8192-token sequence
        ("gemma2_local_w4096_cap50", 1, 32, 16, 8192, 8192, 128, bf16, True,
         4096, 50.0),
        ("gemma2_global_cap50", 1, 32, 16, 8192, 8192, 128, bf16, True, 0,
         50.0),
        # nemotron-4-15b (GQA 6:1) and chameleon-34b (GQA 8:1)
        ("nemotron_gqa6", 4, 48, 8, 512, 512, 128, bf16, True, 0, 0.0),
        ("chameleon_gqa8", 4, 64, 8, 512, 512, 128, bf16, True, 0, 0.0),
    ]
    worst = 0.0
    timed = {}
    for name, b, hq, hkv, sq, sk, d, dt, causal, window, cap in cases:
        q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
        opts = dict(causal=causal, window=window, logit_cap=cap)
        got = fa.flash_attention_bhsd(q, k, v, **opts)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, **opts)
        # f32: the kernel sums in another order than the plain version;
        # bf16: both round the f32 result to bf16 once (tests/test_kernels)
        tol = 1e-4 if dt == f32 else 2e-2
        err = (got.float() - want.float()).abs()
        bad = err > tol + tol * want.float().abs()
        max_err = float(err.max())
        ok = bool(torch.isfinite(got).all()) and not bool(bad.any())
        emit("kernel_check", kernel="flash_attention_bhsd", case=name,
             shape=[b, hq, hkv, sq, sk, d], dtype=str(dt),
             route=fa.route(dt), causal=causal, window=window, cap=cap,
             max_abs_err=max_err, tol=tol, ok=ok)
        if not ok:
            fail(f"flash_attention_bhsd case {name}: max_abs_err {max_err}")
        if name in FLASH_PATH_CASES:
            worst = max(worst, max_err)
            timed[name] = (q, k, v, opts)
    times = {}
    for name, (q, k, v, opts) in timed.items():
        kernel_ms = cuda_ms(lambda: fa.flash_attention_bhsd(q, k, v, **opts))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **opts))
        library, library_note = library_attention(torch, fa, q, k, v, opts)
        library_ms = cuda_ms(library) if library else None
        bound_ms, bound_by = attention_bound_ms(q, k, opts["causal"],
                                                opts["window"])
        times[name] = dict(shape=list(q.shape), kv_heads=k.shape[1],
                           dtype=str(q.dtype), route=fa.route(q.dtype),
                           causal=opts["causal"], window=opts["window"],
                           cap=opts["logit_cap"],
                           kernel_ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms, library=library_note,
                           bound_ms=bound_ms, bound_by=bound_by)
        emit("kernel_time", kernel="flash_attention_bhsd", case=name,
             **times[name])
    t = times["path"]
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "kernel_route": fa.route(bf16),
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83",
            "max_abs_err": worst, "max_err": worst, "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "path_shapes": times}


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


def phase_ssd_kernel(torch, ss):
    """SSD kernel vs its plain version on the card; times at the paths'
    shapes.  No single PyTorch call computes the SSD scan, so there is no
    library time."""
    import torch.nn.functional as F
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
        # the tensor-core route at the options above
        ("groups_2_of_4_bf16", 2, 4, 2, 64, 16, 8, 16, bf16, "normal"),
        ("single_chunk_bf16", 2, 4, 1, 256, 64, 128, 256, bf16, "normal"),
        ("ragged_c96_p40_n48_bf16", 2, 3, 1, 192, 40, 48, 96, bf16,
         "normal"),
        ("strong_decay_bf16", 2, 4, 1, 512, 64, 128, 256, bf16, "strong"),
        ("weak_decay_bf16", 2, 4, 1, 512, 64, 128, 256, bf16, "weak"),
    ]
    lib = ss._lib()
    lib.ssd_scan_scratch_floats.restype = ctypes.c_longlong
    for b, g, s, chunk in ((4, 1, 512, 256), (2, 3, 192, 96), (1, 2, 64, 16)):
        if lib.ssd_scan_scratch_floats(b, g, s, chunk) != \
                ss.scratch_numel(b, g, s, chunk):
            fail(f"scratch size of ({b}, {g}, {s}, {chunk}) differs between "
                 f"the kernel and the wrapper")
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
        y, st = ss.ssd_scan_bhsd(x, dt, a, bm, cm, chunk)
        torch.cuda.synchronize()
        y0, st0 = ss.ssd_scan_plain(x, dt, a, bm, cm, chunk)
        # f32: the kernel sums in another order than the plain version;
        # bf16: both round the f32 result to bf16 once
        tol = 1e-4 if dt_ == f32 else 2e-2
        max_err, ok = 0.0, True
        for got, want in ((y, y0), (st, st0)):
            err = (got.float() - want.float()).abs()
            max_err = max(max_err, float(err.max()))
            ok = ok and bool(torch.isfinite(got).all()) and not bool(
                (err > tol + tol * want.float().abs()).any())
        emit("kernel_check", kernel="ssd_scan_bhsd", case=name,
             shape=[b, h, g, s, p, n], chunk=chunk, dtype=str(dt_),
             route=ss.route(dt_), decay=decay, max_abs_err=max_err, tol=tol,
             ok=ok)
        if not ok:
            fail(f"ssd_scan_bhsd case {name}: max_abs_err {max_err}")
        if name.endswith("_path"):
            worst = max(worst, max_err)
            timed[name] = (x, dt, a, bm, cm, chunk)
    times = {}
    for name, (x, dt, a, bm, cm, chunk) in timed.items():
        kernel_ms = cuda_ms(lambda: ss.ssd_scan_bhsd(x, dt, a, bm, cm, chunk))
        plain_ms = cuda_ms(lambda: ss.ssd_scan_plain(x, dt, a, bm, cm, chunk))
        bound_ms, bound_by = ssd_bound_ms(x, bm, chunk)
        times[name] = dict(shape=list(x.shape) + [bm.shape[1], bm.shape[3]],
                           chunk=chunk, dtype=str(x.dtype),
                           kernel_ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=None, bound_ms=bound_ms,
                           bound_by=bound_by)
        emit("kernel_time", kernel="ssd_scan_bhsd", case=name,
             note="no single PyTorch call computes the SSD scan",
             **times[name])
    t = times["mamba2_path"]
    return {"name": "ssd_scan_bhsd", "route": "cuda",
            "kernel_route": ss.route(bf16),
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:74",
            "max_abs_err": worst, "max_err": worst, "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "path_shapes": times}


PATHS = ("codeqwen15_7b", "mamba2_1_3b", "zamba2_2_7b",
         "granite_moe_3b_a800m", "whisper_large_v3", "gemma2_27b",
         "nemotron_4_15b", "chameleon_34b")


def expected_launches(torch, cfg, n_micro: int, fa, ss) -> dict:
    """Kernel launches one serve run must make, by kernel and route: flash
    once per attention layer (or per call of the hybrid's shared block, or
    per whisper encoder layer) per microbatch's prefill, SSD once per
    Mamba2 layer per microbatch's prefill.  The route follows the inputs'
    dtype: the model's, except in whisper's encoder, where the serve's f32
    frames promote the activations to f32 (as JAX does)."""
    dt = cfg.torch_dtype
    want = {"flash_attention_bhsd": dict.fromkeys(fa.ROUTES.values(), 0),
            "ssd_scan_bhsd": dict.fromkeys(ss.ROUTES.values(), 0)}
    flash = want["flash_attention_bhsd"]
    if cfg.family in ("ssm", "hybrid"):
        want["ssd_scan_bhsd"][ss.route(dt)] += cfg.num_layers * n_micro
    if cfg.family == "hybrid":
        flash[fa.route(dt)] += (cfg.num_layers // cfg.shared_attn_period
                                * n_micro)
    elif cfg.family != "ssm":
        flash[fa.route(dt)] += cfg.num_layers * n_micro
    if cfg.family == "encdec":
        enc_dt = torch.promote_types(torch.float32, dt)
        flash[fa.route(enc_dt)] += cfg.num_encoder_layers * n_micro
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
    got = run_serving(smoke, device="cuda", params=gpu_params, **small)
    same = bool((ref["responses"] == got["responses"]).all())
    emit("serve_reference", config=smoke.name, **small,
         local_window=smoke.local_window, tokens_equal=same)
    if not same:
        fail(f"{smoke.name} served on the card differs from the CPU")

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

    steps = phase_steps(torch, cfg, params, shape)
    card = (prefill_on_card(torch, cfg, params, steps)
            if arch == DRYRUN_PREFILL else None)

    n_micro = shape["num_requests"] // shape["microbatch"]
    want = expected_launches(torch, cfg, n_micro, mods["flash_attention_bhsd"],
                             mods["ssd_scan_bhsd"])
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    res = run_serving(cfg, device="cuda", params=params, **shape)
    launches, by_route = _read_counts(kernels)
    resp = res["responses"]
    emit("serve", config=cfg.name, layers=cfg.num_layers, **shape,
         local_window=cfg.local_window, responses_shape=list(resp.shape),
         wall_s=res["wall_s"], gen_tokens_per_s=res["gen_tokens_per_s"],
         prefill_s=res["prefill_s"], decode_s=res["decode_s"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, launches_by_route=by_route,
         expected_launches_by_route=want)
    if tuple(resp.shape) != (shape["num_requests"], shape["decode_steps"]):
        fail(f"responses shape {resp.shape}")
    if resp.min() < 0 or resp.max() >= cfg.vocab_size:
        fail("token ids outside the vocabulary")
    if by_route != want or launches != {n: sum(r.values())
                                        for n, r in want.items()}:
        fail(f"{cfg.name}: kernel launches by route {by_route} (in all "
             f"{launches}), expected {want}")
    modes = (phase_serve_modes(torch, cfg, params, resp, mods)
             if arch == MODES_PATH else None)
    del res
    gc.collect()                # the engine's drops hold the KV caches
    torch.cuda.empty_cache()
    check_full_width_logits(torch, M, cfg, params, shape,
                            LOGITS_ROWS.get(arch, shape["microbatch"]))
    return launches, by_route, card, modes


MODES_PATH = "codeqwen15_7b"
SERVE_STATS = PROFILE_DIR / "serve_stats.json"


def phase_serve_modes(torch, cfg, params, tokens, mods) -> dict:
    """The serve driver's other engine modes on ``MODES_PATH`` at full
    width, with the weights and the requests of its serve run: (1) the
    compiled substrate, (2) streaming token delivery (the chunk lane from
    ``gen`` to ``assemble``), (3) 3 sessions through a resident
    ``EngineManager``, 2 at a time in threads that share the card, (4) one
    session with ``stats_json``.  Each run's tokens must equal the object
    substrate's (``tokens``); each kernel must launch once per layer per
    microbatch per session on its route, counted from 0 just before the
    run; the sessions run must hit the template cache twice; the stats
    run must write its spans and wall beside the metrics snapshot.
    Returns each mode's launches by kernel."""
    import numpy as np

    from repro_torch.launch.serve import run_serving
    fa, ss = mods["flash_attention_bhsd"], mods["ssd_scan_bhsd"]
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    n_micro = SERVE["num_requests"] // SERVE["microbatch"]
    SERVE_STATS.unlink(missing_ok=True)
    modes = (("compiled", dict(execution="compiled")),
             ("streaming", dict(streaming=True)),
             ("sessions", dict(sessions=3, max_concurrent=2)),
             ("stats_json", dict(stats_json=str(SERVE_STATS))))
    out = {}
    for mode, kw in modes:
        sessions = kw.get("sessions", 1)
        want = expected_launches(torch, cfg, n_micro * sessions, fa, ss)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        res = run_serving(cfg, device="cuda", params=params, **SERVE, **kw)
        launches, by_route = _read_counts(kernels)
        same = bool(np.array_equal(res["responses"], tokens))
        row = dict(mode=mode, config=cfg.name, options=kw, **SERVE,
                   wall_s=res["wall_s"],
                   gen_tokens_per_s=res["gen_tokens_per_s"],
                   prefill_s=res["prefill_s"], decode_s=res["decode_s"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   tokens_equal=same, launches=launches,
                   launches_by_route=by_route,
                   expected_launches_by_route=want)
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
        if by_route != want or launches != {n: sum(r.values())
                                            for n, r in want.items()}:
            fail(f"{cfg.name} {mode}: kernel launches by route {by_route} "
                 f"(in all {launches}), expected {want}")
        if sessions > 1 and res["template_hits"] != sessions - 1:
            fail(f"{cfg.name} {mode}: {res['template_hits']} template hits")
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
    plain = make_prefill_step(cfg, use_kernel=False)
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
    finite = bool(torch.isfinite(lk).all())
    diff = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    same = lk.argmax(-1) == lp.argmax(-1)
    agree = float(same.float().mean())
    # a row whose plain route puts its first two tokens within one unit in
    # the last place of the model's dtype (the head's product is rounded
    # to it) ties them: it has no top-1 for the kernel route to match
    top2 = lp.float().topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ulp = torch.finfo(cfg.torch_dtype).eps * torch.exp2(
        torch.floor(torch.log2(top2[..., 0].abs())))
    tied = margin <= ulp
    out = dict(config=cfg.name, rows=rows, prompt_len=shape["prompt_len"],
               finite=finite, max_abs_diff=diff, max_abs_logit=scale,
               top1_agreement=agree, top1_margins=margin.flatten().tolist(),
               tied_rows=int(tied.sum()),
               top1_agree_untied=bool((same | tied).all()))
    if cfg.family not in ("ssm", "hybrid", "moe"):
        emit("prefill_kernel_vs_plain", **out,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        if not finite:
            fail(f"{cfg.name}: non-finite logits at full width")
        if diff > 0.05 * scale or not out["top1_agree_untied"]:
            fail(f"{cfg.name}: kernel-route logits differ from the plain "
                 f"route by {diff} (top-1 agreement {agree}, "
                 f"{out['tied_rows']} rows tied)")
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


def phase_steps(torch, cfg, params, shape: dict):
    """The serve path's prefill and decode steps alone, without the engine:
    warm, each call on the host clock ended by a device synchronise; then a
    torch.profiler trace of one call of each (summary printed, full tables
    written under ``chiprun_out/chip_smoke/``)."""
    import numpy as np
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.train import make_decode_step, make_prefill_step
    mb, s, steps = (shape["microbatch"], shape["prompt_len"],
                    shape["decode_steps"])
    prefill_step, decode_one = make_prefill_step(cfg), make_decode_step(cfg)
    batch = prompt_batch(cfg, torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size,
                                          size=(mb, s))).cuda())
    first, cache = prefill_step(params, batch, s + steps)
    tok = first[:, None]

    def prefill():
        prefill_step(params, batch, s + steps)

    def decode():
        decode_one(params, cache, tok, s)

    out = {}
    for name, fn, n in (("prefill", prefill, 3), ("decode_step", decode, 8)):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        out[name + "_ms"] = sorted(times)[len(times) // 2] * 1e3
        out[name + "_ms_all"] = [t * 1e3 for t in times]
    out.update(step_bounds(cfg, params, mb, s, s + steps))
    emit("steps", config=cfg.name, microbatch=mb, prompt_len=s, **out)
    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        emit("profile", config=cfg.name, step=name,
             **profile_call(torch, fn, f"profile_{cfg.name}_{name}.txt"))
    return out


def profile_call(torch, fn, table_name: str) -> dict:
    """One call of ``fn`` under torch.profiler, ended by a device
    synchronise: its wall ms, device busy ms and idle share, the ten
    device kernels with the most time, and the device time of the MoE
    dispatch's and the SSD scan's index ops (``WATCHED_OPS``), where the
    call ran them (full table to ``table_name`` under
    ``chiprun_out/chip_smoke/``)."""
    from torch.profiler import ProfilerActivity, profile
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
               for e in events if e.key in WATCHED_OPS}
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                top=[{"op": k[:100], "device_ms": d, "calls": c}
                     for d, c, k in dev[:10]], ops=watched)


# the MoE dispatch (slot cumsum, scatter_add write, gather read) and the
# SSD scan's cumsum, by their device time under the op
WATCHED_OPS = ("aten::cumsum", "aten::scatter_add", "aten::gather",
               "aten::index_put_", "aten::index")


TRAIN_FULL = dict(layers=16, batch=8, seq=512, steps=4, peak_lr=3e-4)
TRAIN_ENGINE = dict(steps=40, shards=2, batch_per_shard=4, seq=128,
                    ckpt_every=20, resume_steps=4)


def train_step_bound(cfg, params, batch: int, seq: int) -> dict:
    """The least time of one dense train step on the card, from the work it
    must do on ``batch`` sequences of ``seq`` tokens.

    Operations: 6 x the parameters a token passes through (every layer
    parameter and the head, not the embedding gather) x the tokens, plus
    the causal attention pairs (QK^T and PV, forward and backward: 12 x
    heads x head_dim per visible pair per layer), at the peak of the
    params' dtype (989 TFLOP/s bf16).  Remat's recomputed forward is not
    counted: the bound is the work the step needs.  Bytes: the optimizer
    reads and writes every parameter once: the param read and written and
    the grad read in the params' dtype, m and v read and written in f32
    (22 B a param in bf16), at 3.35 TB/s.  The two times are added: the
    update waits for the last grad."""
    def numel(tree):
        return sum(t.numel() for t in _leaves(tree))
    if cfg.family != "dense":
        raise ValueError("train_step_bound counts the dense family only")
    es = params["embed"].element_size()
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    through = numel(params["layers"]) + head.numel()
    pairs = visible_pairs(seq, seq, True, 0)
    flops = (6 * through * batch * seq
             + cfg.num_layers * 12 * batch * cfg.num_heads
             * cfg.resolved_head_dim * pairs)
    opt_bytes = numel(params) * (3 * es + 16)
    flops_ms = flops / H100_PEAK_FLOPS[str(cfg.torch_dtype)] * 1e3
    bytes_ms = opt_bytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": flops_ms + bytes_ms, "bound_flops_ms": flops_ms,
            "bound_optimizer_ms": bytes_ms, "flops": flops,
            "optimizer_bytes": opt_bytes, "params": numel(params),
            "params_through": through}


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
    for kw in (dict(), dict(num_microbatches=2), dict(compress=True)):
        cpu = train_state_init(cfg, torch.Generator().manual_seed(0),
                               compress=kw.get("compress", False),
                               device="cpu")
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        step = make_train_step(cfg, peak_lr=1e-2, warmup_steps=1,
                               total_steps=8, **kw)
        rows = []
        for i in range(4):
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
        emit("train_parity", config=cfg.name, options=kw, steps=4,
             rows=rows)
    return worst


def train_engine(torch):
    """(b) ``run_training(lm100m)`` through the engine on the card, at the
    driver's defaults, with checkpoints under ``chiprun_out/``: its losses
    equal the same 40 steps run in a plain loop on the card (the same
    init, batches and step, without the engine) within 1e-4 relative;
    the last checkpoint restores bit for bit; a resumed run starts from
    the saved step.  The plain loop's wall (the same host reads of the
    loss each step) says what the engine adds.  Whether the loss falls is
    reported, not required: at these defaults the reference's own run
    does not lower it in 40 steps (``PERF.md``)."""
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
              seq=e["seq"], ckpt_dir=str(ckpt), ckpt_every=e["ckpt_every"],
              device="cuda")
    torch.cuda.reset_peak_memory_stats()
    res = run_training(cfg, steps=e["steps"], **kw)
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = train_state_init(cfg, gen, device="cuda")
    step = make_train_step(cfg, peak_lr=1e-3,
                           warmup_steps=max(e["steps"] // 10, 1),
                           total_steps=e["steps"], remat=False)
    direct = []
    t0 = time.monotonic()
    for it in range(e["steps"]):
        parts = [synthetic_batch(17, s, it, e["batch_per_shard"], e["seq"],
                                 cfg.vocab_size) for s in range(e["shards"])]
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])
                                     ).to("cuda") for k in parts[0]}
        state, m = step(state, batch)
        direct.append(float(m["loss"]))
    direct_s = time.monotonic() - t0
    del state, m
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], direct))
    tokens = e["shards"] * e["batch_per_shard"] * e["seq"]
    emit("train_engine", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, steps=e["steps"],
         tokens_per_step=tokens,
         wall_s=res["wall_s"], tokens_per_s=res["tokens_per_s"],
         first_loss=res["first_loss"], last_loss=res["last_loss"],
         loss_falls=res["last_loss"] < res["first_loss"],
         losses=res["losses"], direct_losses=direct, direct_s=direct_s,
         direct_tokens_per_s=tokens * e["steps"] / direct_s,
         max_rel_err_vs_direct=rel, drops=res["drops"],
         final_step=res["final_step"], checkpoint_step=saved,
         checkpoint_exact=exact, max_memory_allocated=peak)
    if not rel <= 1e-4:
        fail(f"lm100m through the engine: losses {res['losses']}, without "
             f"it {direct}")
    if saved != e["steps"] or res["final_step"] != e["steps"] or not exact:
        fail(f"lm100m checkpoint: saved step {saved}, final step "
             f"{res['final_step']}, restored exactly: {exact}")
    gc.collect()
    torch.cuda.empty_cache()
    again = run_training(cfg, steps=e["resume_steps"], resume=True, **kw)
    emit("train_resume", config=cfg.name, start_step=again["start_step"],
         final_step=again["final_step"], wall_s=again["wall_s"],
         losses=again["losses"])
    if again["start_step"] != e["steps"] or \
            again["final_step"] != e["steps"] + e["resume_steps"]:
        fail(f"resume started at {again['start_step']}, ended at "
             f"{again['final_step']}")
    shutil.rmtree(ckpt)       # 1.4 GB a step: too large to keep
    return res


def train_full_width(torch):
    """(c) codeqwen1.5-7b at full width, cut to 16 of 32 layers, one
    donated, rematerialised step on 8 x 512 tokens, repeated on one batch:
    the first loss equals ``forward_train``'s, the loss falls by step 4,
    grad norms are finite; steps 2-4 timed, one more profiled."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train import make_train_step, train_state_init
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
    step = make_train_step(cfg, peak_lr=f["peak_lr"], warmup_steps=1,
                           total_steps=10, remat=True, donate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for _ in range(f["steps"]):
        t0 = time.monotonic()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)
    prof = profile_call(torch, one_step, "profile_train_step.txt")
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counted:     # one more step
        one_step()
    torch.cuda.synchronize()
    card = {"flops": counted.get_total_flops(), "batch": f["batch"],
            "seq": f["seq"], "layers": cfg.num_layers, "step_ms": sorted(times[1:])[
                len(times[1:]) // 2], "bound_ms": bound["bound_ms"],
            "bound_flops_ms": bound["bound_flops_ms"]}
    del state, holder
    gc.collect()
    torch.cuda.empty_cache()
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    free_gb = (torch.cuda.get_device_properties(0).total_memory - peak) / 1e9
    emit("train_step", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, batch=f["batch"], seq=f["seq"],
         remat=True, donate=True, step_ms=step_ms, step_ms_all=times,
         tokens_per_s=f["batch"] * f["seq"] / step_ms * 1e3,
         forward_train_loss=ref, losses=losses, grad_norms=norms,
         lrs=[m["lr"] for m in metrics], max_memory_allocated=peak,
         free_gb_at_peak=free_gb, **bound, profile=prof)
    if abs(losses[0] - ref) > 1e-3 * abs(ref):
        fail(f"{cfg.name}: first step's loss {losses[0]}, forward_train "
             f"{ref}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name}: loss on the repeated batch {losses}")
    if not all(math.isfinite(n) for n in norms):
        fail(f"{cfg.name}: grad norms {norms}")
    if free_gb < 8:
        fail(f"{cfg.name}: {free_gb:.1f} GB free at the step's peak")
    return cfg, batch, card


def train_remat(torch, cfg, batch):
    """(c) At a 2-layer cut of the same width, one functional step with and
    without remat from one state: loss and grad norm within 1e-2 relative
    (bf16; recomputation repeats the same ops, so they should be equal)."""
    import dataclasses

    from repro_torch.train import make_train_step, train_state_init
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = train_state_init(cfg2, gen, device="cuda")
    out = {}
    for remat in (True, False):
        step = make_train_step(cfg2, warmup_steps=1, remat=remat)
        _, m = step(state, batch)
        out[remat] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        del m, _
    del state
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_remat", config=cfg2.name, layers=2, remat=out[True],
         no_remat=out[False])
    for k in ("loss", "grad_norm"):
        if abs(out[True][k] - out[False][k]) > 1e-2 * abs(out[False][k]):
            fail(f"remat changes the {k}: {out}")


def phase_train(torch, mods) -> tuple:
    """The train paths on the card, after the serve paths; no kernel may
    launch (training runs attention and the SSD scan as torch ops, as the
    reference does).  Returns each kernel's launches over the phase and
    the full-width train step's FLOPs and times."""
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    _zero_counts(kernels)
    refused = check_kernel_guard(torch, mods)
    worst = train_parity(torch)
    train_engine(torch)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, card = train_full_width(torch)
    train_remat(torch, cfg, batch)
    launches, _ = _read_counts(kernels)
    emit("train_launches", launches=launches, guard_refused=refused,
         parity_max_rel_err=worst)
    if any(launches.values()):
        fail(f"the train phase launched kernels: {launches}")
    return launches, card


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
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import (LINK_BW, fake_process_group,
                                         make_local_mesh)
    from repro_torch.models.common import ShapeConfig
    from repro_torch.roofline import roofline_terms
    from repro_torch.sharding import AbstractMesh
    t0 = time.monotonic()
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    _zero_counts(kernels)

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
    launches, _ = _read_counts(kernels)
    emit("dryrun_launches", launches=launches,
         seconds=time.monotonic() - t0)
    if any(launches.values()):
        fail(f"the dryrun phase launched kernels: {launches}")
    return launches


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
    ``chiprun_out/`` deleted after: the loss falls, its own check; (c) no
    kernel launched.  Returns each kernel's launches over the phase."""
    import shutil
    kernels = {name: getattr(mod, name) for name, mod in mods.items()}
    _zero_counts(kernels)

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
    try:
        train_lm.main()
    except AssertionError as err:
        fail(f"examples/torch/train_lm.py: {err}: {results[0]['losses']}")
    finally:
        sys.argv = argv
    res = results.pop()
    emit("example_train_lm", preset="lm20m", steps=len(res["losses"]),
         first_loss=res["first_loss"], last_loss=res["last_loss"],
         wall_s=res["wall_s"], tokens_per_s=res["tokens_per_s"],
         drops=res["drops"], final_step=res["final_step"],
         checkpoints=sorted(p.name for p in TRAIN_LM_CKPT.iterdir()),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del res
    shutil.rmtree(TRAIN_LM_CKPT)
    launches, _ = _read_counts(kernels)
    emit("examples_launches", launches=launches)
    if any(launches.values()):
        fail(f"the examples phase launched kernels: {launches}")
    return launches


def check_kernel_guard(torch, mods) -> list:
    """Both kernel wrappers refuse CUDA inputs that require grad (their
    output would carry no grad_fn)."""
    fa, ss = mods["flash_attention_bhsd"], mods["ssd_scan_bhsd"]
    q = torch.randn((1, 2, 16, 16), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    x = torch.randn((1, 2, 16, 8), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    bc = torch.randn((1, 1, 16, 8), device="cuda", dtype=torch.bfloat16)
    dt = torch.rand((1, 2, 16), device="cuda")
    a = -torch.rand((2,), device="cuda")
    calls = {"flash_attention_bhsd": lambda: fa.flash_attention_bhsd(
                 q, q.detach(), q.detach()),
             "ssd_scan_bhsd": lambda: ss.ssd_scan_bhsd(x, dt, a, bc, bc, 8)}
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    t_start = time.monotonic()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    build_s = _build.build()
    ptxas = {n: _build.ptxas_summary(n) for n in _build.KERNEL_SOURCES}
    emit("build", seconds=build_s, kernels=list(_build.KERNEL_SOURCES),
         ptxas=ptxas)

    entries = [phase_kernel(torch, fa), phase_ssd_kernel(torch, ss)]
    spills = [k for ks in ptxas.values() for k in ks if k["spill_bytes"]]
    if spills:
        fail(f"ptxas reports spills: {spills}")
    if "--kernels-only" in sys.argv[1:]:
        emit("done", seconds=time.monotonic() - t_start)
        print(json.dumps({"kernels": entries}), flush=True)
        return 0
    mods = {e["name"]: mod for e, mod in zip(entries, (fa, ss))}
    by_path, routes, cards = {}, {}, {}
    for arch in PATHS:
        by_path[arch], routes[arch], card, modes = phase_serve(torch, arch,
                                                               mods)
        if card is not None:
            cards["prefill"] = card
        for mode, launches in (modes or {}).items():
            by_path[f"{arch}/{mode}"] = launches
        gc.collect()                    # free the model before the next
        torch.cuda.empty_cache()
    train, cards["train_step"] = phase_train(torch, mods)
    gc.collect()
    torch.cuda.empty_cache()
    dry = phase_dryrun(torch, mods, cards)
    examples = phase_examples(torch, mods)
    for e in entries:
        e["launches_by_path"] = {a: n[e["name"]] for a, n in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        e["launches_by_path"]["train"] = train[e["name"]]
        e["launches_by_path"]["dryrun"] = dry[e["name"]]
        e["launches_by_path"]["examples"] = examples[e["name"]]
        e["launches_by_route"] = {
            r: sum(routes[a][e["name"]][r] for a in routes)
            for r in routes[PATHS[0]][e["name"]]}

    emit("done", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
