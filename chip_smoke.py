#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repo root with no arguments:

    python3 chip_smoke.py

Full profiler tables land in ``chiprun_out/chip_smoke/`` (gitignored).
Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: compile every CUDA kernel from ``src/repro_torch/csrc`` with nvcc.
3. kernel: each kernel against its plain PyTorch version on the card, at
   the serve path's shape and at the option cases; times of the kernel,
   the plain version and one library call at the path shape, CUDA events.
4. serve: a smoke config served on the card must give the CPU's tokens.
   Then codeqwen1.5-7b at full width and depth (random weights from a
   seed): its prefill and decode steps timed alone and profiled, then 8
   requests x 16 tokens through the engine; the
   kernel's launch count over that run must equal layers x microbatches,
   and full-width prefill logits through the kernel must be finite.
5. the kernels line, the card line, then the result line.

It imports nothing of JAX or of the JAX package.  Without CUDA it exits 2.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
PROFILE_DIR = ROOT / "chiprun_out" / "chip_smoke"   # gitignored

SERVE = dict(num_requests=8, microbatch=4, prompt_len=512, decode_steps=16)
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    import torch.nn.functional as F
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
    ]
    worst = 0.0
    path_inputs = None
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
             shape=[b, hq, hkv, sq, sk, d], dtype=str(dt), causal=causal,
             window=window, cap=cap, max_abs_err=max_err, tol=tol, ok=ok)
        if not ok:
            fail(f"flash_attention_bhsd case {name}: max_abs_err {max_err}")
        if name == "path":
            worst = max_err
            path_inputs = (q, k, v, opts)
    q, k, v, opts = path_inputs
    kernel_ms = cuda_ms(lambda: fa.flash_attention_bhsd(q, k, v, **opts))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **opts))
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(q, k, opts["causal"],
                                            opts["window"])
    emit("kernel_time", kernel="flash_attention_bhsd",
         shape=list(q.shape), dtype=str(q.dtype), kernel_ms=kernel_ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
         bound_by=bound_by)
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83",
            "max_abs_err": worst, "max_err": worst, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_serve(torch, fa):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import model as M

    # small reference: the smoke config on the card (kernel route, f32)
    # gives exactly the CPU's greedy tokens (plain route) on equal weights
    smoke = get_smoke_config("codeqwen15_7b")
    cpu_params = M.init_params(smoke, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    small = dict(num_requests=4, microbatch=2, prompt_len=24, decode_steps=6)
    ref = run_serving(smoke, device="cpu", params=cpu_params, **small)
    got = run_serving(smoke, device="cuda", params=gpu_params, **small)
    same = bool((ref["responses"] == got["responses"]).all())
    emit("serve_reference", config=smoke.name, **small, tokens_equal=same)
    if not same:
        fail("smoke serve on the card differs from the CPU reference")

    cfg = get_config("codeqwen15_7b")
    t0 = time.monotonic()
    params = M.init_params(cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    emit("init", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, seconds=init_s,
         bytes=sum(t.numel() * t.element_size() for t in _leaves(params)))

    phase_steps(torch, cfg, params)

    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_bhsd.launches = 0
    res = run_serving(cfg, device="cuda", params=params, **SERVE)
    launches = fa.flash_attention_bhsd.launches
    n_micro = SERVE["num_requests"] // SERVE["microbatch"]
    resp = res["responses"]
    emit("serve", config=cfg.name, layers=cfg.num_layers, **SERVE,
         responses_shape=list(resp.shape), wall_s=res["wall_s"],
         gen_tokens_per_s=res["gen_tokens_per_s"],
         prefill_s=res["prefill_s"], decode_s=res["decode_s"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         flash_launches=launches,
         expected_launches=cfg.num_layers * n_micro)
    if tuple(resp.shape) != (SERVE["num_requests"], SERVE["decode_steps"]):
        fail(f"responses shape {resp.shape}")
    if resp.min() < 0 or resp.max() >= cfg.vocab_size:
        fail("token ids outside the vocabulary")
    if launches != cfg.num_layers * n_micro:
        fail(f"flash_attention_bhsd launched {launches} times, expected "
             f"{cfg.num_layers * n_micro}")

    # full width: prefill logits through the kernel vs the plain torch ops
    import numpy as np
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(SERVE["microbatch"], SERVE["prompt_len"]))
    ).cuda()
    with torch.inference_mode():
        lk, _ = M.prefill(params, cfg, {"tokens": tokens}, use_kernel=True)
        lp, _ = M.prefill(params, cfg, {"tokens": tokens}, use_kernel=False)
    finite = bool(torch.isfinite(lk).all())
    diff = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    emit("prefill_kernel_vs_plain", config=cfg.name, finite=finite,
         max_abs_diff=diff, max_abs_logit=scale, top1_agreement=agree)
    if not finite:
        fail("non-finite logits at full width")
    # both routes round activations to bf16 (2^-8 relative) at other
    # points, and 32 residual layers carry the difference: 5% of the range
    if diff > 0.05 * scale:
        fail(f"kernel-route logits differ from the plain route by {diff}")
    return launches


def phase_steps(torch, cfg, params):
    """The serve path's prefill and decode steps alone, without the engine:
    warm, each call on the host clock ended by a device synchronise; then a
    torch.profiler trace of one call of each (summary printed, full tables
    written under ``chiprun_out/chip_smoke/``)."""
    import numpy as np
    from repro_torch.train import make_decode_step, make_prefill_step
    mb, s, steps = (SERVE["microbatch"], SERVE["prompt_len"],
                    SERVE["decode_steps"])
    prefill_step, decode_one = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(mb, s))).cuda()
    first, cache = prefill_step(params, {"tokens": tokens}, s + steps)
    tok = first[:, None]

    def prefill():
        prefill_step(params, {"tokens": tokens}, s + steps)

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
    # decode bound: every weight read once; prefill bound: the layers'
    # matmul FLOPs for every prompt token, attention over the causal
    # pairs, and the head for the last position only
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    layer_params = sum(t.numel() for t in _leaves(params["layers"]))
    hd = cfg.resolved_head_dim
    prefill_flops = (2 * layer_params * mb * s
                     + cfg.num_layers * 4 * mb * cfg.num_heads * hd
                     * visible_pairs(s, s, True, 0)
                     + 2 * mb * cfg.d_model * cfg.padded_vocab)
    emit("steps", config=cfg.name, microbatch=mb, prompt_len=s,
         decode_bound_ms=weight_bytes / H100_BYTES_PER_S * 1e3,
         prefill_bound_ms=prefill_flops
         / H100_PEAK_FLOPS["torch.bfloat16"] * 1e3, **out)
    from torch.profiler import ProfilerActivity, profile
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        events = prof.key_averages()
        table = events.table(sort_by="self_cuda_time_total", row_limit=40)
        (PROFILE_DIR / f"profile_{name}.txt").write_text(table)
        # device kernels only: op-level rows repeat their kernels' time
        cuda = torch.autograd.DeviceType.CUDA
        dev = sorted(((_self_device_us(e) / 1e3, e.count, e.key)
                      for e in events if e.device_type == cuda
                      and not getattr(e, "is_user_annotation", False)),
                     reverse=True)
        busy_ms = sum(d for d, _, _ in dev)
        emit("profile", step=name, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
             top=[{"op": k[:100], "device_ms": d, "calls": c}
                  for d, c, k in dev[:10]])


def _self_device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return us if us is not None else getattr(event, "self_cuda_time_total", 0)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

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
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.KERNEL_SOURCES}
    emit("build", seconds=build_s, kernels=list(_build.KERNEL_SOURCES),
         ptxas=ptxas)

    entry = phase_kernel(torch, fa)
    entry["launches"] = phase_serve(torch, fa)

    emit("done", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
