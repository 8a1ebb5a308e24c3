"""Build-time choices of the bf16 kernels, timed at the serve shapes.

Run on a CUDA card from the repo root:

    PYTHONPATH=src python -m repro_torch.kernels.tune

Flash attention: one build of ``csrc/flash_attention.cu`` per (FLASH_BQ,
FLASH_BK, FLASH_MW) tile choice, at the codeqwen1.5-7b shape (D=128) and the
zamba2-2.7b shared-block shape (D=80), beside
``F.scaled_dot_product_attention``.  SSD scan: one build of
``csrc/ssd_scan.cu`` per SSD_MIN_BLOCKS (blocks an SM, which sets the
register cap), at the mamba2-1.3b and zamba2-2.7b shapes.  Each build is
first checked against the plain version (the bf16 tolerance of
``chip_smoke.py``), then timed with CUDA events over 50 calls after 5
warm-up calls, variants in turn and then in reverse order.  Prints the
card's name and power limit, then one JSON line per variant and shape with
its times and its ptxas registers and spills.
"""
from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from . import _build
from . import flash_attention as fa
from . import ssd_scan as ss

# (BQ, BK, MW): query rows, keys per tile, 16-row m-tiles per warp
FLASH_TILES = ((64, 32, 1), (64, 64, 1), (128, 32, 2), (128, 64, 2),
               (64, 32, 2), (256, 32, 2))
FLASH_SHAPES = {"codeqwen": (4, 32, 512, 128), "zamba2": (4, 32, 512, 80)}
SSD_MIN_BLOCKS = (2, 1)
# B, H, S, P, N, chunk
SSD_SHAPES = {"mamba2": (4, 64, 512, 64, 128, 256),
              "zamba2": (4, 80, 512, 64, 64, 256)}
TOL = 2e-2


def _ms(fn, iters: int = 50, warmup: int = 5) -> float:
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


def _check(name, got, want) -> None:
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        if bool((err > TOL + TOL * w.float().abs()).any()) \
                or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{name}: max_abs_err {float(err.max())}")


def _sweep(source, variants, defines, cases, lib_of, run, plain, extra=None):
    """Check, then time every (variant, case) in turn and in reverse."""
    libs = {v: lib_of(defines(v)) for v in variants}
    for v in variants:
        for name, args in cases.items():
            _check(f"{source} {v} {name}", run(libs[v], args), plain(args))
    times = {(v, n): [] for v in variants for n in cases}
    ref = {n: [] for n in cases}
    for order in (variants, variants[::-1]):
        for v in order:
            for name, args in cases.items():
                times[(v, name)].append(_ms(lambda: run(libs[v], args)))
                if extra:
                    ref[name].append(_ms(lambda: extra(args)))
    for (v, name), ms in times.items():
        print(json.dumps({"source": source, "defines": list(defines(v)),
                          "shape": name, "kernel_ms": ms,
                          **({"sdpa_ms": ref[name]} if extra else {}),
                          "ptxas": _build.ptxas_summary(source, defines(v))}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    flash_cases = {n: tuple(randn(*s).bfloat16() for _ in range(3))
                   for n, s in FLASH_SHAPES.items()}

    def flash_run(lib, qkv):
        out = torch.empty_like(qkv[0])
        fa.launch(lib, *qkv, out, True, 0, 0.0)
        return (out,)

    _sweep("flash_attention", FLASH_TILES,
           lambda v: (f"FLASH_BQ={v[0]}", f"FLASH_BK={v[1]}",
                      f"FLASH_MW={v[2]}"), flash_cases,
           fa._lib, flash_run, lambda qkv: (fa.flash_attention_plain(*qkv),),
           extra=lambda qkv: F.scaled_dot_product_attention(*qkv,
                                                            is_causal=True))

    ssd_cases = {}
    for n, (b, h, s, p, nn, chunk) in SSD_SHAPES.items():
        ssd_cases[n] = (randn(b, h, s, p, scale=0.5).bfloat16(),
                        F.softplus(randn(b, h, s)),
                        -torch.exp(randn(h, scale=0.3)),
                        randn(b, 1, s, nn, scale=0.5).bfloat16(),
                        randn(b, 1, s, nn, scale=0.5).bfloat16(), chunk)
    _sweep("ssd_scan", SSD_MIN_BLOCKS, lambda v: (f"SSD_MIN_BLOCKS={v}",),
           ssd_cases, ss._lib, lambda lib, args: ss.launch(lib, *args),
           lambda args: ss.ssd_scan_plain(*args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
