"""Build-time choices of the bf16 kernels, timed at the serve shapes.

Run on a CUDA card from the repo root:

    PYTHONPATH=src python -m repro_torch.kernels.tune \
        [--after-gemm | --ssd | --decode | --norm-bwd]

Flash attention, ``wgmma_bf16`` route (D = 64, 80 and 128): one build of
``csrc/flash_attention.cu`` per (FLASH_WG_BK, FLASH_WG_ST,
FLASH_WG_PINGPONG, FLASH_WG_PERSISTENT) choice (keys a kv tile, stages of
the K and V rings, the consumer warpgroups taking turns to issue or not,
one block an SM walking the work items or one block a work item, or
unset: the kernel's own rule by the number of work items), at the
codeqwen1.5-7b, granite-moe-3b-a800m, nemotron-4-15b, chameleon-34b,
zamba2-2.7b (its shared block's D = 80) and gemma2-27b (windowed and
global, capped, 8192 tokens, one sequence and the serve path's two)
shapes.  Flash attention, ``mma_bf16`` route: one
build per (FLASH_BQ, FLASH_BK, FLASH_MW) tile choice with FLASH_FORCE_MMA
(so D = 128 runs it too), at the codeqwen1.5-7b shape (D=128) and the
zamba2-2.7b shared-block shape (D=80), beside
``F.scaled_dot_product_attention``.  SSD scan, ``wgmma_bf16`` route: one
build of ``csrc/ssd_scan.cu`` per SSD_WG_HEADS (heads a y work item: 2,
the default, or 1), and the old ``mma_bf16`` route built with
SSD_FORCE_MMA, at the mamba2-1.3b and zamba2-2.7b shapes.  Every variant
builds at once, one nvcc each.  Each build is first checked against the
plain version (the bf16 tolerance of ``chip_smoke.py``), then timed with
CUDA events over 50 calls after 5 warm-up calls, queued behind a device
sleep, variants in turn and then in reverse order.  Prints the card's
name and power limit, then one JSON line per variant and shape with its
times and its ptxas registers, spills and warnings.

``--ssd`` builds and times only the SSD scan's variants.
``--decode`` builds decode attention (its default and one build per
``DECODE_TILES`` tile of the ``mma_bf16`` route) and times both bf16
routes at every split count from 1 to 8, each launch checked against the
plain version, at each serve path's decode shape at its last row (bf16)
and at command-r-plus-104b's 12 query heads a kv head (``splits_ms``
lines by route and tile, beside the count the wrapper's rule picks from
that build's occupancy, ``rule``, and the best count, ``best``).
``--norm-bwd`` builds ``csrc/norm_rope.cu`` twice, as it is and with
``-DNORM_BWD_FORCE_REGS`` (the register route at every width: the old
route), and times the norm's backward on both, in turns (new, old, old,
new), at the path shapes of ``NORM_BWD_SHAPES`` (codeqwen1.5-7b's plain
and add norms, mamba2-1.3b's and zamba2-2.7b's gated norms, z a slice of
the input projection, lm100m's f32 norm; and mamba2's gate with z drawn 40
times wider, or holding signed zeros, where the staged route's silu leaves
its fast division),
beside the bound (each input
read and each output written once at the card's memory rate); each
instance's route, stages, registers a thread, spills and resident blocks
an SM (``norm_rope.card_plan``), and the largest distance in ulps of every
output of the new route from the old route's (``max_ulp``; dscale's and
dbias's bits compared too).  Each new output is first checked against the
plain version (``TOL``).
``--after-gemm`` instead times the default build of flash at gemma2-27b's
8192-token shapes (one sequence and its serve's two) back to back and
right after bf16 GEMMs of its MLP's size, as its prefill runs it, with
the SM clock and power draw nvidia-smi reads during each.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from . import _build
from . import decode_attention as da
from . import flash_attention as fa
from . import norm_rope as nr
from . import ssd_scan as ss
from ..launch.mesh import HBM_BW

# (BK, stages, ping-pong, persistent) of the wgmma_bf16 route; persistent
# None: the kernel's rule (by work items an SM)
WGMMA_VARIANTS = ((128, 2, 1, None), (128, 2, 1, 1), (128, 2, 1, 0),
                  (128, 2, 0, 1), (128, 2, 0, 0), (64, 2, 1, 1),
                  (64, 4, 1, 1))
# B, Hq, Hkv, S, D, causal, window, cap
WGMMA_SHAPES = {"codeqwen": (4, 32, 32, 512, 128, True, 0, 0.0),
                "granite": (4, 24, 8, 512, 64, True, 0, 0.0),
                "nemotron": (4, 48, 8, 512, 128, True, 0, 0.0),
                "chameleon": (4, 64, 8, 512, 128, True, 0, 0.0),
                "zamba2": (4, 32, 32, 512, 80, True, 0, 0.0),
                "gemma2_local": (1, 32, 16, 8192, 128, True, 4096, 50.0),
                "gemma2_global": (1, 32, 16, 8192, 128, True, 0, 50.0),
                "gemma2_local_b2": (2, 32, 16, 8192, 128, True, 4096, 50.0),
                "gemma2_global_b2": (2, 32, 16, 8192, 128, True, 0, 50.0)}
# (BQ, BK, MW) of the mma_bf16 route: query rows, keys per tile, 16-row
# m-tiles per warp
FLASH_TILES = ((64, 32, 1), (64, 64, 1), (128, 32, 2), (128, 64, 2),
               (64, 32, 2), (256, 32, 2))
FLASH_SHAPES = {"codeqwen": (4, 32, 512, 128), "zamba2": (4, 32, 512, 80)}
# heads a y work item of the SSD's wgmma_bf16 route (SSD_WG_HEADS); None:
# the old mma_bf16 route (SSD_FORCE_MMA)
SSD_VARIANTS = (2, 1, None)
# gemma2-27b's MLP up-projection on its serve microbatch (2 x 8192 tokens,
# d_model 4608, d_ff 36864): M, K, N of the GEMMs that run between two
# attention calls in its prefill
GEMM_LOAD = (16384, 4608, 36864)
# B, H, S, P, N, chunk
SSD_SHAPES = {"mamba2": (4, 64, 512, 64, 128, 256),
              "zamba2": (4, 80, 512, 64, 64, 256)}
# B, nq, nkv, T, D, window, cap, all rows: each serve path's decode shape
DECODE_SHAPES = {"codeqwen": (4, 32, 32, 528, 128, 0, 0.0, False),
                 "gemma2_local": (2, 32, 16, 8208, 128, 4096, 50.0, False),
                 "gemma2_global": (2, 32, 16, 8208, 128, 0, 50.0, False),
                 "nemotron": (4, 48, 8, 528, 128, 0, 0.0, False),
                 "chameleon": (4, 64, 8, 528, 128, 0, 0.0, False),
                 "granite": (4, 24, 8, 528, 64, 0, 0.0, False),
                 "whisper_self": (4, 20, 20, 528, 64, 0, 0.0, False),
                 "whisper_cross": (4, 20, 20, 66, 64, 0, 0.0, True),
                 "zamba2": (4, 32, 32, 528, 80, 0, 0.0, False),
                 "command_r_plus": (4, 96, 8, 528, 128, 0, 0.0, False)}
# mma_bf16's tiles (DECODE_MMA_ROWS, _STAGES, _WARPS: K / V rows a ring
# stage, stages, consumer warps); None: the default build
DECODE_DEFAULT_TILE = (64, 2, 4)
DECODE_TILES = (None, (64, 3, 4), (32, 4, 4), (128, 2, 4), (64, 2, 2),
                (64, 2, 8))
TOL = 2e-2
# the norm backward's shapes: prologue, rows' shape, x dtype, scale dtype,
# the gated norm's projection width (z its first columns; 0 otherwise),
# bias (the add norm's, of the scale's dtype); and the gate with z drawn 40
# times wider (its silu past the fast division's range: the bits there)
NORM_BWD_SHAPES = {
    "codeqwen_norm": ("", (8, 512, 4096), "bfloat16", "bfloat16", 0, False),
    "codeqwen_add": ("add", (8, 512, 4096), "bfloat16", "bfloat16", 0,
                     True),
    "mamba2_gate": ("gate", (4, 512, 4096), "bfloat16", "bfloat16", 8512,
                    False),
    "zamba2_gate": ("gate", (4, 512, 5120), "bfloat16", "bfloat16", 10448,
                    False),
    "lm100m_norm_f32": ("", (8, 128, 768), "float32", "float32", 0, False),
    "mamba2_gate_z_x40": ("gate", (4, 512, 4096), "bfloat16", "bfloat16",
                          8512, False),
    "mamba2_gate_z_zeros": ("gate", (4, 512, 4096), "bfloat16", "bfloat16",
                            8512, False),
}
NORM_BWD_Z_SCALE = {"mamba2_gate_z_x40": 40.0}
# a gate whose z holds signed zeros (every 7th element -0, every 13th +0):
# silu(-0) is -0, which the fast division would give as +0
NORM_BWD_Z_ZEROS = {"mamba2_gate_z_zeros"}


def _ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device ms per call, the calls queued behind a ~20 ms device sleep
    so that short kernels are not timed at the host's pace."""
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


def _check(name, got, want) -> None:
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        if bool((err > TOL + TOL * w.float().abs()).any()) \
                or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{name}: max_abs_err {float(err.max())}")


def _sweep(source, variants, defines, cases, lib_of, run, plain,
           extra=None):
    """Check, then time every (variant, case) in turn and in reverse;
    ``run(v, lib, args)`` calls variant v's library."""
    libs = {v: lib_of(defines(v)) for v in variants}
    for name, args in cases.items():
        want = plain(args)
        for v in variants:
            _check(f"{source} {v} {name}", run(v, libs[v], args), want)
        del want
    times = {(v, n): [] for v in variants for n in cases}
    ref = {n: [] for n in cases}
    for order in (variants, variants[::-1]):
        for v in order:
            for name, args in cases.items():
                times[(v, name)].append(_ms(lambda: run(v, libs[v], args)))
                if extra:
                    ref[name].append(_ms(lambda: extra(args)))
    for (v, name), ms in times.items():
        print(json.dumps({"source": source, "defines": list(defines(v)),
                          "shape": name, "kernel_ms": ms,
                          **({"sdpa_ms": ref[name]} if extra else {}),
                          "ptxas": _build.ptxas_summary(source, defines(v))}),
              flush=True)


def _wgmma_defines(v):
    return (f"FLASH_WG_BK={v[0]}", f"FLASH_WG_ST={v[1]}",
            f"FLASH_WG_PINGPONG={v[2]}") + (
        () if v[3] is None else (f"FLASH_WG_PERSISTENT={v[3]}",))


def _ssd_defines(v):
    return ("SSD_FORCE_MMA",) if v is None else (f"SSD_WG_HEADS={v}",)


def _ssd_run(v, lib, args):
    x, bm = args[0], args[3]
    kind = ("mma_bf16" if v is None
            else ss.route(x.dtype, x.shape[3], bm.shape[3]))
    return ss.launch(lib, *args, kind)


def _mma_defines(v):
    return ("FLASH_FORCE_MMA", f"FLASH_BQ={v[0]}", f"FLASH_BK={v[1]}",
            f"FLASH_MW={v[2]}")


def _smi_sample() -> subprocess.Popen:
    return subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader"],
                            stdout=subprocess.PIPE, text=True)


def flash_after_gemm(cases: dict, reps: int = 20, gemms: int = 6) -> None:
    """Per case: flash ms back to back (``_ms``) and, one call at a time,
    right after ``gemms`` GEMMs of ``GEMM_LOAD``, with the SM clock and
    power nvidia-smi reads while each runs."""
    m, k, n = GEMM_LOAD
    a = torch.randn(m, k, device="cuda").bfloat16()
    w = torch.randn(k, n, device="cuda").bfloat16()
    for name, (q, kk, v, causal, window, cap) in cases.items():
        def call():
            return fa.flash_attention_bhsd(q, kk, v, causal=causal,
                                           window=window, logit_cap=cap)
        alone_ms = _ms(call)
        for _ in range(400):            # ~1 s of calls queued
            call()
        smi = _smi_sample()
        alone_smi = smi.communicate(timeout=60)[0].strip()
        torch.cuda.synchronize()
        events = []
        for i in range(reps):
            for _ in range(gemms):
                a @ w
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            events.append((start, end))
            if i == reps // 2:
                smi = _smi_sample()
        loaded_smi = smi.communicate(timeout=60)[0].strip()
        torch.cuda.synchronize()
        print(json.dumps({"experiment": "flash_after_gemm", "shape": name,
                          "gemm_mkn": list(GEMM_LOAD), "gemms": gemms,
                          "back_to_back_ms": alone_ms,
                          "back_to_back_clock_power": alone_smi,
                          "after_gemm_ms": [s.elapsed_time(e)
                                            for s, e in events],
                          "after_gemm_clock_power": loaded_smi}), flush=True)


def _ssd_sweep(randn) -> None:
    """The SSD scan's variants at the serve paths' shapes."""
    ssd_cases = {}
    for n, (b, h, s, p, nn, chunk) in SSD_SHAPES.items():
        ssd_cases[n] = (randn(b, h, s, p, scale=0.5).bfloat16(),
                        F.softplus(randn(b, h, s)),
                        -torch.exp(randn(h, scale=0.3)),
                        randn(b, 1, s, nn, scale=0.5).bfloat16(),
                        randn(b, 1, s, nn, scale=0.5).bfloat16(), chunk)
    _sweep("ssd_scan", SSD_VARIANTS, _ssd_defines, ssd_cases, ss._lib,
           _ssd_run, lambda args: ss.ssd_scan_plain(*args))


def _decode_defines(v):
    if v is None:
        return ()
    return (f"DECODE_MMA_ROWS={v[0]}", f"DECODE_MMA_STAGES={v[1]}",
            f"DECODE_MMA_WARPS={v[2]}")


def _decode_run(lib, args, splits, route):
    q, k, v, pos, window, cap, all_rows = args
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    da.launch(lib, q, k, v, None if all_rows else pos, out, window, cap,
              splits, route)
    return out


def _decode_sweep(randn) -> None:
    """Decode attention at every split count on both bf16 routes (the
    ``mma_bf16`` route in each tile of ``DECODE_TILES``), each launch
    checked against the plain version (2e-5 x max|V|, ``chip_smoke.py``'s
    tolerance), then timed in turn and in reverse, at the
    ``DECODE_SHAPES``, beside the split count the wrapper's rule picks from
    that build's occupancy (``rule``) and the best count (``best``)."""
    _build.build([], variants=[("decode_attention", _decode_defines(v))
                               for v in DECODE_TILES])
    runs = [("splitk_bf16", None)] + [("mma_bf16", v) for v in DECODE_TILES]
    libs = {v: da._lib(_decode_defines(v)) for v in DECODE_TILES}
    for name, (b, nq, nkv, t, d, window, cap, rows) in DECODE_SHAPES.items():
        args = (randn(b, nq, d).bfloat16(), randn(b, t, nkv, d).bfloat16(),
                randn(b, t, nkv, d).bfloat16(),
                torch.tensor(t - 1, device="cuda"), window, cap, rows)
        want = da.decode_attention_plain(*args[:4], window=window,
                                         logit_cap=cap, all_rows=rows)
        tol = 2e-5 * float(args[2].float().abs().max())
        counts = range(1, da.MAX_SPLITS + 1)
        for route, v in runs:
            for s in counts:
                err = float((_decode_run(libs[v], args, s, route)
                             - want).abs().max())
                if not err <= tol:
                    raise SystemExit(f"decode_attention {name} {route} {v} "
                                     f"splits {s}: max_abs_err {err} "
                                     f"(tol {tol})")
        ms = {(r, v, s): [] for r, v in runs for s in counts}
        for order in (runs, runs[::-1]):
            for r, v in order:
                for s in counts:
                    ms[(r, v, s)].append(_ms(
                        lambda: _decode_run(libs[v], args, s, r)))
        for r, v in runs:
            chunks, heads = da.head_chunks(nq // nkv, r, d)
            occ = da.occupancy(libs[v], r, d, heads)
            rule = da.num_splits(b * nkv * chunks,
                                 da.row_bound(t, window, rows),
                                 2 * d * args[1].element_size(), occ)
            mean = {s: sum(ms[(r, v, s)]) / 2 for s in counts}
            best = min(mean, key=mean.get)
            print(json.dumps({
                "source": "decode_attention", "shape": name, "route": r,
                "tile": list(v or DECODE_DEFAULT_TILE),
                "routed": da.route(torch.bfloat16, nq // nkv, d),
                "splits_ms": {s: ms[(r, v, s)] for s in counts},
                "resident_blocks": occ.blocks, "rows_in_flight": occ.rows,
                "rule": rule, "best": best,
                "rule_over_best": mean[rule] / mean[best],
                "ptxas": _build.ptxas_summary("decode_attention",
                                              _decode_defines(v))}),
                flush=True)
        del args, want


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in ulps between two tensors of one float
    dtype (their bits as ordered integers)."""
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]

    def ordered(t):
        b = t.contiguous().view(ints).long()
        top = 1 << (8 * got.element_size() - 1)
        return torch.where(b < 0, -(b + top), b)
    return int((ordered(got) - ordered(want)).abs().max())


def _norm_bwd_case(randn, prologue, shape, x_dt, s_dt, width, bias,
                   z_scale=1.0, z_zeros=False):
    """A norm backward case's call on a library's build (``run(defines)``,
    returning its outputs), the plain version's outputs and the bound's
    bytes (each input read and each output written once)."""
    xd, sd = getattr(torch, x_dt), getattr(torch, s_dt)
    n = shape[-1]
    x, dy = randn(*shape).to(xd), randn(*shape).to(xd)
    scale = randn(n, scale=0.1).to(sd)
    if prologue == "add":
        dres = randn(*shape).to(xd)
        b_dt = sd if bias else None

        def run(defines):
            return [t for t in nr.add_rms_norm_bwd(
                x, scale, dy, dres, b_dt, defines=defines) if t is not None]
        plain = nr.add_rms_norm_bwd_plain(x, scale, dy, dres, b_dt)
        ins, outs = (x, dy, dres, scale), (x, scale) + ((scale,) if bias
                                                          else ())
    elif prologue == "gate":
        z = randn(*shape[:-1], width, scale=z_scale).to(xd)[..., :n]
        if z_zeros:
            z[..., ::7] = -0.0
            z[..., ::13] = 0.0

        def run(defines):
            return list(nr.gated_rms_norm_bwd(x, z, scale, dy,
                                              defines=defines))
        plain = nr.gated_rms_norm_bwd_plain(x, z, scale, dy)
        ins, outs = (x, x, dy, scale), (x, x, scale)
    else:
        def run(defines):
            return list(nr.rms_norm_bwd(x, scale, dy, defines=defines))
        plain = nr.rms_norm_bwd_plain(x, scale, dy)
        ins, outs = (x, dy, scale), (x, scale)
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    return run, [t for t in plain if t is not None], nbytes


def _norm_bwd_sweep(randn) -> None:
    """The norm backward on its new route and on the old (the
    ``FORCE_REGS_DEFINES`` build) at ``NORM_BWD_SHAPES``: checked, then
    timed in turns (new, old, old, new)."""
    old = nr.FORCE_REGS_DEFINES
    _build.build([], variants=[("norm_rope", ()), ("norm_rope", old)])
    for name, (pro, shape, x_dt, s_dt, width, bias) in \
            NORM_BWD_SHAPES.items():
        run, plain, nbytes = _norm_bwd_case(
            randn, pro, shape, x_dt, s_dt, width, bias,
            NORM_BWD_Z_SCALE.get(name, 1.0), name in NORM_BWD_Z_ZEROS)
        new_out, old_out = run(()), run(old)
        _check(f"norm_bwd {name}", new_out, plain)
        ms = {"new": [], "old": []}
        for which in ("new", "old", "old", "new"):
            defs = () if which == "new" else old
            ms[which].append(_ms(lambda: run(defs)))
        bound_ms = nbytes / HBM_BW * 1e3
        n = shape[-1]
        plans = {w: nr.card_plan(nr._lib(d), pro, getattr(torch, x_dt),
                                 getattr(torch, s_dt), n,
                                 n % nr.VEC == 0 and not width % 8)
                 for w, d in (("new", ()), ("old", old))}
        mean = {w: sum(v) / 2 for w, v in ms.items()}
        print(json.dumps({
            "source": "norm_rope", "experiment": "norm_bwd", "shape": name,
            "prologue": pro, "rows": list(shape), "x": x_dt, "scale": s_dt,
            "z_width": width, "bias": bias,
            "route": plans["new"]["route"], "ms": ms,
            "new_ms": mean["new"], "old_ms": mean["old"],
            "bound_ms": bound_ms, "bound_bytes": nbytes,
            "new_share_of_bound": bound_ms / mean["new"],
            "old_share_of_bound": bound_ms / mean["old"],
            "plans": plans,
            "max_ulp": [_ulps(a, b) for a, b in zip(new_out, old_out)],
            "same_bits": [bool(torch.equal(a.view(torch.uint8),
                                           b.view(torch.uint8)))
                          for a, b in zip(new_out, old_out)],
            "ptxas": {w: [k for k in _build.ptxas_summary("norm_rope", d)
                          if "rms_norm_bwd" in k["kernel"]]
                      for w, d in (("new", ()), ("old", old))}}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--after-gemm", action="store_true",
                    help="only time flash after GEMMs at gemma2-27b's "
                         "8192-token shapes")
    ap.add_argument("--ssd", action="store_true",
                    help="only build and time the SSD scan's variants")
    ap.add_argument("--decode", action="store_true",
                    help="only build and time decode attention's split "
                         "counts")
    ap.add_argument("--norm-bwd", action="store_true",
                    help="only build and time the norm backward's staged "
                         "route and its register route in turns")
    args = ap.parse_args()
    after_gemm, ssd_only = args.after_gemm, args.ssd
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

    if args.decode:
        _decode_sweep(randn)
        return 0
    if args.norm_bwd:
        _norm_bwd_sweep(randn)
        return 0
    if after_gemm:
        flash_after_gemm({
            n: (randn(b, hq, s, d).bfloat16(),
                randn(b, hkv, s, d).bfloat16(),
                randn(b, hkv, s, d).bfloat16(), causal, window, cap)
            for n, (b, hq, hkv, s, d, causal, window, cap)
            in WGMMA_SHAPES.items() if n.startswith("gemma2")})
        return 0

    _build.build([], variants=(
        [] if ssd_only else
        [("flash_attention", _wgmma_defines(v)) for v in WGMMA_VARIANTS]
        + [("flash_attention", _mma_defines(v)) for v in FLASH_TILES])
        + [("ssd_scan", _ssd_defines(v)) for v in SSD_VARIANTS])

    def flash_run(v, lib, args):
        q, k, v, causal, window, cap = args
        out = torch.empty_like(q)
        fa.launch(lib, q, k, v, out, causal, window, cap)
        return (out,)

    def flash_plain(args):
        q, k, v, causal, window, cap = args
        return (fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, logit_cap=cap),)

    if ssd_only:
        _ssd_sweep(randn)
        return 0
    wgmma_cases = {
        n: (randn(b, hq, s, d).bfloat16(), randn(b, hkv, s, d).bfloat16(),
            randn(b, hkv, s, d).bfloat16(), causal, window, cap)
        for n, (b, hq, hkv, s, d, causal, window, cap)
        in WGMMA_SHAPES.items()}
    _sweep("flash_attention", WGMMA_VARIANTS, _wgmma_defines, wgmma_cases,
           fa._lib, flash_run, flash_plain)
    del wgmma_cases

    flash_cases = {n: tuple(randn(*s).bfloat16() for _ in range(3))
                   + (True, 0, 0.0) for n, s in FLASH_SHAPES.items()}
    _sweep("flash_attention", FLASH_TILES, _mma_defines, flash_cases,
           fa._lib, flash_run, flash_plain,
           extra=lambda args: F.scaled_dot_product_attention(
               *args[:3], is_causal=True))

    _ssd_sweep(randn)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
