"""Fused flash attention: GQA + causal + window + softcap, for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_bhsd``, body ``_flash_kernel``).  The kernel is CUDA C++
written by hand for sm_90a (``repro_torch/csrc/flash_attention.cu``), built
by ``nvcc`` into a plain-C shared library and called through ctypes.

What bounds it: at the serve path's shape (B=4, H=32, S=512, D=128, bf16,
causal) the function must read q, k, v and write o once, 67 MB (20 us at
3.35 TB/s), against 8.6 GFLOP over the visible pairs (9 us at 989
TFLOP/s), so the memory traffic bounds it; at gemma2-27b's 8192 tokens the
FLOPs do.  What the design does about it: each (batch x query head,
query tile) walks the kv tiles with an online softmax, so the S x S
scores never reach device memory and K/V are read per kv head without
repeating them for GQA; kv tiles hidden by the causal mask or the window
are skipped.

Routes, fixed by dtype and head dim before the launch (``route``):
- bf16, D = 64, 80 or 128 -> ``wgmma_bf16``: warp-specialised for Hopper.
  A producer warpgroup issues TMA loads (Q once, K and V through mbarrier
  rings); two consumer warpgroups of 64 query rows run both products as
  wgmma (S = Q K^T from shared memory, O += P V with P from registers),
  the softmax on the accumulator registers, and take turns to issue so one
  warpgroup's softmax runs under the other's products; one block an SM
  walks the query tiles, heaviest first.  Each operand row is 64-column
  boxes in the 128-byte swizzle and, at zamba2's D = 80, a 16-column box
  in the 32-byte swizzle: Q K^T takes one more k16 step and P V one more
  m64n16k16 product, so D = 80 does its own work and no padded columns.
- bf16, any other D (8..256) -> ``mma_bf16``: both products on the tensor
  cores through mma.sync m16n8k16 from ldmatrix fragments, K/V tiles in a
  2-stage cp.async ring (every bf16 D with ``-DFLASH_FORCE_MMA``,
  ``chip_smoke.MMA_DEFINES``: the old route, timed in turns).  Both bf16
  routes round P to bf16 as the A operand of P V and launch the long
  causal query tiles first.
- f32, D <= 128 -> ``mma_3xtf32`` (whisper's f32 encoder): both products
  on the tensor cores as split-f32 products (``csrc/f32_split.cuh``, shared
  with the training attention: each f32 operand a TF32 big part plus its
  TF32 remainder, three mma.sync m16n8k8.tf32 products, ~21 bits a
  product; one TF32 rounding keeps 11 bits and would miss the f32
  tolerance), 32 query rows a block.  A build with ``-DFLASH_FORCE_SCALAR``
  (``FORCE_SCALAR_DEFINES``) runs ``scalar_f32`` in its place.
- f32, D > 128 -> ``scalar_f32``: scalar f32 FMAs.

Layout: (batch, heads, seq, head_dim).  ``flash_attention_bhsd`` launches
the kernel for CUDA tensors and raises on what the kernel does not take;
only CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from . import _build
from .ref import mha_reference

_COUNT_LOCK = threading.Lock()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma_bf16", "mma_bf16", "scalar_f32", "mma_3xtf32")
WGMMA_HEAD_DIMS = (64, 80, 128)
X3_MAX_HEAD_DIM = 128
# the build whose mma_3xtf32 calls run scalar_f32 (the old route, timed in
# turns with the new one)
FORCE_SCALAR_DEFINES = ("FLASH_FORCE_SCALAR",)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel instance a CUDA call of this dtype and head dim launches."""
    if dtype == torch.float32:
        return "mma_3xtf32" if head_dim <= X3_MAX_HEAD_DIM else "scalar_f32"
    if dtype == torch.bfloat16:
        return "wgmma_bf16" if head_dim in WGMMA_HEAD_DIMS else "mma_bf16"
    raise ValueError(f"dtype {dtype} not supported (float32, bfloat16)")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          logit_cap: float = 0.0) -> torch.Tensor:
    """The kernel's plain PyTorch version (f32 math, output in q's dtype)."""
    return mha_reference(q, k, v, causal=causal, window=window,
                         logit_cap=logit_cap)


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise if autograd would record a call of kernel ``name``: its output
    is written through ctypes and would carry no ``grad_fn``, so no grad
    would reach the inputs (the projections feeding attention or the scan
    would silently go untrained)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} has no backward kernel, and an input requires grad; "
            f"train with use_kernel=False, where the training route "
            f"(kernels.train_attention, forward and backward) runs the "
            f"attention that autograd records")


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("flash_attention", defines)
    fn = lib.flash_attention_bhsd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_launches.argtypes = [i]
        lib.flash_attention_launches.restype = ctypes.c_ulonglong
    return lib


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by route that ``lib``'s kernels have counted on the device
    since the library was loaded (kernel i of ``ROUTES``; a CUDA graph's
    replays included), so the route its dispatch chose can be held to
    ``route``.  A synchronous copy from the device: never call it during a
    capture."""
    out = {}
    for i, r in enumerate(ROUTES):
        n = int(lib.flash_attention_launches(i))
        if n == 2 ** 64 - 1:
            raise RuntimeError("flash_attention_launches: the copy from the "
                               "device failed")
        out[r] = n
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d (B, H, S, D)")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if min(b, hq, sq, sk) == 0:
        raise ValueError("empty attention input")
    if not (8 <= d <= 256 and d % 8 == 0):
        raise ValueError(f"head_dim {d} not in 8..256 in steps of 8")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    route(q.dtype, d)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         logit_cap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D), q's dtype.

    CUDA tensors launch the hand-written kernel on the route of the dtype
    and head dim (``route``) and count the launch in
    ``flash_attention_bhsd.launches`` and ``.launches_by_route``; a refused
    or failed launch raises, and nothing falls back.  CPU tensors take the
    plain version.  Raises
    RuntimeError, on every device, for inputs that require grad while grad
    mode is on: the kernel has no backward.
    """
    refuse_grad("flash_attention_bhsd", q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap)
    window = int(window)
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = torch.empty_like(q)
    launch(_lib(), q, k, v, out, causal, window, logit_cap)
    with _COUNT_LOCK:
        flash_attention_bhsd.launches += 1
        flash_attention_bhsd.launches_by_route[
            route(q.dtype, q.shape[3])] += 1
    return out


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, out: torch.Tensor, causal: bool, window: int,
           logit_cap: float) -> None:
    """One launch of ``lib``'s kernel on checked CUDA tensors into ``out``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bhsd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, sk, d, int(bool(causal)), window,
            float(logit_cap), 1.0 / math.sqrt(d), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bhsd launch failed: CUDA error "
                           f"{err}")


flash_attention_bhsd.launches = 0
flash_attention_bhsd.launches_by_route = dict.fromkeys(ROUTES, 0)
