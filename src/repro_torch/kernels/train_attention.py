"""The train step's attention on Hopper: forward and backward in the
reference's f32 arithmetic, as an autograd function of hand-written kernels.

Replaces no Pallas kernel: the reference trains its attention with jnp
inside the jitted train step (``repro/models/attention.py`` ``_gqa_scores``,
``softcap``, the mask, ``jax.nn.softmax``, ``_gqa_out``; ``jax.jit`` in
``repro/launch/train.py``), where XLA fuses the upcast, scale, cap, mask
and softmax around the two products.  The port's plain version
(``ref.attention_core``, the ops ``models.attention._attend`` ran before)
upcasts q, k, v to f32, multiplies on the CUDA cores and writes and reads
the whole S x S f32 score tensor about ten times a forward and a dozen a
backward.  The kernels (``repro_torch/csrc/train_attention.cu``, CUDA C++
for sm_90a, built by ``nvcc`` into a plain-C shared library and called
through ctypes) keep the scores on chip and read q, k, v once, in the
model's (B, S, H, D) layout by strides.

What bounds them: bytes.  At codeqwen1.5-7b's train shape (B = 8, 32
heads, S = 512, D = 128, causal, bf16) a forward must read q, k, v and
write o and the log-sum-exp once (134 MB, 40 us at 3.35 TB/s) against 17 us
of visible pairs at 989 TFLOP/s; the backward must move about twice the
bytes.  The design: an online softmax in the forward, P recomputed
from the log-sum-exp in a dK dV pass over key tiles and a dQ pass over
query tiles, hidden tiles skipped, every grad summed in f32 and rounded
once to the inputs' dtype, no float atomics (the same bits every run).

Routes, fixed before the launch (``route``):
- ``wgmma_bf16``: bf16 q, k, v at D = 64 and 128, the same arithmetic as
  ``mma_bf16`` in kernels designed for Hopper: a producer warpgroup feeds
  TMA rings, two consumer warpgroups take turns on wgmma (Q K^T and dO V^T
  from shared memory; P and dS as hi + lo register operands), a persistent
  grid for the forward and dQ, 64-row query tiles in dK dV.  A build with
  ``-DTRAIN_ATTN_FORCE_MMA`` (``FORCE_MMA_DEFINES``) runs ``mma_bf16`` in
  its place, for timing the old route.
- ``mma_bf16``: bf16 q, k, v with D a multiple of 8 up to 128 (the other
  head dims).  Q K^T and dO V^T on the tensor cores (mma.sync m16n8k16, f32
  accumulation: bf16 products are exact); P and dS, f32, enter P V, P^T dO,
  dS K and dS^T Q as hi + lo bf16 halves (~16 mantissa bits), never rounded
  once.
- ``mma_3xtf32``: f32 q, k, v with D a multiple of 8 up to 128 (lm100m,
  lm20m, tiny, whisper's f32 encoder), and mixed dtypes there (whisper's
  bf16 q against the f32 encoder's k and v) after an exact upcast.  Every
  product on the tensor cores as a split-f32 product (``csrc/f32_split.cuh``:
  each f32 operand a TF32 big part plus its TF32 remainder, three
  mma.sync m16n8k8.tf32 products, ~21 bits a product; one TF32 rounding
  keeps 11 bits and misses the f32 tolerance); blocks of 32 query rows or
  keys, two 16-row strips each split between two warps, so lm100m's
  shape fills the card; the dQ kernel computes delta, so a backward is
  two launches.  A build with
  ``-DTRAIN_ATTN_FORCE_SCALAR`` (``FORCE_SCALAR_DEFINES``) runs
  ``scalar_f32`` in its place, for timing the old route.
- ``scalar_f32``: the rest up to D = 256 (D > 128, or D not a multiple
  of 8), scalar f32 FMAs; bf16 and mixed dtypes there after an exact
  upcast.  An upcast is recorded by autograd, so the grads come back in
  the inputs' dtypes as the plain route's do.

The mask compares row and column indices: the plain route's mask on
positions wherever they are ``arange``.  ``models.attention._attend``
sends a masked call here only when its caller states that its positions
are ``arange`` (``forward_train``, ``encode``, ``prefill``); causal or
windowed calls must have S == T.

``train_attention`` chooses by device: CUDA tensors run ``TrainAttention``
(the forward kernel, then on the backward the delta, dQ and dK dV
kernels); CPU and meta tensors, DTensors among them, take the plain
version; a DTensor on CUDA and any other device raise.  A refused or failed
launch raises; nothing falls back.  Launches are counted on the host
(``train_attention_forward.launches`` / ``.launches_by_route``,
``train_attention_backward.launches`` / ``.launches_by_route``: one a call,
the backward's kernels together) and on the device, by kernel and
route (``kernel_launches``).
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Any, Iterable, Tuple

import numpy as np
import torch

from . import _build
from .ref import attention_core

_COUNT_LOCK = threading.Lock()
ROUTES = ("mma_bf16", "scalar_f32", "wgmma_bf16",
          "mma_3xtf32")                             # the C route ids
KERNELS = ("forward", "delta", "dkdv", "dq")        # the C kernel ids
WGMMA_HEAD_DIMS = (64, 128)
MMA_MAX_HEAD_DIM = 128
X3_MAX_HEAD_DIM = 128
F32_MAX_HEAD_DIM = 256
# routes that take f32 q, k, v (the others bf16): the wrapper upcasts
F32_ROUTES = ("mma_3xtf32", "scalar_f32")
# the route whose dQ kernel computes delta: no delta launch
DELTA_IN_DQ = ("mma_3xtf32",)
# the build whose wgmma_bf16 route runs mma_bf16 (the old route, timed in
# turns with the new one)
FORCE_MMA_DEFINES = ("TRAIN_ATTN_FORCE_MMA",)
# the build whose mma_3xtf32 route runs scalar_f32, likewise
FORCE_SCALAR_DEFINES = ("TRAIN_ATTN_FORCE_SCALAR",)
_DTYPES = (torch.float32, torch.bfloat16)


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int) -> str:
    """The route a CUDA call with these dtypes and head dim launches."""
    for name, dt in (("q", q_dtype), ("k, v", kv_dtype)):
        if dt not in _DTYPES:
            raise ValueError(f"train_attention: {name} are {dt} "
                             f"(float32, bfloat16)")
    if q_dtype == kv_dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma_bf16"
    if q_dtype == kv_dtype == torch.bfloat16 and head_dim % 8 == 0 \
            and head_dim <= MMA_MAX_HEAD_DIM:
        return "mma_bf16"
    if head_dim > F32_MAX_HEAD_DIM:
        raise ValueError(f"train_attention: head dim {head_dim} > "
                         f"{F32_MAX_HEAD_DIM}")
    if head_dim % 8 == 0 and head_dim <= X3_MAX_HEAD_DIM:
        return "mma_3xtf32"
    return "scalar_f32"


def takes_kernel(tensors: Iterable[Any]) -> bool:
    """True if ``tensors`` launch the kernels: all on CUDA, none a DTensor.
    False if they take the plain version: all on the CPU or meta, DTensors
    among them (the dry-run traces the train step on meta DTensors).
    Raises for a DTensor on CUDA (no path shards the kernels' inputs), for
    any other device and for a mix of CUDA and CPU or meta tensors."""
    kinds = set()
    for t in tensors:
        if t.device.type in ("cpu", "meta"):
            kinds.add("plain")
        elif t.device.type == "cuda":
            if getattr(t, "placements", None) is not None:
                raise ValueError("no training attention kernel for a "
                                 "DTensor on CUDA")
            kinds.add("cuda")
        else:
            raise ValueError(f"no training attention kernel or plain "
                             f"version for device {t.device}")
    if len(kinds) > 1:
        raise ValueError("training attention inputs mix CUDA and CPU or "
                         "meta tensors")
    return kinds == {"cuda"}


def train_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          logit_cap: float = 0.0) -> torch.Tensor:
    """The kernels' plain version: ``ref.attention_core`` at positions
    ``arange`` (the plain route's ops; f32 out, autograd's backward)."""
    positions = None
    if causal or window:
        positions = torch.arange(q.shape[1], device=q.device).expand(
            q.shape[0], q.shape[1])
    return attention_core(q, k, v, positions, causal=causal, window=window,
                          logit_cap=logit_cap)


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("train_attention", tuple(defines))
    if lib.train_attention_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i] * 6 + [p] * 3 + [i, i, f, f, f, i, p]
        lib.train_attention_forward.argtypes = [p] * 6 + dims
        lib.train_attention_forward.restype = i
        lib.train_attention_backward.argtypes = [p] * 10 + dims
        lib.train_attention_backward.restype = i
        lib.train_attention_launches.argtypes = [i, i]
        lib.train_attention_launches.restype = ctypes.c_ulonglong
    return lib


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by kernel and route that ``lib``'s kernels have counted on
    the device since the library was loaded.  A synchronous copy from the
    device: never call it during a capture."""
    out = {}
    for ki, name in enumerate(KERNELS):
        out[name] = {}
        for ri, r in enumerate(ROUTES):
            n = int(lib.train_attention_launches(ki, ri))
            if n == 2 ** 64 - 1:
                raise RuntimeError("train_attention_launches: the copy "
                                   "from the device failed")
            out[name][r] = n
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("train_attention: q, k, v must be 4-d (B, S, H, D)")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"train_attention: k, v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    t, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"train_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if min(b, s, t, d) == 0:
        raise ValueError("train_attention: empty input")
    if window < 0:
        raise ValueError(f"train_attention: window {window} < 0")
    if (causal or window) and s != t:
        raise ValueError(f"train_attention: a causal or windowed call needs "
                         f"S == T (self-attention), got {s} and {t}")
    for n, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"train_attention: {n} on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"train_attention: {n} is {x.dtype}, q "
                             f"{q.dtype}")


def _readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the kernels can read it by strides (last dim
    contiguous; bf16 rows and heads 16-byte aligned), else a contiguous
    copy."""
    vec = 16 // x.element_size()
    if x.stride(3) == 1 and x.data_ptr() % 16 == 0 and \
            all(st % vec == 0 for st in x.stride()[:3]):
        return x
    return x.contiguous()


def _strides(x: torch.Tensor):
    return (ctypes.c_longlong * 3)(*x.stride()[:3])


def _dims(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, ...]:
    b, s, hq, d = q.shape
    return b, s, k.shape[1], hq, k.shape[2], d


def _scales(logit_cap: float, head_dim: int) -> Tuple[float, float, float]:
    """(cap, 1 / cap, 1 / sqrt(D)), the reciprocals rounded to f32 as ATen
    takes them to divide a CUDA tensor by a scalar (0 for no cap)."""
    one = np.float32(1.0)
    inv_cap = float(one / np.float32(logit_cap)) if logit_cap else 0.0
    return (float(logit_cap), inv_cap,
            float(one / np.float32(math.sqrt(head_dim))))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def train_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool, window: int,
                            logit_cap: float, lib: ctypes.CDLL = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One forward launch on CUDA tensors of one dtype (f32, or bf16 on
    the tensor-core routes' head dims): (o (B, S, Hq, D) in their dtype,
    o32 (its f32 values; o itself on the f32 routes), lse (B, Hq, S) f32).
    ``lib``: the library to launch from (``_lib(FORCE_MMA_DEFINES)`` or
    ``_lib(FORCE_SCALAR_DEFINES)`` for the old routes), by default the
    kernels' own build."""
    window = int(window)
    name = route(q.dtype, k.dtype, q.shape[3])
    _check(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"train_attention launches on CUDA tensors, got "
                         f"{q.device}")
    if name in F32_ROUTES and q.dtype != torch.float32:
        raise ValueError(f"train_attention: {q.dtype} at head dim "
                         f"{q.shape[3]} takes {name}: upcast first")
    q, k, v = _readable(q), _readable(k), _readable(v)
    b, s, t, hq, hkv, d = _dims(q, k)
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    o32 = o if q.dtype == torch.float32 else torch.empty(
        o.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = lib if lib is not None else _lib()
    with torch.cuda.device(q.device):
        err = lib.train_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            o32.data_ptr(), lse.data_ptr(), b, s, t, hq, hkv, d,
            _strides(q), _strides(k), _strides(v), int(bool(causal)),
            window, *_scales(logit_cap, d), ROUTES.index(name),
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"train_attention forward launch failed on "
                           f"{name}: CUDA error {err}")
    with _COUNT_LOCK:
        train_attention_forward.launches += 1
        train_attention_forward.launches_by_route[name] += 1
    return o, o32, lse


def train_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o32: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: int, logit_cap: float,
                             lib: ctypes.CDLL = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward of ``train_attention_forward`` with the same arguments
    (o32 and lse its outputs, dout the grad of o, read in the inputs'
    dtype): (dq, dk, dv) in the inputs' dtype, from three launches (two on
    ``DELTA_IN_DQ``'s route)."""
    window = int(window)
    name = route(q.dtype, k.dtype, q.shape[3])
    _check(q, k, v, causal, window)
    q, k, v = _readable(q), _readable(k), _readable(v)
    b, s, t, hq, hkv, d = _dims(q, k)
    dout = dout.to(q.dtype).contiguous()
    if dout.shape != q.shape or o32.shape != q.shape or \
            lse.shape != (b, hq, s):
        raise ValueError("train_attention backward: dout, o32 or lse do not "
                         "fit q")
    dq = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = lib if lib is not None else _lib()
    with torch.cuda.device(q.device):
        err = lib.train_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, hq, hkv,
            d, _strides(q), _strides(k), _strides(v), int(bool(causal)),
            window, *_scales(logit_cap, d), ROUTES.index(name),
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"train_attention backward launch failed on "
                           f"{name}: CUDA error {err}")
    with _COUNT_LOCK:
        train_attention_backward.launches += 1
        train_attention_backward.launches_by_route[name] += 1
    return dq, dk, dv


class TrainAttention(torch.autograd.Function):
    """o = attention(q, k, v) by the kernels: the forward saves q, k, v,
    o's f32 values and the log-sum-exp; the backward launches the delta,
    dQ and dK dV kernels.  Under ``checkpoint(use_reentrant=False)`` the
    recompute is a second forward launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, logit_cap: float):
        o, o32, lse = train_attention_forward(
            q, k, v, causal=causal, window=window, logit_cap=logit_cap)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = train_attention_backward(q, k, v, o32, lse, dout,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, S, Hq, D), k and v (B, T, Hkv, D), model layout -> (B, S, Hq,
    D): in the kernel route's dtype on CUDA (``TrainAttention``; bf16 on
    the bf16 routes, else f32 after an exact upcast), f32 on the CPU
    and meta (``train_attention_plain``).  Chosen by device
    (``takes_kernel``)."""
    if not takes_kernel((q, k, v)):
        return train_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap)
    if route(q.dtype, k.dtype, q.shape[3]) in F32_ROUTES:
        q, k, v = q.float(), k.float(), v.float()
    return TrainAttention.apply(q, k, v, bool(causal), int(window),
                                float(logit_cap))


train_attention_forward.launches = 0
train_attention_forward.launches_by_route = dict.fromkeys(ROUTES, 0)
train_attention_backward.launches = 0
train_attention_backward.launches_by_route = dict.fromkeys(ROUTES, 0)
