"""One-token decode attention over a KV cache read where it lies, for Hopper.

Replaces no Pallas kernel: the reference computes this with jnp inside its
jitted decode step (``repro/models/attention.py`` ``decode_attention`` and
``decode_cross_attention``, compiled by ``jax.jit(make_decode_step(cfg))``
in ``repro/launch/serve.py``), where XLA may fuse the cache's f32
conversion into the products.  The port's plain version (the same torch ops
the model ran before) writes an f32 copy of the whole cache every layer and
step and multiplies over every row; the kernel
(``repro_torch/csrc/decode_attention.cu``, CUDA C++ for sm_90a, built by
``nvcc`` into a plain-C shared library and called through ctypes) reads the
visible bf16 or f32 rows once and keeps the math in f32.

What bounds it: the bytes of the visible K and V rows (gemma2-27b's global
layer, B = 2, 16 kv heads x 8,208 rows x 128, bf16: 134.5 MB, 40 us at
3.35 TB/s); at G query heads a kv head it does ~G FLOP a byte.  What
the design does: one block a (b, kv head, split) serves the whole query
group from 16-byte row loads (a group of more than ``MAX_GROUP`` heads in
equal chunks, one block a chunk: ``head_chunks``); the splits of a
(b, kv head, chunk) are one thread block cluster and combine through
distributed shared memory, in a fixed order, in the same launch.  The
split count (``num_splits``) depends on B x kv heads, the group, the SM
count and the static row bound, never on the position, which the kernel
reads on the device: one CUDA graph capture serves every position.

Routes, fixed by the dtype before the launch (``route``): f32 caches ->
``splitk_f32``, bf16 -> ``splitk_bf16``; the query has the cache's dtype,
the output is f32.  CUDA tensors launch the kernel; CPU tensors take the
plain version; any other device raises.  Each launch is counted on the
host (``decode_attention.launches``, ``.launches_by_route``) and on the
device (``kernel_launches``: a CUDA graph's replays are counted too).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple, Union

import torch

from . import _build
from .flash_attention import refuse_grad
from .ref import gqa_out, gqa_scores, softcap

_COUNT_LOCK = threading.Lock()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("splitk_f32", "splitk_bf16")
MAX_SPLITS = 8          # the portable thread block cluster size
MAX_GROUP = 8           # query heads a block
ROW_ALIGN = 16          # a split's rows are a whole number of these
# The split rule (``num_splits``), from ``tune.py --decode``'s sweep of
# every count at the serve paths' shapes: fewer, longer splits, since each
# adds a block's fixed cost and the cluster's combine; a split's work is
# its rows times its block's query heads; and at most 7, since clusters
# of 8 fit fewer a GPC (8 splits took 1.7x 7's time at 6 and 8 heads a
# group).
MIN_SPLIT_WORK = 128    # rows x query heads, the least a split gets
RULE_MAX_SPLITS = 7
BLOCKS_PER_SM = 2       # the blocks a launch aims at per SM
_SMS: Dict[int, int] = {}

Position = Union[int, torch.Tensor, None]


def route(dtype: torch.dtype) -> str:
    """The kernel instance a CUDA call with a cache of this dtype launches."""
    if dtype == torch.float32:
        return "splitk_f32"
    if dtype == torch.bfloat16:
        return "splitk_bf16"
    raise ValueError(f"dtype {dtype} not supported (float32, bfloat16)")


def row_bound(t: int, window: int, all_rows: bool) -> int:
    """The most rows a call can see: the cache's ``t``, or its window."""
    return t if all_rows or not window else min(t, window)


def head_chunks(group: int) -> Tuple[int, int]:
    """A group of ``group`` query heads a kv head as the kernel cuts it:
    (chunks, heads a chunk), equal chunks of at most ``MAX_GROUP``."""
    chunks = -(-group // MAX_GROUP)
    return chunks, -(-group // chunks)


def num_splits(batch: int, kv_heads: int, group: int, rows: int,
               sm_count: int) -> int:
    """Splits of each (b, kv head, chunk)'s rows: enough blocks for
    ``BLOCKS_PER_SM`` an SM, at most ``RULE_MAX_SPLITS``, and no split with
    less than ``MIN_SPLIT_WORK`` rows x heads of the static row bound
    ``rows``."""
    chunks, heads = head_chunks(group)
    want = -(-BLOCKS_PER_SM * sm_count // (batch * kv_heads * chunks))
    return max(1, min(RULE_MAX_SPLITS, want,
                      -(-rows * heads // MIN_SPLIT_WORK)))


def visible_rows(pos: int, t: int, window: int,
                 all_rows: bool) -> Tuple[int, int]:
    """The rows [lo, end) a call at ``pos`` sees, as the kernel works them
    out: every row with ``all_rows``, else those up to ``pos`` and, with a
    ``window``, after ``pos - window``."""
    if all_rows:
        return 0, t
    lo = max(0, pos - window + 1) if window > 0 else 0
    return lo, min(pos, t - 1) + 1


def split_rows(pos: int, t: int, window: int, all_rows: bool, splits: int,
               align: int = ROW_ALIGN) -> List[Tuple[int, int]]:
    """Each split's rows [r0, r1) at position ``pos``, as the kernel works
    them out on the device: the visible rows cut into ``splits`` shares of
    a whole number of ``align`` rows; a split past the last is empty
    (r1 <= r0)."""
    lo, end = visible_rows(pos, t, window, all_rows)
    per = -(-(-(-(end - lo) // splits)) // align) * align
    return [(lo + s * per, min(lo + (s + 1) * per, end))
            for s in range(splits)]


def sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: Position = None, *, window: int = 0,
                           logit_cap: float = 0.0,
                           all_rows: bool = False) -> torch.Tensor:
    """The kernel's plain PyTorch version: q (B, nq, D), or the model's
    (B, 1, nq, D); k/v (B, T, nkv, D) -> f32 in q's shape.

    The torch ops the model's decode ran before the kernel, from the
    attention math the prefill's plain route uses (``ref.gqa_scores``,
    ``softcap``, ``gqa_out``): f32 scores of q against every cache row
    over sqrt(D), the softcap, rows past ``pos`` or before its window
    masked to -1e30 (none with ``all_rows``: cross-attention), the
    softmax, the f32 product with V."""
    b, nq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t = k.shape[1]
    scores = softcap(gqa_scores(q.reshape(b, 1, nq, d), k), logit_cap)
    if not all_rows:
        kpos = torch.arange(t, device=q.device)[None, None, None, None, :]
        mask = kpos <= pos
        if window:
            mask = mask & (pos - kpos < window)
        scores = scores.masked_fill(~mask, -1e30)
    return gqa_out(torch.softmax(scores, dim=-1), v).reshape(q.shape)


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("decode_attention", defines)
    fn = lib.decode_attention
    if fn.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = [p] * 5 + [i] * 5 + [ll] * 8 + [i, f, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.decode_attention_launches.argtypes = [i]
        lib.decode_attention_launches.restype = ctypes.c_ulonglong
    return lib


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by route that ``lib``'s kernel has counted on the device
    since the library was loaded (a CUDA graph's replays included).  A
    synchronous copy from the device: never call it during a capture."""
    out = {}
    for i, r in enumerate(ROUTES):
        n = int(lib.decode_attention_launches(i))
        if n == 2 ** 64 - 1:
            raise RuntimeError("decode_attention_launches: the copy from "
                               "the device failed")
        out[r] = n
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           pos: Position, window: int, all_rows: bool) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be 3-d (B, nq, D), k and v 4-d "
                         "(B, T, nkv, D)")
    b, nq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    nkv = k.shape[2]
    if nkv == 0 or nq % nkv:
        raise ValueError(f"nq={nq} must be a multiple of nkv={nkv}")
    if min(b, nq, k.shape[1]) == 0:
        raise ValueError("empty attention input")
    if not (8 <= d <= 256 and d % 8 == 0):
        raise ValueError(f"head_dim {d} not in 8..256 in steps of 8")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    route(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    for name, t in (("k", k), ("v", v)):
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    if all_rows:
        return
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 0
            and pos.dtype == torch.int64 and pos.device == q.device):
        raise ValueError(f"pos must be a 0-d int64 tensor on {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Position = None, *, window: int = 0,
                     logit_cap: float = 0.0,
                     all_rows: bool = False) -> torch.Tensor:
    """q: (B, nq, D); k/v: (B, T, nkv, D) -> (B, nq, D) f32.

    ``pos`` is the new token's position, a 0-d int64 tensor on q's device
    (the kernel reads it there; the plain version also takes an int): rows
    past it, and with a ``window`` rows at or before ``pos - window``, are
    left out; ``all_rows`` sees every row and reads no position.  CUDA tensors launch the hand-written kernel on the route
    of the dtype (``route``), counted on the host in
    ``decode_attention.launches`` / ``.launches_by_route`` and on the
    device (``kernel_launches``); a refused or failed launch raises, and
    nothing falls back.  CPU tensors take the plain version.  Raises
    RuntimeError, on every device, for inputs that require grad while
    grad mode is on: the kernel has no backward."""
    refuse_grad("decode_attention", q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, window=window,
                                      logit_cap=logit_cap,
                                      all_rows=all_rows)
    window = int(window)
    _check(q, k, v, pos, window, all_rows)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    splits = num_splits(q.shape[0], k.shape[2], q.shape[1] // k.shape[2],
                        row_bound(k.shape[1], window, all_rows),
                        sm_count(q.device))
    launch(_lib(), q, k, v, None if all_rows else pos, out, window,
           logit_cap, splits)
    with _COUNT_LOCK:
        decode_attention.launches += 1
        decode_attention.launches_by_route[route(q.dtype)] += 1
    return out


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, pos: Optional[torch.Tensor], out: torch.Tensor,
           window: int, logit_cap: float, splits: int) -> None:
    """One launch of ``lib``'s kernel on checked CUDA tensors into ``out``
    (``pos`` None: every row visible)."""
    b, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if pos is None else pos.data_ptr(), b, t, nq, nkv, d,
            q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
            window, float(logit_cap), int(pos is None), splits, ROW_ALIGN,
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")


decode_attention.launches = 0
decode_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
