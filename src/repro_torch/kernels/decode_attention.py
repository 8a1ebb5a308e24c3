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
3.35 TB/s); at G query heads a kv head it does ~G FLOP a byte.  What the
design does: one block a (b, kv head, head chunk, split) serves its chunk
of the query group, so each row is read once a chunk (``head_chunks``:
one chunk of up to 16 heads on ``mma_bf16`` at D <= 128, else equal
chunks of at most 8); the splits of a (b, kv head, chunk) are one thread
block cluster and combine through distributed shared memory, in a fixed
order, in the same launch.  On ``mma_bf16`` a producer warp keeps a TMA
ring of K and V tiles in flight, and the consumer warps run Q K^T and
P V on the tensor cores (keys on M, heads on N, P as hi + lo bf16
halves); on the ``splitk`` routes each lane streams 16-byte row vectors
into CUDA-core FMAs.  The split count (``num_splits``) is a pure function
of the shape, of how many blocks one launch keeps resident at each
candidate count and of the rows a block keeps in flight (``occupancy``:
the card's ``cudaOccupancyMaxActiveClusters`` for the route's instance,
cached on the host before any capture), never of the position, which
the kernel reads on the device: one CUDA graph capture serves every
position.

Routes, fixed before the launch (``route(dtype, group, d)``): f32 caches
-> ``splitk_f32``; bf16 caches with D a multiple of 16 and at least
``MMA_MIN_GROUP`` query heads a kv head -> ``mma_bf16``, other bf16 ->
``splitk_bf16``; the query has the cache's dtype, the output is f32.  CUDA
tensors launch the kernel; CPU tensors take the plain version; any other
device raises.  Each launch is counted on the host
(``decode_attention.launches``, ``.launches_by_route``) and on the device
(``kernel_launches``: a CUDA graph's replays are counted too).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from . import _build
from .flash_attention import refuse_grad
from .ref import gqa_out, gqa_scores, softcap

_COUNT_LOCK = threading.Lock()
ROUTES = ("splitk_f32", "splitk_bf16", "mma_bf16")   # the C route ids
MAX_SPLITS = 8          # the portable thread block cluster size
ROW_ALIGN = 16          # a split's rows are a whole number of these
# The bf16 route by group, from ``tune.py --decode``'s timings of both
# routes at the serve paths' shapes: ``mma_bf16`` from this many query
# heads a kv head on (D a multiple of 16).  At one head (codeqwen,
# whisper, zamba2) the tensor cores' 8 head columns hold 1 live one and
# ``splitk_bf16`` was as fast or faster (whisper's 66-row cross cache 1.2x).
MMA_MIN_GROUP = 2
# The split rule (``num_splits``): the fewest splits that keep a split's
# whole rows in flight at once, or ``IN_FLIGHT_BYTES`` of K and V across
# the launch, and never more than one launch keeps resident in one wave.
IN_FLIGHT_BYTES = 10 * 2 ** 20
_OCCUPANCY: Dict[Tuple[int, str, int, int], "Occupancy"] = {}

Position = Union[int, torch.Tensor, None]


def route(dtype: torch.dtype, group: int, d: int) -> str:
    """The kernel instance a CUDA call launches for a cache of this dtype,
    ``group`` query heads a kv head and head dim ``d``."""
    if dtype == torch.float32:
        return "splitk_f32"
    if dtype == torch.bfloat16:
        return ("mma_bf16" if d % 16 == 0 and group >= MMA_MIN_GROUP
                else "splitk_bf16")
    raise ValueError(f"dtype {dtype} not supported (float32, bfloat16)")


def row_bound(t: int, window: int, all_rows: bool) -> int:
    """The most rows a call can see: the cache's ``t``, or its window."""
    return t if all_rows or not window else min(t, window)


def max_heads(route_name: str, d: int) -> int:
    """Query heads one block of the route takes at head dim ``d``: 16 on
    ``mma_bf16`` at D <= 128 (two 8-head blocks of N), else 8."""
    return 16 if route_name == "mma_bf16" and d <= 128 else 8


def head_chunks(group: int, route_name: str, d: int) -> Tuple[int, int]:
    """A group of ``group`` query heads a kv head as the route's kernel cuts
    it: (chunks, heads a chunk), equal chunks of at most ``max_heads``."""
    chunks = -(-group // max_heads(route_name, d))
    return chunks, -(-group // chunks)


class Occupancy(NamedTuple):
    """What one launch of a route's instance holds on the card: ``blocks``,
    the blocks resident at once at each split count 1..MAX_SPLITS (whole
    clusters of that many blocks); ``rows``, the K / V rows one block keeps
    in flight."""
    blocks: Dict[int, int]
    rows: int


def num_splits(items: int, rows: int, row_bytes: int,
               occ: Occupancy) -> int:
    """Splits of each of ``items`` (b, kv head, chunk)s of at most ``rows``
    visible rows (the static row bound) of ``row_bytes`` K and V bytes: the
    fewest that put a split's whole rows in flight at once
    (``occ.rows`` a block) or ``IN_FLIGHT_BYTES`` across the launch, but no
    more than the most whose ``items`` x splits blocks are resident at once
    (``occ.blocks``); at least 1, at most ``MAX_SPLITS``."""
    fit = max((s for s in range(1, MAX_SPLITS + 1)
               if items * s <= occ.blocks[s]), default=1)
    cover = -(-rows // occ.rows)
    fill = -(-IN_FLIGHT_BYTES // (items * occ.rows * row_bytes))
    return max(1, min(fit, cover, fill))


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


def occupancy(lib: ctypes.CDLL, route_name: str, d: int,
              heads: int) -> Occupancy:
    """``lib``'s instance of the route at (``d``, ``heads`` a block) on the
    current device: clusters of each split count resident at once
    (``cudaOccupancyMaxActiveClusters``) times the count, and the rows a
    block keeps in flight."""
    r = ROUTES.index(route_name)
    blocks = {s: lib.decode_attention_clusters(r, d, heads, s) * s
              for s in range(1, MAX_SPLITS + 1)}
    rows = lib.decode_attention_rows_in_flight(r, d, heads)
    if rows < 1 or min(blocks.values()) < 1:
        raise RuntimeError(f"decode_attention occupancy of {route_name} at "
                           f"d={d}, heads={heads}: {blocks}, rows {rows}")
    return Occupancy(blocks, rows)


def occupancy_on(lib: ctypes.CDLL, route_name: str, d: int, heads: int,
                 device: torch.device) -> Occupancy:
    """``occupancy`` on ``device``, asked once per (device, route, d, heads)
    and cached; never asked during a CUDA graph capture (raises there:
    make an eager call at the shape first, as the decode step's first step
    is)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, route_name, d, heads)
    if key not in _OCCUPANCY:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_attention: the occupancy of a new shape is read "
                "outside a CUDA graph capture; make one eager call first")
        with torch.cuda.device(index):
            _OCCUPANCY[key] = occupancy(lib, route_name, d, heads)
    return _OCCUPANCY[key]


def splits_for(lib: ctypes.CDLL, route_name: str, q: torch.Tensor,
               k: torch.Tensor, window: int, all_rows: bool) -> int:
    """The split count of a call on route ``route_name`` (``num_splits`` of
    its shape and the route's cached occupancy on q's device)."""
    b, nq, d = q.shape
    nkv = k.shape[2]
    chunks, heads = head_chunks(nq // nkv, route_name, d)
    return num_splits(b * nkv * chunks,
                      row_bound(k.shape[1], window, all_rows),
                      2 * d * k.element_size(),
                      occupancy_on(lib, route_name, d, heads, q.device))


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
        fn.argtypes = [p] * 5 + [i] * 5 + [ll] * 8 + [i, f] + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        lib.decode_attention_launches.argtypes = [i]
        lib.decode_attention_launches.restype = ctypes.c_ulonglong
        lib.decode_attention_clusters.argtypes = [i] * 4
        lib.decode_attention_clusters.restype = ctypes.c_int
        lib.decode_attention_rows_in_flight.argtypes = [i] * 3
        lib.decode_attention_rows_in_flight.restype = ctypes.c_int
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
    route(q.dtype, nq // nkv, d)
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
    left out; ``all_rows`` sees every row and reads no position.  CUDA
    tensors launch the hand-written kernel on the route of the dtype,
    group and head dim (``route``), counted on the host in
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
    name = route(q.dtype, q.shape[1] // k.shape[2], q.shape[2])
    lib = _lib()
    splits = splits_for(lib, name, q, k, window, all_rows)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch(lib, q, k, v, None if all_rows else pos, out, window, logit_cap,
           splits, name)
    with _COUNT_LOCK:
        decode_attention.launches += 1
        decode_attention.launches_by_route[name] += 1
    return out


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, pos: Optional[torch.Tensor], out: torch.Tensor,
           window: int, logit_cap: float, splits: int,
           route_name: str) -> None:
    """One launch of ``lib``'s kernel on the named route, on checked CUDA
    tensors into ``out`` (``pos`` None: every row visible)."""
    b, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    chunks = head_chunks(nq // nkv, route_name, d)[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if pos is None else pos.data_ptr(), b, t, nq, nkv, d,
            q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
            window, float(logit_cap), int(pos is None), splits, ROW_ALIGN,
            chunks, ROUTES.index(route_name), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed on "
                           f"{route_name}: CUDA error {err}")


decode_attention.launches = 0
decode_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
