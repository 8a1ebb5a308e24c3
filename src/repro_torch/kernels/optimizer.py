"""The train step's fused update on Hopper: AdamW in one pass over a leaf and
the grads' sum of squares for the global-norm clip.

Replaces no Pallas kernel: the reference computes both with jnp inside its
jitted train step (``repro/optim/adamw.py`` ``adamw_update`` and
``clip_by_global_norm``, under ``jax.jit`` in ``repro/launch/train.py``),
where XLA fuses them into a few passes over the state.  The kernels are CUDA
C++ written by hand for sm_90a (``repro_torch/csrc/optimizer.cu``), built by
``nvcc`` into a plain-C shared library and called through ctypes.

What bounds them: bytes.  ``adamw_update`` reads p and g in their dtype and
m, v in f32 once and writes p, m and v once (22 bytes a bf16 parameter);
``sumsq`` reads each grad once (2 bytes a bf16 element).  What the design
does: 16-byte vector loads in a grid-stride loop with 64-bit offsets, no
temporary in device memory; the update's f32 ops are the reference's, in
its order, each IEEE-rounded (no FMA contraction), so p, m and v equal the
plain version's to the bit; ``lr``, the clip scale and the bias corrections
are read on the device, so a step makes no host synchronise.  ``sumsq`` is
one launch over every grad of a step (``SUMSQ_LEAVES`` leaves a launch, f32
and bf16 mixed; the leaf table a by-value kernel parameter): each leaf cut
into chunks of ``CHUNK_BYTES``, a block and a partial a chunk, the last
block summing the partials in chunk order.  Its order of sums depends only
on the leaves' sizes, dtypes and order (``sumsq_plan``), so it repeats
itself to the bit; its ticket returns to 0 after each launch, so one
zeroed ticket a stream serves every eager call and nothing is filled
before a launch (a CUDA graph capture takes a ticket from the graph's
pool, zeroed by a captured fill: ``_ticket``).

The plain versions are ``repro_torch.optim.adamw``'s ``_update_slice`` over
``slices`` and ``global_norm``'s f32 sums; ``optim.adamw`` chooses by the
tensors' device (``takes_kernel``): CUDA tensors launch these kernels, CPU
and meta tensors (DTensors among them) take the plain versions, a DTensor
on CUDA and any other device raise.  The functions here launch only: each needs CUDA tensors, raises on
what the kernel does not take or a refused launch, and counts its launches
on the host (``adamw_update.launches`` / ``.launches_by_route``,
``sumsq.launches`` / ``.launches_by_route``) and on the device
(``kernel_launches``: a CUDA graph's replays are counted too).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch

from . import _build

_COUNT_LOCK = threading.Lock()
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the C instance ids: adamw (params bf16) * 2 + (grads bf16); sumsq by its
# launch's leaves: all f32, all bf16, both.  An adamw route is named
# params_grads.
ADAMW_ROUTES = ("f32_f32", "f32_bf16", "bf16_f32", "bf16_bf16")
SUMSQ_ROUTES = ("f32", "bf16", "mixed")
# sumsq's launch shape, as ``sumsq`` / ``sumsq_kernel`` in optimizer.cu work
# it out (the CPU tests emulate its order of sums from these): threads a
# block, elements a thread a step from a 16-byte aligned leaf (else 1),
# bytes a chunk, leaves a launch
THREADS = 256
VEC = 8
CHUNK_BYTES = 131072
SUMSQ_LEAVES = 64


def adamw_route(p_dtype: torch.dtype, g_dtype: torch.dtype) -> str:
    """The instance a launch on params of ``p_dtype`` and grads of
    ``g_dtype`` runs (each float32 or bfloat16)."""
    for name, dt in (("params", p_dtype), ("grads", g_dtype)):
        if dt not in _NAMES:
            raise ValueError(f"adamw_update: {name} are {dt} "
                             f"(float32, bfloat16)")
    return f"{_NAMES[p_dtype]}_{_NAMES[g_dtype]}"


def sumsq_route(dtypes: Iterable[torch.dtype]) -> str:
    """The instance a launch over leaves of these dtypes runs: their
    common dtype's name, or ``mixed``."""
    names = set()
    for dt in dtypes:
        if dt not in _NAMES:
            raise ValueError(f"sumsq: grads are {dt} (float32, bfloat16)")
        names.add(_NAMES[dt])
    if not names:
        raise ValueError("sumsq of no leaves")
    return names.pop() if len(names) == 1 else "mixed"


def sumsq_chunk(dtype: torch.dtype) -> int:
    """Elements of a ``sumsq`` chunk of a leaf of ``dtype``."""
    return CHUNK_BYTES // (2 if dtype == torch.bfloat16 else 4)


def sumsq_plan(leaves: Sequence[Tuple[int, torch.dtype]]
               ) -> List[Tuple[int, int, int]]:
    """The launches of one ``sumsq`` call over non-empty leaves of these
    (elements, dtype): (first leaf, leaves, chunks) each.  ``SUMSQ_LEAVES``
    leaves a launch in leaf order; a leaf ``ceil(n / sumsq_chunk(dtype))``
    chunks, one block and one partial each."""
    plan = []
    for first in range(0, len(leaves), SUMSQ_LEAVES):
        part = leaves[first:first + SUMSQ_LEAVES]
        chunks = sum(-(-n // sumsq_chunk(dt)) for n, dt in part)
        plan.append((first, len(part), chunks))
    return plan


def takes_kernel(tensors: Iterable[Any]) -> bool:
    """True if ``tensors`` launch the kernels: all on CUDA, none a DTensor.
    False if they take the plain versions: all on the CPU or meta,
    DTensors among them (the dry-run traces the train step on meta
    DTensors).  Raises for a DTensor on CUDA (its local shards would need
    their partial sums reduced, and no path builds one), for any other
    device and for a mix of CUDA and CPU or meta tensors."""
    kinds = set()
    for t in tensors:
        if t.device.type in ("cpu", "meta"):
            kinds.add("plain")
        elif t.device.type == "cuda":
            if getattr(t, "placements", None) is not None:
                raise ValueError("no optimizer kernel for a DTensor on "
                                 "CUDA")
            kinds.add("cuda")
        else:
            raise ValueError(f"no optimizer kernel or plain version for "
                             f"device {t.device}")
    if len(kinds) > 1:
        raise ValueError("optimizer tensors mix CUDA and CPU or meta "
                         "leaves")
    return kinds == {"cuda"}


def _lib() -> ctypes.CDLL:
    lib = _build.load("optimizer")
    if lib.adamw_update.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.adamw_update.argtypes = ([p] * 7 + [ll, i, i] + [p] * 4
                                     + [f] * 6 + [p])
        lib.adamw_update.restype = ctypes.c_int
        lib.sumsq.argtypes = [p, i, p, i, p, p, i, i, p]
        lib.sumsq.restype = ctypes.c_int
        lib.optimizer_launches.argtypes = [i, i]
        lib.optimizer_launches.restype = ctypes.c_ulonglong
    return lib


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by kernel and route that ``lib``'s kernels have counted on
    the device since the library was loaded (a CUDA graph's replays
    included).  A synchronous copy from the device: never call it during
    a capture."""
    out = {}
    for k, (name, routes) in enumerate((("adamw_update", ADAMW_ROUTES),
                                        ("sumsq", SUMSQ_ROUTES))):
        out[name] = {}
        for i, r in enumerate(routes):
            n = int(lib.optimizer_launches(k, i))
            if n == 2 ** 64 - 1:
                raise RuntimeError("optimizer_launches: the copy from the "
                                   "device failed")
            out[name][r] = n
    return out


def _device_scalar(x: Any, device: torch.device, name: str) -> torch.Tensor:
    """``x`` (a number or a one-element tensor) as a 0-d f32 tensor on
    ``device``, without a copy when it is one already."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise ValueError(f"adamw_update: {name} must hold one value")
        if x.device == device and x.dtype == torch.float32:
            return x.reshape(())
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, c1: Any, c2: Any, lr: Any, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 scale: Optional[torch.Tensor] = None, *,
                 inplace: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """New (p, m, v) of one leaf, as ``optim.adamw._update_slice`` gives
    them, in one launch: p f32 or bf16, g f32 or bf16 (unclipped when
    ``scale``, the clip factor, is given), m and v f32, all on one CUDA
    device; ``c1``, ``c2`` (the bias corrections), ``lr`` and ``scale``
    are read on the device (numbers and CPU tensors are copied there
    first).  ``inplace`` writes into p, m and v (contiguous) and returns
    them; else new tensors, and the inputs stay as they were."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"adamw_update launches on CUDA tensors, got "
                         f"{dev}")
    route = adamw_route(p.dtype, g.dtype)
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.device != dev:
            raise ValueError(f"adamw_update: {name} on {t.device}, p on "
                             f"{dev}")
        if t.shape != p.shape:
            raise ValueError(f"adamw_update: {name} is {tuple(t.shape)}, "
                             f"p {tuple(p.shape)}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"adamw_update: m, v are {m.dtype}, {v.dtype} "
                         f"(float32)")
    g = g.contiguous()
    if inplace:
        for name, t in (("p", p), ("m", m), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"adamw_update in place: {name} must be "
                                 f"contiguous")
        outs = (p, m, v)
    else:
        p, m, v = p.contiguous(), m.contiguous(), v.contiguous()
        outs = (torch.empty_like(p), torch.empty_like(m),
                torch.empty_like(v))
    if p.numel() == 0:
        return outs
    c1, c2, lr = (_device_scalar(x, dev, n) for x, n in
                  ((c1, "c1"), (c2, "c2"), (lr, "lr")))
    if scale is not None:
        scale = _device_scalar(scale, dev, "scale")
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.adamw_update(
            outs[0].data_ptr(), p.data_ptr(), g.data_ptr(),
            outs[1].data_ptr(), m.data_ptr(), outs[2].data_ptr(),
            v.data_ptr(), p.numel(), _BF16[p.dtype], _BF16[g.dtype],
            lr.data_ptr(), None if scale is None else scale.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps,
            weight_decay, _stream(dev))
    if err != 0:
        raise RuntimeError(f"adamw_update launch failed on {route}: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        adamw_update.launches += 1
        adamw_update.launches_by_route[route] += 1
    return outs


class _SumsqLeaf(ctypes.Structure):
    """``SumsqLeaf`` of optimizer.cu."""
    _fields_ = [("ptr", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first_chunk", ctypes.c_int), ("flags", ctypes.c_int)]


# one zeroed ticket a (device, stream) outside a capture: each launch
# leaves it 0
_TICKETS: dict = {}
_TICKET_LOCK = threading.Lock()


def _ticket(device: torch.device, stream: int, capturing: bool
            ) -> torch.Tensor:
    """``sumsq``'s zeroed ticket on ``device`` for a launch on ``stream``.
    Outside a capture, the one cached for (device, stream).  Inside a CUDA
    graph capture, a new one: made there, it comes from the graph's pool
    and is zeroed by a captured fill on every replay, whereas a cached
    ticket first made inside a capture would outlive the pool that holds
    it once the graph is released."""
    if capturing:
        return torch.zeros((), dtype=torch.int32, device=device)
    key = (device.type, device.index, stream)
    with _TICKET_LOCK:
        if key not in _TICKETS:
            _TICKETS[key] = torch.zeros((), dtype=torch.int32, device=device)
        return _TICKETS[key]


def sumsq(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every element of ``tensors`` squared, a 0-d f32 tensor on
    their CUDA device: one launch over every non-empty tensor (f32 or bf16,
    each read in its own dtype; ``SUMSQ_LEAVES`` a launch, in order, each
    launch adding its total to the last one's)."""
    tensors: List[torch.Tensor] = list(tensors)
    if not tensors:
        raise ValueError("sumsq of no tensors")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"sumsq launches on CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"sumsq: tensors on {t.device} and {dev}")
    sumsq_route(t.dtype for t in tensors)
    leaves = [t.contiguous() for t in tensors if t.numel()]
    out = torch.empty((), dtype=torch.float32, device=dev)
    if not leaves:
        return out.zero_()
    plan = sumsq_plan([(t.numel(), t.dtype) for t in leaves])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        ticket = _ticket(dev, stream,
                         torch.cuda.is_current_stream_capturing())
        partials = torch.empty(max(c for _, _, c in plan),
                               dtype=torch.float32, device=dev)
        for k, (first, count, _) in enumerate(plan):
            part = leaves[first:first + count]
            table = (_SumsqLeaf * count)(*(
                _SumsqLeaf(t.data_ptr(), t.numel(), 0,
                           _BF16[t.dtype]) for t in part))
            route = sumsq_route(t.dtype for t in part)
            err = lib.sumsq(table, count, partials.data_ptr(),
                            partials.numel(), ticket.data_ptr(),
                            out.data_ptr(), int(k > 0),
                            SUMSQ_ROUTES.index(route), stream)
            if err != 0:
                raise RuntimeError(f"sumsq launch failed on {route}: CUDA "
                                   f"error {err}")
            with _COUNT_LOCK:
                sumsq.launches += 1
                sumsq.launches_by_route[route] += 1
    return out


adamw_update.launches = 0
adamw_update.launches_by_route = dict.fromkeys(ADAMW_ROUTES, 0)
sumsq.launches = 0
sumsq.launches_by_route = dict.fromkeys(SUMSQ_ROUTES, 0)
