"""The MoE block's routing and dispatch on Hopper: the router's softmax,
top-k, slot positions and aux loss; the dispatch; the combine.

Replaces no Pallas kernel: the reference computes the whole MoE block with
jnp inside its jitted serve steps (``repro/models/moe.py`` ``moe_block``,
under ``jax.jit`` in ``repro/launch/serve.py``), where XLA fuses the
routing glue.  The kernels are CUDA C++ written by hand for sm_90a
(``repro_torch/csrc/moe_dispatch.cu``), built by ``nvcc`` into a plain-C
shared library and called through ctypes.  The router's f32 product and
the experts' products stay torch products.

What bounds them: latency and bytes.  ``moe_route`` reads the router's
logits (g, sg, e) f32 and writes the top-k experts ``idx``, their
renormalised ``gates``, each slot's position in its expert ``pos``, whether
it is kept, the inverse map ``src`` (the token row that fills each expert
slot, or -1) and the aux loss: a chain of dependent steps over few bytes,
so a block a tile of 16 tokens (a warp a token) and a single-pass chained
scan of the tiles' per-expert counts spread it over many SMs (exact in
integers, the aux loss's partials summed in tile order: the same bits
every call).  ``moe_dispatch`` writes the experts' buffer from the tokens'
rows (a warp a row, in 16-byte vectors where the rows allow, several
loaded before they are stored, the stores streamed), laid out as ``src``
is: expert-major from ``moe_route``, so the experts' einsums take
it without a copy;
``moe_combine`` reads the kept rows of the experts' output and writes y.
``moe_slots`` is the slot scan of the router's idx in one block a group,
the route before ``moe_route``.

``models.moe.moe_block(..., use_kernel=True)`` calls ``moe_route``,
``moe_dispatch`` and ``moe_combine``.  Each wrapper validates its inputs,
raises for a tensor that requires grad (no backward: training takes the
block's plain route), then launches its kernel for CUDA tensors or takes
its plain version (``moe_route_plain``, ``moe_slots_plain``,
``moe_dispatch_plain``, ``moe_combine_plain``) for CPU and meta ones; a
DTensor on CUDA, any other device and a mix raise.  No wrapper reads a
tensor's values on the host, so a decode step that calls them can be
captured as a CUDA graph.  Launches are counted on the host
(``.launches`` / ``.launches_by_route``) and on the device
(``kernel_launches``: a graph's replays are counted too).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Iterable, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import launch as _launch

MAX_EXPERTS = 256       # the kernels' shared-memory counts
# in the C kernel ids' order
KERNELS = ("moe_slots", "moe_dispatch", "moe_combine", "moe_route")
# the C instance ids: slots one; dispatch and combine a dtype; route one
# (f32 logits)
ROUTES = {"moe_slots": ("int64",), "moe_dispatch": ("f32", "bf16"),
          "moe_combine": ("f32", "bf16"), "moe_route": ("f32",)}
# the build whose dispatch copies a vector a load with default stores (the
# copy before the batched streaming one), timed in turns against it
FORCE_PLAIN_COPY_DEFINES = ("MOE_DISPATCH_FORCE_PLAIN_COPY",)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_COUNT_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# The plain versions (the reference's formulas as torch ops)
# ---------------------------------------------------------------------------


def slot_positions(flat_idx: torch.Tensor, num_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, keep) of the flattened slots ``flat_idx`` (g, n): the number
    of earlier slots of the group with the same expert, and pos < cap (the
    reference's ``cumsum(one_hot) - 1``, ``repro/models/moe.py``)."""
    pos_in_expert = F.one_hot(flat_idx, num_experts).cumsum(dim=1) - 1
    pos = pos_in_expert.gather(-1, flat_idx[..., None])[..., 0]
    return pos, pos < cap


def moe_slots_plain(idx: torch.Tensor, num_experts: int, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``moe_slots`` as torch ops: (pos (g, n) int32, keep (g, n) bool, src
    (g, e, cap) int32) of idx (g, sg, k), n = sg * k."""
    g, sg, k = idx.shape
    n = sg * k
    flat = idx.reshape(g, n)
    pos, keep = slot_positions(flat, num_experts, cap)
    # each kept slot adds its token row + 1 into zeros (a dropped one into
    # the spare slot ``cap``, sliced off): empty slots read -1
    slot = flat * (cap + 1) + torch.where(keep, pos, cap)
    row = torch.arange(n, device=idx.device) // k + 1
    src = torch.zeros((g, num_experts * (cap + 1)), dtype=torch.int64,
                      device=idx.device).scatter_add(1, slot,
                                                     row.expand(g, n))
    src = src.view(g, num_experts, cap + 1)[:, :, :cap] - 1
    return pos.to(torch.int32), keep, src.to(torch.int32)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of ``probs`` along the last dim,
    in descending order, the lower index first among equal values
    (``lax.top_k``'s order): the first k of a stable descending sort."""
    vals, order = probs.sort(dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def e_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` (g, e, ...) with the same values, its storage laid out (e, g,
    ...): a permuted view of an e-major copy."""
    return t.transpose(0, 1).contiguous().transpose(0, 1)


def route_plain(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain route's routing of the router's f32 logits (g, sg, e):
    (gates (g, sg, k) renormalised, idx (g, sg, k), the load-balancing aux
    loss E * mean(frac_i * prob_i)), as torch ops that autograd and the
    dry-run's DTensors take (``models.moe``)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    return gates, idx, e * torch.sum(me * ce)


def moe_route_plain(logits: torch.Tensor, k: int, cap: int
                    ) -> Tuple[torch.Tensor, ...]:
    """``moe_route`` as torch ops, the plain route's own (``route_plain``
    and ``moe_slots_plain``): (idx (g, sg, k) int64, gates (g, sg, k) f32,
    pos (g, n) int32, keep (g, n) bool, src (g, e, cap) int32 laid out
    e-major, aux f32 scalar) of the router's logits (g, sg, e) f32, n = sg
    * k."""
    gates, idx, aux = route_plain(logits, k)
    pos, keep, src = moe_slots_plain(idx, logits.shape[-1], cap)
    return idx, gates, pos, keep, e_major(src), aux


def moe_dispatch_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``moe_dispatch`` as torch ops: buf (g, e, cap, d) with buf[g, e, c]
    = x[g, src[g, e, c]], zeros where src is -1."""
    g, e, cap = src.shape
    d = x.shape[-1]
    rows = src.reshape(g, e * cap, 1).long()
    buf = x.gather(1, rows.clamp_min(0).expand(g, e * cap, d))
    return torch.where(rows >= 0, buf, 0.0).view(g, e, cap, d)


def moe_combine_plain(out_buf: torch.Tensor, idx: torch.Tensor,
                      pos: torch.Tensor, keep: torch.Tensor,
                      gates: torch.Tensor, dtype: torch.dtype
                      ) -> torch.Tensor:
    """y (g, sg, d) in ``dtype``: the sum over each token's k slots of
    keep * gate * out_buf[g, expert, pos] in f32 (the reference's gather,
    where and einsum; a dropped slot's gather is clamped, then masked)."""
    g, e, cap, d = out_buf.shape
    sg, k = idx.shape[1:]
    n = sg * k
    slot = (idx.reshape(g, n) * cap + pos.clamp_max(cap - 1))[..., None]
    gathered = out_buf.reshape(g, e * cap, d).gather(1, slot.expand(g, n, d))
    gathered = torch.where(keep[..., None], gathered, 0.0)
    gathered = gathered.reshape(g, sg, k, d)
    return torch.einsum("gskd,gsk->gsd", gathered.float(), gates).to(dtype)


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("moe_dispatch", defines)
    if lib.moe_dispatch_launches.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.moe_slots.argtypes = [p, i, i, i, i, i, p, p, p, p]
        lib.moe_slots.restype = i
        lib.moe_dispatch.argtypes = [p, p, p, i, i, i, i, ll, ll, i, i, p]
        lib.moe_dispatch.restype = i
        lib.moe_route.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p, p, ll,
                                  p, ll, i, p]
        lib.moe_route.restype = i
        lib.moe_route_scratch_bytes.argtypes = [i, i, i, i]
        lib.moe_route_scratch_bytes.restype = ll
        lib.moe_combine.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ll,
                                    ll, ll, i, p]
        lib.moe_combine.restype = i
        lib.moe_dispatch_launches.argtypes = [i, i]
        lib.moe_dispatch_launches.restype = ctypes.c_ulonglong
    return lib


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by kernel and route that ``lib``'s kernels have counted on
    the device since the library was loaded (a CUDA graph's replays
    included).  A synchronous copy from the device: never call it during a
    capture."""
    out = {}
    for k, name in enumerate(KERNELS):
        out[name] = {}
        for i, r in enumerate(ROUTES[name]):
            n = int(lib.moe_dispatch_launches(k, i))
            if n == 2 ** 64 - 1:
                raise RuntimeError("moe_dispatch_launches: the copy from "
                                   "the device failed")
            out[name][r] = n
    return out


def _on_card(name: str, tensors: Iterable[torch.Tensor]) -> bool:
    """True if ``tensors`` launch the kernel: all on one CUDA device, none
    a DTensor; False if they take the plain version: all on the CPU or
    all meta.  Raises for a tensor that requires grad, a DTensor on CUDA,
    any other device and a mix."""
    devices = set()
    for t in tensors:
        if t.requires_grad:
            raise RuntimeError(f"{name} has no backward: the MoE block "
                               "trains on its plain route")
        if t.device.type not in ("cpu", "meta", "cuda") or (
                t.device.type == "cuda"
                and getattr(t, "placements", None) is not None):
            raise ValueError(f"{name}: no kernel or plain version for "
                             f"{type(t).__name__} on {t.device}")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: inputs on {sorted(map(str, devices))}")
    return devices.pop().type == "cuda"


def _count(fn, inst: str) -> None:
    with _COUNT_LOCK:
        fn.launches += 1
        fn.launches_by_route[inst] += 1


def route(dtype: torch.dtype, name: str = "moe_dispatch") -> str:
    """The instance the dispatch or the combine runs for ``dtype``."""
    if dtype not in _NAMES:
        raise ValueError(f"{name}: {dtype} (float32, bfloat16)")
    return _NAMES[dtype]


def is_e_major(src: torch.Tensor) -> bool:
    """True if the map ``src`` (g, e, cap) is laid out e-major (as
    ``moe_route`` returns it), False if group-major (``moe_slots``')."""
    g, e, cap = src.shape
    return g > 1 and e > 1 and src.stride() == (cap, g * cap, 1)


# moe_route's state a (device, stream): zeroed once, and every launch
# leaves its tickets and words 0
_STATES: dict = {}
_STATE_LOCK = threading.Lock()


def _route_state(device: torch.device, stream: int, nbytes: int
                 ) -> torch.Tensor:
    key = (device.index, stream)
    with _STATE_LOCK:
        state = _STATES.get(key)
        if state is None or state.numel() < nbytes:
            size = max(nbytes, 2 * state.numel() if state is not None else 0)
            state = _STATES[key] = torch.zeros(size, dtype=torch.uint8,
                                               device=device)
        return state


def moe_route(logits: torch.Tensor, k: int, cap: int
              ) -> Tuple[torch.Tensor, ...]:
    """(idx (g, sg, k) int64, gates (g, sg, k) f32, pos (g, n) int32, keep
    (g, n) bool, src (g, e, cap) int32, aux f32 scalar) of the router's
    logits (g, sg, e) f32, n = sg * k: each token's k most probable experts
    (softmax; ties to the lower expert), their probabilities renormalised
    to sum 1, each slot's position among the group's earlier slots of its
    expert (token order, top-1 before top-2), whether it is within the
    expert's capacity ``cap``, the token row that fills each expert slot
    (-1 where none does; laid out e-major, (e, g, cap), so ``moe_dispatch``
    writes an e-major buffer), and the load-balancing aux loss over all g *
    sg tokens.  One launch a call (inside a CUDA graph capture a memset of
    its scratch before it)."""
    if logits.dim() != 3 or logits.dtype != torch.float32:
        raise ValueError(f"moe_route: logits {tuple(logits.shape)} "
                         f"{logits.dtype}, want (g, sg, e) float32")
    g, sg, e = logits.shape
    if not (1 <= k <= e <= MAX_EXPERTS) or cap < 1 or g * sg == 0 or \
            sg * k >= 2 ** 30:
        raise ValueError(f"moe_route: logits {tuple(logits.shape)}, top {k} "
                         f"of the experts (k <= e <= {MAX_EXPERTS}), "
                         f"capacity {cap}")
    if not _on_card("moe_route", (logits,)):
        return moe_route_plain(logits, k, cap)
    logits = logits.contiguous()
    dev, n = logits.device, sg * k
    lib = _lib()
    idx = torch.empty((g, sg, k), dtype=torch.int64, device=dev)
    gates = torch.empty((g, sg, k), dtype=torch.float32, device=dev)
    pos = torch.empty((g, n), dtype=torch.int32, device=dev)
    keep = torch.empty((g, n), dtype=torch.bool, device=dev)
    src = torch.empty((e, g, cap), dtype=torch.int32,
                      device=dev).transpose(0, 1)
    aux = torch.empty((), dtype=torch.float32, device=dev)
    nbytes, pbytes = (int(lib.moe_route_scratch_bytes(g, sg, e, part))
                      for part in (0, 1))
    # inside a capture the state comes from the graph's pool, which no
    # launch has zeroed: the C entry point memsets it first
    capturing = torch.cuda.is_current_stream_capturing()
    state = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
             if capturing else _route_state(
                 dev, torch.cuda.current_stream(dev).cuda_stream, nbytes))
    partials = torch.empty(pbytes, dtype=torch.uint8, device=dev)
    err = _launch(dev, lib.moe_route, logits.data_ptr(), g, sg, e, k, cap,
                  idx.data_ptr(), gates.data_ptr(), pos.data_ptr(),
                  keep.data_ptr(), src.data_ptr(), aux.data_ptr(),
                  state.data_ptr(), state.numel(), partials.data_ptr(),
                  partials.numel(), int(capturing))
    if err != 0:
        raise RuntimeError(f"moe_route launch failed: CUDA error {err}")
    _count(moe_route, "f32")
    return idx, gates, pos, keep, src, aux


def moe_slots(idx: torch.Tensor, num_experts: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos (g, n) int32, keep (g, n) bool, src (g, e, cap) int32) of the
    router's top-k experts ``idx`` (g, sg, k) int64, n = sg * k: each
    slot's position among the group's earlier slots of its expert (token
    order, top-1 before top-2 within a token), whether it is within the
    expert's capacity ``cap``, and the token row that fills each expert
    slot (-1 where none does).  One launch a call."""
    if idx.dim() != 3 or idx.dtype != torch.int64:
        raise ValueError(f"moe_slots: idx {tuple(idx.shape)} {idx.dtype}, "
                         "want (g, sg, k) int64")
    g, sg, k = idx.shape
    if not (1 <= k <= num_experts <= MAX_EXPERTS) or cap < 1 or \
            g * sg == 0:
        raise ValueError(f"moe_slots: idx {tuple(idx.shape)}, {num_experts} "
                         f"experts (k <= e <= {MAX_EXPERTS}), capacity "
                         f"{cap}")
    if not _on_card("moe_slots", (idx,)):
        return moe_slots_plain(idx, num_experts, cap)
    idx = idx.contiguous()
    n = sg * k
    pos = torch.empty((g, n), dtype=torch.int32, device=idx.device)
    keep = torch.empty((g, n), dtype=torch.bool, device=idx.device)
    src = torch.empty((g, num_experts, cap), dtype=torch.int32,
                      device=idx.device)
    err = _launch(idx.device, _lib().moe_slots, idx.data_ptr(), g, n, k,
                  num_experts, cap, pos.data_ptr(), keep.data_ptr(),
                  src.data_ptr())
    if err != 0:
        raise RuntimeError(f"moe_slots launch failed: CUDA error {err}")
    _count(moe_slots, "int64")
    return pos, keep, src


def moe_dispatch(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """buf (g, e, cap, d) in x's dtype with buf[g, e, c] = x[g, src[g, e,
    c]], zeros where src is -1: the experts' input, of tokens x (g, sg, d)
    (f32 or bf16) and the inverse map src of ``moe_route`` or
    ``moe_slots``.  The buffer is laid out as src is: e-major storage (e,
    g, cap, d), returned as a permuted view, for ``moe_route``'s map;
    group-major for ``moe_slots``'.  One launch a call."""
    inst = route(x.dtype)
    if x.dim() != 3 or src.dim() != 3 or src.shape[0] != x.shape[0] or \
            src.dtype != torch.int32 or src.shape[1] > MAX_EXPERTS or \
            min(src.shape) < 1 or min(x.shape) < 1:
        raise ValueError(f"moe_dispatch: x {tuple(x.shape)}, src "
                         f"{tuple(src.shape)} {src.dtype}")
    if not _on_card("moe_dispatch", (x, src)):
        buf = moe_dispatch_plain(x, src)
        return e_major(buf) if is_e_major(src) else buf
    buf = launch_dispatch(_lib(), x, src)
    _count(moe_dispatch, inst)
    return buf


def launch_dispatch(lib: ctypes.CDLL, x: torch.Tensor, src: torch.Tensor
                    ) -> torch.Tensor:
    """``moe_dispatch``'s launch on ``lib`` (``_lib(defines)``) for CUDA x
    and src that it has checked: the buffer, laid out as src is."""
    g, e, cap = src.shape
    d = x.shape[-1]
    if x.stride(-1) != 1:
        x = x.contiguous()
    major = is_e_major(src)
    if major:
        buf = torch.empty((e, g, cap, d), dtype=x.dtype,
                          device=x.device).transpose(0, 1)
    else:
        src = src.contiguous()
        buf = torch.empty((g, e, cap, d), dtype=x.dtype, device=x.device)
    err = _launch(x.device, lib.moe_dispatch, buf.data_ptr(), x.data_ptr(),
                  src.data_ptr(), g, e, cap, d, x.stride(0), x.stride(1),
                  int(major), _BF16[x.dtype])
    if err != 0:
        raise RuntimeError(f"moe_dispatch launch failed on "
                           f"{route(x.dtype)}: CUDA error {err}")
    return buf


def moe_combine(out_buf: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor, gates: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    """y (g, sg, d) in ``dtype`` (out_buf's): for each token the sum over
    its k slots, in order, of keep * gate * out_buf[g, idx, pos] in f32,
    rounded once.  out_buf (g, e, cap, d) f32 or bf16, any strides;
    idx and gates (g, sg, k) int64 and f32; pos and keep of ``moe_route``
    or ``moe_slots``.  One launch a call."""
    inst = route(out_buf.dtype, "moe_combine")
    if out_buf.dim() != 4 or idx.dim() != 3:
        raise ValueError(f"moe_combine: out_buf {tuple(out_buf.shape)}, idx "
                         f"{tuple(idx.shape)}")
    g, e, cap, d = out_buf.shape
    sg, k = idx.shape[1:]
    n = sg * k
    if dtype != out_buf.dtype or idx.dtype != torch.int64 or \
            gates.dtype != torch.float32 or pos.dtype != torch.int32 or \
            keep.dtype != torch.bool or idx.shape[0] != g or \
            gates.shape != idx.shape or pos.shape != (g, n) or \
            keep.shape != (g, n) or not 1 <= k <= e <= MAX_EXPERTS or \
            min(out_buf.shape) < 1 or sg < 1:
        raise ValueError(
            f"moe_combine: out_buf {tuple(out_buf.shape)} {out_buf.dtype} "
            f"to {dtype}, idx {tuple(idx.shape)} {idx.dtype}, gates "
            f"{tuple(gates.shape)} {gates.dtype}, pos {tuple(pos.shape)} "
            f"{pos.dtype}, keep {tuple(keep.shape)} {keep.dtype}")
    if not _on_card("moe_combine", (out_buf, idx, pos, keep, gates)):
        return moe_combine_plain(out_buf, idx, pos, keep, gates, dtype)
    if out_buf.stride(-1) != 1:
        out_buf = out_buf.contiguous()
    idx, pos, keep, gates = (t.contiguous() for t in (idx, pos, keep, gates))
    y = torch.empty((g, sg, d), dtype=dtype, device=out_buf.device)
    err = _launch(out_buf.device, _lib().moe_combine, y.data_ptr(),
                  out_buf.data_ptr(), idx.data_ptr(), pos.data_ptr(),
                  keep.data_ptr(), gates.data_ptr(), g, sg, k, e, cap, d,
                  *out_buf.stride()[:3], _BF16[dtype])
    if err != 0:
        raise RuntimeError(f"moe_combine launch failed on {inst}: CUDA "
                           f"error {err}")
    _count(moe_combine, inst)
    return y


for _fn in (moe_slots, moe_dispatch, moe_combine, moe_route):
    _fn.launches = 0
    _fn.launches_by_route = dict.fromkeys(ROUTES[_fn.__name__], 0)
del _fn
