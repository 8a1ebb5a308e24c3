"""The MoE block's dispatch on Hopper: slot positions, dispatch, combine.

Replaces no Pallas kernel: the reference computes the whole MoE block with
jnp inside its jitted serve steps (``repro/models/moe.py`` ``moe_block``,
under ``jax.jit`` in ``repro/launch/serve.py``), where XLA fuses the
routing glue.  The kernels are CUDA C++ written by hand for sm_90a
(``repro_torch/csrc/moe_dispatch.cu``), built by ``nvcc`` into a plain-C
shared library and called through ctypes.  They start from the router's
top-k experts ``idx`` (g, sg, k) and gates; the router, the experts'
products and the aux loss stay torch ops.

What bounds them: bytes.  ``moe_slots`` reads idx and writes each slot's
position in its expert, whether it is kept and the inverse map ``src``
(g, e, cap): the token row that fills each expert slot, or -1;
``moe_dispatch`` writes the (g, e, cap, d) buffer from the tokens' rows;
``moe_combine`` reads the kept rows of the experts' output and writes y.
What the design does: a block a group ranks its slots by warp matches and a
shared-memory scan of per-warp counts (exact, no atomics); the dispatch
and the combine copy and sum 16-byte vectors, a warp a row, the combine in
f32 in slot order and rounded once.

``models.moe.moe_block(..., use_kernel=True)`` calls the three wrappers
here.  Each validates its inputs, raises for a tensor that requires grad
(no backward: training takes the block's plain route), then launches its
kernel for CUDA tensors or takes its plain version (``moe_slots_plain``,
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

MAX_EXPERTS = 256       # the slot kernel's shared-memory counts
KERNELS = ("moe_slots", "moe_dispatch", "moe_combine")
# the C instance ids: slots one; dispatch and combine (bf16)
ROUTES = {"moe_slots": ("int64",), "moe_dispatch": ("f32", "bf16"),
          "moe_combine": ("f32", "bf16")}
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


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_dispatch")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.moe_slots.argtypes = [p, i, i, i, i, i, p, p, p, p]
        lib.moe_slots.restype = i
        lib.moe_dispatch.argtypes = [p, p, p, i, i, i, i, ll, ll, i, p]
        lib.moe_dispatch.restype = i
        lib.moe_combine.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ll,
                                    ll, ll, i, p]
        lib.moe_combine.restype = i
        lib.moe_dispatch_launches.argtypes = [i, i]
        lib.moe_dispatch_launches.restype = ctypes.c_ulonglong
        _LIB = lib
    return _LIB


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
    """The instance the dispatch and the combine run for x in ``dtype``."""
    if dtype not in _NAMES:
        raise ValueError(f"{name}: {dtype} (float32, bfloat16)")
    return _NAMES[dtype]


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
    (f32 or bf16) and ``moe_slots``' src.  One launch a call."""
    inst = route(x.dtype)
    if x.dim() != 3 or src.dim() != 3 or src.shape[0] != x.shape[0] or \
            src.dtype != torch.int32 or src.shape[1] > MAX_EXPERTS or \
            min(src.shape) < 1 or min(x.shape) < 1:
        raise ValueError(f"moe_dispatch: x {tuple(x.shape)}, src "
                         f"{tuple(src.shape)} {src.dtype}")
    if not _on_card("moe_dispatch", (x, src)):
        return moe_dispatch_plain(x, src)
    g, e, cap = src.shape
    sg, d = x.shape[1:]
    if x.stride(-1) != 1:
        x = x.contiguous()
    src = src.contiguous()
    buf = torch.empty((g, e, cap, d), dtype=x.dtype, device=x.device)
    err = _launch(x.device, _lib().moe_dispatch, buf.data_ptr(),
                  x.data_ptr(), src.data_ptr(), g, e, cap, d, x.stride(0),
                  x.stride(1), _BF16[x.dtype])
    if err != 0:
        raise RuntimeError(f"moe_dispatch launch failed on {inst}: CUDA "
                           f"error {err}")
    _count(moe_dispatch, inst)
    return buf


def moe_combine(out_buf: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor, gates: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    """y (g, sg, d) in ``dtype`` (out_buf's): for each token the sum over
    its k slots, in order, of keep * gate * out_buf[g, idx, pos] in f32,
    rounded once.  out_buf (g, e, cap, d) f32 or bf16, any strides;
    idx and gates (g, sg, k) int64 and f32; pos and keep of ``moe_slots``.
    One launch a call."""
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


for _fn in (moe_slots, moe_dispatch, moe_combine):
    _fn.launches = 0
    _fn.launches_by_route = dict.fromkeys(ROUTES[_fn.__name__], 0)
del _fn
