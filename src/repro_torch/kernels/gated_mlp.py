"""The gated MLP's activation ``act(a) * b`` on Hopper, forward and
backward, as an autograd function.

Replaces no Pallas kernel: the reference computes ``gate(h) * g`` with jnp
inside its jitted steps (``repro/models/model.py`` ``_mlp`` and the experts
of ``repro/models/moe.py``, under ``jax.jit`` in ``repro/launch/train.py``
and ``launch/serve.py``), where XLA fuses the pair.  The kernels are CUDA
C++ written by hand for sm_90a (``repro_torch/csrc/gated_mlp.cu``), built
by ``nvcc`` into a plain-C shared library and called through ctypes.

What bounds them: bytes.  The forward reads a and b and writes y once; the
backward reads a, b and dy and writes da and db once.  What the design
does: one flat pass over the elements in whatever dense layout a and b
share (the MoE experts' e-major products pass uncopied), 16-byte loads
where every pointer is aligned and the count a multiple of the vector
(else one element a thread), the plain route's arithmetic and its bf16
roundings between the ops, so that the bits are the plain route's.

``models.common.gated_act`` chooses by the tensors' device
(``takes_kernel``): CUDA tensors go through ``GatedAct`` (its forward and
backward launch the kernels; a call autograd does not record launches the
forward alone); CPU and meta tensors (DTensors among them) take the plain
version, ``gated_act_plain`` (its backward written out,
``gated_act_bwd_plain``); a DTensor on CUDA, any other device and a mix
raise.  The launch functions (``gated_act_fwd``, ``gated_act_bwd``) need
CUDA tensors, raise on what the kernels do not take or a refused launch,
and count their launches on the host (``.launches`` /
``.launches_by_route``) and on the device (``kernel_launches``: a CUDA
graph's replays are counted too).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Iterable, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import launch as _launch

_COUNT_LOCK = threading.Lock()
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the config's gated activations and the C's activation ids
ACTIVATIONS = {"swiglu": 0, "geglu": 1}
# the C instance ids: activation * 2 + (bf16)
ROUTES = ("silu_f32", "silu_bf16", "gelu_f32", "gelu_bf16")
KERNELS = ("gated_act_fwd", "gated_act_bwd")
VEC_BYTES = 16          # a vectorised thread's load


def route(activation: str, dtype: torch.dtype) -> str:
    """The instance ``activation`` (swiglu or geglu) of tensors of
    ``dtype`` (float32 or bfloat16) runs."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"gated_act: activation {activation!r} (swiglu, "
                         f"geglu)")
    if dtype not in _NAMES:
        raise ValueError(f"gated_act: tensors are {dtype} (float32, "
                         f"bfloat16)")
    return ROUTES[ACTIVATIONS[activation] * 2 + _BF16[dtype]]


def vectorised(tensors: Sequence[torch.Tensor]) -> bool:
    """True where the kernels take 16 bytes a thread: every pointer
    16-byte aligned and the element count a multiple of the vector."""
    per = VEC_BYTES // tensors[0].element_size()
    return tensors[0].numel() % per == 0 and all(
        t.data_ptr() % VEC_BYTES == 0 for t in tensors)


def takes_kernel(tensors: Iterable[Any], what: str = "gated_act") -> bool:
    """True if ``tensors`` launch ``what``'s kernels: all on CUDA, none a
    DTensor.  False if they take the plain versions: all on the CPU or
    meta, DTensors among them (the dry-run traces the steps on meta
    DTensors).  Raises for a DTensor on CUDA (no path shards the kernels'
    inputs), for any other device and for a mix of CUDA and CPU or meta
    tensors."""
    kinds = set()
    for t in tensors:
        if t.device.type in ("cpu", "meta"):
            kinds.add("plain")
        elif t.device.type == "cuda":
            if getattr(t, "placements", None) is not None:
                raise ValueError(f"no {what} kernel for a DTensor on CUDA")
            kinds.add("cuda")
        else:
            raise ValueError(f"no {what} kernel or plain version for "
                             f"device {t.device}")
    if len(kinds) > 1:
        raise ValueError(f"{what} inputs mix CUDA and CPU or meta tensors")
    return kinds == {"cuda"}


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def _act(activation: str):
    route(activation, torch.float32)
    if activation == "swiglu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def gated_act_plain(a: torch.Tensor, b: torch.Tensor,
                    activation: str) -> torch.Tensor:
    """``act(a) * b`` as torch ops: silu for swiglu, gelu's tanh form for
    geglu (``jax.nn.gelu``'s default), in a's dtype."""
    return _act(activation)(a) * b


def gated_act_bwd_plain(a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor,
                        activation: str
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of ``gated_act_plain(a, b)`` given dy, as autograd computes
    them, op for op: db = dy * act(a), da = act's backward of dy * b, each
    in the inputs' dtype."""
    gb = dy * b
    if activation == "swiglu":
        da = torch.ops.aten.silu_backward(gb, a)
    else:
        route(activation, a.dtype)
        da = torch.ops.aten.gelu_backward(gb, a, approximate="tanh")
    return da, dy * _act(activation)(a)


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("gated_mlp")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gated_act_fwd.argtypes = [p, p, p, ll, i, i, p]
        lib.gated_act_fwd.restype = i
        lib.gated_act_bwd.argtypes = [p, p, p, p, p, ll, i, i, p]
        lib.gated_act_bwd.restype = i
        lib.gated_act_launches.argtypes = [i, i]
        lib.gated_act_launches.restype = ctypes.c_ulonglong
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
        for i, r in enumerate(ROUTES):
            n = int(lib.gated_act_launches(k, i))
            if n == 2 ** 64 - 1:
                raise RuntimeError("gated_act_launches: the copy from the "
                                   "device failed")
            out[name][r] = n
    return out


def _dense(t: torch.Tensor) -> bool:
    """True if ``t`` covers its storage span without gaps or overlaps in
    some order of its dims (its strides those ``empty_like`` keeps)."""
    return all(s > 0 for s in t.stride()) and \
        torch.empty_like(t).stride() == t.stride()


def _laid_out(name: str, tensors: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, ...]:
    """``tensors`` checked (CUDA, one device, shape and dtype) and in one
    dense layout: the first's where it is dense (contiguous, or a
    permutation of it), else contiguous; each other tensor as it is where
    it has that layout, else copied into it."""
    first = tensors[0]
    dev = first.device
    for t in tensors[1:]:
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"{name}: tensors {tuple(t.shape)} {t.dtype} "
                             f"and {tuple(first.shape)} {first.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {dev}")
    ref = first if first.is_contiguous() or _dense(first) \
        else first.contiguous()

    def alike(t):
        if (t.is_contiguous() and ref.is_contiguous()) \
                or t.stride() == ref.stride():
            return t
        return torch.empty_like(ref).copy_(t)
    return (ref, *(alike(t) for t in tensors[1:]))


def gated_act_fwd(a: torch.Tensor, b: torch.Tensor,
                  activation: str) -> torch.Tensor:
    """``gated_act_plain(a, b, activation)`` of CUDA tensors a and b (one
    shape, f32 or bf16) in one launch, laid out as a."""
    r = route(activation, a.dtype)
    a, b = _laid_out("gated_act_fwd", (a, b))
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    err = _launch(a.device, _lib().gated_act_fwd, out.data_ptr(),
                  a.data_ptr(), b.data_ptr(), a.numel(),
                  ACTIVATIONS[activation], _BF16[a.dtype])
    if err != 0:
        raise RuntimeError(f"gated_act_fwd launch failed on {r}: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        gated_act_fwd.launches += 1
        gated_act_fwd.launches_by_route[r] += 1
    return out


def gated_act_bwd(a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor,
                  activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of ``gated_act_fwd(a, b, activation)`` given dy (their
    shape and dtype), as ``gated_act_bwd_plain`` computes them, in one
    launch."""
    r = route(activation, a.dtype)
    a, b, dy = _laid_out("gated_act_bwd", (a, b, dy))
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    err = _launch(a.device, _lib().gated_act_bwd, da.data_ptr(),
                  db.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(),
                  a.numel(), ACTIVATIONS[activation], _BF16[a.dtype])
    if err != 0:
        raise RuntimeError(f"gated_act_bwd launch failed on {r}: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        gated_act_bwd.launches += 1
        gated_act_bwd.launches_by_route[r] += 1
    return da, db


class GatedAct(torch.autograd.Function):
    """``act(a) * b`` on CUDA tensors: one forward launch and one backward
    launch writing da and db.  Saves a and b only (the backward recomputes
    act(a)), so remat's recompute and the saved activations are the
    inputs'."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor,
                activation: str) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        ctx.activation = activation
        return gated_act_fwd(a, b, activation)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        a, b = ctx.saved_tensors
        da, db = gated_act_bwd(a, b, dy.to(a.dtype), ctx.activation)
        return da, db, None


gated_act_fwd.launches = 0
gated_act_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
gated_act_bwd.launches = 0
gated_act_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
