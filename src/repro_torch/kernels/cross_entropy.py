"""The train step's soft-capped cross-entropy on Hopper, forward and
backward, as an autograd function.

Replaces no Pallas kernel: the reference computes ``softcap(logits.astype(
f32), cap)`` and ``cross_entropy`` with jnp inside its jitted train step
(``repro/models/model.py`` ``logits_fn`` and ``forward_train``,
``repro/models/common.py`` ``softcap`` and ``cross_entropy``, under
``jax.jit`` in ``repro/launch/train.py``), where XLA fuses them.  The
kernels are CUDA C++ written by hand for sm_90a
(``repro_torch/csrc/cross_entropy.cu``), built by ``nvcc`` into a plain-C
shared library and called through ctypes.

What bounds them: bytes.  The forward reads the logits once in their own
dtype (no f32 copy) and writes a row's lse (an f32 value and its f32
remainder) and loss; the backward reads them
once more and writes their grad once.  What the design does: a block a
row, 16-byte loads, the plain route's cap bit for bit, an online maximum
and a sum of exponentials in a fixed order (f64 across a thread's groups),
merged in a fixed order; a second small launch sums the rows' losses in
row order and divides by the labels kept; the backward reads the upstream
grad and that count on the device (no ``.item()``, so a step can be
captured).  No float atomics: the same bits on every call.

``models.common.capped_cross_entropy`` chooses by the tensors' device
(``takes_kernel``): CUDA tensors go through ``CappedCrossEntropy``; CPU and
meta tensors (DTensors among them) take the plain version,
``capped_cross_entropy_plain`` (``models.common.cross_entropy`` of
``softcap(logits.float(), cap)``, the ops ``forward_train`` has always run
there; its backward written out, ``capped_cross_entropy_bwd_plain``); a
DTensor on CUDA, any other device and a mix raise.  Labels outside
``[0, vocab_size)``, those at or past the padded width included, are
masked out of the mean.  The launch functions (``cross_entropy_fwd``,
``cross_entropy_bwd``) need CUDA tensors, raise on what the kernels do not
take or a refused launch, and count their launches on the host
(``.launches`` / ``.launches_by_route``) and on the device
(``kernel_launches``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from . import _build
from ._build import launch as _launch
from .gated_mlp import takes_kernel as _takes_kernel

_COUNT_LOCK = threading.Lock()
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("f32", "bf16")            # the logits' dtype: the C instance id
KERNELS = ("cross_entropy_fwd", "cross_entropy_sum", "cross_entropy_bwd")
MAX_ROWS = 1 << 24                  # the kept count is exact in f32


def route(dtype: torch.dtype) -> str:
    if dtype not in _BF16:
        raise ValueError(f"cross_entropy: logits are {dtype} (float32, "
                         f"bfloat16)")
    return ROUTES[_BF16[dtype]]


def takes_kernel(tensors) -> bool:
    """``gated_mlp.takes_kernel``'s rule for the loss's tensors."""
    return _takes_kernel(tensors, "cross_entropy")


def inv_cap(cap: float) -> float:
    """The f32 reciprocal of the cap that ATen's division of a CUDA tensor
    by a Python scalar multiplies by (0 for no cap)."""
    return float(np.float32(1) / np.float32(cap)) if cap else 0.0


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def capped_cross_entropy_plain(logits: torch.Tensor, labels: torch.Tensor,
                               cap: float, vocab_size: int) -> torch.Tensor:
    """The mean cross-entropy of ``softcap(logits.float(), cap)`` over the
    labels in ``[0, vocab_size)`` (``models.common.cross_entropy``)."""
    from ..models.common import cross_entropy, softcap
    return cross_entropy(softcap(logits.float(), cap), labels, vocab_size)


def capped_cross_entropy_bwd_plain(logits: torch.Tensor,
                                   labels: torch.Tensor, cap: float,
                                   vocab_size: int, g: torch.Tensor
                                   ) -> torch.Tensor:
    """The grad of ``capped_cross_entropy_plain`` with respect to the
    logits, given the upstream grad g, written out in f32 in autograd's
    order and cast to the logits' dtype: (exp(c - lse) - onehot(label)) *
    cap' * mask * g / max(kept, 1), c the capped logits, cap' = 1 -
    tanh(x / cap)^2."""
    x = logits.float()
    c = x if not cap else cap * torch.tanh(x / cap)
    labels = labels.long()
    mask = (labels >= 0) & (labels < vocab_size)
    w = (g.float() / mask.sum().clamp_min(1)) * mask
    lse = torch.logsumexp(c, dim=-1, keepdim=True)
    grad = torch.exp(c - lse) * w[..., None]
    idx = labels.clamp(0, x.shape[-1] - 1)[..., None]
    grad = grad.scatter_add(-1, idx, -w[..., None])
    if cap:
        grad = grad * (1 - torch.tanh(x / cap).square())
    return grad.to(logits.dtype)


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("cross_entropy")
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.cross_entropy_fwd.argtypes = [p, p, p, p, p, p, ll, i, i, f, f,
                                          i, p]
        lib.cross_entropy_fwd.restype = i
        lib.cross_entropy_bwd.argtypes = [p, p, p, p, p, p, ll, i, i, f, f,
                                          i, p]
        lib.cross_entropy_bwd.restype = i
        lib.cross_entropy_launches.argtypes = [i, i]
        lib.cross_entropy_launches.restype = ctypes.c_ulonglong
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
            n = int(lib.cross_entropy_launches(k, i))
            if n == 2 ** 64 - 1:
                raise RuntimeError("cross_entropy_launches: the copy from "
                                   "the device failed")
            out[name][r] = n
    return out


def _args(name: str, logits: torch.Tensor, labels: torch.Tensor,
          vocab_size: int) -> Tuple[str, torch.Tensor, torch.Tensor, int]:
    """(route, logits contiguous, labels as (rows,) int64, rows) after
    the checks: labels of the logits' leading shape, 1 <= vocab_size <=
    the width, rows below ``MAX_ROWS``, CUDA tensors on one device."""
    r = route(logits.dtype)
    if logits.dim() < 1 or labels.shape != logits.shape[:-1]:
        raise ValueError(f"{name}: labels {tuple(labels.shape)} for logits "
                         f"{tuple(logits.shape)}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise ValueError(f"{name}: labels are {labels.dtype} (integers)")
    width = logits.shape[-1]
    if not 1 <= vocab_size <= width:
        raise ValueError(f"{name}: vocab_size {vocab_size} for width "
                         f"{width}")
    rows = labels.numel()
    if rows >= MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows (at most {MAX_ROWS - 1})")
    dev = logits.device
    if labels.device != dev:
        raise ValueError(f"{name}: tensors on {labels.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {dev}")
    return r, logits.contiguous(), labels.reshape(-1).long(), rows


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor,
                      cap: float, vocab_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, lse, denominator) of ``capped_cross_entropy_plain(logits,
    labels, cap, vocab_size)`` on CUDA tensors (logits f32 or bf16, last
    dim the padded width; labels their leading shape) in two launches:
    the loss a 0-d f32 tensor, lse (rows, 2) f32 (each row's log-sum-exp
    as an f32 value and its f32 remainder), the denominator max(kept, 1)
    a 0-d f32 tensor (the backward's)."""
    r, logits, flat, rows = _args("cross_entropy_fwd", logits, labels,
                                  vocab_size)
    dev = logits.device
    if rows == 0:
        return (torch.zeros((), device=dev), torch.empty((0, 2), device=dev),
                torch.ones((), device=dev))
    loss = torch.empty((), dtype=torch.float32, device=dev)
    denominator = torch.empty_like(loss)
    lse = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    row_loss = torch.empty(rows, dtype=torch.float32, device=dev)
    err = _launch(dev, _lib().cross_entropy_fwd, lse.data_ptr(),
                  row_loss.data_ptr(), loss.data_ptr(),
                  denominator.data_ptr(), logits.data_ptr(),
                  flat.data_ptr(), rows, logits.shape[-1], vocab_size,
                  float(cap), inv_cap(cap), _BF16[logits.dtype])
    if err != 0:
        raise RuntimeError(f"cross_entropy_fwd launch failed on {r}: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        cross_entropy_fwd.launches += 1
        cross_entropy_fwd.launches_by_route[r] += 1
    return loss, lse, denominator


def cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, g: torch.Tensor,
                      denominator: torch.Tensor, cap: float,
                      vocab_size: int) -> torch.Tensor:
    """The grad of ``cross_entropy_fwd``'s loss with respect to the logits
    (their shape and dtype) given the upstream grad ``g`` (a 0-d device
    tensor) and the forward's lse and denominator, in one launch, as
    ``capped_cross_entropy_bwd_plain`` computes it."""
    r, logits, flat, rows = _args("cross_entropy_bwd", logits, labels,
                                  vocab_size)
    dev = logits.device
    for name, t in (("lse", lse), ("g", g), ("denominator", denominator)):
        if t.device != dev:
            raise ValueError(f"cross_entropy_bwd: {name} on {t.device}, "
                             f"logits on {dev}")
    if lse.shape != (rows, 2) or lse.dtype != torch.float32:
        raise ValueError(f"cross_entropy_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} for {rows} rows")
    grad = torch.empty_like(logits)
    if rows == 0:
        return grad
    g = g.reshape(()).float()
    denominator = denominator.reshape(()).float()
    lse = lse.contiguous()
    err = _launch(dev, _lib().cross_entropy_bwd, grad.data_ptr(),
                  logits.data_ptr(), lse.data_ptr(), flat.data_ptr(),
                  g.data_ptr(), denominator.data_ptr(), rows,
                  logits.shape[-1], vocab_size, float(cap), inv_cap(cap),
                  _BF16[logits.dtype])
    if err != 0:
        raise RuntimeError(f"cross_entropy_bwd launch failed on {r}: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        cross_entropy_bwd.launches += 1
        cross_entropy_bwd.launches_by_route[r] += 1
    return grad


class CappedCrossEntropy(torch.autograd.Function):
    """The mean capped cross-entropy of CUDA logits: the forward's two
    launches (rows; their sum) and one backward launch.  Saves the logits
    in their own dtype, the labels, lse and the denominator: no f32 copy
    of the logits."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor, cap: float,
                vocab_size: int) -> torch.Tensor:
        loss, lse, denominator = cross_entropy_fwd(logits, labels, cap,
                                                   vocab_size)
        ctx.save_for_backward(logits, labels, lse, denominator)
        ctx.cap, ctx.vocab_size = cap, vocab_size
        return loss

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, labels, lse, denominator = ctx.saved_tensors
        grad = cross_entropy_bwd(logits, labels, lse, g, denominator,
                                 ctx.cap, ctx.vocab_size)
        return grad, None, None, None


cross_entropy_fwd.launches = 0
cross_entropy_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
cross_entropy_bwd.launches = 0
cross_entropy_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
