"""RMSNorm and RoPE on Hopper, forward and backward, as autograd functions.

Replaces no Pallas kernel: the reference computes both with jnp inside its
jitted steps (``repro/models/common.py`` ``rms_norm`` and ``apply_rope``,
under ``jax.jit`` in ``repro/launch/train.py`` and ``launch/serve.py``),
where XLA fuses each into a few passes.  The kernels are CUDA C++ written
by hand for sm_90a (``repro_torch/csrc/norm_rope.cu``), built by ``nvcc``
into a plain-C shared library and called through ctypes.

What bounds them: bytes.  A norm reads x and writes y once; its backward
reads x and dy and writes dx (plus one f32 partial row a chunk of rows for
dscale); a rotation reads and writes q and k once.  What the design does:
16-byte loads kept in registers (a row wider than 8,192 elements in
passes, each but the last read again), a row's sums in a fixed order
(``plan``: it depends on the width and the alignment only), the
reference's order of
operations with each product and sum IEEE-rounded; dscale as per-chunk f32
partials summed in a fixed order by a second kernel (no float atomics, so
losses and grads repeat to the bit); cos and sin by ``cosf`` / ``sinf``
once a (row, pair) for every head; q and k rotated by one launch, the
backward the same kernel by -angle.

``models.common``'s ``rms_norm``, ``apply_rope`` and ``apply_rope_qk``
choose by the tensors' device (``takes_kernel``): CUDA tensors go through
``RMSNorm`` and ``Rope`` here, whose forwards and backwards launch the
kernels (with or without autograd recording); CPU and
meta tensors (DTensors among them) take the plain versions
(``models.common.rms_norm_plain``, ``apply_rope_plain``; their backward
formulas written out are ``rms_norm_bwd_plain`` and ``rope_bwd_plain``); a
DTensor on CUDA, any other device and a mix raise.  The launch functions
(``rms_norm_fwd``, ``rms_norm_bwd``, ``rope``) need CUDA tensors, raise on
what the kernels do not take or a refused launch, and count their launches
on the host (``.launches`` / ``.launches_by_route``) and on the device
(``kernel_launches``: a CUDA graph's replays are counted too).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Iterable, Sequence, Tuple

import torch

from . import _build
from ._build import launch as _launch

_COUNT_LOCK = threading.Lock()
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the C instance ids: a norm kernel's (x bf16) * 2 + (scale bf16), named
# x_scale; rope's (backward) * 2 + (bf16)
NORM_ROUTES = ("f32_f32", "f32_bf16", "bf16_f32", "bf16_bf16")
ROPE_ROUTES = ("forward_f32", "forward_bf16", "backward_f32",
               "backward_bf16")
KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "rms_norm_dscale", "rope")
# the kernels' launch shape, as norm_rope.cu works it out (the CPU tests
# emulate the order of dscale's sums from these): threads a block, elements
# a 16-byte group, groups a thread keeps a pass (aligned), elements a
# thread keeps a pass (unaligned), the backward's row chunks at most,
# strided runs a dscale column
THREADS = 256
VEC = 8
ITEMS = 4
SCALAR_ITEMS = 32
BWD_BLOCKS = 264
DSCALE_SPLIT = 8


def norm_route(x_dtype: torch.dtype, scale_dtype: torch.dtype) -> str:
    """The instance a norm of x in ``x_dtype`` with a scale in
    ``scale_dtype`` runs (each float32 or bfloat16)."""
    for name, dt in (("x", x_dtype), ("scale", scale_dtype)):
        if dt not in _NAMES:
            raise ValueError(f"rms_norm: {name} is {dt} (float32, bfloat16)")
    return f"{_NAMES[x_dtype]}_{_NAMES[scale_dtype]}"


def rope_route(dtype: torch.dtype, backward: bool = False) -> str:
    if dtype not in _NAMES:
        raise ValueError(f"rope: x is {dtype} (float32, bfloat16)")
    return f"{'backward' if backward else 'forward'}_{_NAMES[dtype]}"


def plan(rows: int, n: int, vec: bool) -> dict:
    """How the norm kernels cut ``rows`` rows of ``n`` elements (``vec``:
    every pointer 16-byte aligned and n % 8 == 0): threads a row (the
    fewest powers of two from 32 that leave each thread ``ITEMS`` groups of
    8, or ``SCALAR_ITEMS`` elements, up to ``THREADS``), passes over a row
    (more than one past ``THREADS`` threads' items), rows a block
    (``slots``), the backward's rows a chunk and chunks (a block and a
    partial row each)."""
    groups, most = (n // VEC, ITEMS) if vec else (n, SCALAR_ITEMS)
    t = 32
    while t < THREADS and groups > most * t:
        t *= 2
    per = -(-rows // BWD_BLOCKS)
    return {"threads_per_row": t, "passes": -(-groups // (most * t)),
            "slots": THREADS // t, "rows_per_chunk": per,
            "chunks": -(-rows // per)}


def takes_kernel(tensors: Iterable[Any]) -> bool:
    """True if ``tensors`` launch the kernels: all on CUDA, none a DTensor.
    False if they take the plain versions: all on the CPU or meta,
    DTensors among them (the dry-run traces the steps on meta DTensors).
    Raises for a DTensor on CUDA (no path shards the kernels' inputs), for
    any other device and for a mix of CUDA and CPU or meta tensors."""
    kinds = set()
    for t in tensors:
        if t.device.type in ("cpu", "meta"):
            kinds.add("plain")
        elif t.device.type == "cuda":
            if getattr(t, "placements", None) is not None:
                raise ValueError("no norm or rope kernel for a DTensor on "
                                 "CUDA")
            kinds.add("cuda")
        else:
            raise ValueError(f"no norm or rope kernel or plain version for "
                             f"device {t.device}")
    if len(kinds) > 1:
        raise ValueError("norm or rope inputs mix CUDA and CPU or meta "
                         "tensors")
    return kinds == {"cuda"}


# ---------------------------------------------------------------------------
# The plain backward formulas (the autograd of the plain versions, written
# out in the kernels' order of operations)
# ---------------------------------------------------------------------------


def rms_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                       dy: torch.Tensor, eps: float = 1e-6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale in the scale's dtype) of ``y = x *
    rsqrt(mean(x^2) + eps) * (1 + scale)`` (f32 inside) given dy: dx = dy
    w r - x (dot r^3 / n), dot = sum(dy w x), dscale = the sum over rows of
    dy x r."""
    n = x.shape[-1]
    xf, g = x.float(), dy.float()
    w = 1.0 + scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = g * w
    dot = (gw * xf).sum(dim=-1, keepdim=True)
    c = dot * r * r * r / n
    dx = gw * r - xf * c
    dscale = (g * (xf * r)).reshape(-1, n).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rope_cos_sin(positions: torch.Tensor, freqs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the angles ``positions[..., None] * freqs`` as the
    plain version computes them, (..., S, 1, hd/2) f32."""
    angles = (positions[..., None].float() * freqs)[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def rope_bwd_plain(dy: torch.Tensor, positions: torch.Tensor,
                   theta: float) -> torch.Tensor:
    """dx of the plain rotation (``models.common.apply_rope_plain``) given
    dy (..., S, heads, hd): dy rotated by -angle, in dy's dtype."""
    from ..models.common import rope_freqs
    cos, sin = rope_cos_sin(positions,
                            rope_freqs(dy.shape[-1], theta, dy.device))
    g1, g2 = dy.float().chunk(2, dim=-1)
    out = torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)
    return out.to(dy.dtype)


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------


_LIB = None      # the loaded library: a norm is a few microseconds of work


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("norm_rope")
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.rms_norm_fwd.argtypes = [p, p, p, ll, i, i, i, f, p]
        lib.rms_norm_fwd.restype = i
        lib.rms_norm_bwd.argtypes = [p, p, p, ll, p, p, p, ll, i, i, i, f,
                                     p]
        lib.rms_norm_bwd.restype = i
        lib.rope.argtypes = [p, p, i, p, p, i, ll, i, i, p, ll, ll, p, i, i,
                             p]
        lib.rope.restype = i
        lib.norm_rope_launches.argtypes = [i, i]
        lib.norm_rope_launches.restype = ctypes.c_ulonglong
        _LIB = lib
    return _LIB


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by kernel and route that ``lib``'s kernels have counted on
    the device since the library was loaded (a CUDA graph's replays
    included).  A synchronous copy from the device: never call it during a
    capture."""
    out = {}
    for k, name in enumerate(KERNELS):
        routes = ROPE_ROUTES if name == "rope" else NORM_ROUTES
        out[name] = {}
        for i, r in enumerate(routes):
            n = int(lib.norm_rope_launches(k, i))
            if n == 2 ** 64 - 1:
                raise RuntimeError("norm_rope_launches: the copy from the "
                                   "device failed")
            out[name][r] = n
    return out


def _check_cuda(name: str, tensors: Sequence[torch.Tensor]) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")


def _norm_args(name: str, x: torch.Tensor, scale: torch.Tensor
               ) -> Tuple[str, int, int]:
    route = norm_route(x.dtype, scale.dtype)
    n = x.shape[-1]
    if scale.shape != (n,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for width {n}")
    if n < 1:
        raise ValueError(f"{name}: width 0")
    return route, x.numel() // n, n


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """``models.common.rms_norm`` of x (f32 or bf16, last dim n) with
    ``scale`` (n,) (f32 or bf16) in one launch, in x's dtype."""
    _check_cuda("rms_norm_fwd", (x, scale))
    route, rows, n = _norm_args("rms_norm_fwd", x, scale)
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = _launch(x.device, _lib().rms_norm_fwd, out.data_ptr(),
                  x.data_ptr(), scale.data_ptr(), rows, n, _BF16[x.dtype],
                  _BF16[scale.dtype], eps)
    if err != 0:
        raise RuntimeError(f"rms_norm_fwd launch failed on {route}: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        rms_norm_fwd.launches += 1
        rms_norm_fwd.launches_by_route[route] += 1
    return out


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rms_norm_fwd(x, scale, eps)`` given dy (x's shape
    and dtype), as ``rms_norm_bwd_plain`` computes them, in two launches:
    dx and a partial dscale row a chunk of rows, then dscale summed over
    the chunks in a fixed order (``plan``)."""
    _check_cuda("rms_norm_bwd", (x, scale, dy))
    route, rows, n = _norm_args("rms_norm_bwd", x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rms_norm_bwd: dy {tuple(dy.shape)} {dy.dtype}, "
                         f"x {tuple(x.shape)} {x.dtype}")
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    chunks = plan(rows, n, False)["chunks"]
    partials = torch.empty(chunks * n, dtype=torch.float32, device=x.device)
    err = _launch(x.device, _lib().rms_norm_bwd, dx.data_ptr(),
                  dscale.data_ptr(), partials.data_ptr(), partials.numel(),
                  x.data_ptr(), dy.data_ptr(), scale.data_ptr(), rows, n,
                  _BF16[x.dtype], _BF16[scale.dtype], eps)
    if err != 0:
        raise RuntimeError(f"rms_norm_bwd launch failed on {route}: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        rms_norm_bwd.launches += 1
        rms_norm_bwd.launches_by_route[route] += 1
    return dx, dscale


def rope(xs: Sequence[torch.Tensor], positions: torch.Tensor,
         freqs: torch.Tensor, *, backward: bool = False
         ) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` (one or two tensors (..., S, heads, hd) of one
    dtype, f32 or bf16, whose leading dims agree: q and k) rotated by the
    angles ``positions * freqs`` (by -angle with ``backward``), as
    ``models.common.apply_rope_plain`` rotates them: one launch for all of
    them.  ``positions``: integers broadcastable to (..., S); ``freqs``:
    ``models.common.rope_freqs(hd, theta)`` on the device."""
    xs = list(xs)
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"rope rotates one or two tensors, got {len(xs)}")
    _check_cuda("rope", (*xs, positions, freqs))
    lead, hd = xs[0].shape[:-2], xs[0].shape[-1]
    route = rope_route(xs[0].dtype, backward)
    for t in xs:
        if t.dim() < 3 or t.shape[:-2] != lead or t.shape[-1] != hd \
                or t.dtype != xs[0].dtype:
            raise ValueError(f"rope: tensors {[tuple(u.shape) for u in xs]}"
                             f" {[u.dtype for u in xs]} do not agree")
    if hd % 2 or freqs.shape != (hd // 2,) or freqs.dtype != torch.float32:
        raise ValueError(f"rope: head dim {hd}, freqs {tuple(freqs.shape)} "
                         f"{freqs.dtype}")
    if positions.dtype.is_floating_point or positions.dtype == torch.bool:
        raise ValueError(f"rope: positions are {positions.dtype} (integers)")
    seq = lead[-1]
    pos = torch.broadcast_to(positions, lead).reshape(-1, seq)
    if pos.dtype != torch.int64:
        pos = pos.long()
    xs = [t.contiguous() for t in xs]
    outs = tuple(torch.empty_like(t) for t in xs)
    rows = pos.numel()
    if rows == 0:
        return outs
    k, k_out, hk = ((xs[1].data_ptr(), outs[1].data_ptr(), xs[1].shape[-2])
                    if len(xs) == 2 else (None, None, 0))
    freqs = freqs.contiguous()
    err = _launch(freqs.device, _lib().rope, outs[0].data_ptr(),
                  xs[0].data_ptr(), xs[0].shape[-2], k_out, k, hk, rows, seq,
                  hd, pos.data_ptr(), pos.stride(0), pos.stride(1),
                  freqs.data_ptr(), _BF16[xs[0].dtype], int(backward))
    if err != 0:
        raise RuntimeError(f"rope launch failed on {route}: CUDA error "
                           f"{err}")
    with _COUNT_LOCK:
        rope.launches += 1
        rope.launches_by_route[route] += 1
    return outs


# ---------------------------------------------------------------------------
# The autograd functions
# ---------------------------------------------------------------------------


class RMSNorm(torch.autograd.Function):
    """``rms_norm(x, scale, eps)`` on CUDA tensors: the forward kernel, and
    the backward's two (dx; dscale).  Saves x and the scale only (the
    backward recomputes each row's rsqrt), so remat's recompute and the
    saved activations are the inputs'."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, dy.to(x.dtype), ctx.eps)
        return dx, dscale, None


class Rope(torch.autograd.Function):
    """``rope`` of one or two tensors (q and k) on CUDA tensors: one launch
    forward, and one backward rotating their grads by -angle."""

    @staticmethod
    def forward(ctx, positions: torch.Tensor, freqs: torch.Tensor,
                *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        ctx.save_for_backward(positions, freqs)
        return rope(xs, positions, freqs)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        positions, freqs = ctx.saved_tensors
        return (None, None, *rope(grads, positions, freqs, backward=True))


rms_norm_fwd.launches = 0
rms_norm_fwd.launches_by_route = dict.fromkeys(NORM_ROUTES, 0)
rms_norm_bwd.launches = 0
rms_norm_bwd.launches_by_route = dict.fromkeys(NORM_ROUTES, 0)
rope.launches = 0
rope.launches_by_route = dict.fromkeys(ROPE_ROUTES, 0)
