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
backward the same kernel by -angle.  The norm's backward has two routes
(``bwd_plan``, by the width, the dtype and the alignment only): the staged
route copies each input row once into a ring of row stages in shared
memory, several rows in flight on each SM, and reads both of its passes
from there; rows the ring does not take run on the register route, which
reads them twice.  Both give the same bits; each counts its launches on
routes of its own (``BWD_ROUTES``: ``staged_*`` and the register route's
``NORM_ROUTES``).

The elementwise work that XLA fuses into a norm or a rotation under
``jax.jit`` runs inside these kernels too, as compile-time prologues of the
norm (``add``: the output projection's bias and the residual add, h' = h +
(a + b) written out beside the normed rows; ``gate``: the SSM's gated
norm's ``y * silu(z)``) and RoPE's biases (q's and k's projection biases
added before the rotation), forward and backward, each rounded where the
plain ops round, so h' and every normed or rotated input are the unfused
route's bits.

``models.common``'s ``rms_norm``, ``apply_rope`` and ``apply_rope_qk``
choose by the tensors' device (``takes_kernel``): CUDA tensors go through
``RMSNorm`` and ``Rope`` here, whose forwards and backwards launch the
kernels (with or without autograd recording); CPU and
meta tensors (DTensors among them) take the plain versions
(``models.common.rms_norm_plain``, ``apply_rope_plain``; their backward
formulas written out are ``rms_norm_bwd_plain`` and ``rope_bwd_plain``); a
DTensor on CUDA, any other device and a mix raise.  The fused entry points
(``models.common``'s ``add_rms_norm``, ``gated_rms_norm`` and
``apply_rope_qk(..., biases=)``) choose by ``takes_fused``, the same rule:
CUDA tensors go through ``AddRMSNorm``, ``GatedRMSNorm`` and ``RopeBias``;
the others run the unfused ops (``add_rms_norm_plain``,
``gated_rms_norm_plain`` on the CPU; their backwards written out are
``add_rms_norm_bwd_plain``, ``gated_rms_norm_bwd_plain`` and
``rope_bias_bwd_plain``).  The launch functions (``rms_norm_fwd``,
``add_rms_norm_fwd``, ``gated_rms_norm_fwd``, their backwards, ``rope``)
need CUDA tensors, raise on what the kernels do not take or a refused
launch, and count their launches on the host by kernel and route
(``host_launches``: ``rms_norm_fwd``'s, ``rms_norm_bwd``'s and ``rope``'s
``.launches`` / ``.launches_by_route`` count every instance of their
kernel) and on the device (``kernel_launches``: a CUDA graph's replays are
counted too).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import launch as _launch

_COUNT_LOCK = threading.Lock()
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the C instance ids: a norm kernel's prologue * 4 + (x bf16) * 2 + (scale
# bf16), named [prologue_]x_scale (prologue none, add, gate); the dscale
# kernel's the norms' and 12 + (bf16) for RoPE's bias grads; rope's
# (biases) * 4 + (backward) * 2 + (bf16)
PROLOGUES = ("", "add", "gate")
_PAIRS = ("f32_f32", "f32_bf16", "bf16_f32", "bf16_bf16")
NORM_ROUTES = tuple(f"{p}_{r}" if p else r for p in PROLOGUES
                    for r in _PAIRS)
DSCALE_ROUTES = NORM_ROUTES + ("rope_bias_f32", "rope_bias_bf16")
ROPE_ROUTES = ("forward_f32", "forward_bf16", "backward_f32",
               "backward_bf16", "bias_forward_f32", "bias_forward_bf16",
               "bias_backward_f32", "bias_backward_bf16")
# the backward's routes: the register route's instances, then the staged
# route's (C counter 12 + the instance)
STAGED_ROUTES = tuple(f"staged_{r}" for r in NORM_ROUTES)
BWD_ROUTES = NORM_ROUTES + STAGED_ROUTES
KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "rms_norm_dscale", "rope")
KERNEL_ROUTES = {"rms_norm_fwd": NORM_ROUTES, "rms_norm_bwd": BWD_ROUTES,
                 "rms_norm_dscale": DSCALE_ROUTES, "rope": ROPE_ROUTES}
# a library whose backward runs the register route at every width (the old
# route, timed in turns with the staged one: ``tune.py --norm-bwd``)
FORCE_REGS_DEFINES = ("NORM_BWD_FORCE_REGS",)
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
PAIRS = 8
# the backward's staged route: a block's ring of row stages (bytes), its
# most stages, and the rows it stages an input row by prologue
RING_BYTES = 112 * 1024
MAX_STAGES = 4
STAGED_INPUTS = {"": 2, "add": 3, "gate": 3}
_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def norm_route(x_dtype: torch.dtype, scale_dtype: torch.dtype,
               prologue: str = "") -> str:
    """The instance a norm of x in ``x_dtype`` with a scale in
    ``scale_dtype`` runs (each float32 or bfloat16), behind ``prologue``
    ("" none, "add", "gate")."""
    for name, dt in (("x", x_dtype), ("scale", scale_dtype)):
        if dt not in _NAMES:
            raise ValueError(f"rms_norm: {name} is {dt} (float32, bfloat16)")
    if prologue not in PROLOGUES:
        raise ValueError(f"rms_norm: prologue {prologue!r} ({PROLOGUES})")
    pair = f"{_NAMES[x_dtype]}_{_NAMES[scale_dtype]}"
    return f"{prologue}_{pair}" if prologue else pair


def rope_route(dtype: torch.dtype, backward: bool = False,
               bias: bool = False) -> str:
    if dtype not in _NAMES:
        raise ValueError(f"rope: x is {dtype} (float32, bfloat16)")
    route = f"{'backward' if backward else 'forward'}_{_NAMES[dtype]}"
    return f"bias_{route}" if bias else route


def bwd_route(x_dtype: torch.dtype, scale_dtype: torch.dtype,
              prologue: str = "", staged: bool = False) -> str:
    """The route of a norm backward's rows: ``norm_route``'s instance on
    the register route, ``staged_`` and that on the staged one."""
    route = norm_route(x_dtype, scale_dtype, prologue)
    return f"staged_{route}" if staged else route


def dscale_route(route: str) -> str:
    """The dscale kernel's instance that sums the bias grads of RoPE's
    ``route`` (a ``bias_backward_*``), or a norm backward's ``route`` (on
    either of its routes)."""
    if route.startswith("bias_backward_"):
        return "rope_bias_" + route[len("bias_backward_"):]
    if route.startswith("staged_"):
        route = route[len("staged_"):]
    if route not in NORM_ROUTES:
        raise ValueError(f"no dscale launch on route {route!r}")
    return route


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


def bwd_plan(rows: int, n: int, vec: bool, x_dtype: torch.dtype,
             prologue: str = "", force_regs: bool = False) -> dict:
    """``plan`` and the backward's route, as ``norm_rope.cu``'s
    ``bwd_plan`` chooses it: "staged" where the rows may be copied in
    16-byte pieces (``vec``), a row takes one pass and a block's ring of
    ``RING_BYTES`` holds two stages or more (a stage: the block's
    ``slots`` rows of each of the prologue's ``STAGED_INPUTS``), with
    ``stages`` of them (at most ``MAX_STAGES``), beside the add and gated
    norms' weights in f32 (``ring_bytes``: the whole).  Else "regs"
    (the register route; every width with ``force_regs``, the
    ``FORCE_REGS_DEFINES`` build).  Both routes take the same chunks of
    rows and row slots, so the partial rows' order is ``plan``'s."""
    if prologue not in STAGED_INPUTS:
        raise ValueError(f"rms_norm: prologue {prologue!r} ({PROLOGUES})")
    p = plan(rows, n, vec)
    stage = p["slots"] * n * _BYTES[x_dtype] * STAGED_INPUTS[prologue]
    w_bytes = 4 * n if prologue else 0
    fit = (RING_BYTES - w_bytes) // stage
    staged = vec and p["passes"] == 1 and fit >= 2 and not force_regs
    stages = min(fit, MAX_STAGES) if staged else 0
    return {**p, "route": "staged" if staged else "regs", "stages": stages,
            "ring_bytes": stages * stage + w_bytes if staged else 0}


def vec_rows(n: int, tensors: Sequence[torch.Tensor],
             stride_bytes: int = 16) -> bool:
    """The kernels' rule for 16-byte groups: n % 8 == 0, every tensor's
    address 16-byte aligned and the row stride (``stride_bytes``, of a
    strided input) a multiple of 16 bytes."""
    return n % VEC == 0 and stride_bytes % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def backward_route(prologue: str, x: torch.Tensor, scale: torch.Tensor,
                   tensors: Sequence[torch.Tensor] = (),
                   stride_bytes: int = 16, force_regs: bool = False) -> str:
    """The route (``BWD_ROUTES``) of the norm backward of ``x`` (rows of
    its last dim) behind ``prologue``, whose launch also reads or writes
    ``tensors`` (the addresses the kernel checks, as its C entry point
    lists them), a strided input's row stride ``stride_bytes``."""
    n = x.shape[-1]
    vec = vec_rows(n, (x, scale, *tensors), stride_bytes)
    p = bwd_plan(x.numel() // n, n, vec, x.dtype, prologue, force_regs)
    return bwd_route(x.dtype, scale.dtype, prologue, p["route"] == "staged")


def rope_bias_blocks(rows: int, head_dim: int, vec: bool) -> int:
    """The blocks (partial rows of the bias grads) of RoPE's backward with
    biases: a block ``THREADS // (head_dim / 2 / pairs)`` whole rows
    (``vec``: 8 pairs a thread; every pointer 16-byte aligned and
    head_dim / 2 % 8 == 0)."""
    chunks = head_dim // 2 // (PAIRS if vec else 1)
    if chunks > THREADS:
        raise ValueError(f"rope with biases: head dim {head_dim} over "
                         f"{2 * THREADS} pairs' threads")
    slots = THREADS // chunks
    return -(-rows // slots)


def takes_kernel(tensors: Iterable[Any]) -> bool:
    """True if ``tensors`` launch the kernels: all on CUDA, none a DTensor.
    False if they take the plain versions: all on the CPU or meta,
    DTensors among them (the dry-run traces the steps on meta DTensors).
    Raises for a DTensor on CUDA (no path shards the kernels' inputs), for
    any other device and for a mix of CUDA and CPU or meta tensors."""
    return _takes(tensors)


def takes_fused(tensors: Iterable[Any]) -> bool:
    """``takes_kernel``'s rule for the fused entry points
    (``models.common``'s ``add_rms_norm``, ``gated_rms_norm``,
    ``apply_rope_qk`` with biases): True, their kernels; False, the
    unfused ops (the adds, or silu and the product, then ``rms_norm`` /
    ``apply_rope_qk``, which choose by ``takes_kernel``).  A function of its
    own so that a caller can select the unfused route on CUDA (the
    parent's path, which ``chip_smoke.py`` times in turns)."""
    return _takes(tensors)


def _takes(tensors: Iterable[Any]) -> bool:
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


def add_rms_norm_bwd_plain(hp: torch.Tensor, scale: torch.Tensor,
                           dy: torch.Tensor, dres: torch.Tensor,
                           bias_dtype: Optional[torch.dtype] = None,
                           eps: float = 1e-6):
    """(dh, dscale, dbias or None) of ``(h', y) = add_rms_norm(h, a, scale,
    b)`` from h' given y's grad dy and h''s grad dres: dh = dres + the
    norm's dx in h''s dtype (the grad of h and of a), dbias = dh summed
    over the rows in the bias's dtype (``bias_dtype``; None: no bias)."""
    dx, dscale = rms_norm_bwd_plain(hp, scale, dy, eps)
    dh = dres.to(hp.dtype) + dx
    dbias = None
    if bias_dtype is not None:
        dbias = dh.float().reshape(-1, hp.shape[-1]).sum(dim=0).to(
            bias_dtype)
    return dh, dscale, dbias


def gated_rms_norm_bwd_plain(y: torch.Tensor, z: torch.Tensor,
                             scale: torch.Tensor, dy: torch.Tensor,
                             eps: float = 1e-6):
    """(dy, dz, dscale) of ``rms_norm(y * silu(z), scale)`` given its grad
    dy, rounded as autograd of the plain ops rounds them: g = y silu(z),
    dg = the norm's dx of g, y's grad dg silu(z), z's silu'(z) (dg y)."""
    sz = F.silu(z)
    dg, dscale = rms_norm_bwd_plain(y * sz, scale, dy, eps)
    return (dg * sz, torch.ops.aten.silu_backward(dg * y, z).to(z.dtype),
            dscale)


def rope_bias_bwd_plain(dys: Sequence[torch.Tensor], positions: torch.Tensor,
                        theta: float, bias_dtypes: Sequence[torch.dtype]
                        ) -> Tuple[torch.Tensor, ...]:
    """The grads of the rotation of ``x + b`` (each of q and k, their
    biases (heads, head_dim)) given the rotated tensors' grads dys: each
    dy rotated by -angle (``rope_bwd_plain``), then each bias's grad, those
    summed over the rows in the bias's dtype."""
    outs = [rope_bwd_plain(d, positions, theta) for d in dys]
    sums = [o.float().reshape(-1, *o.shape[-2:]).sum(dim=0).to(dt)
            for o, dt in zip(outs, bias_dtypes)]
    return (*outs, *sums)


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------


_LIBS: dict = {}   # the loaded libraries by defines: a norm is a few
                   # microseconds of work


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _LIBS.get(defines)
    if lib is None:
        lib = _build.load("norm_rope", defines)
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
        lib.add_rms_norm_fwd.argtypes = [p, p, p, p, p, p, ll, i, i, i, i,
                                         f, p]
        lib.add_rms_norm_fwd.restype = i
        lib.gated_rms_norm_fwd.argtypes = [p, p, p, ll, p, ll, i, i, i, f,
                                           p]
        lib.gated_rms_norm_fwd.restype = i
        lib.add_rms_norm_bwd.argtypes = [p, p, p, p, ll, p, p, p, p, ll, i,
                                         i, i, i, f, p]
        lib.add_rms_norm_bwd.restype = i
        lib.gated_rms_norm_bwd.argtypes = [p, p, p, p, ll, p, p, ll, p, p,
                                           ll, i, i, i, f, p]
        lib.gated_rms_norm_bwd.restype = i
        lib.rope_bias.argtypes = [p, p, p, i, p, p, p, i, ll, i, i, p, ll,
                                  ll, p, i, i, p, p, ll, p]
        lib.rope_bias.restype = i
        lib.rms_norm_bwd_plan.argtypes = [i, i, i, i, i, p]
        lib.rms_norm_bwd_plan.restype = i
        lib.norm_rope_launches.argtypes = [i, i]
        lib.norm_rope_launches.restype = ctypes.c_ulonglong
        _LIBS[defines] = lib
    return lib


def card_plan(lib: ctypes.CDLL, prologue: str, x_dtype: torch.dtype,
              scale_dtype: torch.dtype, n: int, vec: bool) -> dict:
    """The backward's plan at width ``n`` as ``lib`` (on the current card)
    works it out: its route ("staged" or "regs"), threads a row, stages,
    dynamic shared bytes, and its rows' kernel's resident blocks an SM,
    registers a thread and spilled bytes a thread."""
    out = (ctypes.c_int * 7)()
    err = lib.rms_norm_bwd_plan(PROLOGUES.index(prologue), _BF16[x_dtype],
                                _BF16[scale_dtype], n, int(vec), out)
    if err != 0:
        raise RuntimeError(f"rms_norm_bwd_plan: CUDA error {err}")
    keys = ("route", "threads_per_row", "stages", "ring_bytes",
            "blocks_per_sm", "registers", "local_bytes")
    got = dict(zip(keys, list(out)))
    got["route"] = "staged" if got["route"] else "regs"
    return got


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by kernel and route that ``lib``'s kernels have counted on
    the device since the library was loaded (a CUDA graph's replays
    included).  A synchronous copy from the device: never call it during a
    capture."""
    out = {}
    for k, name in enumerate(KERNELS):
        out[name] = {}
        for i, r in enumerate(KERNEL_ROUTES[name]):
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


def host_launches() -> dict:
    """The launches counted on the host since the counts were last set to
    0, by kernel and route (``KERNEL_ROUTES``): a backward's dscale launch
    is its norm's (on the instance of either of its routes), or, on
    ``rope_bias_*``, RoPE's backward with biases."""
    fwd, bwd, rp = (dict(f.launches_by_route)
                    for f in (rms_norm_fwd, rms_norm_bwd, rope))
    dscale = {r: bwd.get(r, 0) + bwd.get(f"staged_{r}", 0)
              for r in NORM_ROUTES}
    for r in ("f32", "bf16"):
        dscale[f"rope_bias_{r}"] = rp.get(f"bias_backward_{r}", 0)
    return {"rms_norm_fwd": fwd, "rms_norm_bwd": bwd,
            "rms_norm_dscale": dscale, "rope": rp}


def _count(fn, route: str) -> None:
    """One host launch of ``fn``'s kernel (``rms_norm_fwd``,
    ``rms_norm_bwd`` or ``rope``) on ``route``."""
    with _COUNT_LOCK:
        fn.launches += 1
        fn.launches_by_route[route] += 1


def _norm_args(name: str, x: torch.Tensor, scale: torch.Tensor,
               prologue: str = "") -> Tuple[str, int, int]:
    route = norm_route(x.dtype, scale.dtype, prologue)
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
    _count(rms_norm_fwd, route)
    return out


def _forced(defines: Tuple[str, ...]) -> bool:
    return FORCE_REGS_DEFINES[0] in defines


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6, defines: Tuple[str, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rms_norm_fwd(x, scale, eps)`` given dy (x's shape
    and dtype), as ``rms_norm_bwd_plain`` computes them, in two launches:
    dx and a partial dscale row a chunk of rows (on the route
    ``backward_route`` gives), then dscale summed over the chunks in a
    fixed order (``plan``).  ``defines``: the library's build
    (``FORCE_REGS_DEFINES``: the register route at every width)."""
    _check_cuda("rms_norm_bwd", (x, scale, dy))
    _, rows, n = _norm_args("rms_norm_bwd", x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rms_norm_bwd: dy {tuple(dy.shape)} {dy.dtype}, "
                         f"x {tuple(x.shape)} {x.dtype}")
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    route = backward_route("", x, scale, (dx, dy),
                           force_regs=_forced(defines))
    chunks = plan(rows, n, False)["chunks"]
    partials = torch.empty(chunks * n, dtype=torch.float32, device=x.device)
    err = _launch(x.device, _lib(defines).rms_norm_bwd, dx.data_ptr(),
                  dscale.data_ptr(), partials.data_ptr(), partials.numel(),
                  x.data_ptr(), dy.data_ptr(), scale.data_ptr(), rows, n,
                  _BF16[x.dtype], _BF16[scale.dtype], eps)
    if err != 0:
        raise RuntimeError(f"rms_norm_bwd launch failed on {route}: CUDA "
                           f"error {err}")
    _count(rms_norm_bwd, route)
    return dx, dscale


def _bias_arg(name: str, bias: Optional[torch.Tensor], x: torch.Tensor,
              n: int) -> int:
    """The C flag of ``bias``'s dtype (1 bf16); raises unless ``x + bias``
    keeps x's dtype: a bias of x's dtype, or bf16 beside f32 x."""
    if bias is None:
        return 0
    if bias.shape != (n,) or bias.dtype not in _NAMES or not (
            bias.dtype == x.dtype or x.dtype == torch.float32):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} {bias.dtype} "
                         f"for x (..., {n}) {x.dtype} (x's dtype, or bf16 "
                         f"beside f32 x)")
    return _BF16[bias.dtype]


def add_rms_norm_fwd(h: torch.Tensor, a: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
                     h_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', y): h' = h + (a + bias) (``bias`` (n,) optional) and y =
    ``rms_norm_fwd(h', scale, eps)``, in one launch: h and a of one shape
    and dtype (f32 or bf16), the sums rounded to it as the plain adds
    round them, so h' is their bits.  ``h_out``: where h' goes (contiguous,
    of h's shape and dtype; it may be h or a itself: each element is read
    before it is written, by the same thread), else a new tensor."""
    _check_cuda("add_rms_norm_fwd",
                (h, a, scale) + (() if bias is None else (bias,)))
    route, rows, n = _norm_args("add_rms_norm_fwd", h, scale, "add")
    if a.shape != h.shape or a.dtype != h.dtype:
        raise ValueError(f"add_rms_norm_fwd: a {tuple(a.shape)} {a.dtype}, "
                         f"h {tuple(h.shape)} {h.dtype}")
    if h_out is not None and (h_out.shape != h.shape or h_out.dtype
                              != h.dtype or not h_out.is_contiguous()):
        raise ValueError(f"add_rms_norm_fwd: h_out {tuple(h_out.shape)} "
                         f"{h_out.dtype} (contiguous, h's shape and dtype)")
    b_bf16 = _bias_arg("add_rms_norm_fwd", bias, h, n)
    h, a, scale = h.contiguous(), a.contiguous(), scale.contiguous()
    h_out = torch.empty_like(h) if h_out is None else h_out
    out = torch.empty_like(h)
    if rows == 0:
        return h_out, out
    err = _launch(h.device, _lib().add_rms_norm_fwd, h_out.data_ptr(),
                  out.data_ptr(), h.data_ptr(), a.data_ptr(),
                  None if bias is None else bias.contiguous().data_ptr(),
                  scale.data_ptr(), rows, n, _BF16[h.dtype],
                  _BF16[scale.dtype], b_bf16, eps)
    if err != 0:
        raise RuntimeError(f"add_rms_norm_fwd launch failed on {route}: "
                           f"CUDA error {err}")
    _count(rms_norm_fwd, route)
    return h_out, out


def add_rms_norm_bwd(hp: torch.Tensor, scale: torch.Tensor,
                     dy: torch.Tensor, dres: torch.Tensor,
                     bias_dtype: Optional[torch.dtype] = None,
                     eps: float = 1e-6, defines: Tuple[str, ...] = ()):
    """(dh, dscale, dbias or None) of ``add_rms_norm_fwd`` from its h'
    (``hp``) given y's grad dy and h''s dres (both hp's shape and dtype),
    as ``add_rms_norm_bwd_plain`` computes them, in two launches (the rows
    and the partials on ``backward_route``'s route; the dscale kernel's
    fixed order for dscale and dbias); ``defines`` as ``rms_norm_bwd``'s."""
    _check_cuda("add_rms_norm_bwd", (hp, scale, dy, dres))
    _, rows, n = _norm_args("add_rms_norm_bwd", hp, scale, "add")
    for name, t in (("dy", dy), ("dres", dres)):
        if t.shape != hp.shape or t.dtype != hp.dtype:
            raise ValueError(f"add_rms_norm_bwd: {name} {tuple(t.shape)} "
                             f"{t.dtype}, h' {tuple(hp.shape)} {hp.dtype}")
    dbias = None
    if bias_dtype is not None:
        dbias = torch.empty(n, dtype=bias_dtype, device=hp.device)
        _bias_arg("add_rms_norm_bwd", dbias, hp, n)
    hp, scale = hp.contiguous(), scale.contiguous()
    dy, dres = dy.contiguous(), dres.contiguous()
    dh = torch.empty_like(hp)
    if rows == 0:
        return dh, torch.zeros_like(scale), (
            None if dbias is None else dbias.zero_())
    dscale = torch.empty_like(scale)
    route = backward_route("add", hp, scale, (dh, dy, dres),
                           force_regs=_forced(defines))
    parts = 1 if dbias is None else 2
    partials = torch.empty(plan(rows, n, False)["chunks"] * n * parts,
                           dtype=torch.float32, device=hp.device)
    err = _launch(hp.device, _lib(defines).add_rms_norm_bwd, dh.data_ptr(),
                  dscale.data_ptr(),
                  None if dbias is None else dbias.data_ptr(),
                  partials.data_ptr(), partials.numel(), hp.data_ptr(),
                  dy.data_ptr(), dres.data_ptr(), scale.data_ptr(), rows, n,
                  _BF16[hp.dtype], _BF16[scale.dtype],
                  0 if dbias is None else _BF16[dbias.dtype], eps)
    if err != 0:
        raise RuntimeError(f"add_rms_norm_bwd launch failed on {route}: "
                           f"CUDA error {err}")
    _count(rms_norm_bwd, route)
    return dh, dscale, dbias


def _rows_of(z: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """z (..., n) as rows (rows, n) and their stride: a view where z's
    strides allow one (the SSM's z, a slice of the input projection), else
    a contiguous copy."""
    rows = z.reshape(-1, n)
    if rows.stride(1) != 1 or rows.stride(0) < n:
        rows = rows.contiguous()
    return rows, rows.stride(0)


def gated_rms_norm_fwd(y: torch.Tensor, z: torch.Tensor,
                       scale: torch.Tensor, eps: float = 1e-6
                       ) -> torch.Tensor:
    """``rms_norm_fwd(y * silu(z), scale, eps)`` in one launch: y and z of
    one shape and dtype (f32 or bf16; z read by its row stride), silu(z)
    and the product rounded to it as the plain ops round them."""
    _check_cuda("gated_rms_norm_fwd", (y, z, scale))
    route, rows, n = _norm_args("gated_rms_norm_fwd", y, scale, "gate")
    if z.shape != y.shape or z.dtype != y.dtype:
        raise ValueError(f"gated_rms_norm_fwd: z {tuple(z.shape)} {z.dtype}"
                         f", y {tuple(y.shape)} {y.dtype}")
    y, scale = y.contiguous(), scale.contiguous()
    out = torch.empty_like(y)
    if rows == 0:
        return out
    z2, z_stride = _rows_of(z, n)
    err = _launch(y.device, _lib().gated_rms_norm_fwd, out.data_ptr(),
                  y.data_ptr(), z2.data_ptr(), z_stride, scale.data_ptr(),
                  rows, n, _BF16[y.dtype], _BF16[scale.dtype], eps)
    if err != 0:
        raise RuntimeError(f"gated_rms_norm_fwd launch failed on {route}: "
                           f"CUDA error {err}")
    _count(rms_norm_fwd, route)
    return out


def gated_rms_norm_bwd(y: torch.Tensor, z: torch.Tensor,
                       scale: torch.Tensor, dy: torch.Tensor,
                       eps: float = 1e-6, defines: Tuple[str, ...] = ()):
    """(y's grad, z's grad, dscale) of ``gated_rms_norm_fwd`` given its
    grad dy (y's shape and dtype), as ``gated_rms_norm_bwd_plain`` computes
    them, in two launches (on ``backward_route``'s route); z's grad
    contiguous; ``defines`` as ``rms_norm_bwd``'s."""
    _check_cuda("gated_rms_norm_bwd", (y, z, scale, dy))
    _, rows, n = _norm_args("gated_rms_norm_bwd", y, scale, "gate")
    for name, t in (("z", z), ("dy", dy)):
        if t.shape != y.shape or t.dtype != y.dtype:
            raise ValueError(f"gated_rms_norm_bwd: {name} {tuple(t.shape)} "
                             f"{t.dtype}, y {tuple(y.shape)} {y.dtype}")
    y, scale, dy = y.contiguous(), scale.contiguous(), dy.contiguous()
    dy_out = torch.empty_like(y)
    dz = torch.empty_like(y)
    if rows == 0:
        return dy_out, dz, torch.zeros_like(scale)
    z2, z_stride = _rows_of(z, n)
    dscale = torch.empty_like(scale)
    route = backward_route("gate", y, scale, (dy_out, dz, z2, dy),
                           z_stride * z2.element_size(),
                           force_regs=_forced(defines))
    partials = torch.empty(plan(rows, n, False)["chunks"] * n,
                           dtype=torch.float32, device=y.device)
    err = _launch(y.device, _lib(defines).gated_rms_norm_bwd,
                  dy_out.data_ptr(),
                  dz.data_ptr(), dscale.data_ptr(), partials.data_ptr(),
                  partials.numel(), y.data_ptr(), z2.data_ptr(), z_stride,
                  dy.data_ptr(), scale.data_ptr(), rows, n, _BF16[y.dtype],
                  _BF16[scale.dtype], eps)
    if err != 0:
        raise RuntimeError(f"gated_rms_norm_bwd launch failed on {route}: "
                           f"CUDA error {err}")
    _count(rms_norm_bwd, route)
    return dy_out, dz, dscale


def rope(xs: Sequence[torch.Tensor], positions: torch.Tensor,
         freqs: torch.Tensor, *, backward: bool = False,
         biases: Optional[Sequence[torch.Tensor]] = None
         ) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` (one or two tensors (..., S, heads, hd) of one
    dtype, f32 or bf16, whose leading dims agree: q and k) rotated by the
    angles ``positions * freqs`` (by -angle with ``backward``), as
    ``models.common.apply_rope_plain`` rotates them: one launch for all of
    them.  ``positions``: integers broadcastable to (..., S); ``freqs``:
    ``models.common.rope_freqs(hd, theta)`` on the device.  ``biases``
    (one (heads, hd) a tensor, of its dtype): the forward rotates
    round(x + b); the backward returns each rotated grad and then each
    bias's grad (the rows summed in a fixed order; a second launch)."""
    xs = list(xs)
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"rope rotates one or two tensors, got {len(xs)}")
    _check_cuda("rope", (*xs, positions, freqs))
    lead, hd = xs[0].shape[:-2], xs[0].shape[-1]
    route = rope_route(xs[0].dtype, backward, biases is not None)
    for t in xs:
        if t.dim() < 3 or t.shape[:-2] != lead or t.shape[-1] != hd \
                or t.dtype != xs[0].dtype:
            raise ValueError(f"rope: tensors {[tuple(u.shape) for u in xs]}"
                             f" {[u.dtype for u in xs]} do not agree")
    if biases is not None:
        biases = list(biases)
        if len(biases) != len(xs) or any(
                b.shape != t.shape[-2:] or b.dtype != t.dtype
                for b, t in zip(biases, xs)):
            raise ValueError(
                f"rope: biases {[tuple(b.shape) for b in biases]} "
                f"{[b.dtype for b in biases]} for tensors "
                f"{[tuple(t.shape) for t in xs]} {xs[0].dtype} (one (heads, "
                f"head_dim) a tensor, of its dtype)")
        _check_cuda("rope", (*xs, *biases))
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
    grads = ()
    if biases is not None and backward:
        widths = [t.shape[-2] * hd for t in xs]
        dbias = torch.empty(sum(widths), dtype=xs[0].dtype,
                            device=xs[0].device)
        grads = tuple(g.view(t.shape[-2], hd) for g, t in
                      zip(dbias.split(widths), xs))
    if rows == 0:
        return outs + tuple(g.zero_() for g in grads)
    k, k_out, hk = ((xs[1].data_ptr(), outs[1].data_ptr(), xs[1].shape[-2])
                    if len(xs) == 2 else (None, None, 0))
    freqs = freqs.contiguous()
    common = (xs[0].shape[-2], k_out, k, hk, rows, seq, hd, pos.data_ptr(),
              pos.stride(0), pos.stride(1), freqs.data_ptr(),
              _BF16[xs[0].dtype], int(backward))
    if biases is None:
        err = _launch(freqs.device, _lib().rope, outs[0].data_ptr(),
                      xs[0].data_ptr(), *common)
    elif not backward:
        b = [t.contiguous().data_ptr() for t in biases]
        err = _launch(freqs.device, _lib().rope_bias, outs[0].data_ptr(),
                      xs[0].data_ptr(), b[0], xs[0].shape[-2], k_out, k,
                      b[1] if len(b) == 2 else None, *common[3:], None, None,
                      0)
    else:
        vec = (hd // 2) % PAIRS == 0 and all(
            t.data_ptr() % 16 == 0 for t in (*xs, *outs))
        partials = torch.empty(
            rope_bias_blocks(rows, hd, vec) * dbias.numel(),
            dtype=torch.float32, device=xs[0].device)
        err = _launch(freqs.device, _lib().rope_bias, outs[0].data_ptr(),
                      xs[0].data_ptr(), None, xs[0].shape[-2], k_out, k,
                      None, *common[3:], dbias.data_ptr(),
                      partials.data_ptr(), partials.numel())
    if err != 0:
        raise RuntimeError(f"rope launch failed on {route}: CUDA error "
                           f"{err}")
    _count(rope, route)
    return outs + grads


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


class AddRMSNorm(torch.autograd.Function):
    """``(h', rms_norm(h', scale, eps))`` with h' = h + (a + bias) on CUDA
    tensors: one forward launch, the backward's two (dh; dscale and the
    bias's grad).  Saves h' and the scale only; dh is the grad of h and of
    a both."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, a: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor], eps: float):
        hp, out = add_rms_norm_fwd(h, a, scale, bias, eps)
        ctx.save_for_backward(hp, scale)
        ctx.eps = eps
        ctx.bias_dtype = None if bias is None else bias.dtype
        return hp, out

    @staticmethod
    def backward(ctx, dhp: torch.Tensor, dy: torch.Tensor):
        hp, scale = ctx.saved_tensors
        dh, dscale, dbias = add_rms_norm_bwd(
            hp, scale, dy.to(hp.dtype), dhp.to(hp.dtype), ctx.bias_dtype,
            ctx.eps)
        return dh, dh, dscale, dbias, None


class GatedRMSNorm(torch.autograd.Function):
    """``rms_norm(y * silu(z), scale, eps)`` on CUDA tensors: one forward
    launch, the backward's two (y's and z's grads; dscale).  Saves y, z
    and the scale only."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
        ctx.save_for_backward(y, z, scale)
        ctx.eps = eps
        return gated_rms_norm_fwd(y, z, scale, eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        y, z, scale = ctx.saved_tensors
        dy_, dz, dscale = gated_rms_norm_bwd(y, z, scale, dy.to(y.dtype),
                                             ctx.eps)
        return dy_, dz, dscale, None


class RopeBias(torch.autograd.Function):
    """``rope`` of q + bq and k + bk on CUDA tensors: one launch forward;
    one backward rotating the grads by -angle and the biases' grads summed
    by the dscale kernel."""

    @staticmethod
    def forward(ctx, positions: torch.Tensor, freqs: torch.Tensor,
                bq: torch.Tensor, bk: torch.Tensor, q: torch.Tensor,
                k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ctx.save_for_backward(positions, freqs, bq, bk)
        return rope((q, k), positions, freqs, biases=(bq, bk))

    @staticmethod
    def backward(ctx, dq: torch.Tensor, dk: torch.Tensor):
        positions, freqs, bq, bk = ctx.saved_tensors
        gq, gk, dbq, dbk = rope((dq, dk), positions, freqs, backward=True,
                                biases=(bq, bk))
        return None, None, dbq, dbk, gq, gk


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
rms_norm_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)
rope.launches = 0
rope.launches_by_route = dict.fromkeys(ROPE_ROUTES, 0)
