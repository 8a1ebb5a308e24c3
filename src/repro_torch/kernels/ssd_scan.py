"""Mamba2 SSD chunk scan from a zero state, for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``
(``ssd_scan_bhsd``, body ``_ssd_kernel``).  The kernels are CUDA C++
written by hand for sm_90a (``repro_torch/csrc/ssd_scan.cu`` +
``hopper.cuh``), built by ``nvcc`` into a plain-C shared library and
called through ctypes.

What bounds it: at the mamba2-1.3b serve shape (B=4, H=64, S=512, P=64,
N=128, G=1, chunk 256, bf16) the function must read x, dt, B, C and write
y and the state once, about 39 MB (11.7 us at 3.35 TB/s): the memory
traffic bounds the function.  The kernels' own products are about 8.6
GFLOP, and the hi + lo splits that the 2e-2 tolerance needs take them to
about 14.5 GFLOP of wgmma work (14.7 us at 989 TFLOP/s), the floor of
this design.  The old route walked each (batch, head)'s chunks in one
block, 256 or 320 blocks in 264 slots, so the state's serial chain set its
time (9-11% of the bound).

Routes, fixed by (dtype, P, N) before the launch (``route``):
- bf16, P = 64, N = 64 or 128 (the serve paths) -> ``wgmma_bf16``: two
  kernels, TMA loads into mbarrier rings, one producer warp, wgmma
  consumer warpgroups.  ``ssd_wg_state_kernel`` (one block per (batch,
  head)) carries the f32 state over the chunks, S = exp(cum_Q) S +
  (B o w)^T x, and writes the state entering each later chunk as hi and
  lo bf16 tiles, and each row's decay exponents, into a scratch this
  wrapper allocates (8.4 + 1 MB at the mamba2 shape), and the final
  state.
  ``ssd_wg_y_kernel`` makes every (64-row query tile, chunk, batch, two
  heads) an independent work item: exp(cum) o (C S_c) plus the causal
  intra-chunk tiles, C B^T formed on the tensor cores beside its use
  once for the item's heads.  x, B and C stay bf16; the weighted score
  tile and (B o w)^T enter as hi + lo register A fragments, the state as a
  hi and a lo shared tile.
- other bf16 (P and N multiples of 8) -> ``mma_bf16``: the older route,
  two kernels on mma.sync (C B^T once per (batch, group, chunk) into an f32
  scratch this wrapper allocates, then one block per (batch, head) walking
  the chunks).  Built alone with ``-DSSD_FORCE_MMA`` it takes every bf16
  shape, for timing the old route.
- f32 -> ``scalar_f32``: scalar f32 FMAs, one block per (batch, head, 32
  columns of P); the tests and the f32 checks use it.

Layout: (batch, heads, seq, ...).  ``ssd_scan_bhsd`` launches the kernels
for CUDA tensors and raises on what they do not take; nothing falls back
to another route, and only CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import _build
from .flash_attention import refuse_grad

_COUNT_LOCK = threading.Lock()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma_bf16", "mma_bf16", "scalar_f32")
# the device kernels, in the library's order (ssd_scan_launches), and the
# kernels one call of each route launches, once each
KERNELS = ("ssd_cbt_kernel", "ssd_mma_kernel", "ssd_wg_state_kernel",
           "ssd_wg_y_kernel", "ssd_f32_kernel")
ROUTE_KERNELS = {"wgmma_bf16": ("ssd_wg_state_kernel", "ssd_wg_y_kernel"),
                 "mma_bf16": ("ssd_cbt_kernel", "ssd_mma_kernel"),
                 "scalar_f32": ("ssd_f32_kernel",)}
WGMMA_P = 64             # P the wgmma route takes
WGMMA_N = (64, 128)      # N it takes
MAX_STATE = 256          # N: the state per block lives on the SM
MAX_CHUNK = 1024         # chunk: per-row f32 values in shared memory
TILE = 64                # rows of a C B^T scratch tile


def route(dtype: torch.dtype, P: int, N: int) -> str:
    """The kernels a CUDA call of this dtype, head dim P and state size N
    launches."""
    if dtype == torch.float32:
        return "scalar_f32"
    if dtype == torch.bfloat16:
        return ("wgmma_bf16" if P == WGMMA_P and N in WGMMA_N
                else "mma_bf16")
    raise ValueError(f"dtype {dtype} not supported (float32, bfloat16)")


def route_kernels(calls: dict) -> dict:
    """The device kernels that ``calls`` ({route: calls}) launch, by
    kernel, routes with no call left out."""
    out: dict = {}
    for r, n in calls.items():
        for k in ROUTE_KERNELS[r] if n else ():
            out[k] = out.get(k, 0) + n
    return out


def scratch_numel(B: int, G: int, S: int, chunk: int) -> int:
    """f32 values of the bf16 route's C B^T scratch: the lower-triangular
    64 x 64 tiles of every (batch, group, chunk)."""
    nt = -(-chunk // TILE)
    return B * G * (S // chunk) * nt * (nt + 1) // 2 * TILE * TILE


def state_scratch_bytes(B: int, H: int, S: int, P: int, N: int,
                        chunk: int) -> int:
    """Bytes of the wgmma route's scratch: the state entering each chunk
    but the first as a hi and a lo bf16 (N, P) tile, then two f32 values a
    row (its exponent as a query and as a key), which the state kernel
    computes and the y kernel reads."""
    return 2 * 2 * B * H * (S // chunk - 1) * N * P + 2 * 4 * B * H * S


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: ``_ssd_kernel`` chunk by chunk
    in f32.  x: (B,H,S,P); dt: (B,H,S); a: (H,); b/c: (B,G,S,N) with head h
    reading group h // (H/G).  Returns y (B,H,S,P) and the final state
    (B,H,N,P), both in x's dtype."""
    B, H, S, P = x.shape
    rep = H // b.shape[1]
    xf, dtf = x.float(), dt.float()
    af = a.float()[None, :, None]
    bf = b.float().repeat_interleave(rep, dim=1)
    cf = c.float().repeat_interleave(rep, dim=1)
    state = torch.zeros((B, H, b.shape[-1], P), dtype=torch.float32,
                        device=x.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xq, dtq = xf[:, :, sl], dtf[:, :, sl]
        bq, cq = bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(dtq * af, dim=-1)                      # (B,H,Q)
        # select, never multiply: exp(cum_i - cum_j) overflows for i < j
        L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
        att = torch.einsum("bhin,bhjn->bhij", cq, bq) * L * dtq[..., None, :]
        y = torch.einsum("bhij,bhjp->bhip", att, xq)
        y = y + torch.einsum("bhin,bhnp->bhip",
                             cq * torch.exp(cum)[..., None], state)
        decay_end = torch.exp(cum[..., -1:] - cum)                # (B,H,Q)
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + torch.einsum("bhjn,bhjp->bhnp", bq,
                                xq * (dtq * decay_end)[..., None]))
        ys.append(y)
    return torch.cat(ys, dim=2).to(x.dtype), state.to(x.dtype)


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("ssd_scan", defines)
    fn = lib.ssd_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_launches.argtypes = [i]
        lib.ssd_scan_launches.restype = ctypes.c_ulonglong
        lib.ssd_scan_scratch_floats.restype = ctypes.c_longlong
        lib.ssd_scan_state_scratch_bytes.restype = ctypes.c_longlong
    return lib


def kernel_launches(lib: ctypes.CDLL) -> dict:
    """Launches by device kernel that ``lib``'s kernels have counted on the
    device since the library was loaded (a CUDA graph's replays included),
    so the kernels its dispatch chose can be held to ``route``.  A
    synchronous copy from the device: never call it during a capture."""
    out = {}
    for i, k in enumerate(KERNELS):
        n = int(lib.ssd_scan_launches(i))
        if n == 2 ** 64 - 1:
            raise RuntimeError("ssd_scan_launches: the copy from the device "
                               "failed")
        out[k] = n
    return out


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, chunk: int,
           kernel: bool = True) -> None:
    """Raise ValueError on shapes the function does not take and, with
    ``kernel``, on what the CUDA kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 \
            or c.dim() != 4:
        raise ValueError("ranks: x (B,H,S,P), dt (B,H,S), a (H,), "
                         "b/c (B,G,S,N)")
    B, H, S, P = x.shape
    G, N = b.shape[1], b.shape[3]
    if tuple(dt.shape) != (B, H, S) or tuple(a.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if b.shape != c.shape or b.shape[0] != B or b.shape[2] != S:
        raise ValueError(f"b/c shapes {tuple(b.shape)}, {tuple(c.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if min(B, H, S, P, G, N) == 0:
        raise ValueError("empty SSD input")
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    if not kernel:
        return
    if chunk > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK} or N {N} > "
                         f"{MAX_STATE}")
    kind = route(x.dtype, P, N)
    if kind == "mma_bf16" and (P % 8 or N % 8):
        raise ValueError(f"bf16 route needs P and N multiples of 8, got "
                         f"P={P}, N={N}")
    if kind == "wgmma_bf16" and chunk % 4:
        raise ValueError(f"wgmma_bf16 route needs a chunk that is a multiple "
                         f"of 4 (16-byte rows of cum and dt), got {chunk}")
    for name, t, dtype in (("dt", dt, torch.float32), ("a", a, torch.float32),
                           ("b", b, x.dtype), ("c", c, x.dtype)):
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def ssd_scan_bhsd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,H,S,P); dt: (B,H,S); a: (H,); b/c: (B,G,S,N), G dividing H
    (the JAX signature's groups pre-broadcast to heads is G = H).
    Returns (y: (B,H,S,P), state: (B,H,N,P)) in x's dtype.

    CUDA tensors launch the hand-written kernels of the route of the
    dtype, P and N (``route``; each bf16 route is two kernels) and count
    the call once in ``ssd_scan_bhsd.launches`` and
    ``.launches_by_route``; a refused or failed launch raises, and nothing
    falls back.  CPU tensors take the plain version.  dt and a are cast to f32 first, as the JAX
    wrapper does.  Raises RuntimeError, on every device, for inputs that
    require grad while grad mode is on: the kernel has no backward."""
    refuse_grad("ssd_scan_bhsd", x, dt, a, b, c)
    dt, a = dt.float(), a.float()
    if all(t.device.type == "cpu" for t in (x, dt, a, b, c)):
        _check(x, dt, a, b, c, chunk, kernel=False)
        return ssd_scan_plain(x, dt, a, b, c, chunk)
    chunk = int(chunk)
    _check(x, dt, a, b, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    kind = route(x.dtype, x.shape[3], b.shape[3])
    y, state = launch(_lib(), x, dt, a, b, c, chunk, kind)
    with _COUNT_LOCK:
        ssd_scan_bhsd.launches += 1
        ssd_scan_bhsd.launches_by_route[kind] += 1
    return y, state


def launch(lib: ctypes.CDLL, x: torch.Tensor, dt: torch.Tensor,
           a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int,
           kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of ``lib``'s kernels on checked CUDA tensors: allocates y,
    the state and the scratch of route ``kind`` (the route ``lib`` takes
    for this shape: ``route``'s, or ``mma_bf16`` for a bf16 build with
    ``-DSSD_FORCE_MMA``)."""
    B, H, S, P = x.shape
    G, N = b.shape[1], b.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=x.dtype, device=x.device)
    scratch = None
    if kind == "mma_bf16":
        scratch = torch.empty(scratch_numel(B, G, S, chunk),
                              dtype=torch.float32, device=x.device)
    elif kind == "wgmma_bf16":
        scratch = torch.empty(state_scratch_bytes(B, H, S, P, N, chunk),
                              dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                           b.data_ptr(), c.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           y.data_ptr(), state.data_ptr(), B, H, G, S, P, N,
                           chunk, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    return y, state


ssd_scan_bhsd.launches = 0
ssd_scan_bhsd.launches_by_route = dict.fromkeys(ROUTES, 0)
