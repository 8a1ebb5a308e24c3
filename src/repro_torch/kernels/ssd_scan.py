"""Mamba2 SSD chunk scan from a zero state, for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``
(``ssd_scan_bhsd``, body ``_ssd_kernel``).  The kernel is CUDA C++ written
by hand for sm_90a (``repro_torch/csrc/ssd_scan.cu``), built by ``nvcc``
into a plain-C shared library and called through ctypes.

What bounds it: at the mamba2-1.3b serve shape (B=4, H=64, S=512, P=64,
N=128, G=1, chunk 256, bf16) the function must read x, dt, B, C and write
y and the state once, about 39 MB (11.7 us at 3.35 TB/s), against about
6.5 GFLOP once C B^T is formed once per (batch, group, chunk) rather than
per head (about 10 us at mma.sync rates): the memory traffic bounds it.
What the design does about it: the state never leaves the SM, the Q x Q
scores never reach device memory, B and C are read by group index and
never repeated per head, and every product runs on the tensor cores.

Routes, chosen by dtype alone (``route``):
- bf16 -> ``mma_bf16``: one call launches two kernels.  The first forms
  the lower-triangular 64 x 64 tiles of C B^T once per (batch, group,
  chunk) into an f32 scratch that this wrapper allocates (shared by every
  head of the group; 1.3 MB at the mamba2 shape).  The second runs one
  block per (batch, head) and 64 columns of P: the f32 state in registers,
  x and B tiles through a 2-stage cp.async ring.  The three f32 operands
  of its products (the state, the weighted score tile, x o w) enter as
  hi + lo bf16 pairs, two mmas each (one bf16 rounding would miss the
  2e-2 tolerance where y is near 0): about 12 GFLOP of mma work at the
  mamba2 shape.  Needs P and N multiples of 8.
- f32 -> ``scalar_f32``: scalar f32 FMAs, one block per (batch, head,
  32 columns of P); the tests and the f32 checks use it.

Layout: (batch, heads, seq, ...).  ``ssd_scan_bhsd`` launches the kernel
for CUDA tensors and raises on what the kernel does not take; only CPU
tensors take the plain version.
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
ROUTES = {torch.bfloat16: "mma_bf16", torch.float32: "scalar_f32"}
MAX_STATE = 256          # N: the state per block lives on the SM
MAX_CHUNK = 1024         # chunk: per-row f32 values in shared memory
TILE = 64                # rows of a C B^T scratch tile


def route(dtype: torch.dtype) -> str:
    """The kernel instance a CUDA call of this dtype launches."""
    if dtype not in ROUTES:
        raise ValueError(f"dtype {dtype} not supported (float32, bfloat16)")
    return ROUTES[dtype]


def scratch_numel(B: int, G: int, S: int, chunk: int) -> int:
    """f32 values of the bf16 route's C B^T scratch: the lower-triangular
    64 x 64 tiles of every (batch, group, chunk)."""
    nt = -(-chunk // TILE)
    return B * G * (S // chunk) * nt * (nt + 1) // 2 * TILE * TILE


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
    return lib


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
    if route(x.dtype) == "mma_bf16" and (P % 8 or N % 8):
        raise ValueError(f"bf16 route needs P and N multiples of 8, got "
                         f"P={P}, N={N}")
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

    CUDA tensors launch the hand-written kernel on the dtype's route (the
    bf16 route is two kernels, C B^T then the scan) and count the call once
    in ``ssd_scan_bhsd.launches`` and ``.launches_by_route``; CPU tensors
    take the plain version.  dt and a are cast to f32 first, as the JAX
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
    kind = route(x.dtype)
    y, state = launch(_lib(), x, dt, a, b, c, chunk)
    with _COUNT_LOCK:
        ssd_scan_bhsd.launches += 1
        ssd_scan_bhsd.launches_by_route[kind] += 1
    return y, state


def launch(lib: ctypes.CDLL, x: torch.Tensor, dt: torch.Tensor,
           a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of ``lib``'s kernels on checked CUDA tensors: allocates y,
    the state and (bf16) the C B^T scratch."""
    B, H, S, P = x.shape
    G, N = b.shape[1], b.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=x.dtype, device=x.device)
    scratch = (torch.empty(scratch_numel(B, G, S, chunk), dtype=torch.float32,
                           device=x.device)
               if route(x.dtype) == "mma_bf16" else None)
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
ssd_scan_bhsd.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
