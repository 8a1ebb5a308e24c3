"""Activation-sharding context: profile-driven constraints inside models.

PyTorch counterpart of ``repro/sharding/ctx.py``.  The model code stays
profile-agnostic; it calls ``constrain(x, role)`` at a few points (the
residual stream after each layer, the MoE dispatch buffers).  The active
``ShardProfile`` decides what spec (if any) each role gets, and
``constrain`` redistributes a DTensor to it, the counterpart of
``jax.lax.with_sharding_constraint``.  Profiles:

  baseline   - no explicit constraints (sharding propagation only)
  dp_all     - batch sharded over (data x model): pure 256-way DP inside the
               fixed mesh; params replicated, optimizer ZeRO-sharded.
  sp         - sequence parallelism: the residual stream's seq dim lives on
               the model axis between blocks.
  ep         - expert parallelism on a derived (data, expert, tp) view of
               the same 256 ranks; MoE dispatch becomes an all-to-all.

Outside a profile, and for a plain tensor, ``constrain`` returns its input
unchanged, so serving and training run exactly as without the hooks.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from .rules import P, abstract_mesh, to_placements


@dataclass(frozen=True)
class ShardProfile:
    name: str = "baseline"
    mesh: Any = None                  # a DeviceMesh
    # axis-name groups (derived meshes rename these)
    data_axes: Tuple[str, ...] = ("data",)
    tp_axes: Tuple[str, ...] = ("model",)
    expert_axis: Optional[str] = None


_local = threading.local()


def current() -> Optional[ShardProfile]:
    return getattr(_local, "profile", None)


@contextlib.contextmanager
def use_profile(profile: Optional[ShardProfile]):
    prev = getattr(_local, "profile", None)
    _local.profile = profile
    try:
        yield
    finally:
        _local.profile = prev


def _axis_size(shape, names: Tuple[str, ...]) -> int:
    n = 1
    for a in names:
        n *= shape[a]
    return n


def role_spec(prof: ShardProfile, shape: Tuple[int, ...],
              role: str) -> Optional[P]:
    """The spec ``prof`` gives a tensor of ``shape`` in ``role``, or None."""
    sizes = abstract_mesh(prof.mesh).shape
    da, tp = prof.data_axes, prof.tp_axes
    dm = tuple(da) + tuple(tp)
    ndim = len(shape)
    spec: Optional[P] = None
    if prof.name == "dp_all":
        if role in ("residual", "logits") and ndim >= 2:
            if shape[0] % _axis_size(sizes, dm) == 0:
                spec = P(dm, *([None] * (ndim - 1)))
        elif role == "moe_buffer" and ndim == 4:
            # pin the dispatch buffer's group axis
            if shape[0] % _axis_size(sizes, dm) == 0:
                spec = P(dm, None, None, None)
    elif prof.name == "sp":
        if role == "residual" and ndim == 3:
            b, s, _ = shape
            bs = da if b % _axis_size(sizes, da) == 0 else None
            if s % _axis_size(sizes, tp) == 0:
                spec = P(bs, tp, None)
    elif prof.name == "ep":
        e_ax = prof.expert_axis
        if role == "moe_buffer" and ndim == 4 and e_ax:
            g, e, c, d = shape
            gs = da if g % _axis_size(sizes, da) == 0 else None
            es = e_ax if e % sizes[e_ax] == 0 else None
            spec = P(gs, es, None, None)
        if role == "residual" and ndim == 3:
            if shape[0] % _axis_size(sizes, da) == 0:
                spec = P(da, None, None)
    return spec


def constrain(x: torch.Tensor, role: str) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the active profile's spec for
    ``role``; ``x`` itself outside a profile, for a plain tensor, or where
    the profile gives the role no spec."""
    prof = current()
    if prof is None or prof.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = role_spec(prof, tuple(x.shape), role)
    if spec is None:
        return x
    return x.redistribute(prof.mesh, to_placements(spec, prof.mesh))

