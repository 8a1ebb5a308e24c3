"""AdamW + global-norm clipping, PyTorch counterpart of
``repro/optim/adamw.py``.

Plain functions over the nested dict of tensors: ``adamw_update`` returns
new tensors, as the JAX function does.  ``adamw_update_`` (trailing
underscore) is the donating form, the port's counterpart of jitting the
update with ``donate_argnums``: it writes the new params, m, v and step
into the given tensors.  Both take the clip factor as ``scale`` for grads
that come unclipped, so no f32 copy of the grads is made.

Each function chooses its path by the tensors' device
(``kernels.optimizer.takes_kernel``).  CUDA tensors launch the hand-written
kernels of ``kernels/optimizer.py``, the counterpart of what XLA fuses
under the reference's ``jax.jit``: ``adamw_update`` once a leaf (no
temporary, so no slicing), ``global_norm`` ``sumsq`` once over every grad
of the step.  CPU and
meta tensors, DTensors among them (the dry-run traces the donating step on
meta DTensors), take the plain versions here: ``_update_slice`` on every
element, and the donating form goes leaf by leaf along axis 0 (the stacked
layer axis) in slices of at most ``SLICE_ELEMS`` elements, so its f32
temporaries stay near one layer slice.  A DTensor on CUDA and any other
device raise; a failed
launch raises, and nothing falls back.  The kernel repeats
``_update_slice``'s f32 ops in its order, so both paths give the same bits.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import torch

from ..kernels import optimizer as K
from ..tree import leaves, tree_map, tree_map_n

# 2^26 elements: one layer slice of codeqwen1.5-7b's MLP (4096 x 13440 =
# 55 M) fits in one, and a 256 MB f32 temporary beside an 80 GB state
SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any                  # f32 tree like the params
    v: Any


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return AdamWState(step=step, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def slices(t: torch.Tensor, *like: torch.Tensor) -> Iterator[Any]:
    """Views of ``t`` along axis 0 of at most ``SLICE_ELEMS`` elements each
    (one view of the whole tensor when it is 0-d or small).  With tensors
    ``like`` of ``t``'s shape, tuples of the same views of each.  A DTensor
    sharded on axis 0 (in ``t`` or ``like``) is not sliced: a slice across
    shards would gather it on every rank."""
    ts = (t, *like)
    if (t.dim() == 0 or t.numel() <= SLICE_ELEMS
            or any(_shards_axis0(x) for x in ts)):
        yield ts if like else t
        return
    rows = max(1, SLICE_ELEMS // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield (tuple(x[i:i + rows] for x in ts) if like
               else t[i:i + rows])


def _shards_axis0(t: torch.Tensor) -> bool:
    return any(p.is_shard(0) for p in getattr(t, "placements", ()))


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every grad element squared, in f32: on CUDA the
    ``sumsq`` kernel (each grad read once in its own dtype, a fixed order
    of sums); else summed slice by slice (no f32 copy of a whole leaf)."""
    gs = leaves(grads)
    if K.takes_kernel(gs):
        return torch.sqrt(K.sumsq(gs))
    total = None
    for g in gs:
        for s in slices(g):
            part = s.float().square().sum()
            total = part if total is None else total + part
    return torch.sqrt(total)


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads x min(1, max_norm / max(gn, 1e-9)), gn).  The clipped grads
    are f32, as JAX promotes a bf16 grad times the f32 scale."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _bias_corrections(step: torch.Tensor, b1: float, b2: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    s = step.to(torch.float32)
    return 1.0 - torch.pow(b1, s), 1.0 - torch.pow(b2, s)


def _update_slice(p, g, m, v, c1, c2, lr, b1, b2, eps, weight_decay,
                  scale: Optional[torch.Tensor] = None):
    """New (p, m, v) of one slice, in the reference's order of f32 ops;
    ``scale`` is the clip factor when the grads come unclipped."""
    g = g.float()
    if scale is not None:
        g = g * scale
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * torch.square(g)
    mh = m2 / c1
    vh = v2 / c2
    delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
    p2 = p.float() - lr * delta
    return p2.to(p.dtype), m2, v2


def _on_card(params: Any, grads: Any, state: AdamWState) -> bool:
    """Whether the update launches the kernel (CUDA leaves)."""
    trees = (params, grads, state.m, state.v)
    return K.takes_kernel(t for tree in trees for t in leaves(tree))


def adamw_update(params: Any, grads: Any, state: AdamWState, *,
                 lr: Any, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 scale: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step; returns (new params, new state) and leaves the
    arguments as they were.  ``scale`` is the clip factor for grads that
    come unclipped."""
    step = state.step + 1
    c1, c2 = _bias_corrections(step, b1, b2)
    update = (partial(K.adamw_update, inplace=False)
              if _on_card(params, grads, state) else _update_slice)
    new_p, m, v = tree_map_n(lambda p, g, m, v: update(
        p, g, m, v, c1, c2, lr, b1, b2, eps, weight_decay, scale),
        3, params, grads, state.m, state.v)
    return new_p, AdamWState(step=step, m=m, v=v)


def adamw_update_(params: Any, grads: Any, state: AdamWState, *,
                  lr: Any, b1: float = 0.9, b2: float = 0.95,
                  eps: float = 1e-8, weight_decay: float = 0.1,
                  scale: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, AdamWState]:
    """The donating form of ``adamw_update``: writes the new params, m and
    v into ``params``, ``state.m`` and ``state.v`` (on CUDA one launch a
    leaf, else slice by slice), advances ``state.step`` in place, and
    returns them.  Every tensor of the state keeps its storage, so a CUDA
    graph that captured the update reads the step it has reached on each
    replay.  ``scale`` applies the clip factor, for grads that come
    unclipped (``clip_by_global_norm`` would make an f32 copy of every
    grad)."""
    step = state.step.add_(1)
    c1, c2 = _bias_corrections(step, b1, b2)
    on_card = _on_card(params, grads, state)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        if on_card:
            K.adamw_update(p, g, m, v, c1, c2, lr, b1, b2, eps,
                           weight_decay, scale, inplace=True)
            continue
        for ps, gs, ms, vs in slices(p, g, m, v):
            p2, m2, v2 = _update_slice(ps, gs, ms, vs, c1, c2, lr, b1, b2,
                                       eps, weight_decay, scale)
            ps.copy_(p2)
            ms.copy_(m2)
            vs.copy_(v2)
    return params, state
