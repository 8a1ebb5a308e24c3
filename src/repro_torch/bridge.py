"""Weight bridge: a parameter tree (or a train state) of numpy arrays ->
the port's tensors.

The JAX package and the port keep the same nested dict (same keys, same
shapes, layers stacked on axis 0), so bridging is a tree-map.  The caller
turns the JAX tree into numpy (``jax.tree.map(np.asarray, params)``); this
module never imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .optim import AdamWState
from .train import TrainState


def _tensor(a: Any, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Any, device: Any,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of arrays -> same dict of tensors on ``device``
    (cast to ``dtype`` when given)."""
    dev = torch.device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return _tensor(tree, dev, dtype)


def train_state_from_numpy(state: Any, device: Any) -> Any:
    """A JAX ``TrainState`` whose leaves are numpy arrays (``jax.tree.map(
    np.asarray, state)``) -> the port's ``TrainState`` on ``device``:
    params, the AdamW step, m and v, and the residual when present."""
    dev = torch.device(device)
    residual = (None if state.residual is None
                else params_from_numpy(state.residual, dev))
    opt = AdamWState(step=_tensor(state.opt.step, dev, None),
                     m=params_from_numpy(state.opt.m, dev),
                     v=params_from_numpy(state.opt.v, dev))
    return TrainState(params_from_numpy(state.params, dev), opt, residual)
