"""Roofline terms of a traced step, and the counters that measure it.

PyTorch counterpart of ``repro/roofline/analyze.py``:

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = bytes accessed / (chips * HBM_bw)
    collective term = collective bytes / (chips * link_bw)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and parses
collective bytes out of the partitioned HLO text.  The port traces the step
on DTensors and counts as it goes:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``.  Entered innermost
  (on top of the mode stack), it sees each op with DTensor arguments before
  DTensor splits it into local shards, so its count is GLOBAL: the same
  program on a 1-rank mesh and on 256 ranks counts the same FLOPs.
* bytes accessed and collective bytes: ``StepCounter``, a dispatch mode
  entered outside the FLOP counter.  It lets DTensor run first (it returns
  ``NotImplemented`` on DTensor arguments, as ``CommDebugMode`` does) and
  counts the local ops DTensor issues, so its figures are PER DEVICE: those
  of rank 0's shards, the collectives' results included.  The dry-run
  multiplies them by the chips to make them global, as the reference
  normalises XLA's per-device counts.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.common import ArchConfig, ShapeConfig

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# c10d functional collectives -> the reference's (HLO) names
_COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# c10d functional ops that move no data of their own
_COLLECTIVE_HELPERS = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Per-device counts of one traced step, from the local ops DTensor
    issues (and any op on plain tensors):

    * ``bytes_accessed``: the bytes of every input and output tensor of
      every op that computes, unfused (each op reads its inputs from memory
      and writes its outputs back, as XLA's unfused count does); views
      move no bytes and are not counted.
    * ``collectives``: the result bytes of every c10d functional
      collective, by the reference's kind names, and their ``total``.
    * ``peak_live_bytes``: the most bytes held at once by the tensors the
      step allocated (the outputs of ops that are neither views nor
      in-place), each freed when its last reference goes.

    Only ops on meta tensors count: the dry-run's tensors are meta, and
    DTensor computes its mesh coordinates on small CPU tensors.
    DTensor's sharding propagation runs ops on global-shape fake tensors to
    learn output shapes; those are not counted either."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
        self.live_bytes = 0
        self.peak_live_bytes = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, out: Any) -> None:
        for t in _tensors(out):
            n = _nbytes(t)
            self.live_bytes += n
            weakref.finalize(t, self._free, n)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_propagation_op(types) or not isinstance(
                func, torch._ops.OpOverload):
            return out
        if not any(t.device.type == "meta"
                   for t in _tensors((args, kwargs, out))):
            return out                    # DTensor's bookkeeping
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d_functional"):
            if name in _COLLECTIVE_HELPERS:
                return out
            if name not in _COLLECTIVE_NAMES:
                raise NotImplementedError(f"uncounted collective {func}")
            self.collectives[_COLLECTIVE_NAMES[name]] += sum(
                _nbytes(t) for t in _tensors(out))
            self._track(out)
            return out
        if func.is_view:
            return out
        self.bytes_accessed += (sum(_nbytes(t) for t in _tensors(args))
                                + sum(_nbytes(t) for t in _tensors(kwargs))
                                + sum(_nbytes(t) for t in _tensors(out)))
        if not _mutates(func):
            self._track(out)
        return out

    def collective_bytes(self) -> Dict[str, int]:
        out = dict(self.collectives)
        out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
        return out


def _is_dtensor_op(types) -> bool:
    """An op on DTensors: the mode lets DTensor split it into local ops."""
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _is_propagation_op(types) -> bool:
    """An op of DTensor's sharding propagation: on global-shape fake
    tensors, in the meta kernels they run, or while their fake mode makes
    them."""
    from torch._subclasses.fake_tensor import FakeTensor
    return (any(issubclass(t, FakeTensor) for t in types)
            or torch._C._meta_in_tls_dispatch_include()
            or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None)


def _mutates(func) -> bool:
    """Whether ``func`` writes an argument (in place or ``out=``): its
    outputs are then that argument, not new memory."""
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens.

    For decode shapes, D = batch tokens (one step).  Train triples the
    forward (fwd+bwd); 6ND already assumes that for train; for inference
    we use 2ND.
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch          # one new token per sequence
    return 2.0 * n * tokens


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, chips: int,
                   peak_flops: float, hbm_bw: float, link_bw: float
                   ) -> Dict[str, float]:
    compute_s = flops / (chips * peak_flops)
    memory_s = bytes_accessed / (chips * hbm_bw)
    collective_s = collective_bytes / (chips * link_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=lambda k: terms[k])
    terms["dominant"] = dom  # type: ignore[assignment]
    bound = max(compute_s, memory_s, collective_s)
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms
