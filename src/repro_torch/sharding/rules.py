"""Logical-axis -> partition-spec rules for every architecture.

PyTorch counterpart of ``repro/sharding/rules.py``, function for function
and decision string for decision string.  The production mesh
(``launch/mesh.py``) is ``(16,16)`` axes ``("data","model")`` single-pod or
``(2,16,16)`` axes ``("pod","data","model")`` multi-pod.

Baseline strategy per tensor class:
  * vocab / d_ff / attention heads      -> TP over "model" (if divisible)
  * batch (and MoE groups)              -> DP over ("pod","data")
  * large d_model dims of weights       -> FSDP over ("pod","data") when the
    arch's ``sharding_strategy == "fsdp"``
  * KV caches at decode                 -> kv-heads over "model" when they
    divide, else the *sequence* axis over "model"
  * everything that doesn't divide      -> replicated, recorded in
    ``decisions`` so the dry-run report shows every fallback.

A spec is a ``P``: one entry per tensor dim, each ``None``, a mesh axis
name or a tuple of names, normalised as ``jax.sharding.PartitionSpec``
normalises them (a 1-tuple is its name), so a spec compares entry for
entry with the reference's.  ``to_placements`` turns one into DTensor
placements on a ``DeviceMesh``.  The rules read only axis names and
sizes: they take a ``DeviceMesh`` or an ``AbstractMesh`` and touch no
device and no process group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..models.common import ArchConfig
from ..tree import leaves_with_path, tree_map, unflatten_like


class P:
    """A partition spec (``jax.sharding.PartitionSpec``'s counterpart).

    Not a tuple, so trees of specs keep each spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Any):
        self.entries = tuple(_normalise(e) for e in entries)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self.entries == other.entries
        if isinstance(other, tuple):
            return self.entries == tuple(_normalise(e) for e in other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def _normalise(entry: Any) -> Any:
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class AbstractMesh:
    """Axis names and sizes of a mesh, without devices (the rules' view of
    a ``DeviceMesh``; ``jax.sharding.AbstractMesh``'s counterpart)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes} vs {axis_names}")
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(mesh: Any) -> AbstractMesh:
    """The ``AbstractMesh`` of a ``DeviceMesh`` (an ``AbstractMesh`` is
    returned as it is)."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the rules need a mesh with named dims")
    return AbstractMesh(tuple(mesh.mesh.shape), names)


def data_axes(mesh: Any) -> Tuple[str, ...]:
    names = abstract_mesh(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh: Any, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    shape = abstract_mesh(mesh).shape
    n = 1
    for a in names:
        n *= shape.get(a, 1)        # absent axis (derived meshes) = no shard
    return n


def shard_if_divisible(dim: int, mesh: Any, names,
                       decisions: Optional[List[str]] = None,
                       label: str = "") -> Optional[Any]:
    """Return ``names`` if dim divides the axis product, else None."""
    sz = axis_size(mesh, names)
    if sz > 1 and dim % sz == 0:
        return names
    if decisions is not None and sz > 1:
        decisions.append(f"replicated {label} (dim {dim} % {sz} != 0)")
    return None


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def shard_best(dim: int, mesh: Any, candidates,
               decisions: Optional[List[str]] = None, label: str = ""):
    """First candidate axis-group that divides ``dim`` wins (EP cascade)."""
    for names in candidates:
        if names is None:
            continue
        sz = axis_size(mesh, names)
        if sz > 1 and dim % sz == 0:
            return names
    if decisions is not None:
        decisions.append(f"replicated {label} (dim {dim})")
    return None


def _leaf_spec(path: str, shape: Tuple[int, ...], cfg: ArchConfig,
               mesh: Any, decisions: List[str],
               tp=("model",), expert_axis: Optional[str] = None) -> P:
    mesh = abstract_mesh(mesh)
    da = data_axes(mesh)
    fsdp = da if cfg.sharding_strategy == "fsdp" else None
    m = tuple(tp) if len(tp) > 1 else tp[0]
    head_casc = [tuple(tp)] + [(a,) for a in tp]

    def div(dim, names, label):
        if label.endswith("heads") or label == "vocab" or label == "ffn":
            if names is m:
                got = shard_best(dim, mesh, head_casc, decisions,
                                 f"{path}:{label}")
                return got if got is None or len(got) > 1 else got[0]
        return shard_if_divisible(dim, mesh, names, decisions,
                                  f"{path}:{label}")

    stacked = path.startswith("['layers']") or \
        path.startswith("['enc_layers']")
    L = (1,) if stacked else ()           # leading layer axis -> None

    def spec(*tail):
        return P(*([None] * len(L) + list(tail)))

    body = shape[len(L):]

    # --- embeddings & head ------------------------------------------------
    if "embed" in path:
        return P(div(shape[0], m, "vocab"),
                 div(shape[1], fsdp, "embed-fsdp"))
    if "lm_head" in path:
        return P(div(shape[0], fsdp, "dmodel-fsdp"),
                 div(shape[1], m, "vocab"))
    # --- attention ---------------------------------------------------------
    if path.endswith("['wq']") or path.endswith("['wo']"):
        if path.endswith("['wq']"):       # (d, nq, hd)
            return spec(div(body[0], fsdp, "d-fsdp"),
                        div(body[1], m, "qheads"), None)
        return spec(div(body[0], m, "qheads"), None,
                    div(body[2], fsdp, "d-fsdp"))
    if path.endswith("['wk']") or path.endswith("['wv']"):
        return spec(div(body[0], fsdp, "d-fsdp"),
                    div(body[1], m, "kvheads"), None)
    if path.endswith("['bq']"):
        return spec(div(body[0], m, "qheads"), None)
    if path.endswith("['bk']") or path.endswith("['bv']"):
        return spec(div(body[0], m, "kvheads"), None)
    # --- dense mlp -----------------------------------------------------------
    if path.endswith("['w1']") or path.endswith("['w3']"):
        if len(body) == 3:                # moe (E, d, f)
            e_sh = (expert_axis if expert_axis
                    and body[0] % mesh.shape[expert_axis] == 0 else None)
            ffn_tp = ("tp",) if expert_axis else m
            return spec(e_sh, div(body[1], fsdp, "d-fsdp"),
                        shard_if_divisible(body[2], mesh, ffn_tp,
                                           decisions, f"{path}:ffn"))
        return spec(div(body[0], fsdp, "d-fsdp"), div(body[1], m, "ffn"))
    if path.endswith("['w2']"):
        if len(body) == 3:                # moe (E, f, d)
            e_sh = (expert_axis if expert_axis
                    and body[0] % mesh.shape[expert_axis] == 0 else None)
            ffn_tp = ("tp",) if expert_axis else m
            return spec(e_sh,
                        shard_if_divisible(body[1], mesh, ffn_tp,
                                           decisions, f"{path}:ffn"),
                        div(body[2], fsdp, "d-fsdp"))
        return spec(div(body[0], m, "ffn"), div(body[1], fsdp, "d-fsdp"))
    if path.endswith("['router']"):
        return spec(div(body[0], fsdp, "d-fsdp"), None)
    # --- mamba2 ---------------------------------------------------------------
    if path.endswith("['in_proj']"):      # (d, K-packed)
        return spec(div(body[0], fsdp, "d-fsdp"), None)
    if path.endswith("['out_proj']"):     # (di, d)
        return spec(None, div(body[1], fsdp, "d-fsdp"))
    # conv_w / conv_b / A_log / D / dt_bias / norms / biases: replicate
    return spec(*([None] * len(body)))


def param_pspecs(cfg: ArchConfig, params_abstract: Any, mesh: Any,
                 tp=("model",), expert_axis: Optional[str] = None
                 ) -> Tuple[Any, List[str]]:
    """(tree of specs shaped like the params, decisions)."""
    decisions: List[str] = []
    specs = [_leaf_spec(path, tuple(leaf.shape), cfg, mesh, decisions,
                        tp=tp, expert_axis=expert_axis)
             for path, leaf in leaves_with_path(params_abstract)]
    return unflatten_like(params_abstract, specs), decisions


def replicated_pspecs(params_abstract: Any) -> Any:
    """All-replicated params (dp_all profile: model is small, DP is king)."""
    return tree_map(lambda l: P(*([None] * len(l.shape))), params_abstract)


def zero_opt_pspecs(opt_state_abstract: Any, mesh: Any) -> Any:
    """ZeRO: shard optimizer moments over whatever axes their dims allow
    (independent of the replicated param layout)."""
    from ..optim import AdamWState
    mesh = abstract_mesh(mesh)
    axes_avail = [a for a in ("data", "model") if a in mesh.axis_names]

    def leaf(l) -> P:
        dims: List[Any] = [None] * len(l.shape)
        used = set()
        for ax in axes_avail:
            for i, d in enumerate(l.shape):
                if dims[i] is None and i not in used \
                        and d % mesh.shape[ax] == 0 and d >= mesh.shape[ax]:
                    dims[i] = ax
                    used.add(i)
                    break
        return P(*dims)

    return AdamWState(step=P(), m=tree_map(leaf, opt_state_abstract.m),
                      v=tree_map(leaf, opt_state_abstract.v))


def opt_pspecs(param_specs: Any, opt_state_abstract: Any) -> Any:
    """Adam m/v shard exactly like their parameters (ZeRO)."""
    from ..optim import AdamWState
    return AdamWState(step=P(), m=param_specs, v=param_specs)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def _batch_axis(mesh: Any, b: int) -> Optional[Tuple[str, ...]]:
    da = data_axes(mesh)
    return da if b % axis_size(mesh, da) == 0 else None


def batch_pspecs(cfg: ArchConfig, batch_abstract: Dict[str, Any],
                 mesh: Any, batch_axes=None) -> Dict[str, Any]:
    def baxis(b):
        if batch_axes is not None:
            return batch_axes if b % axis_size(mesh, batch_axes) == 0 \
                else _batch_axis(mesh, b)
        return _batch_axis(mesh, b)

    out: Dict[str, Any] = {}
    for k, v in batch_abstract.items():
        if k in ("tokens", "labels"):
            out[k] = P(baxis(v.shape[0]), None)
        elif k == "frames":
            out[k] = P(baxis(v.shape[0]), None, None)
        elif k == "pos":
            out[k] = P()
        elif k == "cache":
            out[k] = cache_pspecs(cfg, v, mesh)
        else:
            out[k] = P(*([None] * len(v.shape)))
    return out


def cache_pspecs(cfg: ArchConfig, cache_abstract: Any, mesh: Any) -> Any:
    """KV: (L,B,T,kv,hd); SSM state: (L,B,h,n,p); conv: (L,B,W,C)."""
    decisions: List[str] = []

    def kv_spec(leaf):
        L, B, T, KV, HD = leaf.shape
        b = _batch_axis(mesh, B)
        kv = shard_if_divisible(KV, mesh, "model", decisions, "kvcache-heads")
        if kv is not None:
            return P(None, b, None, kv, None)
        # flash-decoding layout: shard the sequence axis instead
        t = shard_if_divisible(T, mesh, "model", decisions, "kvcache-seq")
        return P(None, b, t, None, None)

    def spec_for(path: str, leaf) -> P:
        if "cross_k" in path or "cross_v" in path:   # (L,B,enc,kv,hd)
            return kv_spec(leaf)
        if "'k'" in path or "'v'" in path:
            return kv_spec(leaf)
        if "state" in path:                          # (L,B,h,n,p)
            L, B, H, N, Pdim = leaf.shape
            return P(None, _batch_axis(mesh, B),
                     shard_if_divisible(H, mesh, "model", decisions,
                                        "ssm-heads"), None, None)
        if "conv" in path:                           # (L,B,W,C)
            return P(None, _batch_axis(mesh, leaf.shape[1]), None, None)
        return P(*([None] * len(leaf.shape)))

    specs = [spec_for(p, l) for p, l in leaves_with_path(cache_abstract)]
    return unflatten_like(cache_abstract, specs)


def logits_pspec(cfg: ArchConfig, b: int, mesh: Any) -> P:
    return P(_batch_axis(mesh, b), None,
             shard_if_divisible(cfg.padded_vocab, mesh, "model"))


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec: P, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``): one per mesh dim, ``Shard(d)`` where tensor dim
    ``d``'s entry names that mesh dim, else ``Replicate()``.  A tuple entry
    such as ``("pod", "data")`` shards its dim over each named mesh dim,
    major to minor, which is DTensor's order only when the names come in
    the mesh's order; another order (a strided shard) raises, as does a
    mesh dim named twice or a name the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard
    names = abstract_mesh(mesh).axis_names
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in group:
            if a not in names:
                raise ValueError(f"{spec}: mesh {names} has no axis {a!r}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {a!r} named twice")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {group} are not in the mesh's "
                             f"order {names} (a strided shard)")
    return tuple(out)
