"""Compact array-based Physical Graph Template (the translate fast path).

The paper's headline regime is logical graphs that unroll into *millions* of
drops; a dict-of-``DropSpec`` representation spends microseconds per drop on
Python hashing and attribute access and caps translation at ~10^5 drops.
``CompiledPGT`` stores the same physical graph as parallel numpy arrays:

* **drops** — ``kind`` / ``exec_time`` / ``data_volume`` / ``weight`` /
  ``partition`` / ``node`` as flat arrays indexed by a dense int drop id
  (creation order — identical to the dict path's insertion order),
* **edges** — COO ``edge_src`` / ``edge_dst`` / ``edge_streaming`` int32
  arrays with lazily-built CSR adjacency (``indptr`` + column indices) in
  both directions,
* **instance groups** — one record per logical-graph leaf holding the
  shared metadata (construct name, app, payload kind, params) and the axis
  sizes, so per-drop strings/dicts (uids, oids, params) are *derived on
  demand* instead of materialised up front.

The classic dict/DropSpec API (``pgt.drops[uid]``, ``pgt.edges``,
``predecessors`` / ``successors`` / ``roots`` / ``topological_order``) is
exposed as lazy views, so the engine, graph_io, mapping and the managers
work unchanged; hot algorithms (partitioning, scheduling) dispatch on the
type and run vectorized.
"""
from __future__ import annotations

import bisect
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from .logical import GraphValidationError

KIND_APP = 0
KIND_DATA = 1

_INT32_MAX = np.iinfo(np.int32).max


def _check_int32_capacity(num_drops: int, num_edges: int,
                          context: str) -> None:
    """Drop/edge ids are stored as int32 throughout the compiled path;
    beyond 2^31-1 of either the ids would silently wrap.  Raise with a
    clear message instead (the paper's regime tops out at tens of
    millions — two orders of magnitude of headroom)."""
    if num_drops > _INT32_MAX or num_edges > _INT32_MAX:
        raise GraphValidationError(
            f"{context}: {num_drops} drops / {num_edges} edges exceed the "
            f"int32 index capacity ({_INT32_MAX}); the compiled "
            "representation does not support graphs this large")


def _uid_str(name: str, idx: Tuple[int, ...]) -> str:
    return name if not idx else f"{name}#{'.'.join(map(str, idx))}"


def csr_gather_with_counts(indptr: np.ndarray, cols: np.ndarray,
                           ids: np.ndarray) -> Tuple[np.ndarray,
                                                     np.ndarray]:
    """Concatenated CSR rows for ``ids`` + per-id row lengths.

    The grouped-arange trick ``_kahn_levels`` uses, shared by the frontier
    scheduler (successor advance) and the resilience subsystem (upstream
    lineage closure over the reverse CSR)."""
    starts = indptr[ids]
    cnt = indptr[ids + 1] - starts
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, dtype=cols.dtype), cnt
    if total == ids.shape[0] and bool((cnt == 1).all()):
        # every row has exactly one entry (the dominant case for
        # in-adjacency): plain gather, no repeat/arange construction
        return cols[starts], cnt
    reps = np.repeat(starts - np.concatenate(([0], np.cumsum(cnt)[:-1])),
                     cnt)
    return cols[np.arange(total, dtype=np.int64) + reps], cnt


def csr_gather(indptr: np.ndarray, cols: np.ndarray,
               ids: np.ndarray) -> np.ndarray:
    return csr_gather_with_counts(indptr, cols, ids)[0]


def coo_to_csr(n: int, keys: np.ndarray,
               cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """COO edge list -> CSR: (indptr, cols sorted by key, permutation).

    ``keys`` are the row ids (source for out-adjacency, destination for
    in-adjacency); the returned permutation maps CSR position back to the
    original COO edge id so per-edge attributes can be gathered.
    """
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols[order], order


class InstanceGroup:
    """Shared metadata for all physical instances of one LG leaf."""

    __slots__ = ("name", "base", "sizes", "kind", "app", "payload_kind",
                 "execution_time", "data_volume", "error_threshold",
                 "params")

    def __init__(self, name: str, base: int, sizes: Tuple[int, ...],
                 kind: int, app: Optional[str], payload_kind: str,
                 execution_time: float, data_volume: float,
                 error_threshold: float, params: Dict[str, Any]) -> None:
        self.name = name
        self.base = base
        self.sizes = sizes
        self.kind = kind
        self.app = app
        self.payload_kind = payload_kind
        self.execution_time = execution_time
        self.data_volume = data_volume
        self.error_threshold = error_threshold
        self.params = params

    @property
    def count(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def oid_of(self, local: int) -> Tuple[int, ...]:
        if not self.sizes:
            return ()
        out = []
        for s in reversed(self.sizes):
            out.append(local % s)
            local //= s
        return tuple(reversed(out))

    def local_of(self, oid: Sequence[int]) -> int:
        local = 0
        for s, i in zip(self.sizes, oid):
            local = local * s + i
        return local


class _LazyParams(dict):
    """Per-drop params dict that registers itself only on first mutation.

    Reads of ``spec.params`` (serialisation, deploy) allocate a transient
    copy and retain nothing on the PGT; writes install the dict into
    ``_params_override`` so they persist, matching ``DropSpec`` semantics.
    If another copy was registered first, the mutation is forwarded there
    too, so the registered dict stays authoritative.
    """

    __slots__ = ("_pgt", "_idx")

    def __init__(self, pgt: "CompiledPGT", idx: int, base: Dict[str, Any]):
        super().__init__(base)
        self._pgt = pgt
        self._idx = idx

    def _register(self) -> Optional["_LazyParams"]:
        reg = self._pgt._params_override.setdefault(self._idx, self)
        return None if reg is self else reg

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        reg = self._register()
        if reg is not None:
            dict.__setitem__(reg, k, v)

    def __delitem__(self, k):
        super().__delitem__(k)
        reg = self._register()
        if reg is not None:
            dict.__delitem__(reg, k)

    def update(self, *a, **kw):
        super().update(*a, **kw)
        reg = self._register()
        if reg is not None:
            dict.update(reg, *a, **kw)

    def setdefault(self, k, default=None):
        out = super().setdefault(k, default)
        reg = self._register()
        if reg is not None:
            dict.setdefault(reg, k, default)
        return out

    def pop(self, k, *default):
        out = super().pop(k, *default)
        reg = self._register()
        if reg is not None:
            dict.pop(reg, k, *default)
        return out

    def popitem(self):
        out = super().popitem()
        reg = self._register()
        if reg is not None:
            dict.pop(reg, out[0], None)
        return out

    def clear(self):
        super().clear()
        reg = self._register()
        if reg is not None:
            dict.clear(reg)


class DropView:
    """Lazy ``DropSpec``-compatible proxy over one row of a ``CompiledPGT``.

    Reads come straight from the arrays; writes to ``partition`` / ``node``
    / ``params`` write through, so code that mutates specs (the engine, the
    mapper, the managers) behaves exactly as with real ``DropSpec``s.
    """

    __slots__ = ("_p", "_i")

    def __init__(self, pgt: "CompiledPGT", idx: int) -> None:
        self._p = pgt
        self._i = idx

    # -- identity ---------------------------------------------------------
    @property
    def uid(self) -> str:
        return self._p.uid_of(self._i)

    @property
    def kind(self) -> str:
        return "data" if self._p.kind_arr[self._i] == KIND_DATA else "app"

    @property
    def construct(self) -> str:
        return self._p.group_of(self._i).name

    @property
    def oid(self) -> Tuple[int, ...]:
        return self._p.oid_of(self._i)

    @property
    def app(self) -> Optional[str]:
        return self._p.app_of(self._i)

    @property
    def payload_kind(self) -> str:
        return self._p.group_of(self._i).payload_kind

    @property
    def execution_time(self) -> float:
        return float(self._p.exec_arr[self._i])

    @property
    def data_volume(self) -> float:
        return float(self._p.vol_arr[self._i])

    @property
    def error_threshold(self) -> float:
        return float(self._p.err_arr[self._i]) if self._p.err_arr is not None \
            else self._p.group_of(self._i).error_threshold

    @property
    def params(self) -> Dict[str, Any]:
        return self._p.params_of(self._i)

    # -- mutable fields ------------------------------------------------------
    @property
    def partition(self) -> int:
        return int(self._p.partition[self._i])

    @partition.setter
    def partition(self, value: int) -> None:
        self._p.partition[self._i] = value

    @property
    def node(self) -> Optional[str]:
        nid = self._p.node_ids[self._i]
        return None if nid < 0 else self._p.node_names[nid]

    @node.setter
    def node(self, value: Optional[str]) -> None:
        self._p.set_node(self._i, value)

    # -- cost model -----------------------------------------------------------
    def weight(self) -> float:
        return float(self._p.weight_arr[self._i])

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"DropView({self.uid!r}, kind={self.kind!r}, "
                f"partition={self.partition})")


class DropsView:
    """Read-mostly mapping view: uid -> DropView."""

    def __init__(self, pgt: "CompiledPGT") -> None:
        self._p = pgt

    def __len__(self) -> int:
        return self._p.num_drops

    def __iter__(self) -> Iterator[str]:
        for i in range(self._p.num_drops):
            yield self._p.uid_of(i)

    def __contains__(self, uid: object) -> bool:
        try:
            self._p.index_of(uid)  # type: ignore[arg-type]
            return True
        except KeyError:
            return False

    def __getitem__(self, uid: str) -> DropView:
        return DropView(self._p, self._p.index_of(uid))

    def get(self, uid: str, default: Any = None) -> Any:
        try:
            return self[uid]
        except KeyError:
            return default

    def keys(self) -> Iterator[str]:
        return iter(self)

    def values(self) -> Iterator[DropView]:
        for i in range(self._p.num_drops):
            yield DropView(self._p, i)

    def items(self) -> Iterator[Tuple[str, DropView]]:
        for i in range(self._p.num_drops):
            yield self._p.uid_of(i), DropView(self._p, i)


class EdgesView:
    """Read-only sequence view: (src_uid, dst_uid, streaming) tuples."""

    def __init__(self, pgt: "CompiledPGT") -> None:
        self._p = pgt

    def __len__(self) -> int:
        return self._p.num_edges

    def __getitem__(self, i: int) -> Tuple[str, str, bool]:
        p = self._p
        return (p.uid_of(int(p.edge_src[i])), p.uid_of(int(p.edge_dst[i])),
                bool(p.edge_streaming[i]))

    def __iter__(self) -> Iterator[Tuple[str, str, bool]]:
        p = self._p
        for i in range(p.num_edges):
            yield (p.uid_of(int(p.edge_src[i])),
                   p.uid_of(int(p.edge_dst[i])),
                   bool(p.edge_streaming[i]))


class CompiledPGT:
    """Array-backed Physical Graph Template (CSR adjacency).

    Build with :func:`repro.core.unroll.unroll` (vectorized), with
    :meth:`from_specs` (explicit drop list, e.g. deserialisation) or with
    :meth:`from_dict_pgt` (conversion from the legacy dict representation).
    """

    def __init__(self, name: str, groups: List[InstanceGroup],
                 kind_arr: np.ndarray, exec_arr: np.ndarray,
                 vol_arr: np.ndarray,
                 edge_src: np.ndarray, edge_dst: np.ndarray,
                 edge_streaming: np.ndarray,
                 err_arr: Optional[np.ndarray] = None,
                 uids: Optional[List[str]] = None,
                 oids: Optional[List[Tuple[int, ...]]] = None,
                 group_idx: Optional[np.ndarray] = None,
                 validate_dag: bool = True,
                 levels: Optional[np.ndarray] = None) -> None:
        self.name = name
        self.groups = groups
        self._group_idx = group_idx   # explicit per-drop group mapping
        self._group_bases = [g.base for g in groups]
        self._group_by_name = {g.name: g for g in groups}
        n = int(kind_arr.shape[0])
        _check_int32_capacity(n, int(edge_src.shape[0]),
                              f"CompiledPGT({name!r})")
        self.num_drops = n
        self.kind_arr = kind_arr
        self.exec_arr = exec_arr
        self.vol_arr = vol_arr
        self.err_arr = err_arr
        self.weight_arr = np.where(kind_arr == KIND_APP, exec_arr, 0.0)
        self.partition = np.full(n, -1, dtype=np.int32)
        self.node_ids = np.full(n, -1, dtype=np.int32)
        self.node_names: List[str] = []
        self._node_id_of: Dict[str, int] = {}
        self.edge_src = edge_src.astype(np.int32, copy=False)
        self.edge_dst = edge_dst.astype(np.int32, copy=False)
        self.edge_streaming = edge_streaming.astype(bool, copy=False)
        self.num_edges = int(edge_src.shape[0])
        # explicit-uid mode (deserialised graphs); None => derive from groups
        self._uids = uids
        self._oids = oids
        self._uid_map: Optional[Dict[str, int]] = None
        self._params_override: Dict[int, Dict[str, Any]] = {}
        self._has_streaming: Optional[bool] = None   # lazy edge scan
        # lazy CSR caches
        self._out: Optional[
            Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._in_eid: Optional[
            Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._indeg: Optional[np.ndarray] = None
        # precomputed longest-path levels (the vectorized unroll derives
        # them from the logical leaf DAG for loop-free graphs, whose
        # expansion is acyclic by construction — no Kahn pass needed)
        self._levels: Optional[np.ndarray] = levels
        self._order: Optional[np.ndarray] = None
        self._evol: Optional[np.ndarray] = None
        # merge hierarchy recorded by min_time (core/substrate.py); the
        # mapper consumes it instead of re-coarsening the partition graph
        self._partition_hierarchy = None
        if validate_dag and levels is None:
            self.topological_order_ids()   # raises on cycles

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_specs(cls, name: str, specs: Sequence[Any],
                   edges: Sequence[Tuple[str, str, bool]],
                   validate_dag: bool = True) -> "CompiledPGT":
        """Build from explicit DropSpec-like records + uid-pair edges."""
        n = len(specs)
        kind = np.empty(n, dtype=np.uint8)
        ex = np.empty(n, dtype=np.float64)
        vol = np.empty(n, dtype=np.float64)
        err = np.empty(n, dtype=np.float64)
        uids: List[str] = []
        oids: List[Tuple[int, ...]] = []
        groups: List[InstanceGroup] = []
        group_idx = np.empty(n, dtype=np.int32)
        interned: Dict[Tuple[Any, ...], int] = {}
        uid_map: Dict[str, int] = {}
        partition = np.empty(n, dtype=np.int32)
        nodes: List[Optional[str]] = []
        params: Dict[int, Dict[str, Any]] = {}
        for i, s in enumerate(specs):
            kind[i] = KIND_DATA if s.kind == "data" else KIND_APP
            ex[i] = s.execution_time
            vol[i] = s.data_volume
            err[i] = s.error_threshold
            if s.uid in uid_map:
                raise GraphValidationError(
                    f"duplicate drop uid {s.uid!r}")
            uids.append(s.uid)
            oids.append(tuple(s.oid))
            uid_map[s.uid] = i
            # one shared group per distinct construct (numeric per-drop
            # fields live in the arrays; the group carries shared metadata)
            key = (s.construct, s.kind, s.app, s.payload_kind)
            gi = interned.get(key)
            if gi is None:
                gi = len(groups)
                interned[key] = gi
                groups.append(InstanceGroup(
                    name=s.construct, base=i, sizes=(), kind=int(kind[i]),
                    app=s.app, payload_kind=s.payload_kind,
                    execution_time=s.execution_time,
                    data_volume=s.data_volume,
                    error_threshold=s.error_threshold, params={}))
            group_idx[i] = gi
            if s.params:
                params[i] = dict(s.params)
            partition[i] = s.partition
            nodes.append(s.node)
        esrc = np.fromiter((uid_map[e[0]] for e in edges), dtype=np.int32,
                           count=len(edges))
        edst = np.fromiter((uid_map[e[1]] for e in edges), dtype=np.int32,
                           count=len(edges))
        estr = np.fromiter((bool(e[2]) for e in edges), dtype=bool,
                           count=len(edges))
        pgt = cls(name, groups, kind, ex, vol, esrc, edst, estr, err_arr=err,
                  uids=uids, oids=oids, group_idx=group_idx,
                  validate_dag=validate_dag)
        pgt._uid_map = uid_map
        pgt.partition = partition
        pgt._params_override = params
        for i, nd in enumerate(nodes):
            if nd is not None:
                pgt.set_node(i, nd)
        return pgt

    @classmethod
    def from_dict_pgt(cls, pgt: Any) -> "CompiledPGT":
        """Convert a legacy dict-based ``PhysicalGraphTemplate``."""
        return cls.from_specs(pgt.name, list(pgt.drops.values()),
                              list(pgt.edges))

    # ------------------------------------------------------------------
    # per-drop derived metadata
    # ------------------------------------------------------------------
    def group_of(self, idx: int) -> InstanceGroup:
        if self._group_idx is not None:
            return self.groups[int(self._group_idx[idx])]
        g = bisect.bisect_right(self._group_bases, idx) - 1
        return self.groups[g]

    def uid_of(self, idx: int) -> str:
        if self._uids is not None:
            return self._uids[idx]
        g = self.group_of(idx)
        return _uid_str(g.name, g.oid_of(idx - g.base))

    def oid_of(self, idx: int) -> Tuple[int, ...]:
        if self._oids is not None:
            return self._oids[idx]
        g = self.group_of(idx)
        return g.oid_of(idx - g.base)

    def app_of(self, idx: int) -> Optional[str]:
        return self.group_of(idx).app

    def params_of(self, idx: int) -> Dict[str, Any]:
        p = self._params_override.get(idx)
        if p is not None:
            return p
        # transient copy: nothing is retained unless the caller mutates it
        # (_LazyParams registers itself on first write) — million-drop
        # read-only passes (save_pgt) stay O(1) in retained memory
        return _LazyParams(self, idx, self.group_of(idx).params)

    def index_of(self, uid: str) -> int:
        if self._uids is not None and self._uid_map is None:
            self._uid_map = {u: i for i, u in enumerate(self._uids)}
        if self._uid_map is not None:
            try:
                return self._uid_map[uid]
            except KeyError:
                raise KeyError(uid) from None
        name, _, coord_s = uid.partition("#")
        g = self._group_by_name.get(name)
        if g is None:
            raise KeyError(uid)
        if not coord_s:
            if g.sizes:
                raise KeyError(uid)
            return g.base
        try:
            oid = tuple(int(c) for c in coord_s.split("."))
        except ValueError:
            raise KeyError(uid) from None
        if len(oid) != len(g.sizes) or any(
                i < 0 or i >= s for i, s in zip(oid, g.sizes)):
            raise KeyError(uid)
        return g.base + g.local_of(oid)

    def set_node(self, idx: int, node: Optional[str]) -> None:
        self.node_ids[idx] = -1 if node is None else self.node_id_for(node)

    def node_id_for(self, node: str) -> int:
        nid = self._node_id_of.get(node)
        if nid is None:
            nid = len(self.node_names)
            self.node_names.append(node)
            self._node_id_of[node] = nid
        return nid

    # ------------------------------------------------------------------
    # dict-compatible API (lazy views)
    # ------------------------------------------------------------------
    @property
    def drops(self) -> DropsView:
        return DropsView(self)

    @property
    def edges(self) -> EdgesView:
        return EdgesView(self)

    def __len__(self) -> int:
        return self.num_drops

    def successors(self, uid: Union[str, int]) -> List[str]:
        idx = uid if isinstance(uid, int) else self.index_of(uid)
        indptr, cols = self.out_csr()
        return [self.uid_of(int(c))
                for c in cols[indptr[idx]:indptr[idx + 1]]]

    def predecessors(self, uid: Union[str, int]) -> List[str]:
        idx = uid if isinstance(uid, int) else self.index_of(uid)
        indptr, cols = self.in_csr()
        return [self.uid_of(int(c))
                for c in cols[indptr[idx]:indptr[idx + 1]]]

    def roots(self) -> List[str]:
        return [self.uid_of(int(i)) for i in self.root_ids()]

    def topological_order(self) -> List[str]:
        return [self.uid_of(int(i)) for i in self.topological_order_ids()]

    # ------------------------------------------------------------------
    # vectorized graph kernels
    # ------------------------------------------------------------------
    def out_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, dst_ids) adjacency sorted by source drop id."""
        indptr, cols, _ = self.out_csr_with_eid()
        return indptr, cols

    def out_csr_with_eid(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, dst_ids, edge_ids): CSR plus the COO->CSR permutation,
        so per-edge attributes (cost, streaming) can be gathered in CSR
        order without re-sorting."""
        if self._out is None:
            self._out = coo_to_csr(self.num_drops, self.edge_src,
                                   self.edge_dst)
        return self._out

    def in_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, src_ids) adjacency sorted by destination drop id."""
        indptr, cols, _ = self.in_csr_with_eid()
        return indptr, cols

    def in_csr_with_eid(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, src_ids, edge_ids): reverse CSR plus the COO->CSR
        permutation, so per-edge attributes (streaming) can be gathered in
        incoming order — what the frontier scheduler consumes."""
        if self._in_eid is None:
            self._in_eid = coo_to_csr(self.num_drops, self.edge_dst,
                                      self.edge_src)
        return self._in_eid

    def has_streaming_edges(self) -> bool:
        """Whether any edge carries the streaming flag (cached — the
        frontier scheduler checks this per run, and templates share one
        pgt across many sessions)."""
        if self._has_streaming is None:
            self._has_streaming = bool(self.edge_streaming.any())
        return self._has_streaming

    def in_degrees(self) -> np.ndarray:
        """Per-drop incoming edge count (the frontier scheduler's
        ``pending_inputs`` seed)."""
        if self._indeg is None:
            # int32: in-degree <= num_edges, which the construction guard
            # bounds to int32 range (halves the 10M tier's counter memory)
            self._indeg = np.bincount(
                self.edge_dst, minlength=self.num_drops).astype(np.int32)
        return self._indeg

    def group_idx_arr(self) -> np.ndarray:
        """Per-drop index into ``self.groups`` as a flat int32 array.

        Memoised into ``_group_idx`` (``group_of`` then uses the direct
        lookup instead of bisect — same mapping, derived from the
        contiguous group bases)."""
        if self._group_idx is None:
            counts = np.fromiter((g.count for g in self.groups),
                                 dtype=np.int64, count=len(self.groups))
            self._group_idx = np.repeat(
                np.arange(len(self.groups), dtype=np.int32), counts)
        return self._group_idx

    def root_ids(self) -> np.ndarray:
        return np.flatnonzero(self.in_degrees() == 0)

    def topological_order_ids(self) -> np.ndarray:
        if self._order is None:
            if self._levels is not None:
                # level-major, ascending id within a level — exactly the
                # frontier order the vectorized Kahn emits
                self._order = np.argsort(self._levels, kind="stable")
            else:
                self._order, self._levels = _kahn_levels(
                    self.num_drops, self.edge_src, self.edge_dst)
        return self._order

    def topo_levels(self) -> np.ndarray:
        """Longest-path depth of every drop (vectorized Kahn)."""
        if self._levels is None:
            self.topological_order_ids()
        return self._levels  # type: ignore[return-value]

    def partition_index(self) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Sentinel-shifted dense partition index for bincount aggregation.

        Unassigned drops carry a negative sentinel partition (-1); like the
        dict path, the sentinel is a partition key in its own right.
        Returns ``(part, idx, shift, span)`` with ``idx = part + shift``
        guaranteed non-negative and ``span = idx.max() + 1``.
        """
        part = self.partition.astype(np.int64)
        if part.size == 0:
            return part, part, 0, 0
        shift = -int(min(part.min(), 0))
        idx = part + shift
        return part, idx, shift, int(idx.max()) + 1

    def partition_loads(
            self, weights: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(partition ids, per-partition aggregate of ``weights``) for all
        partitions that actually occur (drop count when weights is None)."""
        _, idx, shift, span = self.partition_index()
        if span == 0:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float64))
        counts = np.bincount(idx, minlength=span)
        present = counts > 0
        ids = np.flatnonzero(present) - shift
        if weights is None:
            agg = counts[present].astype(np.float64)
        else:
            agg = np.bincount(idx, weights=weights,
                              minlength=span)[present]
        return ids, agg

    def edge_volumes(self) -> np.ndarray:
        """Per-edge moved bytes: src volume for data sources, else dst's.
        Memoised — translate evaluates it once for the merge order and
        once per scheduling-array extraction."""
        if self._evol is None:
            if not self.vol_arr.any():
                self._evol = np.zeros(self.num_edges, dtype=np.float64)
            else:
                src_is_data = self.kind_arr[self.edge_src] == KIND_DATA
                self._evol = np.where(src_is_data,
                                      self.vol_arr[self.edge_src],
                                      self.vol_arr[self.edge_dst])
        return self._evol

    def partition_graph_arrays(self) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray,
                                              np.ndarray]:
        """The partition-level graph as flat arrays (the mapper's input).

        Returns ``(ids, load, mem, count, eu, ev, ew)``:

        * ``ids``   — the partition labels that occur, sorted (the sentinel
          ``-1`` of unassigned drops is a partition key in its own right),
        * ``load`` / ``mem`` / ``count`` — per-partition aggregate app
          weight, data volume and drop count (``np.bincount`` over the
          sentinel-shifted dense index),
        * ``eu`` / ``ev`` / ``ew`` — the undirected partition-graph edge
          list: unique cross-partition pairs as indices into ``ids``
          (``eu < ev``) with summed edge volumes.

        One pass of bincounts + one ``np.unique`` over the cross edges —
        no per-partition or per-edge Python, which is what lets the
        mapper keep up with million-drop graphs.
        """
        _, idx, shift, span = self.partition_index()
        _check_int32_capacity(span, self.num_edges,
                              f"partition_graph_arrays({self.name!r})")
        if span == 0:
            e = np.empty(0, dtype=np.int64)
            z = np.empty(0, dtype=np.float64)
            return e, z, z.copy(), e.copy(), e.copy(), e.copy(), z.copy()
        counts_all = np.bincount(idx, minlength=span)
        present = counts_all > 0
        ids = np.flatnonzero(present) - shift
        load = np.bincount(idx, weights=self.weight_arr,
                           minlength=span)[present]
        mem = np.bincount(
            idx, weights=np.where(self.kind_arr == KIND_DATA,
                                  self.vol_arr, 0.0),
            minlength=span)[present]
        count = counts_all[present].astype(np.int64)
        npart = int(ids.size)
        dense = np.cumsum(present) - 1          # span -> dense index
        if self.num_edges:
            ps = dense[idx[self.edge_src]]
            pd = dense[idx[self.edge_dst]]
            cross = ps != pd
        else:
            cross = np.zeros(0, dtype=bool)
        if cross.any():
            lo = np.minimum(ps[cross], pd[cross]).astype(np.int64)
            hi = np.maximum(ps[cross], pd[cross]).astype(np.int64)
            key = lo * np.int64(npart) + hi
            uniq, inv = np.unique(key, return_inverse=True)
            ew = np.bincount(inv, weights=self.edge_volumes()[cross])
            eu = uniq // npart
            ev = uniq % npart
        else:
            eu = ev = np.empty(0, dtype=np.int64)
            ew = np.empty(0, dtype=np.float64)
        return ids, load, mem, count, eu, ev, ew


def _kahn_levels(n: int, esrc: np.ndarray,
                 edst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized level-synchronous Kahn: (topo order, longest-path level).

    Each round processes the whole zero-indegree frontier with numpy
    gathers, so the Python loop runs once per DAG *level*, not per node —
    and per-round work is proportional to the frontier's out-edges, not to
    the graph (deep graphs like unrolled loops have many small levels; a
    full-width bincount per level would make validation O(levels * n)).
    Raises on cycles.
    """
    if n == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32))
    indeg = np.bincount(edst, minlength=n).astype(np.int32)
    order_e = np.argsort(esrc, kind="stable")
    sorted_dst = edst[order_e]
    counts = np.bincount(esrc, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    # int32 levels: the level count is bounded by the drop count, which
    # the construction guard keeps within int32 range
    levels = np.full(n, -1, dtype=np.int32)
    chunks: List[np.ndarray] = []
    frontier = np.flatnonzero(indeg == 0)
    level = 0
    done = 0
    while frontier.size:
        levels[frontier] = level
        chunks.append(frontier)
        done += frontier.size
        starts = indptr[frontier]
        cnt = indptr[frontier + 1] - starts
        total = int(cnt.sum())
        indeg[frontier] = -1          # mark processed
        if total:
            # grouped arange: positions of every out-edge of the frontier
            reps = np.repeat(starts - np.concatenate(
                ([0], np.cumsum(cnt)[:-1])), cnt)
            pos = np.arange(total, dtype=np.int64) + reps
            succ = sorted_dst[pos]
            if total < n >> 4:
                np.subtract.at(indeg, succ, 1)
                # only decremented nodes can have reached zero; unique
                # keeps the frontier sorted like flatnonzero would
                frontier = np.unique(succ[indeg[succ] == 0])
            else:
                indeg -= np.bincount(succ, minlength=n)
                frontier = np.flatnonzero(indeg == 0)
        else:
            frontier = np.empty(0, dtype=np.int64)
        level += 1
    if done != n:
        raise GraphValidationError("physical graph contains a cycle")
    return np.concatenate(chunks), levels
