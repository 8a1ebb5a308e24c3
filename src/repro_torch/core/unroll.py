"""LG -> Physical Graph Template translation (paper §3.4, step 2).

"The second step unrolls the logical graph by first creating all necessary
Drop specifications ... and second establishing directed edges amongst these
Drop specifications."

Unrolling model
---------------
Every *leaf* construct survives to a set of physical instances indexed by the
**axes** contributed by its enclosing containers:

* ``Scatter(K)``     -> axis of size K,
* ``Loop(T)``        -> axis of size T,
* ``Gather(g)``      -> collapses the innermost axis K -> K/g; each surviving
  index q covers underlying coordinates ``[q*g, (q+1)*g)``,
* ``GroupBy``        -> the corner turn: drops the *outer* scatter axis and
  keeps the *inner* one; each instance consumes every outer coordinate.

Edges between leaves connect instance-wise by **joining on underlying scatter
coordinates**: shared axes align, a dst-range (Gather) fans in, a missing axis
on the dst side (GroupBy / graph-level reduce) consumes the full range, a
missing axis on the src side broadcasts.  Loop-carried Data nodes are aliased:
iteration ``t``'s ``loop_entry`` *is* iteration ``t-1``'s ``loop_exit`` drop
("new Data Drops created in each iteration", paper §2.3), and a ``loop_exit``
consumed *outside* its loop contributes only the final iteration's value —
flows crossing the loop boundary shed the loop axis.

Both the reference dict path (:func:`unroll_dict`) and the vectorized array
path (:func:`unroll` -> :class:`~repro.core.pgt.CompiledPGT`) implement the
same semantics; the array path expresses iteration aliasing as index
substitution on block-diagonal per-iteration edge maps instead of
per-instance dict walks.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .constructs import Construct, Kind
from .logical import GraphValidationError, LogicalGraph


# ---------------------------------------------------------------------------
# Physical Graph Template
# ---------------------------------------------------------------------------


@dataclass
class DropSpec:
    """A Drop specification — a PGT node (not yet bound to resources)."""

    uid: str
    kind: str                      # "app" | "data"
    construct: str                 # originating construct name
    oid: Tuple[int, ...]           # instance coordinates
    app: Optional[str] = None
    payload_kind: str = "memory"
    execution_time: float = 0.0
    data_volume: float = 0.0
    error_threshold: float = 0.0
    params: Dict[str, Any] = field(default_factory=dict)
    partition: int = -1            # logical partition (paper §3.4 step 3)
    node: Optional[str] = None     # physical node (paper §3.5)

    def weight(self) -> float:
        """Cost-model weight: runtime for apps, volume for data."""
        return self.execution_time if self.kind == "app" else 0.0


@dataclass
class PhysicalGraphTemplate:
    name: str
    drops: Dict[str, DropSpec] = field(default_factory=dict)
    edges: List[Tuple[str, str, bool]] = field(default_factory=list)
    _succ: Optional[Dict[str, List[str]]] = None
    _pred: Optional[Dict[str, List[str]]] = None

    def add_drop(self, spec: DropSpec) -> None:
        if spec.uid in self.drops:
            raise GraphValidationError(f"duplicate drop uid {spec.uid!r}")
        self.drops[spec.uid] = spec
        self._succ = self._pred = None
        self.__dict__.pop("_sched_arrays", None)

    def add_edge(self, src: str, dst: str, streaming: bool = False) -> None:
        self.edges.append((src, dst, streaming))
        self._succ = self._pred = None
        self.__dict__.pop("_sched_arrays", None)

    # -- adjacency --------------------------------------------------------------
    def _build_adj(self) -> None:
        succ: Dict[str, List[str]] = {u: [] for u in self.drops}
        pred: Dict[str, List[str]] = {u: [] for u in self.drops}
        for s, d, _ in self.edges:
            succ[s].append(d)
            pred[d].append(s)
        self._succ, self._pred = succ, pred

    def successors(self, uid: str) -> List[str]:
        if self._succ is None:
            self._build_adj()
        return self._succ[uid]  # type: ignore[index]

    def predecessors(self, uid: str) -> List[str]:
        if self._pred is None:
            self._build_adj()
        return self._pred[uid]  # type: ignore[index]

    def roots(self) -> List[str]:
        if self._pred is None:
            self._build_adj()
        return [u for u, p in self._pred.items() if not p]  # type: ignore[union-attr]

    def topological_order(self) -> List[str]:
        if self._pred is None:
            self._build_adj()
        indeg = {u: len(p) for u, p in self._pred.items()}  # type: ignore[union-attr]
        stack = [u for u, d in indeg.items() if d == 0]
        order: List[str] = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in self._succ[u]:  # type: ignore[index]
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if len(order) != len(self.drops):
            raise GraphValidationError("physical graph contains a cycle")
        return order

    def __len__(self) -> int:
        return len(self.drops)


# ---------------------------------------------------------------------------
# Axes
# ---------------------------------------------------------------------------


@dataclass
class Axis:
    """A surviving instance axis of a leaf construct.

    ``underlying`` is the contributing Scatter/Loop construct name;
    ``size`` the number of surviving indices; ``group`` the number of
    underlying coordinates covered by one surviving index (Gather collapse).
    """

    underlying: str
    underlying_size: int
    size: int
    group: int = 1   # surviving index q covers [q*group, (q+1)*group)

    def to_index(self, coord: int) -> int:
        return coord // self.group

    def to_coords(self, index: int) -> range:
        return range(index * self.group, (index + 1) * self.group)


class AxisResolver:
    """Resolve the surviving axes of every leaf construct.

    Scatter and Loop ancestors *contribute* axes.  Gather and GroupBy
    *transform* the axes of their **incoming flow** (paper Fig. 3 draws them
    as siblings consuming the scattered branches; they may equally be nested
    inside the Scatter — both spellings resolve identically here):

    * Gather(g): innermost incoming axis K -> K/g (fan-in g per instance),
    * GroupBy:   corner turn — drop the outer of the last two incoming axes,
      keep the inner (each instance consumes the full outer range).

    The incoming flow of a container is taken from the edge whose source is
    outside the container subtree and carries the most axes (the most
    specific producer — broadcast side-inputs don't define the flow shape).
    """

    def __init__(self, lg: LogicalGraph) -> None:
        self.lg = lg
        self._leaf_cache: Dict[str, List[Axis]] = {}
        self._cont_cache: Dict[Optional[str], List[Axis]] = {}
        self._resolving: set = set()

    # -- public ----------------------------------------------------------
    def leaf_axes(self, leaf: str) -> List[Axis]:
        if leaf not in self._leaf_cache:
            c = self.lg.constructs[leaf]
            self._leaf_cache[leaf] = list(self._container_axes(c.parent))
        return self._leaf_cache[leaf]

    # -- internals ----------------------------------------------------------
    def _subtree_leaves(self, name: str) -> List[str]:
        out: List[str] = []
        stack = [name]
        while stack:
            n = stack.pop()
            for ch in self.lg.children(n):
                if ch.is_container():
                    stack.append(ch.name)
                else:
                    out.append(ch.name)
        return out

    def _incoming_axes(self, name: str) -> List[Axis]:
        inside = set(self._subtree_leaves(name))
        best: Optional[List[Axis]] = None
        for e in self.lg.edges:
            if e.dst in inside and e.src not in inside:
                axes = self._flow_axes(e.src, name)
                if best is None or len(axes) > len(best):
                    best = axes
        if best is None:
            raise GraphValidationError(
                f"{name!r} has no incoming flow to aggregate")
        return list(best)

    def _flow_axes(self, src: str, container: str) -> List[Axis]:
        """Axes the flow from ``src`` contributes to ``container``.

        A ``loop_exit`` crossing its loop boundary leaves the loop axis
        behind: the loop emits exactly one (final-iteration) value (paper
        §2.3), so a Gather/GroupBy *outside* the loop aggregates over the
        remaining (scatter) axes, not over iterations.  The matching
        coordinate pin happens at unroll time (``exit_pin``).
        """
        axes = list(self.leaf_axes(src))
        c = self.lg.constructs[src]
        if c.kind is Kind.DATA and c.loop_exit:
            loops = [a for a in self.lg.ancestors(src)
                     if a.kind is Kind.LOOP]
            if loops:
                loop_name = loops[-1].name
                anc = {a.name for a in self.lg.ancestors(container)}
                if loop_name not in anc:
                    axes = [a for a in axes if a.underlying != loop_name]
        return axes

    def _container_axes(self, name: Optional[str]) -> List[Axis]:
        if name in self._cont_cache:
            return self._cont_cache[name]
        if name is None:
            return []
        if name in self._resolving:
            raise GraphValidationError(
                f"cyclic aggregation through container {name!r}")
        self._resolving.add(name)
        try:
            c = self.lg.constructs[name]
            if c.kind is Kind.SCATTER:
                axes = self._container_axes(c.parent) + [
                    Axis(c.name, c.num_of_copies, c.num_of_copies)]
            elif c.kind is Kind.LOOP:
                axes = self._container_axes(c.parent) + [
                    Axis(c.name, c.num_of_iterations, c.num_of_iterations)]
            elif c.kind is Kind.GATHER:
                axes = self._incoming_axes(name)
                if not axes:
                    raise GraphValidationError(
                        f"Gather {c.name!r} has no incoming axis to collapse")
                last = axes[-1]
                g = c.num_of_inputs
                if last.size % g:
                    raise GraphValidationError(
                        f"Gather {c.name!r}: fan-in {g} does not divide "
                        f"branch count {last.size}")
                axes[-1] = Axis(last.underlying, last.underlying_size,
                                last.size // g, last.group * g)
            elif c.kind is Kind.GROUPBY:
                axes = self._incoming_axes(name)
                if len(axes) < 2:
                    raise GraphValidationError(
                        f"GroupBy {c.name!r} needs two incoming axes "
                        "(nested Scatters)")
                # corner turn: drop the outer axis, keep the inner
                axes = axes[:-2] + [axes[-1]]
            else:  # pragma: no cover - validated earlier
                raise GraphValidationError(
                    f"{name!r} is not a container")
        finally:
            self._resolving.discard(name)
        self._cont_cache[name] = axes
        return axes


def leaf_axes(lg: LogicalGraph, leaf: str) -> List[Axis]:
    """Compute the surviving axes of a leaf (convenience wrapper)."""
    return AxisResolver(lg).leaf_axes(leaf)


# ---------------------------------------------------------------------------
# Unroll
# ---------------------------------------------------------------------------


def _uid(name: str, idx: Tuple[int, ...]) -> str:
    return name if not idx else f"{name}#{'.'.join(map(str, idx))}"


@dataclass
class _Carry:
    """Loop-carry record for one ``loop_entry`` leaf."""

    exit: str            # the loop_exit construct that carries into it
    loop: str            # the (innermost) Loop construct name
    pos: Optional[int]   # index of the loop axis within the entry's axes


def _carried_loops(lg: LogicalGraph, leaves: Sequence[Construct],
                   axes_of: Dict[str, List[Axis]]) -> Dict[str, "_Carry"]:
    """Resolve and validate loop-carried entry/exit pairs (entry-keyed).

    Shared by the dict oracle and the vectorized path so both reject the
    same ill-formed graphs: duplicate carriers, chained carries (an exit
    that is itself a carried entry — its t>0 instances would alias drops
    that were never created), and entry/exit axis misalignment (the alias
    substitutes surviving indices by axis name, which silently produced
    dangling uids when sizes or Gather groupings differed).
    """
    carries: Dict[str, _Carry] = {}
    for c in leaves:
        if not (c.kind is Kind.DATA and c.loop_exit):
            continue
        entry = c.params.get("carries")
        if not entry or entry not in lg.constructs:
            raise GraphValidationError(
                f"loop_exit {c.name!r} must name its 'carries' entry")
        e = lg.constructs[entry]
        if not e.loop_entry:
            raise GraphValidationError(
                f"{entry!r} is not marked loop_entry")
        loops = [a for a in lg.ancestors(c.name) if a.kind is Kind.LOOP]
        if not loops:
            raise GraphValidationError(
                f"loop_exit {c.name!r} is outside any Loop")
        if entry in carries:
            raise GraphValidationError(
                f"loop_entry {entry!r} carried by both "
                f"{carries[entry].exit!r} and {c.name!r}")
        la = loops[-1].name
        pos = None
        for i, ax in enumerate(axes_of[entry]):
            if ax.underlying == la:
                pos = i
                break
        carries[entry] = _Carry(exit=c.name, loop=la, pos=pos)
    for entry, car in carries.items():
        if car.exit in carries:
            raise GraphValidationError(
                f"chained loop carry: exit {car.exit!r} is itself a "
                "carried loop_entry")
        if car.pos is None:
            continue
        ent_ax = {a.underlying: a for a in axes_of[entry]}
        for a in axes_of[car.exit]:
            b = ent_ax.get(a.underlying)
            if b is None or b.size != a.size or b.group != a.group:
                raise GraphValidationError(
                    f"loop carry {entry!r} <- {car.exit!r}: axis "
                    f"{a.underlying!r} does not align between entry and "
                    "exit instances")
    return carries


def unroll_dict(lg: LogicalGraph) -> PhysicalGraphTemplate:
    """Reference dict-of-DropSpec unroll (the seed path).

    Kept as the semantic oracle for the vectorized CSR path (see
    :func:`unroll`), including loop-carried graphs, whose iteration
    aliasing the array path expresses as index substitution.
    """
    lg.validate()
    pgt = PhysicalGraphTemplate(name=lg.name)

    leaves = lg.leaves()
    resolver = AxisResolver(lg)
    axes_of: Dict[str, List[Axis]] = {
        c.name: resolver.leaf_axes(c.name) for c in leaves}

    carries = _carried_loops(lg, leaves, axes_of)

    # --- instantiate drops ------------------------------------------------------
    # alias: (construct, idx) -> uid actually used
    alias: Dict[Tuple[str, Tuple[int, ...]], str] = {}

    for c in leaves:
        axes = axes_of[c.name]
        car = carries.get(c.name)
        lp = car.pos if car is not None else None
        for idx in itertools.product(*(range(a.size) for a in axes)):
            if lp is not None and idx[lp] > 0:
                # entry at iteration t>0 aliases exit at t-1
                exit_name = car.exit
                prev = list(idx)
                prev[lp] -= 1
                # exit axes may be ordered differently; align by axis name
                e_axes = axes_of[exit_name]
                coordmap = {axes[i].underlying: prev[i]
                            for i in range(len(axes))}
                e_idx = tuple(coordmap[a.underlying] for a in e_axes)
                alias[(c.name, idx)] = _uid(exit_name, e_idx)
                continue
            uid = _uid(c.name, idx)
            if c.kind is Kind.DATA:
                spec = DropSpec(uid=uid, kind="data", construct=c.name,
                                oid=idx, payload_kind=c.payload_kind,
                                data_volume=float(c.data_volume),
                                params=dict(c.params))
            else:
                spec = DropSpec(uid=uid, kind="app", construct=c.name,
                                oid=idx, app=c.app,
                                execution_time=float(c.execution_time),
                                error_threshold=c.error_threshold,
                                params=dict(c.params))
            pgt.add_drop(spec)

    def resolve(name: str, idx: Tuple[int, ...]) -> str:
        return alias.get((name, idx), _uid(name, idx))

    # --- connect edges -----------------------------------------------------------
    seen: set = set()
    for e in lg.edges:
        s_axes, d_axes = axes_of[e.src], axes_of[e.dst]
        d_axis_names = {a.underlying for a in d_axes}
        src_c = lg.constructs[e.src]
        # loop_exit -> consumer outside the loop: only the FINAL iteration's
        # exit drop leaves the loop (the paper's loop produces one result).
        exit_pin: Dict[str, int] = {}
        if src_c.kind is Kind.DATA and src_c.loop_exit:
            loops = [a for a in lg.ancestors(e.src) if a.kind is Kind.LOOP]
            if loops and loops[-1].name not in d_axis_names:
                exit_pin[loops[-1].name] = loops[-1].num_of_iterations - 1
        for d_idx in itertools.product(*(range(a.size) for a in d_axes)):
            if (e.dst, d_idx) in alias:
                # loop-entry instances at t>0 are pure aliases of exit[t-1];
                # nothing is ever produced *into* them directly.
                continue
            # constraints: underlying coords covered by this dst instance
            constraints: Dict[str, Iterable[int]] = {
                a.underlying: a.to_coords(i)
                for a, i in zip(d_axes, d_idx)}
            # enumerate matching src coordinates per src axis
            coord_ranges = []
            for a in s_axes:
                if a.underlying in exit_pin:
                    coords: Iterable[int] = (exit_pin[a.underlying],)
                else:
                    coords = constraints.get(a.underlying,
                                             range(a.underlying_size))
                coord_ranges.append(coords)
            dst_uid = resolve(e.dst, d_idx)
            for combo in itertools.product(*coord_ranges):
                s_idx = tuple(a.to_index(c)
                              for a, c in zip(s_axes, combo))
                src_uid = resolve(e.src, s_idx)
                key = (src_uid, dst_uid, e.streaming)
                if key in seen or src_uid == dst_uid:
                    continue
                seen.add(key)
                pgt.add_edge(src_uid, dst_uid, e.streaming)
    # sanity: the PGT must be a DAG (validated LGs always are, but aliasing
    # of loop-carried drops could surface user errors)
    pgt.topological_order()
    return pgt


# ---------------------------------------------------------------------------
# Vectorized unroll -> CompiledPGT (CSR arrays)
# ---------------------------------------------------------------------------


class _NeedsFallback(Exception):
    """Raised when an edge pattern has no closed-form array expansion."""


def _strides_of(sizes: Sequence[int]) -> List[int]:
    """C-order strides for ``sizes`` (innermost stride 1)."""
    out: List[int] = []
    acc = 1
    for s in reversed(sizes):
        out.append(acc)
        acc *= s
    out.reverse()
    return out


def _expand_edge(s_axes: List[Axis], d_axes: List[Axis],
                 s_base: int, d_base: int,
                 pin: Optional[Dict[str, int]] = None):
    """Vectorized instance-wise edge expansion for one logical edge.

    Mirrors the per-instance join of :func:`unroll_dict`: shared underlying
    axes align (with Gather fan-in/fan-out via the group ratios), an axis
    missing on the dst side is consumed in full, an axis missing on the src
    side broadcasts.  ``pin`` fixes a src axis to one surviving index
    instead of consuming it (the ``exit_pin``: only the final iteration's
    loop_exit leaves the loop).  Returns (src_ids, dst_ids) int64 arrays.
    """
    d_sizes = [a.size for a in d_axes]
    nd = 1
    for s in d_sizes:
        nd *= s
    d_strides = _strides_of(d_sizes)
    dmap = {a.underlying: (a, j) for j, a in enumerate(d_axes)}

    s_strides = _strides_of([a.size for a in s_axes])

    dst = np.arange(nd, dtype=np.int64)
    src_acc = np.zeros(nd, dtype=np.int64)
    for a, s_stride in zip(s_axes, s_strides):
        if pin is not None and a.underlying in pin:
            src_acc = src_acc + pin[a.underlying] * s_stride
            continue
        hit = dmap.get(a.underlying)
        if hit is not None:
            da, j = hit
            cj = (dst // d_strides[j]) % d_sizes[j]
            gd, gs = da.group, a.group
            if gs % gd == 0:
                # dst instance covers one src index (or a sub-block of one)
                src_acc = src_acc + ((cj * gd) // gs) * s_stride
            elif gd % gs == 0:
                k = gd // gs
                m = dst.shape[0]
                dst = np.repeat(dst, k)
                src_acc = np.repeat(src_acc, k) + (
                    np.repeat(cj * k, k) +
                    np.tile(np.arange(k, dtype=np.int64), m)) * s_stride
            else:
                raise _NeedsFallback(
                    f"incommensurate groups on axis {a.underlying!r}")
        else:
            # axis absent on dst: consume the full (deduplicated) src range
            k = a.size
            m = dst.shape[0]
            dst = np.repeat(dst, k)
            src_acc = np.repeat(src_acc, k) + np.tile(
                np.arange(k, dtype=np.int64), m) * s_stride
    return s_base + src_acc, d_base + dst


def compile_unroll(lg: LogicalGraph) -> "CompiledPGT":
    """Unroll a logical graph straight into CSR arrays.

    Drop ids are allocated leaf-by-leaf in ``lg.leaves()`` order with
    C-order instance coordinates — the exact creation order of
    :func:`unroll_dict` — so the two representations are index-compatible
    and scheduling tie-breaks agree.

    Loop-carried graphs are array-native too: a ``loop_entry`` group is
    instantiated with its loop axis collapsed to size 1 (only iteration
    0 exists — t>0 instances are pure aliases of the exit at t-1), and
    every logical edge touching a carried leaf is expanded once over the
    full per-iteration index space, then rewritten in place — the
    block-diagonal per-iteration edge maps fall out of the linear index
    arithmetic:

    * rows *into* an aliased entry at t>0 are dropped (nothing is ever
      produced into an alias),
    * rows *out of* an aliased entry at t>0 substitute the exit's drop id
      at t-1 (axes aligned by underlying construct name),
    * a ``loop_exit`` consumed outside its loop is pinned to the final
      iteration (``exit_pin``) instead of consuming the loop range.

    Edge patterns with no closed-form array expansion (incommensurate
    Gather groups) still fall back to the dict path and are converted.
    """
    from .pgt import KIND_APP, KIND_DATA, CompiledPGT, InstanceGroup

    lg.validate()
    leaves = lg.leaves()

    resolver = AxisResolver(lg)
    axes_of: Dict[str, List[Axis]] = {
        c.name: resolver.leaf_axes(c.name) for c in leaves}
    carries = _carried_loops(lg, leaves, axes_of)

    full_sizes: Dict[str, List[int]] = {
        c.name: [a.size for a in axes_of[c.name]] for c in leaves}
    full_strides: Dict[str, List[int]] = {
        name: _strides_of(s) for name, s in full_sizes.items()}

    groups: List[InstanceGroup] = []
    base_of: Dict[str, int] = {}
    base = 0
    for c in leaves:
        sizes = list(full_sizes[c.name])
        car = carries.get(c.name)
        if car is not None and car.pos is not None:
            # only iteration 0 of a carried entry is materialised
            sizes[car.pos] = 1
        sizes_t = tuple(sizes)
        base_of[c.name] = base
        if c.kind is Kind.DATA:
            groups.append(InstanceGroup(
                name=c.name, base=base, sizes=sizes_t, kind=KIND_DATA,
                app=None, payload_kind=c.payload_kind, execution_time=0.0,
                data_volume=float(c.data_volume), error_threshold=0.0,
                params=dict(c.params)))
        else:
            groups.append(InstanceGroup(
                name=c.name, base=base, sizes=sizes_t, kind=KIND_APP,
                app=c.app, payload_kind="memory",
                execution_time=float(c.execution_time), data_volume=0.0,
                error_threshold=c.error_threshold, params=dict(c.params)))
        base += groups[-1].count
    n = base

    kind = np.empty(n, dtype=np.uint8)
    ex = np.zeros(n, dtype=np.float64)
    vol = np.zeros(n, dtype=np.float64)
    for g in groups:
        kind[g.base:g.base + g.count] = g.kind
        ex[g.base:g.base + g.count] = g.execution_time
        vol[g.base:g.base + g.count] = g.data_volume

    def drop_loop_digit(lin: np.ndarray, name: str, pos: int) -> np.ndarray:
        """Full-axes linear index -> instantiated index of a carried entry
        (remove the loop digit; caller guarantees its coordinate is 0)."""
        st = full_strides[name][pos]
        sz = full_sizes[name][pos]
        return (lin // (st * sz)) * st + lin % st

    # expansion arithmetic runs in int64 (safe for any index products);
    # the *stored* per-edge results are narrowed to int32 whenever the
    # drop count fits — at the 10M tier this halves the peak footprint
    # of the accumulated edge lists
    idx_dtype = np.int32 if n <= np.iinfo(np.int32).max else np.int64
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    strs: List[np.ndarray] = []
    # per-logical-edge expansion emits each (src, dst) pair at most once
    # (unlike the dict path's coordinate walk, the index arithmetic never
    # revisits a pair), so the global dedup pass is only needed when two
    # logical edges could collide (duplicate logical connections) or when
    # iteration aliasing rewrites ids (conservative)
    seen_pairs: set = set()
    need_dedup = bool(carries)
    for e in lg.edges:
        pair = (e.src, e.dst, e.streaming)
        need_dedup = need_dedup or pair in seen_pairs
        seen_pairs.add(pair)
        s_axes, d_axes = axes_of[e.src], axes_of[e.dst]
        # exit_pin: a loop_exit consumed outside its loop contributes only
        # the final iteration (same rule as the dict path)
        pin: Optional[Dict[str, int]] = None
        src_c = lg.constructs[e.src]
        if src_c.kind is Kind.DATA and src_c.loop_exit:
            loops = [a for a in lg.ancestors(e.src) if a.kind is Kind.LOOP]
            d_axis_names = {a.underlying for a in d_axes}
            if loops and loops[-1].name not in d_axis_names:
                last_t = loops[-1].num_of_iterations - 1
                for a in s_axes:
                    if a.underlying == loops[-1].name:
                        pin = {a.underlying: a.to_index(last_t)}
                        break
        try:
            s_lin, d_lin = _expand_edge(s_axes, d_axes, 0, 0, pin)
        except _NeedsFallback:
            return CompiledPGT.from_dict_pgt(unroll_dict(lg))

        # destination side: an aliased entry at t>0 receives nothing
        d_car = carries.get(e.dst)
        if d_car is not None and d_car.pos is not None:
            st = full_strides[e.dst][d_car.pos]
            sz = full_sizes[e.dst][d_car.pos]
            keep = (d_lin // st) % sz == 0
            if not keep.all():
                s_lin, d_lin = s_lin[keep], d_lin[keep]
            d_ids = base_of[e.dst] + drop_loop_digit(
                d_lin, e.dst, d_car.pos)
        else:
            d_ids = base_of[e.dst] + d_lin

        # source side: entry instances at t>0 alias the exit at t-1
        s_car = carries.get(e.src)
        if s_car is not None and s_car.pos is not None:
            st = full_strides[e.src][s_car.pos]
            sz = full_sizes[e.src][s_car.pos]
            t = (s_lin // st) % sz
            s_ids = base_of[e.src] + drop_loop_digit(
                s_lin, e.src, s_car.pos)
            sub = t > 0
            if sub.any():
                ent_axes = axes_of[e.src]
                pos_of = {a.underlying: i for i, a in enumerate(ent_axes)}
                ent_strides = full_strides[e.src]
                s_sub = s_lin[sub]
                ex_lin = np.zeros(s_sub.shape[0], dtype=np.int64)
                for a, stx in zip(axes_of[s_car.exit],
                                  full_strides[s_car.exit]):
                    if a.underlying == s_car.loop:
                        coord = t[sub] - 1
                    else:
                        i = pos_of[a.underlying]
                        coord = (s_sub // ent_strides[i]) \
                            % full_sizes[e.src][i]
                    ex_lin = ex_lin + coord * stx
                s_ids[sub] = base_of[s_car.exit] + ex_lin
        else:
            s_ids = base_of[e.src] + s_lin

        # aliasing can surface degenerate self-edges; the dict path skips
        # them (src_uid == dst_uid)
        if s_car is not None or d_car is not None:
            ok = s_ids != d_ids
            if not ok.all():
                s_ids, d_ids = s_ids[ok], d_ids[ok]

        srcs.append(s_ids.astype(idx_dtype, copy=False))
        dsts.append(d_ids.astype(idx_dtype, copy=False))
        strs.append(np.full(s_ids.shape[0], e.streaming, dtype=bool))

    if srcs:
        # release each chunk list as soon as its concatenation exists:
        # peak memory is one extra copy of one array, not of all three
        esrc = np.concatenate(srcs)
        srcs.clear()
        edst = np.concatenate(dsts)
        dsts.clear()
        estr = np.concatenate(strs)
        strs.clear()
        if need_dedup:
            # dedup (parallel logical edges / alias rewrites), like the
            # dict path's seen-set; canonical order is (src, dst).  The
            # packed key widens explicitly — int32 storage must not make
            # the key arithmetic wrap
            key = (esrc.astype(np.int64) * np.int64(n)
                   + edst) * 2 + estr
            _, first = np.unique(key, return_index=True)
            esrc, edst, estr = esrc[first], edst[first], estr[first]
    else:
        esrc = np.empty(0, dtype=np.int32)
        edst = np.empty(0, dtype=np.int32)
        estr = np.empty(0, dtype=bool)

    levels: Optional[np.ndarray] = None
    if not carries and all(g.count > 0 for g in groups):
        # Loop-free expansions are acyclic by construction (instance edges
        # follow the validated logical DAG), and every instance of a leaf
        # sits at the leaf's own longest-path depth: each instance
        # receives at least one predecessor instance per logical in-edge
        # (shared axes align, missing axes broadcast or consume — never an
        # empty join).  So the Kahn levels collapse to a leaf-graph pass +
        # one repeat, skipping the O(V+E) validation walk entirely.
        leaf_lv = {c.name: 0 for c in leaves}
        indeg = {c.name: 0 for c in leaves}
        succ: Dict[str, List[str]] = {c.name: [] for c in leaves}
        for e in lg.edges:
            succ[e.src].append(e.dst)
            indeg[e.dst] += 1
        queue = [name for name, d in indeg.items() if d == 0]
        while queue:
            u = queue.pop()
            for v in succ[u]:
                if leaf_lv[u] + 1 > leaf_lv[v]:
                    leaf_lv[v] = leaf_lv[u] + 1
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
        # int32 to match the vectorized Kahn's level dtype (level depth
        # is bounded by the drop count, which fits int32 by construction)
        levels = np.repeat(
            np.fromiter((leaf_lv[g.name] for g in groups), dtype=np.int32,
                        count=len(groups)),
            np.fromiter((g.count for g in groups), dtype=np.int64,
                        count=len(groups)))

    return CompiledPGT(lg.name, groups, kind, ex, vol, esrc, edst, estr,
                       levels=levels)


def unroll(lg: LogicalGraph) -> "CompiledPGT":
    """LG -> array-based physical graph template (the default path)."""
    return compile_unroll(lg)
