"""Scheduling cost model for partitioned physical graphs (paper §3.4–§3.5).

Estimates the makespan of a partitioned PGT under the paper's assumptions:

* intra-partition edges are free (drops are co-located),
* inter-partition edges cost ``data_volume / bandwidth`` (data movement),
* each partition executes at most ``DoP`` application drops concurrently,
* resources are homogeneous.

Two graph representations are supported and must agree exactly:

* the legacy dict-of-``DropSpec`` :class:`PhysicalGraphTemplate`,
* the array-based :class:`repro.core.pgt.CompiledPGT` (CSR adjacency).

Both run the *canonical* event-driven simulation below.  Determinism rules
(so the two paths produce bit-identical makespans):

* ties are broken by dense drop id == creation order (identical in both
  representations — leaves in ``lg.leaves()`` order, instances in C-order),
* at equal times, app completions are processed before readiness events,
* each partition's waiting queue pops by (enqueue time, drop id),
* empty PGTs have makespan / critical path 0.0; a single drop's makespan is
  its weight (these edge cases previously diverged between ``0.0`` and
  ``max()``-of-empty errors).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .pgt import KIND_DATA, CompiledPGT, _kahn_levels, coo_to_csr
from .substrate import level_structure as _level_structure
from .unroll import PhysicalGraphTemplate

DEFAULT_BANDWIDTH = 1e9   # bytes/s across partitions (homogeneous links)

_EV_DONE = 0     # app finished (frees a DoP slot) — processed first
_EV_READY = 1    # drop became ready


def edge_cost(pgt, src: str, dst: str,
              bandwidth: float = DEFAULT_BANDWIDTH) -> float:
    """Cost of an edge if it crosses partitions: moving the data payload."""
    s = pgt.drops[src]
    d = pgt.drops[dst]
    vol = s.data_volume if s.kind == "data" else d.data_volume
    return vol / bandwidth


# ---------------------------------------------------------------------------
# array extraction (shared by the canonical kernels)
# ---------------------------------------------------------------------------


class _Arrays:
    """Flat int/float arrays for one PGT, cached on the PGT object.

    ``partition`` is re-read on every use (it mutates between calls); the
    structural fields are extracted once.
    """

    __slots__ = ("n", "weight", "is_data", "esrc", "edst", "evol",
                 "levels", "_order", "_build_order", "_out_csr",
                 "_build_out_csr", "_lists", "_ecost_l", "_lvl_struct",
                 "_in_csr")

    def __init__(self) -> None:
        self._order = None      # topological order, lazy (rarely used)
        self._build_order = None
        self._out_csr = None    # (indptr, dst ids, eid) by source, lazy
        self._lists = None      # (weight, is_data, indptr, out_dst, preds)
        self._ecost_l = None    # (bandwidth, CSR-ordered edge costs)
        self._lvl_struct = None  # level-bucketed edge/node orders
        self._in_csr = None     # (indptr, src ids, eid) by destination

    @property
    def order(self) -> np.ndarray:
        if self._order is None:
            self._order = self._build_order()
        return self._order

    @order.setter
    def order(self, value: np.ndarray) -> None:
        self._order = value

    @property
    def out_indptr(self) -> np.ndarray:
        return self.out_csr()[0]

    @property
    def out_dst(self) -> np.ndarray:
        return self.out_csr()[1]

    @property
    def out_eid(self) -> np.ndarray:
        return self.out_csr()[2]

    def out_csr(self):
        """Forward CSR, built on first use — the large-graph estimator
        path never touches it unless a delta propagation runs."""
        if self._out_csr is None:
            self._out_csr = self._build_out_csr()
        return self._out_csr

    def partition_of(self, pgt) -> np.ndarray:
        if isinstance(pgt, CompiledPGT):
            return pgt.partition
        part = np.empty(self.n, dtype=np.int64)
        for i, spec in enumerate(pgt.drops.values()):
            part[i] = spec.partition
        return part

    def sim_lists(self, bandwidth: float):
        """Python-list views of the static simulation inputs, cached —
        only the partition labels change between simulate calls."""
        if self._lists is None:
            self._lists = (
                self.weight.tolist(), self.is_data.tolist(),
                self.out_indptr.tolist(), self.out_dst.tolist(),
                np.bincount(self.edst, minlength=self.n).tolist())
        if self._ecost_l is None or self._ecost_l[0] != bandwidth:
            self._ecost_l = (
                bandwidth, (self.evol / bandwidth)[self.out_eid].tolist())
        return self._lists + (self._ecost_l[1],)

    def level_structure(self):
        """Level-bucketed edge and node orders for the critical-path pass.

        Partition-independent (only edge *costs* change between calls), so
        it is computed once per PGT and shared by every evaluation — the
        prefix sweep in ``min_time`` used to redo these argsorts at every
        checkpoint.  Returns ``(esrc_s, edst_s, eid_s, bounds, node_order,
        nbounds, max_level)``; the edge triplets are sorted by destination
        level with ``bounds[lv]:bounds[lv+1]`` slicing out one level.
        """
        if self._lvl_struct is None:
            # the computation lives in core/substrate.py — it is the
            # partition-independent piece of the shared level substrate
            self._lvl_struct = _level_structure(self.levels, self.esrc,
                                                self.edst, self.n)
        return self._lvl_struct

    def in_csr(self):
        """(indptr, src ids, COO edge ids) sorted by destination."""
        if self._in_csr is None:
            self._in_csr = coo_to_csr(self.n, self.edst, self.esrc)
        return self._in_csr


def _extract(pgt) -> _Arrays:
    cached = getattr(pgt, "_sched_arrays", None)
    if cached is not None:
        return cached
    a = _Arrays()
    if isinstance(pgt, CompiledPGT):
        a.n = pgt.num_drops
        a.weight = pgt.weight_arr
        a.is_data = pgt.kind_arr == KIND_DATA
        # int32 stays int32: every consumer (bincount, level bucketing,
        # PrefixCP gathers, coo_to_csr) is dtype-generic, and the 10M
        # tier saves two 80MB widening copies here
        a.esrc = pgt.edge_src
        a.edst = pgt.edge_dst
        a.evol = pgt.edge_volumes()
        a.levels = pgt.topo_levels()
        a._build_order = pgt.topological_order_ids
    else:
        ids: Dict[str, int] = {u: i for i, u in enumerate(pgt.drops)}
        a.n = len(ids)
        a.weight = np.fromiter(
            (s.weight() for s in pgt.drops.values()), dtype=np.float64,
            count=a.n)
        a.is_data = np.fromiter(
            (s.kind == "data" for s in pgt.drops.values()), dtype=bool,
            count=a.n)
        ne = len(pgt.edges)
        a.esrc = np.empty(ne, dtype=np.int64)
        a.edst = np.empty(ne, dtype=np.int64)
        a.evol = np.empty(ne, dtype=np.float64)
        drops = pgt.drops
        for k, (s, d, _) in enumerate(pgt.edges):
            si, di = ids[s], ids[d]
            a.esrc[k] = si
            a.edst[k] = di
            ss = drops[s]
            a.evol[k] = (ss.data_volume if ss.kind == "data"
                         else drops[d].data_volume)
        a.order, a.levels = _kahn_levels(a.n, a.esrc, a.edst)
    if isinstance(pgt, CompiledPGT):
        a._build_out_csr = pgt.out_csr_with_eid
    else:
        a._build_out_csr = lambda: coo_to_csr(a.n, a.esrc, a.edst)
    try:
        pgt._sched_arrays = a
    except AttributeError:  # pragma: no cover - slots-only containers
        pass
    return a


# NOTE: structural mutation invalidates this cache at the mutation sites —
# PhysicalGraphTemplate.add_drop/add_edge pop ``_sched_arrays`` directly.

# ---------------------------------------------------------------------------
# critical path (vectorized, level-synchronous)
# ---------------------------------------------------------------------------


def _critical_path_dist(a: _Arrays, part: Optional[np.ndarray],
                        bandwidth: float) -> np.ndarray:
    """Per-drop longest-path finish time; edges cost vol/bandwidth when
    crossing partitions (or always, when ``part`` is None — the
    unpartitioned bound).  Level-synchronous over the cached
    :meth:`_Arrays.level_structure` — no per-call argsorts."""
    dist = np.zeros(a.n, dtype=np.float64)
    if a.n == 0:
        return dist
    esrc_s, edst_s, e_order, bounds, node_order, nbounds, max_lv = \
        a.level_structure()
    ecost = a.evol / bandwidth
    if part is not None and a.esrc.size:
        ecost = ecost * (part[a.esrc] != part[a.edst])
    ecost_s = ecost[e_order]
    best = np.zeros(a.n, dtype=np.float64)
    for lv in range(max_lv + 1):
        nodes = node_order[nbounds[lv]:nbounds[lv + 1]]
        if lv > 0 and bounds is not None and lv < len(bounds) - 1:
            lo, hi = bounds[lv], bounds[lv + 1]
            if hi > lo:
                np.maximum.at(best, edst_s[lo:hi],
                              dist[esrc_s[lo:hi]] + ecost_s[lo:hi])
        dist[nodes] = best[nodes] + a.weight[nodes]
    return dist


def _critical_path_arrays(a: _Arrays, part: Optional[np.ndarray],
                          bandwidth: float) -> float:
    if a.n == 0:
        return 0.0
    return float(_critical_path_dist(a, part, bandwidth).max())


class PrefixCP:
    """Incremental partitioned critical-path evaluator.

    Tracks the longest-path state (per-drop finish times) across a
    *sequence* of label assignments over one graph.  Each
    :meth:`evaluate` call recomputes only the region downstream of edges
    whose partition-crossing status changed since the previous call —
    during ``min_time``'s prefix sweep the merges are monotone (edges only
    become internal), so consecutive checkpoints share almost all of their
    critical-path state.  Arbitrary relabelings (e.g. ``min_res`` fold
    probes) are also handled — recompute cost stays proportional to the
    affected region, degrading to one full pass at worst.  Every step is
    exactly equivalent to ``_critical_path_arrays(a, labels, bandwidth)``.
    """

    def __init__(self, a: _Arrays, bandwidth: float) -> None:
        self.a = a
        self.bandwidth = bandwidth
        self._ecost = a.evol / bandwidth
        # a zero-cost edge contributes nothing whether it crosses or not —
        # its status changes can never move the critical path, so the
        # delta pass ignores them outright (app->data edges of volume-0
        # drops are common, and entire cost-free graphs short-circuit)
        self._costly = self._ecost != 0.0
        self._has_costly = bool(self._costly.any())
        # a graph with no costly edges AND no weights schedules to 0.0
        # under any labelling — the degenerate overhead-bench shape
        self._zero = (not self._has_costly
                      and (a.n == 0 or float(a.weight.max()) == 0.0))
        self._cross: Optional[np.ndarray] = None   # per-edge crossing mask
        self._dist: Optional[np.ndarray] = None
        self._in: Optional[Tuple[np.ndarray, ...]] = None
        self.delta_evals = 0      # instrumentation: delta vs full passes
        self.full_evals = 0

    # -- internals ---------------------------------------------------------
    def _full(self, labels: Optional[np.ndarray]) -> float:
        self._dist = _critical_path_dist(self.a, labels, self.bandwidth)
        self.full_evals += 1
        return float(self._dist.max()) if self.a.n else 0.0

    def _push(self, pend: Dict[int, List[np.ndarray]],
              nodes: np.ndarray) -> None:
        ls = self.a.levels[nodes]
        order = np.argsort(ls, kind="stable")
        nodes, ls = nodes[order], ls[order]
        cuts = np.flatnonzero(np.diff(ls)) + 1
        starts = np.concatenate(([0], cuts))
        for chunk, lv in zip(np.split(nodes, cuts), ls[starts]):
            pend.setdefault(int(lv), []).append(chunk)

    def evaluate(self, labels: Optional[np.ndarray]) -> float:
        a = self.a
        if a.n == 0 or self._zero:
            return 0.0
        if self._dist is not None and not self._has_costly:
            # crossing-status changes cannot move any path cost
            return float(self._dist.max())
        if a.esrc.size == 0:
            cross = np.empty(0, dtype=bool)
        elif labels is None:
            cross = np.ones(a.esrc.shape[0], dtype=bool)
        else:
            cross = labels[a.esrc] != labels[a.edst]
        if self._dist is None:
            self._cross = cross
            return self._full(labels)
        changed = np.flatnonzero((cross != self._cross) & self._costly)
        self._cross = cross
        if changed.size == 0:
            return float(self._dist.max())
        self.delta_evals += 1
        return self._propagate(np.unique(a.edst[changed]))

    def _propagate(self, seeds: np.ndarray) -> float:
        """Level-ordered recompute of ``dist`` for ``seeds`` and whatever
        their changes reach downstream."""
        a = self.a
        dist = self._dist
        cross = self._cross
        assert dist is not None and cross is not None
        if a.esrc.size == 0:
            np.copyto(dist, a.weight)
            return float(dist.max())
        if self._in is None:
            in_indptr, in_src, in_eid = a.in_csr()
            self._in = (in_indptr, in_src, in_eid, self._ecost[in_eid])
        in_indptr, in_src, in_eid, in_cost = self._in
        pend: Dict[int, List[np.ndarray]] = {}
        self._push(pend, seeds)
        while pend:
            lv = min(pend)
            nodes = np.unique(np.concatenate(pend.pop(lv)))
            starts = in_indptr[nodes]
            cnt = in_indptr[nodes + 1] - starts
            new = a.weight[nodes].copy()    # no-pred base: weight alone
            total = int(cnt.sum())
            if total:
                reps = np.repeat(
                    starts - np.concatenate(([0], np.cumsum(cnt)[:-1])),
                    cnt)
                pos = np.arange(total, dtype=np.int64) + reps
                cand = dist[in_src[pos]] \
                    + in_cost[pos] * cross[in_eid[pos]]
                nz = cnt > 0
                row_start = np.concatenate(([0], np.cumsum(cnt)[:-1]))
                new[nz] = np.maximum.reduceat(cand, row_start[nz]) \
                    + a.weight[nodes[nz]]
            moved = new != dist[nodes]
            if moved.any():
                chn = nodes[moved]
                dist[chn] = new[moved]
                s0 = a.out_indptr[chn]
                c0 = a.out_indptr[chn + 1] - s0
                tot = int(c0.sum())
                if tot:
                    reps = np.repeat(
                        s0 - np.concatenate(([0], np.cumsum(c0)[:-1])), c0)
                    pos2 = np.arange(tot, dtype=np.int64) + reps
                    self._push(pend, np.unique(a.out_dst[pos2]))
        return float(dist.max())


def critical_path(pgt, bandwidth: float = DEFAULT_BANDWIDTH,
                  partitioned: bool = True) -> float:
    """Longest path through the DAG (execution + cross-partition movement)."""
    a = _extract(pgt)
    part = a.partition_of(pgt) if partitioned else None
    return _critical_path_arrays(a, part, bandwidth)


# ---------------------------------------------------------------------------
# canonical makespan simulation
# ---------------------------------------------------------------------------


def _simulate_arrays(a: _Arrays, part: np.ndarray, dop: int,
                     bandwidth: float) -> float:
    """Canonical list-scheduling event simulation over int drop ids."""
    n = a.n
    if n == 0:
        return 0.0
    # plain python lists: ~5x faster scalar access than numpy in this loop
    weight, is_data, indptr, out_dst, preds0, ecost = a.sim_lists(bandwidth)
    partl = part.tolist() if isinstance(part, np.ndarray) else list(part)
    preds_left = list(preds0)
    ready_at = [0.0] * n

    evq: List[Tuple[float, int, int]] = []
    running: Dict[int, int] = {}
    waiting: Dict[int, List[Tuple[float, int]]] = {}
    makespan = 0.0

    for u in range(n):
        if preds_left[u] == 0:
            evq.append((0.0, _EV_READY, u))
    heapq.heapify(evq)

    def complete(u: int, t: float) -> None:
        nonlocal makespan
        if t > makespan:
            makespan = t
        pu = partl[u]
        for j in range(indptr[u], indptr[u + 1]):
            s = out_dst[j]
            cost = ecost[j] if partl[s] != pu else 0.0
            ra = t + cost
            if ra > ready_at[s]:
                ready_at[s] = ra
            preds_left[s] -= 1
            if preds_left[s] == 0:
                heapq.heappush(evq, (ready_at[s], _EV_READY, s))

    def try_start(p: int, t: float) -> None:
        q = waiting.get(p)
        while q and running.get(p, 0) < dop:
            _, u = heapq.heappop(q)
            running[p] = running.get(p, 0) + 1
            heapq.heappush(evq, (t + weight[u], _EV_DONE, u))

    while evq:
        t, kind, u = heapq.heappop(evq)
        if kind == _EV_DONE:
            p = partl[u]
            running[p] -= 1
            complete(u, t)
            try_start(p, t)
            continue
        if is_data[u] or weight[u] == 0.0:
            complete(u, t)
            continue
        p = partl[u]
        heapq.heappush(waiting.setdefault(p, []), (t, u))
        try_start(p, t)

    return makespan


def simulate_makespan(pgt, dop: int,
                      bandwidth: float = DEFAULT_BANDWIDTH) -> float:
    """List-scheduling simulation honouring the per-partition DoP cap.

    Event-driven: an app drop becomes ready when all its predecessors
    finished (plus cross-partition transfer latency); each partition runs
    at most ``dop`` apps at once.  Data drops are free.  Works identically
    for dict-based and array-based PGTs (see module docstring).
    """
    a = _extract(pgt)
    return _simulate_arrays(a, a.partition_of(pgt), dop, bandwidth)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


def partition_stats(pgt) -> Dict[str, float]:
    if isinstance(pgt, CompiledPGT):
        if pgt.num_drops == 0:
            return {"num_partitions": 0.0, "cross_volume": 0.0,
                    "max_load": 0.0, "mean_load": 0.0, "imbalance": 1.0}
        ids, loads = pgt.partition_loads(pgt.weight_arr)
        part = pgt.partition
        cross = part[pgt.edge_src] != part[pgt.edge_dst]
        cross_volume = float(pgt.edge_volumes()[cross].sum())
        nump = float(ids.size)
    else:
        parts: Dict[int, float] = {}
        for uid, spec in pgt.drops.items():
            parts[spec.partition] = (parts.get(spec.partition, 0.0)
                                     + spec.weight())
        cross_volume = 0.0
        for s, d, _ in pgt.edges:
            if pgt.drops[s].partition != pgt.drops[d].partition:
                sp = pgt.drops[s]
                cross_volume += (sp.data_volume if sp.kind == "data"
                                 else pgt.drops[d].data_volume)
        loads = list(parts.values())
        nump = float(len(parts))
    loads = list(np.asarray(loads, dtype=np.float64)) or [0.0]
    return {
        "num_partitions": nump,
        "cross_volume": cross_volume,
        "max_load": float(max(loads)),
        "mean_load": float(sum(loads) / len(loads)),
        "imbalance": float(max(loads) / max(sum(loads) / len(loads), 1e-12)),
    }
