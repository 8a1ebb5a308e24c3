"""Resource mapping: PGT partitions -> physical nodes (paper §3.5).

"We use the METIS software library, which internally uses a multilevel k-way
partitioning algorithm, to merge the p PGT partitions into m virtual clusters
if p > m ... with the goal of balancing the overall workload (both compute
time and memory usage) evenly.  The physical mapping from the m merged
clusters to m compute nodes becomes a straightforward round-robin assignment."

Two implementations share the objective ``alpha * imbalance + beta * cut``:

* ``mapping="csr"`` (default) — array-native multilevel scheme over the
  partition hierarchy ``min_time`` records while merging
  (:class:`~repro.core.substrate.PartitionHierarchy`; the flat
  :meth:`~repro.core.pgt.CompiledPGT.partition_graph_arrays` extraction
  is the fallback when no fresh hierarchy exists):

  1. **Coarsen**: start from the recorded merge hierarchy — translate
     already coarsened this graph, so the mapper re-uses its levels —
     and extend it past the coarsest recorded level with rounds of
     vectorized *heavy-edge matching* (every vertex picks its heaviest
     incident edge, ties broken toward the lighter partner; mutual picks
     contract; re-aggregation via ``np.unique``/``np.bincount``) until
     <= m super-vertices or the positive-weight edges run out.
  2. **Assign**: longest-processing-time greedy of the coarsest level
     onto nodes.  Loads carry a drop-count epsilon, so
     *zero-communication / zero-weight* components (where every
     tie-break used to collapse the whole graph onto node0) spread ~1/m
     per node by count.
  3. **Uncoarsen + refine**: project the assignment back down the
     chain one level at a time, running the vectorized Kernighan–Lin
     best-move greedy at *every* level (``refine_levels="all"``) —
     coarse moves relocate whole clusters that single fine-level moves
     cannot, which is where cut quality is won on communication-heavy
     graphs (``refine_levels="finest"`` restores the old single-level
     behaviour).

* ``mapping="dict"`` — the original dict-of-dicts implementation, kept as
  the semantic oracle (``tests/test_mapping_balance.py`` checks the CSR
  mapper never produces a materially worse objective).

Both paths accept either PGT representation; the CSR path extracts the
partition graph vectorized from a ``CompiledPGT`` and via the dict walk
otherwise (loop-carried graphs still unroll into dict PGTs).
"""
from __future__ import annotations

import heapq
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pgt import KIND_DATA, CompiledPGT
from .substrate import HierarchyLevel
from .unroll import PhysicalGraphTemplate

# drop-count tie-break scale: small enough never to outweigh a real load
# difference, large enough to order pure-count ties (see _chain_loads)
_COUNT_EPS = 1e-9


@dataclass
class NodeInfo:
    """A homogeneous compute node (paper assumes identical capabilities)."""

    name: str
    island: str = "island0"
    alive: bool = True


@dataclass
class PartitionGraph:
    vweights: Dict[int, float] = field(default_factory=dict)       # load
    vmem: Dict[int, float] = field(default_factory=dict)           # memory
    eweights: Dict[Tuple[int, int], float] = field(default_factory=dict)

    @classmethod
    def from_pgt(cls, pgt) -> "PartitionGraph":
        if isinstance(pgt, CompiledPGT):
            return cls._from_compiled(pgt)
        g = cls()
        for spec in pgt.drops.values():
            g.vweights[spec.partition] = (
                g.vweights.get(spec.partition, 0.0) + spec.weight())
            g.vmem[spec.partition] = (
                g.vmem.get(spec.partition, 0.0) +
                (spec.data_volume if spec.kind == "data" else 0.0))
        for s, d, _ in pgt.edges:
            ps, pd = pgt.drops[s].partition, pgt.drops[d].partition
            if ps == pd:
                continue
            key = (min(ps, pd), max(ps, pd))
            vol = (pgt.drops[s].data_volume if pgt.drops[s].kind == "data"
                   else pgt.drops[d].data_volume)
            g.eweights[key] = g.eweights.get(key, 0.0) + vol
        return g

    @classmethod
    def _from_compiled(cls, pgt: CompiledPGT) -> "PartitionGraph":
        """Dict view of the vectorized partition-graph extraction."""
        g = cls()
        ids, load, mem, _, eu, ev, ew = pgt.partition_graph_arrays()
        for p, wv, mv in zip(ids.tolist(), load.tolist(), mem.tolist()):
            g.vweights[p] = float(wv)
            g.vmem[p] = float(mv)
        labels = ids.tolist()
        for a, b, v in zip(eu.tolist(), ev.tolist(), ew.tolist()):
            g.eweights[(labels[a], labels[b])] = float(v)
        return g


class PartitionArrays:
    """The partition-level graph as flat arrays — the CSR mapper's input.

    * ``ids``   — occurring partition labels, sorted,
    * ``load`` / ``mem`` / ``count`` — per-partition app weight, data
      volume, drop count,
    * ``eu`` / ``ev`` / ``ew`` — unique undirected cross-partition edges
      (indices into ``ids``, ``eu < ev``) with summed volumes.
    """

    __slots__ = ("ids", "load", "mem", "count", "eu", "ev", "ew")

    def __init__(self, ids, load, mem, count, eu, ev, ew) -> None:
        self.ids = ids
        self.load = load
        self.mem = mem
        self.count = count
        self.eu = eu
        self.ev = ev
        self.ew = ew

    @classmethod
    def from_pgt(cls, pgt) -> "PartitionArrays":
        if isinstance(pgt, CompiledPGT):
            return cls(*pgt.partition_graph_arrays())
        # dict PGTs (loop-carried graphs): one spec walk, then arrays
        g = PartitionGraph.from_pgt(pgt)
        counts: Counter = Counter(
            s.partition for s in pgt.drops.values())
        labels = sorted(g.vweights)
        index = {p: i for i, p in enumerate(labels)}
        npart = len(labels)
        ids = np.asarray(labels, dtype=np.int64)
        load = np.fromiter((g.vweights[p] for p in labels),
                           dtype=np.float64, count=npart)
        mem = np.fromiter((g.vmem[p] for p in labels),
                          dtype=np.float64, count=npart)
        count = np.fromiter((counts[p] for p in labels),
                            dtype=np.int64, count=npart)
        ne = len(g.eweights)
        eu = np.fromiter((index[a] for a, _ in g.eweights),
                         dtype=np.int64, count=ne)
        ev = np.fromiter((index[b] for _, b in g.eweights),
                         dtype=np.int64, count=ne)
        ew = np.fromiter(g.eweights.values(), dtype=np.float64, count=ne)
        return cls(ids, load, mem, count, eu, ev, ew)


def _validate(nodes: Sequence[NodeInfo],
              refine_iters: int) -> List[NodeInfo]:
    """Shared argument validation (both mapper paths).

    Duplicate node names used to silently collapse via dict keying (two
    ``NodeInfo("n0")`` entries looked like one node with doubled
    capacity); a negative ``refine_iters`` silently skipped refinement.
    """
    if refine_iters < 0:
        raise ValueError(
            f"refine_iters must be >= 0, got {refine_iters}")
    counts = Counter(n.name for n in nodes)
    dupes = sorted(name for name, c in counts.items() if c > 1)
    if dupes:
        raise ValueError(f"duplicate node names: {dupes}")
    live = [n for n in nodes if n.alive]
    if not live:
        raise ValueError("no live nodes to map onto")
    return live


def map_partitions(pgt, nodes: Sequence[NodeInfo],
                   alpha: float = 1.0, beta: float = 1e-9,
                   refine_iters: int = 200,
                   mapping: str = "csr",
                   refine_levels: str = "all",
                   refine_mode: str = "worklist",
                   level_stats: Optional[List[Dict[str, float]]] = None
                   ) -> Dict[int, str]:
    """Assign each PGT partition to a node; also stamps ``spec.node``.

    ``mapping="csr"`` (default) runs the array-native multilevel mapper;
    ``mapping="dict"`` runs the original dict implementation (the
    semantic oracle, fine to ~10^4 partitions).

    ``refine_levels`` controls the uncoarsening pass of the CSR path:
    ``"all"`` (default) runs KL refinement at every level of the
    coarsening chain while projecting the assignment down;
    ``"finest"`` refines only at the finest level (the pre-substrate
    behaviour).  ``refine_mode`` selects the KL inner loop:
    ``"worklist"`` (default) maintains the cut-to-node table
    incrementally, touching only the moved vertex's neighbourhood per
    move; ``"sweep"`` rebuilds it from the full edge list every round
    (the pre-worklist behaviour, kept as the oracle).  When
    ``level_stats`` is a list it receives one dict per refined level —
    cut and imbalance before/after refinement plus the refine wall —
    for diagnostics (``bench_partition.py --verbose-partition``).
    """
    live = _validate(nodes, refine_iters)
    if refine_mode not in ("sweep", "worklist"):
        raise ValueError(f"unknown refine_mode {refine_mode!r}")
    if mapping == "dict":
        return _map_partitions_dict(pgt, live, alpha, beta, refine_iters)
    if mapping != "csr":
        raise ValueError(f"unknown mapping {mapping!r}")
    if refine_levels not in ("all", "finest"):
        raise ValueError(f"unknown refine_levels {refine_levels!r}")
    m = len(live)
    # min_time records its merge hierarchy (core/substrate.py): the
    # finest partition graph AND its coarser levels arrive pre-built.
    # Fall back to the flat extraction when the hierarchy is absent
    # (dict PGTs, min_res, manual labels) or stale (partition mutated
    # since — annealing, DropView writes)
    hier = getattr(pgt, "_partition_hierarchy", None)
    if hier is not None and hier.matches(pgt):
        levels = list(hier.levels)
        ids = np.arange(levels[0].num_vertices, dtype=np.int64)
    else:
        g = PartitionArrays.from_pgt(pgt)
        levels = [HierarchyLevel(g.load, g.mem, g.count, g.eu, g.ev, g.ew)]
        ids = g.ids
    npart = int(ids.size)
    if npart == 0:
        stamp_nodes(pgt, {})
        return {}
    lw = _chain_loads(levels)
    edges = [(l.eu, l.ev, l.ew) for l in levels]
    parents = [l.parent for l in levels[:-1]]
    # 1. coarsen: extend the recorded chain past its coarsest level with
    #    vectorized heavy-edge matching until <= m super-vertices
    for parent, clw, ceu, cev, cew in _hem_levels(lw[-1], *edges[-1], m):
        parents.append(parent)
        lw.append(clw)
        edges.append((ceu, cev, cew))
    # 2. initial assignment: LPT greedy of the coarsest level onto nodes
    a = _lpt_assign(lw[-1], m)
    # 3. uncoarsen: project down one level at a time, KL-refining off
    #    each level's own edge arrays (coarse moves relocate whole
    #    clusters that single finest-level moves cannot reach)
    top = len(lw) - 1
    for i in range(top, -1, -1):
        if i < top:
            a = a[parents[i]]
        if refine_levels == "all" or i == 0:
            eu, ev, ew = edges[i]
            before = (_level_stat(lw[i], a, m, eu, ev, ew)
                      if level_stats is not None else None)
            t0 = time.monotonic()
            _refine_arrays(lw[i], a, m, eu, ev, ew, alpha, beta,
                           refine_iters, refine_mode)
            refine_s = time.monotonic() - t0
            if before is not None:
                after = _level_stat(lw[i], a, m, eu, ev, ew)
                level_stats.append({
                    "level": i, "vertices": int(lw[i].size),
                    "edges": int(eu.size),
                    "cut_before": before[0], "cut_after": after[0],
                    "imbalance_before": before[1],
                    "imbalance_after": after[1],
                    "refine_s": refine_s})
    assign = {int(p): live[int(j)].name
              for p, j in zip(ids.tolist(), a.tolist())}
    stamp_nodes(pgt, assign)
    return assign


def _chain_loads(levels: Sequence[HierarchyLevel]) -> List[np.ndarray]:
    """Per-level effective load vectors with a drop-count tie-break.

    A uniform zero-weight graph has every partition load 0; every greedy
    decision then ties and historically resolved to node0 — the whole
    graph piled onto one node.  Adding a count term that is *tiny
    relative to the mean positive load* (or the count itself when no
    load exists) makes balance-by-count the tie-break without measurably
    distorting weighted graphs.

    The coefficients are fixed at the finest level; the loads are then
    linear in ``(load, mem, count)``, so projecting a level's loads
    through its parent map reproduces the coarser level's exactly —
    refinement sees consistent balance bookkeeping at every level.
    """
    base = levels[0]
    load0 = base.load + 1e-6 * base.mem
    total = float(load0.sum())
    if total <= 0.0:
        return [l.count.astype(np.float64) for l in levels]
    eps = (total / max(float(base.count.sum()), 1.0)) * _COUNT_EPS
    return [(l.load + 1e-6 * l.mem) + eps * l.count for l in levels]


def _level_stat(w: np.ndarray, a: np.ndarray, m: int, eu: np.ndarray,
                ev: np.ndarray, ew: np.ndarray) -> Tuple[float, float]:
    """(cut volume, load imbalance) of assignment ``a`` on one level."""
    cut = float(ew[a[eu] != a[ev]].sum()) if ew.size else 0.0
    loads = np.zeros(m, dtype=np.float64)
    np.add.at(loads, a, w)
    imb = float(loads.max() / max(float(loads.mean()), 1e-12))
    return cut, imb


def _hem_levels(lw: np.ndarray, eu: np.ndarray, ev: np.ndarray,
                ew: np.ndarray, m: int
                ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]]:
    """Vectorized heavy-edge-matching coarsening, one chain level per round.

    Rounds of parallel matching: every vertex nominates the neighbour
    across its heaviest positive edge (ties toward the lighter partner —
    load-aware, so merged loads stay even), mutual nominations contract.
    Merges per round are capped at ``nv - m`` (heaviest matched edges
    first), so coarsening never overshoots below ``m`` vertices.  Each
    round is O(E log E) numpy work; rounds are O(log P) in practice.

    Merged loads are capped at the balanced per-node share
    (``sum(lw)/m``): a pair whose combined load would exceed it does not
    contract.  Without the cap a connected uniform graph coarsens into
    one giant super-vertex that no amount of single-move refinement can
    re-spread — the multilevel analogue of the node0 pile-up.

    Returns one ``(parent, load, eu, ev, ew)`` record per round —
    ``parent`` maps the previous level's vertices to the new one's, the
    rest is the new level's graph — ready to splice onto the recorded
    hierarchy chain.  Zero-weight edges never match — disconnected /
    zero-communication components are left to the load-aware LPT
    assignment (and contribute nothing to any cut, so dropping them from
    the per-level refinement edges is exact).
    """
    out: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                    np.ndarray]] = []
    pos = ew > 0.0
    ceu = eu[pos].astype(np.int64, copy=True)
    cev = ev[pos].astype(np.int64, copy=True)
    cew = ew[pos].astype(np.float64, copy=True)
    cload = lw.astype(np.float64, copy=True)
    cap = float(cload.sum()) / max(m, 1)
    nv = int(lw.size)
    while nv > m and ceu.size:
        src = np.concatenate([ceu, cev])
        dst = np.concatenate([cev, ceu])
        w = np.concatenate([cew, cew])
        # per-vertex heaviest incident edge; equal weights prefer the
        # lighter partner, then the smaller id (deterministic)
        order = np.lexsort((-dst, -cload[dst], w, src))
        s_srt = src[order]
        last = np.flatnonzero(np.r_[s_srt[1:] != s_srt[:-1], True])
        choice = np.full(nv, -1, dtype=np.int64)
        bestw = np.zeros(nv, dtype=np.float64)
        choice[s_srt[last]] = dst[order][last]
        bestw[s_srt[last]] = w[order][last]
        cand = np.flatnonzero(choice >= 0)
        mutual = cand[choice[choice[cand]] == cand]
        pu = mutual[mutual < choice[mutual]]
        if pu.size:
            pv = choice[pu]
            fits = cload[pu] + cload[pv] <= cap     # balance constraint
            pu, pv = pu[fits], pv[fits]
        if pu.size == 0:
            break
        if pu.size > nv - m:      # don't coarsen below m vertices
            keep = np.argsort(-bestw[pu], kind="stable")[:nv - m]
            pu, pv = pu[keep], pv[keep]
        merge_map = np.arange(nv, dtype=np.int64)
        merge_map[pv] = pu        # matched pairs are disjoint
        uniq, new_of = np.unique(merge_map, return_inverse=True)
        nv = int(uniq.size)
        cload = np.bincount(new_of, weights=cload, minlength=nv)
        ceu, cev = new_of[ceu], new_of[cev]
        live_e = ceu != cev
        if live_e.any():
            lo = np.minimum(ceu[live_e], cev[live_e])
            hi = np.maximum(ceu[live_e], cev[live_e])
            key = lo * np.int64(nv) + hi
            uk, inv_k = np.unique(key, return_inverse=True)
            cew = np.bincount(inv_k, weights=cew[live_e])
            ceu, cev = uk // nv, uk % nv
        else:
            ceu = cev = np.empty(0, dtype=np.int64)
            cew = np.empty(0, dtype=np.float64)
        out.append((new_of, cload, ceu, cev, cew))
    return out


def _lpt_assign(gload: np.ndarray, m: int) -> np.ndarray:
    """Longest-processing-time greedy: groups (descending load) onto the
    currently lightest node.  All-equal loads short-circuit to an exact
    round-robin (the common zero-weight / uniform case, vectorized)."""
    ngroups = gload.size
    a = np.zeros(ngroups, dtype=np.int64)
    if ngroups == 0 or m <= 1:
        return a
    order = np.argsort(-gload, kind="stable")
    spread = float(gload.max() - gload.min()) if ngroups else 0.0
    if spread <= 1e-12 * max(abs(float(gload.max())), 1.0):
        a[order] = np.arange(ngroups, dtype=np.int64) % m
        return a
    heap: List[Tuple[float, int]] = [(0.0, j) for j in range(m)]
    for gi in order.tolist():
        load, j = heapq.heappop(heap)
        a[gi] = j
        heapq.heappush(heap, (load + float(gload[gi]), j))
    return a


def _refine_arrays(w: np.ndarray, a: np.ndarray, m: int,
                   ea: np.ndarray, eb: np.ndarray, ew: np.ndarray,
                   alpha: float, beta: float, refine_iters: int,
                   refine_mode: str = "sweep") -> None:
    """Greedy refinement of ``alpha * imbalance + beta * cut_volume``.

    Array-native: the Δcost of moving any partition to any node is
    evaluated for ALL (partition, node) pairs at once —

    * Δimbalance (sum of squared node loads) is ``2 w_p (L_t - L_s + w_p)``,
    * Δcut is ``cut_to[p, s] - cut_to[p, t]`` where ``cut_to[p, t]`` is the
      weight of p's edges into partitions currently on node t —

    and the single best move is applied per round, until no move improves.
    ``a`` (partition -> node index) is refined in place.

    ``refine_mode`` selects how ``cut_to`` is kept current:

    * ``"sweep"`` — rebuilt from the full edge list every round (two
      ``np.add.at`` over E_p), O(iters · (P·m + E_p)); the oracle.
    * ``"worklist"`` — built once, then patched per move: relocating
      partition p from node s to t only changes ``cut_to[q, {s,t}]``
      for q adjacent to p, so each move costs O(deg(p) + P·m) instead
      of O(E_p + P·m).  Full-level rebuilds dominate the 10M-tier map
      wall; boundary-only updates are where that time goes away.  Both
      modes evaluate the same Δcost, so they pick identical move
      sequences up to float summation order.
    """
    nparts = w.size
    if nparts == 0 or m <= 1 or refine_iters == 0:
        return
    loads = np.zeros(m, dtype=np.float64)
    np.add.at(loads, a, w)
    if ew.size and not ew.any():
        ew = np.empty(0, dtype=np.float64)
    rows = np.arange(nparts)
    if refine_mode == "worklist" and ew.size:
        _refine_worklist(w, a, m, ea, eb, ew, alpha, beta, refine_iters,
                         loads, rows)
        return
    for _ in range(refine_iters):
        if ew.size:
            cut_to = np.zeros((nparts, m))
            np.add.at(cut_to, (ea, a[eb]), ew)
            np.add.at(cut_to, (eb, a[ea]), ew)
            d_cut = cut_to[rows, a][:, None] - cut_to
        else:
            d_cut = 0.0
        d_imb = 2.0 * w[:, None] * (loads[None, :] - loads[a][:, None]
                                    + w[:, None])
        delta = alpha * d_imb + beta * d_cut
        delta[rows, a] = 0.0
        best = int(np.argmin(delta))
        p, t = divmod(best, m)
        if not delta[p, t] + 1e-15 < 0.0:
            break
        loads[a[p]] -= w[p]
        loads[t] += w[p]
        a[p] = t


def _refine_worklist(w: np.ndarray, a: np.ndarray, m: int,
                     ea: np.ndarray, eb: np.ndarray, ew: np.ndarray,
                     alpha: float, beta: float, refine_iters: int,
                     loads: np.ndarray, rows: np.ndarray) -> None:
    """Boundary-only KL inner loop (``refine_mode="worklist"``).

    ``cut_to`` and ``d_cut`` are built once; after each applied move
    only the moved vertex's neighbourhood is re-scanned — the move
    p: s→t shifts weight ``w(p,q)`` from column s to column t of every
    neighbour q's ``cut_to`` row, and row p's own baseline column
    changes, so exactly ``{p} ∪ N(p)`` rows of ``d_cut`` are stale.
    """
    nparts = w.size
    # neighbour CSR over the doubled undirected edge list, grouped by src
    src = np.concatenate([ea, eb])
    order = np.argsort(src, kind="stable")
    nbr = np.concatenate([eb, ea])[order]
    nbw = np.concatenate([ew, ew])[order]
    starts = np.searchsorted(src[order], np.arange(nparts + 1))
    cut_to = np.zeros((nparts, m))
    np.add.at(cut_to, (ea, a[eb]), ew)
    np.add.at(cut_to, (eb, a[ea]), ew)
    d_cut = cut_to[rows, a][:, None] - cut_to
    for _ in range(refine_iters):
        d_imb = 2.0 * w[:, None] * (loads[None, :] - loads[a][:, None]
                                    + w[:, None])
        delta = alpha * d_imb + beta * d_cut
        delta[rows, a] = 0.0
        best = int(np.argmin(delta))
        p, t = divmod(best, m)
        if not delta[p, t] + 1e-15 < 0.0:
            break
        s = int(a[p])
        loads[s] -= w[p]
        loads[t] += w[p]
        a[p] = t
        lo, hi = int(starts[p]), int(starts[p + 1])
        nbs, wq = nbr[lo:hi], nbw[lo:hi]
        # np.add.at: robust against duplicate (p, q) entries in the input
        np.add.at(cut_to, (nbs, s), -wq)
        np.add.at(cut_to, (nbs, t), wq)
        aff = np.append(nbs, p)
        d_cut[aff] = cut_to[aff, a[aff]][:, None] - cut_to[aff]


# ---------------------------------------------------------------------------
# The original dict-of-dicts mapper — kept as the semantic oracle
# ---------------------------------------------------------------------------


def _map_partitions_dict(pgt, live: Sequence[NodeInfo],
                         alpha: float, beta: float,
                         refine_iters: int) -> Dict[int, str]:
    """The pre-CSR implementation (``mapping="dict"``): dict partition
    graph, sorted-edge contraction, heap merge of lightest groups, greedy
    assignment.  Retains the historical zero-weight tie-breaking (whole
    uniform graphs land on node0) — that behaviour is exactly what the
    CSR mapper's load-aware tie-breaks fix."""
    m = len(live)
    g = PartitionGraph.from_pgt(pgt)
    parts = sorted(g.vweights)

    # --- coarsen: heaviest-edge matching until <= m super-vertices -----------
    group_of: Dict[int, int] = {p: p for p in parts}

    def find(p: int) -> int:
        while group_of[p] != p:
            group_of[p] = group_of[group_of[p]]
            p = group_of[p]
        return p

    ngroups = len(parts)
    edges = sorted(g.eweights.items(), key=lambda kv: -kv[1])
    ei = 0
    while ngroups > m and ei < len(edges):
        (a, b), w = edges[ei]
        ei += 1
        if w <= 0.0:
            break   # zero-communication pairs: leave to load-based merging
        ra, rb = find(a), find(b)
        if ra != rb:
            group_of[rb] = ra
            ngroups -= 1
    # if still too many groups (disconnected), merge the two lightest —
    # heap-based so zero-communication graphs (all edge volumes 0) coarsen
    # in O(P log P) instead of the old O(P^2) rebuild-and-sort loop
    if ngroups > m:
        loads: Dict[int, float] = {}
        for p in parts:
            r = find(p)
            loads[r] = loads.get(r, 0.0) + g.vweights[p] + 1e-6 * g.vmem[p]
        heap = [(l, r) for r, l in loads.items()]
        heapq.heapify(heap)

        def pop_live() -> Tuple[float, int]:
            while True:
                l, r = heapq.heappop(heap)
                if group_of[r] == r and loads.get(r) == l:
                    return l, r

        while ngroups > m:
            l1, r1 = pop_live()
            l2, r2 = pop_live()
            group_of[r2] = r1
            loads[r1] = l1 + l2
            del loads[r2]
            heapq.heappush(heap, (l1 + l2, r1))
            ngroups -= 1

    clusters: Dict[int, List[int]] = {}
    for p in parts:
        clusters.setdefault(find(p), []).append(p)

    # --- initial assignment: balanced greedy (round-robin by descending load) --
    cluster_load = {r: sum(g.vweights[p] + 1e-6 * g.vmem[p] for p in ps)
                    for r, ps in clusters.items()}
    node_load = {n.name: 0.0 for n in live}
    assign: Dict[int, str] = {}
    for r in sorted(clusters, key=lambda r: -cluster_load[r]):
        tgt = min(live, key=lambda n: node_load[n.name])
        for p in clusters[r]:
            assign[p] = tgt.name
        node_load[tgt.name] += cluster_load[r]

    # --- KL-style refinement (shared vectorised best-move greedy) --------------
    _refine(g, parts, assign, live, alpha, beta, refine_iters)

    stamp_nodes(pgt, assign)
    return assign


def _refine(g: PartitionGraph, parts: List[int], assign: Dict[int, str],
            live: Sequence[NodeInfo], alpha: float, beta: float,
            refine_iters: int) -> None:
    """Dict-graph driver for :func:`_refine_arrays` (the oracle path)."""
    nparts = len(parts)
    m = len(live)
    if nparts == 0 or m <= 1:
        return
    pidx = {p: i for i, p in enumerate(parts)}
    nidx = {n.name: j for j, n in enumerate(live)}
    w = np.fromiter((g.vweights[p] + 1e-6 * g.vmem[p] for p in parts),
                    dtype=np.float64, count=nparts)
    a = np.fromiter((nidx[assign[p]] for p in parts), dtype=np.int64,
                    count=nparts)
    ne = len(g.eweights)
    ea = np.fromiter((pidx[x] for x, _ in g.eweights), dtype=np.int64,
                     count=ne)
    eb = np.fromiter((pidx[y] for _, y in g.eweights), dtype=np.int64,
                     count=ne)
    ew = np.fromiter(g.eweights.values(), dtype=np.float64, count=ne)
    _refine_arrays(w, a, m, ea, eb, ew, alpha, beta, refine_iters)
    for i, p in enumerate(parts):
        assign[p] = live[int(a[i])].name


def stamp_nodes(pgt, assign: Dict[int, str]) -> None:
    """Write a partition->node assignment onto the PGT's placement field.

    Array path: one lookup-table gather writes the whole ``node_ids``
    array (no DropSpec views are materialised); dict path: per-spec
    attribute writes.  ``assign``'s keys are exactly the partition ids
    occurring in the PGT, so the sentinel-shifted index covers them.
    """
    if isinstance(pgt, CompiledPGT):
        _, idx, shift, span = pgt.partition_index()
        table = np.full(span, -1, dtype=np.int32)
        for p, node_name in assign.items():
            table[p + shift] = pgt.node_id_for(node_name)
        pgt.node_ids = table[idx]
    else:
        for spec in pgt.drops.values():
            spec.node = assign[spec.partition]
