"""One partition substrate shared by translate and mapping.

The paper's scalability story rests on *hierarchical* graph partitioning
("Partitioning SKA Dataflows for Optimal Graph Execution"): ``min_time``
coarsens the drop graph by edge-zeroing merges, and ``map_partitions``
coarsens the resulting partition graph again by heavy-edge matching.
Before this module the two stages each built and collapsed their own
hierarchy; now ``min_time`` *records* the merge hierarchy it builds
anyway (:class:`PartitionHierarchy`) and the mapper consumes it directly
— translate hands the mapper its coarsening for free, and the mapper
projects the node assignment back down the recorded levels with KL
refinement at every level (multilevel uncoarsening) instead of refining
only at the finest granularity.

Everything here is plain numpy over flat arrays — no imports from the
rest of ``repro.core`` (partition, mapping and schedule all build on
top of this module, so it must sit below them).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def dense_labels(labels: np.ndarray) -> np.ndarray:
    """Renumber arbitrary partition labels (e.g. union-find root ids) to
    dense 0..P-1 int32 (value-ordered, so already-dense labels pass
    through unchanged)."""
    if labels.size == 0:
        return labels.astype(np.int32, copy=False)
    lo = int(labels.min())
    span = int(labels.max()) - lo + 1
    if 0 <= lo and span <= 4 * labels.size:
        # scan-based renumber (no sort): same value order as np.unique
        present = np.zeros(span, dtype=bool)
        present[labels - lo] = True
        remap = np.cumsum(present, dtype=np.int64) - 1
        return remap[labels - lo].astype(np.int32)
    return np.unique(labels, return_inverse=True)[1].astype(np.int32)


def aggregate_edges(eu: np.ndarray, ev: np.ndarray, ew: np.ndarray,
                    parent: np.ndarray, nv: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project an undirected weighted edge list through a vertex merge map.

    ``parent`` maps every fine vertex to its coarse vertex (0..nv-1).
    Edges whose endpoints land in the same coarse vertex are internalised
    (dropped); parallel survivors are collapsed with summed weights via
    the usual packed-key ``np.unique`` + ``np.bincount`` aggregation.
    Total *cut* weight is exactly preserved for any labelling refined on
    the coarse graph and projected back (internal edges can never be cut
    again).
    """
    empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
             np.empty(0, dtype=np.float64))
    if eu.size == 0:
        return empty
    cu = parent[eu].astype(np.int64, copy=False)
    cv = parent[ev].astype(np.int64, copy=False)
    live = cu != cv
    if not live.any():
        return empty
    lo = np.minimum(cu[live], cv[live])
    hi = np.maximum(cu[live], cv[live])
    key = lo * np.int64(nv) + hi
    uk, inv = np.unique(key, return_inverse=True)
    cw = np.bincount(inv, weights=ew[live])
    return uk // nv, uk % nv, cw


def level_structure(levels: np.ndarray, esrc: np.ndarray, edst: np.ndarray,
                    n: int):
    """Level-bucketed edge and node orders for level-synchronous passes.

    Partition-independent, so one computation serves every evaluation of
    the same graph — ``schedule._Arrays`` caches it per PGT and
    ``PrefixCP`` / ``_critical_path_dist`` share the result.  Returns
    ``(esrc_s, edst_s, e_order, bounds, node_order, nbounds, max_level)``
    where the edge triplets are sorted by destination level and
    ``bounds[lv]:bounds[lv+1]`` slices out one level.
    """
    max_lv = int(levels.max()) if n else 0
    if esrc.size:
        edge_lv = levels[edst]
        e_order = np.argsort(edge_lv, kind="stable")
        edge_lv_sorted = edge_lv[e_order]
        bounds = np.searchsorted(
            edge_lv_sorted, np.arange(edge_lv_sorted[-1] + 2))
        esrc_s, edst_s = esrc[e_order], edst[e_order]
    else:
        e_order = np.empty(0, dtype=np.int64)
        bounds = None
        esrc_s = edst_s = e_order
    node_order = np.argsort(levels, kind="stable")
    nbounds = np.searchsorted(levels[node_order], np.arange(max_lv + 2))
    return (esrc_s, edst_s, e_order, bounds, node_order, nbounds, max_lv)


class HierarchyLevel:
    """One level of a partition hierarchy: a weighted undirected graph.

    * ``load`` / ``mem`` / ``count`` — per-vertex app weight, data volume
      and member-drop count (float64 / float64 / int64),
    * ``eu`` / ``ev`` / ``ew`` — unique undirected cross-vertex edges
      (``eu < ev``) with summed volumes,
    * ``parent`` — maps this level's vertices to the next-*coarser*
      level's (``None`` at the coarsest level).  Projecting a coarse
      assignment down is one gather: ``a_fine = a_coarse[parent]``.
    """

    __slots__ = ("load", "mem", "count", "eu", "ev", "ew", "parent")

    def __init__(self, load, mem, count, eu, ev, ew, parent=None) -> None:
        self.load = load
        self.mem = mem
        self.count = count
        self.eu = eu
        self.ev = ev
        self.ew = ew
        self.parent = parent

    @property
    def num_vertices(self) -> int:
        return int(self.load.size)

    @property
    def num_edges(self) -> int:
        return int(self.eu.size)

    def cut(self, a: np.ndarray) -> float:
        """Total edge weight crossing the node assignment ``a``."""
        if self.eu.size == 0:
            return 0.0
        return float(self.ew[a[self.eu] != a[self.ev]].sum())


class PartitionHierarchy:
    """The merge hierarchy ``min_time`` builds, recorded for the mapper.

    ``levels[0]`` is the finest level — one vertex per PGT partition of
    the labelling the partitioner kept (dense ids, so vertex *i* is
    partition *i*).  Deeper entries are the coarser snapshots the merge
    sweep passed through on the way (nested by construction: the
    union-find only ever coarsens along the cost-sorted prefix).

    ``labels`` is a *copy* of the finest per-drop labelling at recording
    time: :meth:`matches` detects any later mutation of
    ``pgt.partition`` (annealing, manual edits) and the mapper falls back
    to the flat extraction rather than consuming a stale hierarchy.
    """

    __slots__ = ("levels", "labels")

    def __init__(self, levels: List[HierarchyLevel],
                 labels: np.ndarray) -> None:
        self.levels = levels
        self.labels = labels

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def matches(self, pgt) -> bool:
        part = getattr(pgt, "partition", None)
        return part is not None and np.array_equal(part, self.labels)

    @classmethod
    def from_labelings(cls, labelings: Sequence[np.ndarray],
                       load: np.ndarray, mem: np.ndarray, count: np.ndarray,
                       eu: np.ndarray, ev: np.ndarray, ew: np.ndarray
                       ) -> "PartitionHierarchy":
        """Build the hierarchy from nested per-drop dense labelings.

        ``labelings[0]`` is the finest (kept) labelling and
        ``load``/``mem``/``count``/``eu``/``ev``/``ew`` its aggregated
        partition graph; later entries are successively coarser nested
        labelings (every partition of ``labelings[i]`` maps into exactly
        one partition of ``labelings[i+1]``).  Levels that do not merge
        anything are skipped.
        """
        finest = labelings[0]
        levels = [HierarchyLevel(load, mem, count, eu, ev, ew)]
        prev = finest
        for cur in labelings[1:]:
            nv_prev = levels[-1].num_vertices
            nv_cur = int(cur.max()) + 1 if cur.size else 0
            if nv_cur >= nv_prev:
                continue             # checkpoint merged nothing new
            # per-partition parent map: one scatter over the drops
            # (nested labelings make every write per slot consistent)
            parent = np.empty(nv_prev, dtype=np.int32)
            parent[prev] = cur
            top = levels[-1]
            cload = np.bincount(parent, weights=top.load, minlength=nv_cur)
            cmem = np.bincount(parent, weights=top.mem, minlength=nv_cur)
            ccnt = np.bincount(parent, weights=top.count,
                               minlength=nv_cur).astype(np.int64)
            ceu, cev, cew = aggregate_edges(top.eu, top.ev, top.ew,
                                            parent, nv_cur)
            top.parent = parent
            levels.append(HierarchyLevel(cload, cmem, ccnt, ceu, cev, cew))
            prev = cur
        return cls(levels, finest.copy())
