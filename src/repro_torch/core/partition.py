"""Logical partitioning of the PGT (paper §3.4, step 3).

Two families, exactly as the paper describes:

* ``min_time`` — "produce an optimal number of partitions such that first the
  total completion time of the pipeline ... is minimised, and second at any
  point in time the number of drops running in parallel within a single
  partition is no greater than a Degree of Parallelism (DoP) threshold."
  Implemented as edge-zeroing internalisation (Sarkar-style): start with one
  partition per drop and merge across data-movement edges in descending cost
  order while the per-level app width of every partition stays within the
  DoP cap.

* ``min_res`` — "minimise the number of produced partitions subject to
  satisfying completion deadline and the DoP threshold constraints."

Each family has two implementations dispatched on the PGT type:

* the seed **dict path** (``PhysicalGraphTemplate``): merge trials validated
  with a full makespan simulation each (plus optional simulated-annealing
  refinement) — O(E · sim); the semantic reference, fine to ~10^4 drops.
* the **array path** (``CompiledPGT``): union-find over int32 ids with
  incremental per-level width tracking, candidate *prefixes* of the
  cost-sorted edge list evaluated with the vectorized critical-path
  estimator (exact event simulation for small graphs), best prefix kept —
  O(E α(E) + checkpoints · E).  This is what sustains the paper's
  millions-of-drops translate regime.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .logical import GraphValidationError
from .pgt import KIND_APP, CompiledPGT
from .schedule import (DEFAULT_BANDWIDTH, PrefixCP, _critical_path_arrays,
                       _extract, _simulate_arrays, critical_path, edge_cost,
                       simulate_makespan)
from .substrate import PartitionHierarchy
from .substrate import dense_labels as _dense_labels
from .unroll import PhysicalGraphTemplate

# graphs up to this many drops evaluate merge checkpoints with the exact
# event simulation (guarantees makespan never regresses past the trivial
# partitioning); larger graphs use the vectorized critical-path estimator
EXACT_EVAL_MAX_DROPS = 20_000
# largest graph for which the *final* reported makespan is exact-simulated
EXACT_FINAL_MAX_DROPS = 400_000


@dataclass
class PartitionResult:
    num_partitions: int
    makespan: float
    algorithm: str
    dop: int


# ---------------------------------------------------------------------------
# Degree-of-parallelism accounting
# ---------------------------------------------------------------------------


def _partition_dop(pgt, members: Set[str]) -> int:
    """Max antichain width restricted to a partition's app drops.

    Exact max-antichain is expensive; we use the standard level-width
    over-approximation (drops at the same DAG depth can run concurrently),
    which is what constrains the schedule in practice.
    """
    depth: Dict[str, int] = {}
    width: Dict[int, int] = {}
    for uid in pgt.topological_order():
        d = 0
        for p in pgt.predecessors(uid):
            d = max(d, depth[p] + 1)
        depth[uid] = d
        if uid in members and pgt.drops[uid].kind == "app":
            width[d] = width.get(d, 0) + 1
    return max(width.values()) if width else 0


class _UnionFind:
    def __init__(self, items: List[str]) -> None:
        self.parent = {i: i for i in items}
        self.rank = {i: 0 for i in items}

    def find(self, x: str) -> str:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str) -> str:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return ra


def _assign(pgt: PhysicalGraphTemplate, groups: Dict[str, int]) -> None:
    for uid, part in groups.items():
        pgt.drops[uid].partition = part


def _renumber(uf: "_UnionFind", pgt: PhysicalGraphTemplate) -> Dict[str, int]:
    ids: Dict[str, int] = {}
    groups: Dict[str, int] = {}
    for uid in pgt.drops:
        root = uf.find(uid)
        if root not in ids:
            ids[root] = len(ids)
        groups[uid] = ids[root]
    return groups


# ---------------------------------------------------------------------------
# array path: shared merge machinery
# ---------------------------------------------------------------------------


def _resolve_labels(parent: List[int]) -> np.ndarray:
    """Collapse a union-find forest to dense partition labels, vectorized."""
    par = np.asarray(parent, dtype=np.int64)
    while True:
        pp = par[par]
        if np.array_equal(pp, par):
            break
        par = pp
    return np.unique(par, return_inverse=True)[1].astype(np.int32)


class _ArrayMerger:
    """Union-find merge of drops with incremental per-level DoP tracking."""

    def __init__(self, pgt: CompiledPGT, dop: int) -> None:
        self.dop = dop
        self.n = pgt.num_drops
        self.parent = list(range(self.n))
        self.levels = pgt.topo_levels().tolist()
        self.is_app = (pgt.kind_arr == KIND_APP).tolist()
        # per-root level->app-count; singletons are implicit (lazy dicts)
        self.widths: Dict[int, Dict[int, int]] = {}

    def find(self, x: int) -> int:
        parent = self.parent
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def _width_of(self, root: int) -> Dict[int, int]:
        w = self.widths.get(root)
        if w is None:
            w = {self.levels[root]: 1} if self.is_app[root] else {}
        return w

    def try_merge(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return True
        wa, wb = self._width_of(ra), self._width_of(rb)
        small, big = (wa, wb) if len(wa) <= len(wb) else (wb, wa)
        for lvl, c in small.items():
            if big.get(lvl, 0) + c > self.dop:
                return False
        merged = dict(big)
        for lvl, c in small.items():
            merged[lvl] = merged.get(lvl, 0) + c
        self.parent[rb] = ra
        self.widths[ra] = merged
        self.widths.pop(rb, None)
        return True

    def labels(self) -> np.ndarray:
        return _resolve_labels(self.parent)


def _edge_merge_order(pgt: CompiledPGT, bandwidth: float) -> np.ndarray:
    cost = pgt.edge_volumes()
    if cost.size == 0 or cost.max() == cost.min():
        # all ties: the stable sort would return the identity anyway
        return np.arange(cost.size, dtype=np.int64)
    return np.argsort(-cost, kind="stable")


class _BatchedMerger:
    """Vectorized DoP-capped edge-zeroing for large ``CompiledPGT``s.

    Processes a cost-ordered edge window in *rounds* of bulk numpy
    operations instead of one Python union-find walk per edge:

    1. resolve current partition roots of the window's endpoints,
    2. each partition elects its lowest-order crossing edge (*top*);
       edges that are top for **both** endpoints merge as a matching,
    3. edges that are top for exactly one endpoint form *hub sweeps*: all
       pending merges into one partition are resolved together with a
       cumulative per-level width scan in edge order (the star pattern —
       e.g. one source feeding 10^5 scattered branches — that a matching
       alone would need 10^5 rounds for),
    4. rejected merges (a DoP level-width cap would be exceeded) retire
       their edge permanently, mirroring the sequential path's
       attempt-once semantics.

    Width caps are enforced exactly.  Cheap sufficient conditions
    (combined app count <= dop, or disjoint app level ranges) avoid
    building the per-level tables for the common case.  Merge *results*
    can differ from the strictly sequential order when several candidate
    merges contend for one partition in the same round — the snapshot
    evaluation in ``_merge_snapshots`` judges the outcome either way.
    """

    _BIG = np.iinfo(np.int64).max
    # drop/edge ids all fit int32; the hot per-round arrays use it to
    # halve memory traffic (the rounds are bandwidth-bound)
    _BIG32 = np.iinfo(np.int32).max

    def __init__(self, pgt: CompiledPGT, dop: int) -> None:
        n = pgt.num_drops
        self.n = n
        self.dop = dop
        self.parent = np.arange(n, dtype=np.int32)
        self._dirty = False
        self.levels = pgt.topo_levels()
        self.lspan = int(self.levels.max()) + 1 if n else 1
        is_app = pgt.kind_arr == KIND_APP
        self.app_idx = np.flatnonzero(is_app)
        self.app_lv = self.levels[self.app_idx].astype(np.int32)
        # per-root scalars for the cheap cap tests
        self.app_cnt = is_app.astype(np.int32)
        self.lv_min = np.where(is_app, self.levels,
                               self._BIG32).astype(np.int32)
        self.lv_max = np.where(is_app, self.levels,
                               -1).astype(np.int32)
        self.esrc = pgt.edge_src            # already int32
        self.edst = pgt.edge_dst
        self._top = np.full(n, self._BIG32, dtype=np.int32)
        self._slot = np.full(n, -1, dtype=np.int32)       # sweep scratch
        self._hub_slot = np.full(n, -1, dtype=np.int32)
        # role marks (hub / partner) as a stamped scratch array: bumping
        # the stamp retires a whole round's marks without memsets
        self._mark = np.zeros(n, dtype=np.int32)
        self._stamp = 0

    # -- union-find ---------------------------------------------------------
    def _resolve(self, ids: np.ndarray) -> np.ndarray:
        # no write-back needed: labels() globally compresses the forest on
        # every merging round, so chains here are at most a couple deep
        par = self.parent
        r = par[ids]
        if not self._dirty:               # forest is flat: one gather
            return r
        while True:
            rr = par[r]
            if not (rr != r).any():
                return r
            r = rr

    def labels(self) -> np.ndarray:
        """Current root label per drop (path-compresses the forest)."""
        if not self._dirty:
            return self.parent
        par = self.parent
        while True:
            pp = par[par]
            if np.array_equal(pp, par):
                break
            par = pp
        self.parent = par
        self._dirty = False
        return par

    # -- cap checks ---------------------------------------------------------
    def _cheap_ok(self, pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
        """Sufficient (never unsafe) vectorized width-cap test."""
        return ((self.app_cnt[pa] + self.app_cnt[pb] <= self.dop)
                | (self.lv_max[pa] < self.lv_min[pb])
                | (self.lv_max[pb] < self.lv_min[pa]))

    def _exact_pair_ok(self, lab: np.ndarray, pa: np.ndarray,
                       pb: np.ndarray) -> np.ndarray:
        """Exact pairwise width check: per-level app counts of pa[i]+pb[i]
        must stay within dop.  One bulk histogram over the member apps."""
        k = pa.shape[0]
        pairid = self._slot                       # scratch, reset below
        pairid[pa] = np.arange(k)
        pairid[pb] = np.arange(k)
        sel = pairid[lab[self.app_idx]]
        pairid[pa] = -1
        pairid[pb] = -1
        m = sel >= 0
        if not m.any():
            return np.ones(k, dtype=bool)
        keys = sel[m] * np.int64(self.lspan) + self.app_lv[m]
        uniq, counts = np.unique(keys, return_counts=True)
        ok = np.ones(k, dtype=bool)
        ok[np.unique(uniq[counts > self.dop] // self.lspan)] = False
        return ok

    def _apply(self, pa: np.ndarray, pb: np.ndarray) -> None:
        """Merge roots pb into pa (both sides distinct — matched pairs)
        + update the cheap-test scalars."""
        self.parent[pb] = pa
        self._dirty = True
        self.app_cnt[pa] += self.app_cnt[pb]
        self.lv_min[pa] = np.minimum(self.lv_min[pa], self.lv_min[pb])
        self.lv_max[pa] = np.maximum(self.lv_max[pa], self.lv_max[pb])

    def _apply_grouped(self, hubs: np.ndarray,
                       partners: np.ndarray) -> None:
        """Merge each (sorted, possibly repeated) hub's partners into it.

        A fancy ``+=`` would drop all but one increment per duplicated
        hub; the hub runs are contiguous, so segment ``reduceat``s give
        the per-hub aggregates without a slow unbuffered scatter."""
        if hubs.size == 0:
            return
        self.parent[partners] = hubs
        self._dirty = True
        starts = np.flatnonzero(
            np.concatenate(([True], hubs[1:] != hubs[:-1])))
        uh = hubs[starts]
        self.app_cnt[uh] += np.add.reduceat(self.app_cnt[partners], starts)
        self.lv_min[uh] = np.minimum(
            self.lv_min[uh], np.minimum.reduceat(self.lv_min[partners],
                                                 starts))
        self.lv_max[uh] = np.maximum(
            self.lv_max[uh], np.maximum.reduceat(self.lv_max[partners],
                                                 starts))

    # -- hub sweeps ---------------------------------------------------------
    def _sweep_hubs(self, lab: np.ndarray, hubs: np.ndarray,
                    partners: np.ndarray) -> np.ndarray:
        """Resolve all pending merges into each hub partition at once.

        Input arrays are sorted by (hub, edge order).  For every hub the
        partners' per-level app counts are accumulated in order; partners
        before the first level-cap breach merge, the rest are retired —
        exactly what attempting them one by one against the growing hub
        would do whenever the breach is monotone (identical partner
        shapes), and a conservative subset otherwise.  Returns the
        accept mask.
        """
        dop = self.dop
        # cumulative scalar count along each hub run as a first cut: the
        # total-app-count bound is sufficient (a level can never hold more
        # apps than the partition does); the exact per-level scan below
        # only runs for runs that breach it
        grp_new = np.concatenate(([True], hubs[1:] != hubs[:-1]))
        heads = np.flatnonzero(grp_new)
        run_len = np.diff(np.concatenate((heads, [hubs.size])))
        run_of = np.cumsum(grp_new) - 1                  # pos -> run id
        nruns = int(heads.size)
        csum = np.cumsum(self.app_cnt[partners])
        base = np.repeat(csum[heads] - self.app_cnt[partners[grp_new]],
                         run_len)
        cum_cnt = csum - base + self.app_cnt[hubs]
        scalar_ok = cum_cnt <= dop
        if bool(scalar_ok.all()):
            return np.ones(hubs.size, dtype=bool)
        pos = np.arange(hubs.size, dtype=np.int64)
        inrun = pos - heads[run_of]
        # scalar-clean runs accept everything without building any rows;
        # breaching runs get the exact per-level cumulative scan — over a
        # geometric *prefix* only: the accept boundary j* depends just on
        # the partners before it, so scanning the first K per run decides
        # it whenever the breach lies within (a saturated star resolves
        # with ~dop rows instead of one row per member app)
        run_breach = np.zeros(nruns, dtype=bool)
        run_breach[run_of[~scalar_ok]] = True
        j_star = np.full(nruns, self._BIG, dtype=np.int64)
        undecided = run_breach.copy()
        slot = self._slot                         # scratch, reset below
        hub_slot = self._hub_slot
        app_roots = lab[self.app_idx]
        k_scan = max(4 * dop, 64)
        while undecided.any():
            scan = undecided[run_of] & (inrun < k_scan)
            sp = partners[scan]
            slot[sp] = pos[scan]
            uheads = heads[undecided]
            hub_slot[hubs[uheads]] = uheads
            ps = slot[app_roots]
            hs = hub_slot[app_roots]
            slot[sp] = -1
            hub_slot[hubs[uheads]] = -1
            # rows: (run id, level, order-within-run, count 1 each)
            pm = ps >= 0
            hm = hs >= 0
            rows_run = np.concatenate((run_of[ps[pm]], run_of[hs[hm]]))
            rows_lv = np.concatenate((self.app_lv[pm], self.app_lv[hm]))
            # hub apps sort before every partner (order -1)
            rows_j = np.concatenate((ps[pm], np.full(int(hm.sum()), -1)))
            kspan = hubs.size + 2
            if nruns * self.lspan * kspan < (1 << 62):
                # fused single-key argsort (cheaper than 3-key lexsort)
                order = np.argsort(
                    (rows_run * np.int64(self.lspan) + rows_lv)
                    * np.int64(kspan) + rows_j + 1, kind="stable")
            else:                               # pragma: no cover - huge
                order = np.lexsort((rows_j, rows_lv, rows_run))
            rows_run, rows_lv, rows_j = (rows_run[order], rows_lv[order],
                                         rows_j[order])
            seg = np.concatenate(([True], (rows_run[1:] != rows_run[:-1])
                                  | (rows_lv[1:] != rows_lv[:-1])))
            idx = np.arange(rows_run.size, dtype=np.int64)
            seg_start = np.repeat(idx[seg], np.diff(np.concatenate(
                (np.flatnonzero(seg), [rows_run.size]))))
            cum = idx - seg_start + 1                    # per (run, level)
            breach = cum > dop
            if breach.any():
                bj = rows_j[breach]
                # a breach on a hub row (j == -1) would mean the hub
                # already violates — impossible by construction
                bj = np.where(bj < 0, 0, bj)
                np.minimum.at(j_star, rows_run[breach], bj)
                undecided &= j_star == self._BIG         # found => decided
            # breach-free runs fully covered by this prefix are clean
            undecided &= run_len > k_scan
            k_scan *= 8
        return pos < j_star[run_of]

    # -- main entry ---------------------------------------------------------
    def merge_window(self, eids: np.ndarray, guard_rounds: int = 200
                     ) -> None:
        """Attempt every edge of ``eids`` (already cost-ordered) once."""
        self.merge_ordered(self.esrc[eids], self.edst[eids], guard_rounds)

    def merge_ordered(self, ew_src: np.ndarray, ew_dst: np.ndarray,
                      guard_rounds: int = 200) -> None:
        """Like :meth:`merge_window` but over pre-gathered endpoint
        arrays (the snapshot sweep gathers the whole cost order once and
        hands out zero-copy window slices)."""
        if ew_src.size == 0:
            return
        pending = np.arange(ew_src.size, dtype=np.int32)
        for _ in range(guard_rounds):
            if pending.size == 0:
                return
            ra = self._resolve(ew_src[pending])
            rb = self._resolve(ew_dst[pending])
            cross = ra != rb
            if not cross.all():
                pending = pending[cross]
                if pending.size == 0:
                    return
                ra, rb = ra[cross], rb[cross]
            pending = self._round(pending, ra, rb)
        # pathological contention (should not happen — every round
        # resolves at least the active chain tops): finish strictly
        # sequentially rather than failing translate
        self._finish_sequential(ew_src, ew_dst, pending)

    def _round(self, pending: np.ndarray, ra: np.ndarray,
               rb: np.ndarray) -> np.ndarray:
        """One vectorized merge round; returns the surviving edges.

        Structure: every partition elects its lowest-order pending edge
        (*top*).  An edge that is top for exactly one endpoint joins the
        other endpoint's *group* (hub); a mutual top joins the hub side
        (or merges immediately as an isolated pair when neither side has
        a group).  Groups chain along "my hub is your partner" links — a
        forest, ordered by edge priority — and are applied deepest layer
        first, so a hub always absorbs its own partners (updating its
        width scalars and member mapping) before a shallower group
        absorbs *it*: every cap check sees exact, current widths.
        """
        # election: lowest-order pending edge per root.  ``pending`` is
        # ascending, so writing both endpoint arrays interleaved in
        # *reverse* makes the last (= lowest-order) write win — a pair of
        # fancy-index stores instead of two slow ``minimum.at``s
        top = self._top
        top[ra] = self._BIG32
        top[rb] = self._BIG32
        w = pending.size
        cc = np.empty(2 * w, dtype=np.int32)
        pp = np.empty(2 * w, dtype=np.int32)
        cc[0::2], cc[1::2] = ra[::-1], rb[::-1]
        pp[0::2] = pp[1::2] = pending[::-1]
        top[cc] = pp
        ta, tb = top[ra] == pending, top[rb] == pending
        mutual = ta & tb
        single = ta ^ tb
        retire = np.zeros(pending.size, dtype=bool)
        mark = self._mark
        s_hub = self._stamp + 1            # role stamp for this round
        self._stamp += 1
        # hubs: partitions other elections point into (the side the edge
        # is NOT top for); their pending merges resolve together
        si = np.flatnonzero(single)
        hub = np.where(ta[si], rb[si], ra[si])
        partner = np.where(ta[si], ra[si], rb[si])
        mark[hub] = s_hub
        # a mutual top joins the hub side's group (its lowest-order
        # candidate); with hubs on both sides the src side wins — the
        # parity schedule below serialises the two groups.  With no hub
        # attached the pair is isolated and merges immediately.
        mi = np.flatnonzero(mutual)
        ha, hb = mark[ra[mi]] == s_hub, mark[rb[mi]] == s_hub
        isolated = mi[~(ha | hb)]
        mf = mi[ha | hb]
        fa = ha[ha | hb]                   # fold into ra side when hub
        if isolated.size:
            pa, pb = ra[isolated], rb[isolated]
            ok = self._cheap_ok(pa, pb)
            if not ok.all():
                bad = ~ok
                ok[bad] = self._exact_pair_ok(
                    self.labels(), pa[bad], pb[bad])
            self._apply(pa[ok], pb[ok])
            retire[isolated] = True        # merged or cap-rejected
        if mf.size or si.size:
            si = np.concatenate((si, mf))
            hub = np.concatenate((hub, np.where(fa, ra[mf], rb[mf])))
            partner = np.concatenate(
                (partner, np.where(fa, rb[mf], ra[mf])))
            depth = self._group_depths(hub, partner)
            # fused (depth desc, hub, order) key — deepest layer first
            dmax = int(depth.max())
            espan = np.int64(self.esrc.size + 1)
            if (dmax + 1) * self.n * int(espan) < (1 << 62):
                o = np.argsort(
                    (np.int64(dmax) - depth) * np.int64(self.n) * espan
                    + hub * espan + pending[si], kind="stable")
            else:                               # pragma: no cover - huge
                o = np.lexsort((pending[si], hub, dmax - depth))
            si, hub, partner, depth = si[o], hub[o], partner[o], depth[o]
            bounds = np.flatnonzero(np.concatenate(
                ([True], depth[1:] != depth[:-1]))).tolist() + [si.size]
            for lo, hi in zip(bounds, bounds[1:]):
                # one layer: hubs here are never partners of an
                # already-processed (deeper) layer's hub... the reverse:
                # their partners' own groups (deeper) have already been
                # applied, so member scans and scalars are exact
                acc = self._sweep_hubs(self.labels(), hub[lo:hi],
                                       partner[lo:hi])
                # each partner root occurs exactly once (its top edge is
                # unique), so bulk-applying the accepts is safe
                self._apply_grouped(hub[lo:hi][acc], partner[lo:hi][acc])
            retire[si] = True              # merged or cap-rejected
        return pending[~retire]

    def _finish_sequential(self, ew_src: np.ndarray, ew_dst: np.ndarray,
                           pending: np.ndarray) -> None:
        """Strictly sequential remainder: correctness valve for inputs
        that starve the round scheduler (not observed in practice)."""
        if pending.size == 0:
            return
        lab = self.labels()
        roots = np.unique(np.concatenate(
            (lab[ew_src[pending]], lab[ew_dst[pending]])))
        widths: Dict[int, Dict[int, int]] = {int(r): {} for r in roots}
        app_roots = lab[self.app_idx]
        m = np.isin(app_roots, roots)
        for r, l in zip(app_roots[m].tolist(), self.app_lv[m].tolist()):
            d = widths[r]
            d[l] = d.get(l, 0) + 1
        parent = self.parent

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = int(parent[x])
            return x

        for e in pending.tolist():
            a_, b_ = find(int(ew_src[e])), find(int(ew_dst[e]))
            if a_ == b_:
                continue
            wa, wb = widths[a_], widths[b_]
            small, big = (wa, wb) if len(wa) <= len(wb) else (wb, wa)
            if any(big.get(l, 0) + c > self.dop for l, c in small.items()):
                continue
            for l, c in small.items():
                big[l] = big.get(l, 0) + c
            parent[b_] = a_
            widths[a_] = big
            widths[b_] = {}
            self.app_cnt[a_] += self.app_cnt[b_]
            self.lv_min[a_] = min(self.lv_min[a_], self.lv_min[b_])
            self.lv_max[a_] = max(self.lv_max[a_], self.lv_max[b_])
        self._dirty = True

    def _group_depths(self, hub: np.ndarray,
                      partner: np.ndarray) -> np.ndarray:
        """Per-edge depth of the edge's group in the defers-to forest.

        Group links — "group(h) is a child of group(g) when h is one of
        g's partners" — form a forest (a cycle would need an edge-order
        contradiction).  Applying groups deepest-first keeps the width
        accounting exact: a hub absorbs its own partners (and has its
        scalars updated) before any shallower group absorbs *it*.  Depth
        is computed with pointer jumping in O(log depth) vectorized
        steps, no sort.
        """
        k = hub.size
        gof = self._slot                   # scratch: hub -> canonical slot
        gof[hub] = np.arange(k, dtype=np.int32)
        gid = gof[hub]                     # per-edge canonical group slot
        gof[hub] = -1
        pg = self._hub_slot                # scratch: partner -> its group
        pg[partner] = gid
        up_edge = pg[hub]                  # -1 => forest root
        pg[partner] = -1
        if not (up_edge >= 0).any():
            return np.zeros(k, dtype=np.int64)
        up = np.full(k, -1, dtype=np.int32)
        up[gid] = up_edge
        dep = (up >= 0).astype(np.int64)
        j = up.copy()
        while True:
            m = j >= 0
            if not m.any():
                break
            dj, jj = dep.copy(), j.copy()
            dep[m] += dj[jj[m]]
            j[m] = jj[jj[m]]
        return dep[gid]


def _record_hierarchy(pgt: CompiledPGT, best_k: int, best_labels: np.ndarray,
                      snapshots: List[Tuple[int, float, np.ndarray]]) -> None:
    """Record the merge hierarchy onto the PGT for the mapper.

    The kept labelling is the finest level; snapshots *deeper* along the
    merge prefix (``k > best_k``) are its coarser nested levels — the
    union-find only ever coarsens, so every kept partition maps into
    exactly one partition of each deeper snapshot.  ``map_partitions``
    consumes this instead of re-coarsening from scratch (see
    ``core/substrate.py``).
    """
    coarser = [_dense_labels(lab) for k, _, lab in snapshots if k > best_k]
    _, load, mem, count, eu, ev, ew = pgt.partition_graph_arrays()
    pgt._partition_hierarchy = PartitionHierarchy.from_labelings(
        [best_labels] + coarser, load, mem, count, eu, ev, ew)


def _merge_snapshots(pgt: CompiledPGT, a, dop: int, bandwidth: float,
                     max_trials: Optional[int] = None
                     ) -> List[Tuple[int, float, np.ndarray]]:
    """Sweep geometric prefixes of the cost-sorted edge list through the
    DoP-capped union-find merge, evaluating each checkpoint.

    Returns ``(k, makespan, labels)`` snapshots; ``k = 0`` is the trivial
    partitioning.  Shared by ``min_time`` (argmin) and ``min_res``
    (deepest deadline-meeting prefix).

    Two regimes, split at ``EXACT_EVAL_MAX_DROPS``:

    * small graphs keep the strictly sequential per-edge merge
      (:class:`_ArrayMerger`) and evaluate checkpoints with the exact
      event simulation — bit-compatible with the original behaviour;
    * large graphs use the vectorized :class:`_BatchedMerger` and the
      *incremental* :class:`~repro.core.schedule.PrefixCP` critical-path
      evaluator, which reuses the longest-path state across checkpoints
      (merges only ever internalise edges, so consecutive prefixes share
      almost all of it).  Snapshot labels in this regime are union-find
      root ids — callers densify the labelling they keep via
      :func:`_dense_labels`.
    """
    order = _edge_merge_order(pgt, bandwidth)
    if max_trials is not None:
        order = order[:max_trials]
    ne = int(order.size)
    exact = pgt.num_drops <= EXACT_EVAL_MAX_DROPS
    if exact:
        ks = sorted({0, ne // 32, ne // 16, ne // 8, ne // 4, ne // 2, ne})
    else:
        # the exact simulator's non-monotone makespans reward a fine
        # checkpoint grid; the estimator regime is monotone in practice,
        # so a thinner geometric schedule buys the same argmin for less
        # merge-window bookkeeping
        ks = sorted({0, ne // 16, ne // 4, ne})
    snapshots: List[Tuple[int, float, np.ndarray]] = []
    prev = 0
    if exact:
        merger = _ArrayMerger(pgt, dop)
        esrc = pgt.edge_src.tolist()
        edst = pgt.edge_dst.tolist()
        order_l = order.tolist()
        for k in ks:
            for j in range(prev, k):
                ei = order_l[j]
                merger.try_merge(esrc[ei], edst[ei])
            prev = k
            labels = merger.labels()
            snapshots.append(
                (k, _simulate_arrays(a, labels, dop, bandwidth), labels))
    else:
        bmerger = _BatchedMerger(pgt, dop)
        evaluator = PrefixCP(a, bandwidth)
        es_sorted = bmerger.esrc[order]
        ed_sorted = bmerger.edst[order]
        for k in ks:
            bmerger.merge_ordered(es_sorted[prev:k], ed_sorted[prev:k])
            prev = k
            labels = bmerger.labels().copy()
            snapshots.append((k, evaluator.evaluate(labels), labels))
    return snapshots


# ---------------------------------------------------------------------------
# min_time
# ---------------------------------------------------------------------------


def _min_time_compiled(pgt: CompiledPGT, dop: int, bandwidth: float,
                       max_trials: Optional[int] = None) -> PartitionResult:
    a = _extract(pgt)
    n = pgt.num_drops
    pgt._partition_hierarchy = None
    if n == 0:
        pgt.partition = np.empty(0, dtype=np.int32)
        return PartitionResult(0, 0.0, "min_time", dop)

    snapshots = _merge_snapshots(pgt, a, dop, bandwidth, max_trials)
    best_k, best_t, best_labels = min(
        snapshots, key=lambda s: (s[1], -s[0]))   # ties -> fewer partitions

    best_labels = _dense_labels(best_labels)
    pgt.partition = best_labels
    _record_hierarchy(pgt, best_k, best_labels, snapshots)
    nparts = int(best_labels.max()) + 1 if best_labels.size else 0
    if n <= EXACT_EVAL_MAX_DROPS:
        makespan = best_t
    elif n <= EXACT_FINAL_MAX_DROPS:
        makespan = _simulate_arrays(a, best_labels, dop, bandwidth)
    else:
        makespan = best_t   # critical-path estimate (documented)
    return PartitionResult(nparts, makespan, "min_time", dop)


def min_time(pgt, dop: int = 8,
             bandwidth: float = DEFAULT_BANDWIDTH,
             anneal_iters: int = 0, seed: int = 0,
             max_trials: Optional[int] = None) -> PartitionResult:
    """``max_trials`` bounds the number of merge trials (dict path: each
    trial runs a full makespan simulation; array path: bounds the merge
    prefix).  The array path needs no budget — the full cost-sorted edge
    list is merged in O(E α(E))."""
    if isinstance(pgt, CompiledPGT):
        res = _min_time_compiled(pgt, dop, bandwidth, max_trials)
        if anneal_iters:
            # the annealer is view-based and representation-agnostic;
            # explicit opt-in, so the per-move simulation cost is expected
            ms = _anneal(pgt, dop, bandwidth, anneal_iters, seed,
                         objective="time")
            n = len({s.partition for s in pgt.drops.values()})
            return PartitionResult(n, ms, "min_time", dop)
        return res
    uids = list(pgt.drops)
    uf = _UnionFind(uids)

    # level-width tracking per merged group (incremental DoP bound)
    depth: Dict[str, int] = {}
    for uid in pgt.topological_order():
        depth[uid] = max((depth[p] + 1 for p in pgt.predecessors(uid)),
                         default=0)
    width: Dict[str, Dict[int, int]] = {}
    for uid in uids:
        if pgt.drops[uid].kind == "app":
            width[uid] = {depth[uid]: 1}
        else:
            width[uid] = {}

    def merged_width_ok(ra: str, rb: str) -> bool:
        wa, wb = width[ra], width[rb]
        small, big = (wa, wb) if len(wa) < len(wb) else (wb, wa)
        return all(big.get(d, 0) + c <= dop for d, c in small.items())

    # heaviest-edge-first internalisation
    edges = sorted(
        ((edge_cost(pgt, s, d, bandwidth), s, d) for s, d, _ in pgt.edges),
        key=lambda t: -t[0])
    if max_trials is not None:
        edges = edges[:max_trials]

    _assign(pgt, _renumber(uf, pgt))
    best_time = simulate_makespan(pgt, dop, bandwidth)

    for cost, s, d in edges:
        ra, rb = uf.find(s), uf.find(d)
        if ra == rb:
            continue
        if not merged_width_ok(ra, rb):
            continue
        # tentatively merge and check completion time does not regress
        saved_parent = dict(uf.parent)
        saved_rank = dict(uf.rank)
        root = uf.union(ra, rb)
        _assign(pgt, _renumber(uf, pgt))
        t = simulate_makespan(pgt, dop, bandwidth)
        if t <= best_time + 1e-12:
            best_time = t
            other = rb if root == ra else ra
            merged = dict(width[root])
            for k, v in width[other].items():
                merged[k] = merged.get(k, 0) + v
            width[root] = merged
        else:
            uf.parent, uf.rank = saved_parent, saved_rank
    groups = _renumber(uf, pgt)
    _assign(pgt, groups)

    if anneal_iters:
        best_time = _anneal(pgt, dop, bandwidth, anneal_iters, seed,
                            objective="time")
    n = len({s.partition for s in pgt.drops.values()})
    return PartitionResult(n, best_time, "min_time", dop)


# ---------------------------------------------------------------------------
# min_res
# ---------------------------------------------------------------------------


def _min_res_compiled(pgt: CompiledPGT, deadline: float, dop: int,
                      bandwidth: float) -> PartitionResult:
    a = _extract(pgt)
    n = pgt.num_drops
    # min_res labellings are fold products, not the recorded merge chain —
    # any hierarchy from an earlier min_time run is stale for them
    pgt._partition_hierarchy = None
    if n == 0:
        pgt.partition = np.empty(0, dtype=np.int32)
        return PartitionResult(0, 0.0, "min_res", dop)
    lower = _critical_path_arrays(a, None, bandwidth)
    deadline = max(deadline, lower)

    exact = n <= EXACT_EVAL_MAX_DROPS
    # the fold probes below relabel non-monotonically; PrefixCP handles
    # that and shares its longest-path state across the O(log P) probes
    # (exactly equal to the from-scratch pass — see the test suite)
    probe_cp = None if exact else PrefixCP(a, bandwidth)

    def evaluate(lab: np.ndarray) -> float:
        if exact:
            return _simulate_arrays(a, lab, dop, bandwidth)
        return probe_cp.evaluate(lab)

    # cost-ordered internalisation, but — unlike min_time — the merge depth
    # is *chosen by the deadline*: among geometric prefixes of the sorted
    # edge list, take the deepest whose makespan still meets the deadline
    # (maximal internalisation under the DoP cap can serialize independent
    # apps and overshoot a deadline the trivial partitioning meets)
    snapshots = _merge_snapshots(pgt, a, dop, bandwidth)
    meeting = [s for s in snapshots if s[1] <= deadline * (1 + 1e-9)]
    if meeting:
        # deepest merge (fewest partitions) that meets the deadline
        _, t, labels = max(meeting, key=lambda s: s[0])
        # then binary-search the partition COUNT: fold the labelling into k
        # load-balanced bins (respecting the per-level DoP caps) and find
        # the smallest k whose evaluated makespan still meets the deadline.
        # This replaces the old greedy pairwise partition folding, which
        # stopped at the first blocked pair and left the count approximate.
        labels, t = _min_parts_search(pgt, _dense_labels(labels), deadline,
                                      dop, evaluate, t)
    else:
        # deadline unmeetable: best-effort fastest assignment
        _, t, labels = min(snapshots, key=lambda s: s[1])
        labels = _dense_labels(labels)

    pgt.partition = labels
    nparts = int(labels.max()) + 1 if labels.size else 0
    if not exact and n <= EXACT_FINAL_MAX_DROPS:
        t = _simulate_arrays(a, labels, dop, bandwidth)
    return PartitionResult(nparts, t, "min_res", dop)


def _fold_to_k(labels: np.ndarray, loads: np.ndarray,
               pwidths: List[Dict[int, int]], dop: int,
               k: int) -> Optional[np.ndarray]:
    """Fold a partitioning into <= k bins: heaviest partitions first, each
    into the least-loaded bin whose per-level app widths stay within the
    DoP cap.  Returns the folded (dense) labels, or None when the width
    caps make k bins infeasible."""
    import heapq as _hq
    nparts = loads.shape[0]
    if k >= nparts:
        return labels
    remap = np.empty(nparts, dtype=np.int32)
    # LPT with k machines: k empty bins up front, heaviest partition into
    # the least-loaded bin whose width caps still hold
    bin_load = [0.0] * k
    bin_width: List[Dict[int, int]] = [dict() for _ in range(k)]
    heap: List[Tuple[float, int]] = [(0.0, b) for b in range(k)]
    for p in np.argsort(-loads, kind="stable").tolist():
        wp = pwidths[p]
        placed = -1
        popped: List[Tuple[float, int]] = []
        while heap:
            load, b = _hq.heappop(heap)
            if load != bin_load[b]:
                continue                   # stale entry
            wb = bin_width[b]
            if all(wb.get(l, 0) + c <= dop for l, c in wp.items()):
                placed = b
                break
            popped.append((load, b))
        for e in popped:
            _hq.heappush(heap, e)
        if placed < 0:
            return None
        wb = bin_width[placed]
        for l, c in wp.items():
            wb[l] = wb.get(l, 0) + c
        bin_load[placed] += float(loads[p])
        _hq.heappush(heap, (bin_load[placed], placed))
        remap[p] = placed
    folded = remap[labels]
    # dense renumber (some of the k bins may have stayed empty)
    return np.unique(folded, return_inverse=True)[1].astype(np.int32)


def _min_parts_search(pgt: CompiledPGT, labels: np.ndarray, deadline: float,
                      dop: int, evaluate, t_best: float
                      ) -> Tuple[np.ndarray, float]:
    """Binary search on the partition count over the exact-sim evaluator.

    ``labels`` must meet the deadline.  Probes fold(k) for k in
    [1, nparts] and returns the labelling of the smallest k found whose
    evaluated makespan still meets the deadline (O(log P) evaluations).
    """
    nparts = int(labels.max()) + 1
    if nparts <= 1:
        return labels, t_best
    loads = np.bincount(labels, weights=pgt.weight_arr, minlength=nparts)
    lv = pgt.topo_levels()
    pwidths: List[Dict[int, int]] = [dict() for _ in range(nparts)]
    for i in np.flatnonzero(pgt.kind_arr == KIND_APP).tolist():
        w = pwidths[labels[i]]
        l = int(lv[i])
        w[l] = w.get(l, 0) + 1
    best_labels, best_t = labels, t_best
    lo, hi = 1, nparts
    while lo < hi:
        mid = (lo + hi) // 2
        folded = _fold_to_k(labels, loads, pwidths, dop, mid)
        if folded is not None:
            tt = evaluate(folded)
            if tt <= deadline * (1 + 1e-9):
                hi = mid
                best_labels, best_t = folded, tt
                continue
        lo = mid + 1
    return best_labels, best_t


def min_res(pgt, deadline: float, dop: int = 8,
            bandwidth: float = DEFAULT_BANDWIDTH,
            anneal_iters: int = 0, seed: int = 0) -> PartitionResult:
    """Greedy topological packing into as few partitions as possible."""
    if isinstance(pgt, CompiledPGT):
        res = _min_res_compiled(pgt, deadline, dop, bandwidth)
        if anneal_iters:
            ms = _anneal(pgt, dop, bandwidth, anneal_iters, seed,
                         objective="res", deadline=max(
                             deadline, critical_path(
                                 pgt, bandwidth, partitioned=False)))
            n = len({s.partition for s in pgt.drops.values()})
            return PartitionResult(n, ms, "min_res", dop)
        return res
    order = pgt.topological_order()
    # lower bound on achievable makespan: unpartitioned critical path
    lower = critical_path(pgt, bandwidth, partitioned=False)
    deadline = max(deadline, lower)

    parts: List[Set[str]] = []
    assignment: Dict[str, int] = {}

    def level_ok(members: Set[str], uid: str) -> bool:
        trial = set(members)
        trial.add(uid)
        return _partition_dop(pgt, trial) <= dop

    for uid in order:
        placed = False
        # prefer the partition of a predecessor (internalise heavy edges)
        cand: List[int] = []
        for p in pgt.predecessors(uid):
            if p in assignment and assignment[p] not in cand:
                cand.append(assignment[p])
        cand.extend(i for i in range(len(parts)) if i not in cand)
        for i in cand:
            if not level_ok(parts[i], uid):
                continue
            parts[i].add(uid)
            assignment[uid] = i
            pgt.drops[uid].partition = i
            t = simulate_makespan(pgt, dop, bandwidth)
            if t <= deadline * (1 + 1e-9):
                placed = True
                break
            parts[i].discard(uid)
            del assignment[uid]
        if not placed:
            parts.append({uid})
            assignment[uid] = len(parts) - 1
            pgt.drops[uid].partition = len(parts) - 1

    makespan = simulate_makespan(pgt, dop, bandwidth)
    if anneal_iters:
        makespan = _anneal(pgt, dop, bandwidth, anneal_iters, seed,
                           objective="res", deadline=deadline)
    n = len({s.partition for s in pgt.drops.values()})
    return PartitionResult(n, makespan, "min_res", dop)


# ---------------------------------------------------------------------------
# simulated annealing refinement (paper cites [51] simulated annealing)
# ---------------------------------------------------------------------------


def _anneal(pgt, dop: int, bandwidth: float,
            iters: int, seed: int, objective: str,
            deadline: Optional[float] = None) -> float:
    """Simulated-annealing refinement over the drops-view API
    (representation-agnostic: dict PGTs and CompiledPGTs both work)."""
    rng = random.Random(seed)
    uids = list(pgt.drops)
    cur_parts = {u: pgt.drops[u].partition for u in uids}
    nparts = max(cur_parts.values()) + 1 if cur_parts else 1

    def score() -> float:
        t = simulate_makespan(pgt, dop, bandwidth)
        n = len({s.partition for s in pgt.drops.values()})
        if objective == "time":
            return t + 1e-9 * n
        # res: minimise partitions, deadline as penalty
        pen = 0.0 if (deadline is None or t <= deadline * (1 + 1e-9)) \
            else 1e6 * (t - deadline)
        return n + pen

    cur = score()
    best = cur
    best_parts = dict(cur_parts)
    temp0 = max(cur, 1.0)
    for k in range(iters):
        u = rng.choice(uids)
        old = pgt.drops[u].partition
        new = rng.randrange(nparts)
        if new == old:
            continue
        pgt.drops[u].partition = new
        members = {x for x in uids if pgt.drops[x].partition == new}
        if _partition_dop(pgt, members) > dop:
            pgt.drops[u].partition = old
            continue
        s = score()
        temp = temp0 * (1.0 - k / max(iters, 1)) + 1e-9
        if s <= cur or rng.random() < math.exp(-(s - cur) / temp):
            cur = s
            if s < best:
                best = s
                best_parts = {x: pgt.drops[x].partition for x in uids}
        else:
            pgt.drops[u].partition = old
    for x, p in best_parts.items():
        pgt.drops[x].partition = p
    return simulate_makespan(pgt, dop, bandwidth)
