"""Compiled-graph templates — translate once, run per-observation.

The paper's managers are *resident* services: a pipeline shape is
translated once and executed for every observation (MUSER runs the same
graph per correlator frame; "SKA shakes hands with Summit" reuses one
translated graph across the whole campaign).  Our ``Pipeline`` was
one-shot — every ``run()`` paid full translate+map — and translate
dominates every tier below 100k drops.

This module amortises that cost:

* :func:`structural_hash` — a canonical digest of a logical graph plus
  the translate/mapping parameters that shape the physical graph
  (algorithm, dop, deadline, cluster layout).  Two structurally
  identical requests hash identically regardless of construction order.
* :class:`GraphTemplate` — a translated **and mapped**
  :class:`~repro.core.pgt.CompiledPGT` captured together with its
  precomputed per-node drop-id slices and warmed CSR caches.
  :meth:`GraphTemplate.materialize` re-instantiates a runnable
  :class:`~repro.core.session.CompiledSession` in O(drops): the CSR
  topology, weights, partition labels, node placement and node slices
  are *shared copy-on-write* (they are never mutated by execution);
  only the per-session state — the int8 state array, the dense payload
  table, the error map — is freshly allocated.
* :class:`TemplateCache` — a bounded LRU of templates keyed by
  structural hash (what :class:`repro.core.manager.EngineManager`
  serves sessions from).

The division of labour mirrors ``node_manager.py``'s
``getTemplates``/``materializeTemplate`` in the upstream DALiuGE
daemon hierarchy.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence

import numpy as np

from . import partition as partition_mod
from .logical import LogicalGraph
from .mapping import NodeInfo, map_partitions
from .pgt import CompiledPGT
from .session import CompiledSession
from .unroll import unroll


def translate_lg(lg: LogicalGraph, algorithm: str = "min_time",
                 dop: int = 8,
                 deadline: Optional[float] = None) -> CompiledPGT:
    """Stage 4 (translate): unroll + partition one logical graph.

    The single implementation behind ``Pipeline.translate`` and
    ``GraphTemplate.build`` — both one-shot runs and cached templates
    produce byte-identical physical graphs for the same inputs."""
    pgt = unroll(lg)
    if algorithm == "min_time":
        partition_mod.min_time(pgt, dop=dop)
    elif algorithm == "min_res":
        dl = deadline if deadline is not None else float("inf")
        partition_mod.min_res(pgt, deadline=dl, dop=dop)
    elif algorithm == "none":
        if isinstance(pgt, CompiledPGT):
            pgt.partition = np.arange(len(pgt), dtype=np.int32)
        else:
            for i, spec in enumerate(pgt.drops.values()):
                spec.partition = i
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return pgt


def structural_hash(lg: LogicalGraph, *, algorithm: str = "min_time",
                    dop: int = 8, deadline: Optional[float] = None,
                    nodes: Sequence[NodeInfo] = (),
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Canonical digest of (logical graph, translate params, cluster).

    Everything that shapes the translated+mapped physical graph goes
    into the key: the constructs and edges (sorted, so construction
    order does not matter), the partitioning algorithm and its
    parameters, and the node layout the mapper placed onto.  Values
    that are not JSON-serialisable fall back to ``repr`` — stable
    within a process, which is the cache's lifetime.
    """
    doc = lg.to_json()
    canonical = {
        "name": doc["name"],
        "constructs": sorted(doc["constructs"],
                             key=lambda c: c.get("name", "")),
        "edges": sorted((e["src"], e["dst"], bool(e.get("streaming")))
                        for e in doc["edges"]),
        "translate": {"algorithm": algorithm, "dop": dop,
                      "deadline": deadline},
        "nodes": [(n.name, n.island) for n in nodes],
        "extra": extra or {},
    }
    blob = json.dumps(canonical, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class GraphTemplate:
    """One translated+mapped physical graph, ready to instantiate.

    Immutable after :meth:`build` — every array it holds is shared by
    all sessions materialised from it, so nothing here may be written
    by execution (``tests/test_serving.py`` proves sessions of one
    template stay fully isolated).
    """

    __slots__ = ("key", "name", "pgt", "node_slices", "cross_node_edges",
                 "translate_s", "map_s", "built_at", "hits",
                 "materializations")

    def __init__(self, key: str, pgt: CompiledPGT,
                 node_slices: Dict[str, np.ndarray],
                 cross_node_edges: int,
                 translate_s: float, map_s: float) -> None:
        self.key = key
        self.name = pgt.name
        self.pgt = pgt
        self.node_slices = node_slices
        self.cross_node_edges = cross_node_edges
        self.translate_s = translate_s
        self.map_s = map_s
        self.built_at = time.monotonic()
        self.hits = 0                 # cache lookups served by this entry
        self.materializations = 0     # sessions instantiated from it

    @property
    def num_drops(self) -> int:
        return self.pgt.num_drops

    @classmethod
    def build(cls, lg: LogicalGraph, nodes: Sequence[NodeInfo], *,
              algorithm: str = "min_time", dop: int = 8,
              deadline: Optional[float] = None,
              key: Optional[str] = None) -> "GraphTemplate":
        """Translate + map one logical graph into a reusable template.

        Pays the full cold path once — unroll, partition, partition->node
        mapping, per-node slice argsort — and warms every lazy CSR cache
        so concurrent sessions never race to build them."""
        if key is None:
            key = structural_hash(lg, algorithm=algorithm, dop=dop,
                                  deadline=deadline, nodes=nodes)
        t0 = time.monotonic()
        pgt = translate_lg(lg, algorithm=algorithm, dop=dop,
                           deadline=deadline)
        translate_s = time.monotonic() - t0
        tm = time.monotonic()
        map_partitions(pgt, nodes)
        map_s = time.monotonic() - tm
        # the deploy argsort, paid once per shape instead of per session
        from .managers import _node_slices
        node_slices = _node_slices(pgt)
        if pgt.num_edges:
            cross = int((pgt.node_ids[pgt.edge_src]
                         != pgt.node_ids[pgt.edge_dst]).sum())
        else:
            cross = 0
        # warm the lazy caches shared by every future session: two
        # concurrent first-touch builds would compute identical arrays
        # (benign), but would still duplicate the work
        pgt.out_csr_with_eid()
        pgt.in_csr_with_eid()
        pgt.in_degrees()
        pgt.group_idx_arr()
        return cls(key, pgt, node_slices, cross, translate_s, map_s)

    def materialize(self, session_id: str, master: Any = None,
                    bus: Any = None) -> CompiledSession:
        """Instantiate a fresh runnable session in O(drops).

        No re-translate, no re-map, no argsort: the session shares the
        template's CSR topology, placement and node slices, and only
        allocates what execution mutates — the state array, the payload
        table and the error map.  With ``master`` the session is
        registered on the Node Drop Managers exactly as
        ``deploy_compiled`` would (same slices, no per-session sort).
        """
        session = CompiledSession(session_id, self.pgt, bus=bus)
        session.deploy()
        if master is not None:
            nms = master.node_managers()
            for name, indices in self.node_slices.items():
                nms[name].register_compiled(session, indices)
            master._sessions[session_id] = session
        else:
            session.node_slices = dict(self.node_slices)
        session.cross_node_edges = self.cross_node_edges
        self.materializations += 1
        return session


class TemplateCache:
    """Bounded LRU of :class:`GraphTemplate` keyed by structural hash.

    Thread-safe for lookup/insert; building a missing template happens
    *outside* the lock (translate can take seconds at the 1M tier and
    must not block cache hits for other shapes), so two threads racing
    on the same cold key may both build — the first insert wins and the
    duplicate is discarded, which is wasteful but correct.
    """

    def __init__(self, max_templates: int = 8,
                 metrics: Optional[Any] = None) -> None:
        if max_templates < 1:
            raise ValueError("max_templates must be >= 1")
        self.max_templates = max_templates
        self._entries: "OrderedDict[str, GraphTemplate]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # optional MetricsRegistry mirror of the counters above (the
        # ints stay authoritative — stats() reads them either way)
        if metrics is not None:
            self._m_hits = metrics.counter("templates.hits")
            self._m_misses = metrics.counter("templates.misses")
            self._m_evictions = metrics.counter("templates.evictions")
        else:
            self._m_hits = self._m_misses = self._m_evictions = None

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def lookup(self, key: str) -> Optional[GraphTemplate]:
        with self._lock:
            tpl = self._entries.get(key)
            if tpl is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                tpl.hits += 1
                if self._m_hits is not None:
                    self._m_hits.inc()
            return tpl

    def insert(self, tpl: GraphTemplate) -> GraphTemplate:
        """Insert (first writer wins); returns the cached instance."""
        with self._lock:
            cached = self._entries.get(key := tpl.key)
            if cached is not None:
                # lost the build race: serve the incumbent
                self._entries.move_to_end(key)
                return cached
            self._entries[key] = tpl
            self.misses += 1
            if self._m_misses is not None:
                self._m_misses.inc()
            while len(self._entries) > self.max_templates:
                self._entries.popitem(last=False)
                self.evictions += 1
                if self._m_evictions is not None:
                    self._m_evictions.inc()
            return tpl

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"templates": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}
