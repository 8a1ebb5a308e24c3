"""Hierarchical Drop Managers (paper §3.5, Fig. 6).

"A Node Drop Manager exists for each compute node ... ultimately responsible
for creating and deleting Drops.  Because compute nodes are grouped into Data
Islands, a Data Island Drop Manager exists at the Data Island level ...
Finally, in order to expose a single point of contact a Master Drop Manager
manages all Data Island Managers."

Deployment recursively traverses the hierarchy: the Master splits the PG by
island placement, each Island splits by node placement and records the edges
crossing node boundaries, communicating them to the relevant Node Managers
afterwards.

This container is one host, so "nodes" are thread pools; the structure,
splitting logic and bookkeeping are exactly the paper's, and node failure /
island accounting operate on these objects.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .drop import AppDrop, DataDrop, Drop, DropState, make_payload
from .events import EventBus
from .mapping import NodeInfo
from .pgt import CompiledPGT
from .procpool import PayloadPlane, ProcExecutor, TrackingThreadPool
from .session import CompiledSession, Session
from .unroll import DropSpec, PhysicalGraphTemplate
from .util import safe_uid as _safe

# ---------------------------------------------------------------------------
# Application registry — pipeline components (paper §3.1)
# ---------------------------------------------------------------------------

AppFunc = Callable[[List[DataDrop], List[DataDrop], AppDrop], Any]

_APP_REGISTRY: Dict[str, AppFunc] = {}


def register_app(name: str, *, streaming: bool = False,
                 finish: Optional[AppFunc] = None
                 ) -> Callable[[AppFunc], AppFunc]:
    """Register a pipeline component (paper §3.1).

    ``streaming=True`` marks the function as a *chunk handler*: it is
    called as ``fn(value, app)`` once per chunk arriving on a streaming
    input (§4/Fig. 10), accumulating across chunks in ``app.scratch``.
    The optional ``finish(ok_inputs, outputs, app)`` runs at batch
    resolution (all inputs terminal) to emit final outputs; without it
    the drop completes without writing.  Both engines honour the marks —
    see ``docs/streaming.md``."""
    def deco(fn: AppFunc) -> AppFunc:
        if streaming:
            fn.streaming = True            # type: ignore[attr-defined]
        if finish is not None:
            fn.finish = finish             # type: ignore[attr-defined]
        _APP_REGISTRY[name] = fn
        return fn
    return deco


def get_app(name: str) -> AppFunc:
    if name not in _APP_REGISTRY:
        raise KeyError(f"app {name!r} not registered "
                       f"(known: {sorted(_APP_REGISTRY)})")
    return _APP_REGISTRY[name]


# -- built-in apps (paper §3.7: bash commands, python funcs, sockets...) ------


@register_app("noop")
def _noop(inputs: List[DataDrop], outputs: List[DataDrop],
          app: AppDrop) -> None:
    for o in outputs:
        o.write(None)


@register_app("identity")
def _identity(inputs: List[DataDrop], outputs: List[DataDrop],
              app: AppDrop) -> None:
    vals = [i.read() for i in inputs]
    v = vals[0] if len(vals) == 1 else vals
    for o in outputs:
        o.write(v)


@register_app("sleep")
def _sleep(inputs: List[DataDrop], outputs: List[DataDrop],
           app: AppDrop) -> None:
    time.sleep(float(app.meta.get("seconds", 0.001)))
    for o in outputs:
        o.write(None)


# the built-in implementations the compiled engine may replace with
# vectorised fast paths — if a user re-registers one of these names, the
# registry entry no longer ``is`` the builtin and the fast path must yield
BUILTIN_FAST_APPS: Dict[str, AppFunc] = {
    "noop": _noop, "identity": _identity, "sleep": _sleep}


@register_app("bash")
def _bash(inputs: List[DataDrop], outputs: List[DataDrop],
          app: AppDrop) -> None:
    import subprocess
    cmd = app.meta["command"]
    res = subprocess.run(cmd, shell=True, capture_output=True, text=True,
                         timeout=app.meta.get("timeout", 60))
    if res.returncode != 0:
        raise RuntimeError(f"bash app failed ({res.returncode}): "
                           f"{res.stderr[:500]}")
    for o in outputs:
        o.write(res.stdout)


# ---------------------------------------------------------------------------
# Node Drop Manager
# ---------------------------------------------------------------------------


class NodeDropManager:
    """Creates/deletes Drops for one compute node; bottom of the hierarchy."""

    #: seconds shutdown() waits for in-flight app calls before abandoning
    #: them and failing their sessions
    SHUTDOWN_GRACE_S = 5.0

    def __init__(self, info: NodeInfo, max_workers: int = 4) -> None:
        self.info = info
        self.executor = self._make_executor(max_workers)
        self.sessions: Dict[str, Dict[str, Drop]] = {}
        # compiled sessions: session id -> drop-id index slice on this node
        self.compiled_sessions: Dict[str, np.ndarray] = {}
        # sessions deployed here, weakly held so shutdown can fail the ones
        # it abandons work for without pinning closed sessions in memory
        self._session_refs: "weakref.WeakValueDictionary[str, Any]" = \
            weakref.WeakValueDictionary()
        self._lock = threading.Lock()

    def _make_executor(self, max_workers: int) -> TrackingThreadPool:
        return TrackingThreadPool(
            max_workers=max_workers,
            thread_name_prefix=f"ndm-{self.info.name}")

    @property
    def name(self) -> str:
        return self.info.name

    # -- deployment ------------------------------------------------------------
    def create_drops(self, session: Session,
                     specs: Sequence[DropSpec]) -> Dict[str, Drop]:
        """Instantiate the Drops placed on this node (paper: NM deployment =
        'checking the validity of the PG and the creation of the Session and
        all its Drops')."""
        created: Dict[str, Drop] = {}
        for spec in specs:
            if spec.node != self.name:
                raise ValueError(
                    f"drop {spec.uid} placed on {spec.node}, "
                    f"not this node {self.name}")
            drop = self._instantiate(spec, session.bus)
            created[spec.uid] = drop
            session.add_drop(drop)
        with self._lock:
            self.sessions.setdefault(session.session_id, {}).update(created)
        self._session_refs[session.session_id] = session
        return created

    def _instantiate(self, spec: DropSpec, bus: EventBus) -> Drop:
        meta = {"oid": spec.oid, "construct": spec.construct, **spec.params}
        if spec.kind == "data":
            path = None
            if spec.payload_kind == "file":
                path = spec.params.get(
                    "path", f"/tmp/repro_drops/{_safe(spec.uid)}.pkl")
            payload = make_payload(spec.payload_kind, path=path)
            d: Drop = DataDrop(spec.uid, payload=payload, bus=bus,
                               node=self.name, meta=meta,
                               lifetime=spec.params.get("lifetime"))
            d.meta["data_volume"] = spec.data_volume
        else:
            func = get_app(spec.app) if spec.app else None
            d = AppDrop(spec.uid, func,
                        error_threshold=spec.error_threshold,
                        executor=self.executor, bus=bus, node=self.name,
                        meta=meta)
            d.meta["execution_time"] = spec.execution_time
        return d

    def register_compiled(self, session: CompiledSession,
                          indices: np.ndarray) -> None:
        """Batched deploy: record the drop-id slice placed on this node.

        The array path's replacement for ``create_drops`` — no per-drop
        instantiation; the drops *are* the rows of the session's state
        arrays, and this node owns the ``indices`` view of them.
        """
        with self._lock:
            self.compiled_sessions[session.session_id] = indices
        self._session_refs[session.session_id] = session
        session.node_slices[self.name] = indices

    # -- failure simulation -----------------------------------------------------
    def fail(self) -> None:
        """Simulate node death: everything non-terminal on it is lost
        (plus volatile COMPLETED memory payloads — memory dies with the
        node).  Object sessions recover via ``fault.FaultManager``;
        compiled sessions via ``resilience.CompiledFaultManager``."""
        self.info.alive = False

    def shutdown(self) -> None:
        """Drain in-flight app calls with a bounded grace, then stop the pool.

        ``executor.shutdown(wait=False, cancel_futures=True)`` alone abandons
        calls mid-write: a session shut down during dispatch was left
        non-terminal with half-written payloads.  Now running + queued work
        gets ``SHUTDOWN_GRACE_S`` seconds to finish; anything still pending
        after that is cancelled and every non-terminal session deployed here
        is marked FAILED with an error naming the abandonment."""
        leftover = self.executor.drain(self.SHUTDOWN_GRACE_S)
        self.executor.shutdown(wait=False, cancel_futures=True)
        if leftover:
            self._fail_open_sessions(len(leftover))

    def _fail_open_sessions(self, n_inflight: int) -> None:
        reason = (f"node {self.name} shut down with {n_inflight} in-flight "
                  f"app call(s) abandoned after {self.SHUTDOWN_GRACE_S}s "
                  "grace; payloads may be partially written")
        for session in list(self._session_refs.values()):
            fail = getattr(session, "fail", None)
            if fail is not None:
                fail(reason)


class ProcNodeDropManager(NodeDropManager):
    """Node manager whose executor is a crash-isolated spawn worker process.

    Same ``node_executors()`` contract as the thread-backed manager — the
    executor still has ``submit`` (orchestration thunks run on a small local
    thread pool) — plus ``run_batch``, which the compiled dispatcher detects
    and routes Python-app batches through.  All nodes of one island share a
    :class:`~repro.core.procpool.PayloadPlane`, so intra-island array edges
    travel as shared-memory descriptors; a dead worker flips
    ``info.alive`` so the scheduler and resilience loop see a failed node.
    """

    def __init__(self, info: NodeInfo, plane: PayloadPlane,
                 max_workers: int = 4,
                 shm_min_bytes: Optional[int] = None) -> None:
        self._plane = plane
        self._shm_min_bytes = shm_min_bytes
        plane.retain()
        super().__init__(info, max_workers=max_workers)

    @property
    def plane(self) -> PayloadPlane:
        return self._plane

    def _make_executor(self, max_workers: int) -> ProcExecutor:
        ex = ProcExecutor(self.info.name, plane=self._plane,
                          submit_workers=max_workers,
                          shm_min_bytes=self._shm_min_bytes)
        ex.on_lost = self._on_worker_lost
        return ex

    def _on_worker_lost(self) -> None:
        self.info.alive = False

    def shutdown(self) -> None:
        leftover = self.executor.drain(self.SHUTDOWN_GRACE_S)
        self.executor.shutdown()          # stops the worker process too
        if leftover:
            self._fail_open_sessions(len(leftover))
        self._plane.release()


# ---------------------------------------------------------------------------
# Data Island Drop Manager
# ---------------------------------------------------------------------------


class DataIslandDropManager:
    def __init__(self, name: str,
                 node_managers: Sequence[NodeDropManager]) -> None:
        self.name = name
        self.node_managers = {nm.name: nm for nm in node_managers}
        # edges leaving/entering this island, recorded PER SESSION (a
        # single shared list used to accumulate across sessions and leak
        # one session's edges into the next deployment's wiring pass)
        self.cross_node_edges: Dict[str, List[Tuple[str, str, bool]]] = {}

    def deploy(self, session: Session, pgt: PhysicalGraphTemplate,
               specs: Sequence[DropSpec]) -> None:
        """Split by node placement; record crossing edges; wire afterwards."""
        by_node: Dict[str, List[DropSpec]] = {}
        for spec in specs:
            by_node.setdefault(spec.node or "?", []).append(spec)
        unknown = set(by_node) - set(self.node_managers)
        if unknown:
            raise ValueError(f"island {self.name}: drops placed on unknown "
                             f"nodes {sorted(unknown)}")
        for node, nspecs in by_node.items():
            self.node_managers[node].create_drops(session, nspecs)
        # intra-island edges: wire those whose both ends live here
        mine = {s.uid for s in specs}
        crossing = self.cross_node_edges.setdefault(session.session_id, [])
        for s, d, streaming in pgt.edges:
            if s in mine and d in mine:
                _wire(session, s, d, streaming)
            elif s in mine or d in mine:
                crossing.append((s, d, streaming))

    def deploy_compiled(self, session: CompiledSession, pgt: CompiledPGT,
                        by_node: Dict[str, np.ndarray]) -> None:
        """Array-native deployment: hand each node its drop-id slice.

        No edge wiring happens — adjacency stays in the shared CSR arrays
        and the frontier scheduler reads it directly; islands only
        validate node placement, exactly the paper's Fig. 6 split.
        """
        unknown = set(by_node) - set(self.node_managers)
        if unknown:
            raise ValueError(f"island {self.name}: drops placed on unknown "
                             f"nodes {sorted(unknown)}")
        for node, indices in by_node.items():
            self.node_managers[node].register_compiled(session, indices)

    def nodes_alive(self) -> List[str]:
        return [n for n, nm in self.node_managers.items() if nm.info.alive]


# ---------------------------------------------------------------------------
# Master Drop Manager
# ---------------------------------------------------------------------------


class MasterDropManager:
    """Single point of contact (paper §3.5); splits the PG by island."""

    def __init__(self, islands: Sequence[DataIslandDropManager]) -> None:
        self.islands = {im.name: im for im in islands}
        self._sessions: Dict[str, Session] = {}
        self._session_counter = 0

    # island of a node
    def _island_of(self, node: str) -> DataIslandDropManager:
        for im in self.islands.values():
            if node in im.node_managers:
                return im
        raise KeyError(f"node {node!r} not managed by any island")

    def create_session(self, session_id: Optional[str] = None,
                       bus: Optional[EventBus] = None) -> Session:
        if session_id is None:
            self._session_counter += 1
            session_id = f"session-{self._session_counter}"
        s = Session(session_id, bus=bus)
        self._sessions[session_id] = s
        return s

    def deploy(self, session: Session,
               pgt: PhysicalGraphTemplate) -> None:
        """Recursive deployment (paper Fig. 6): split by island, then node."""
        session.deploy()
        by_island: Dict[str, List[DropSpec]] = {}
        for spec in pgt.drops.values():
            if spec.node is None:
                raise ValueError(f"drop {spec.uid} not mapped to a node; "
                                 "run mapping.map_partitions first")
            im = self._island_of(spec.node)
            by_island.setdefault(im.name, []).append(spec)
        for iname, specs in by_island.items():
            self.islands[iname].deploy(session, pgt, specs)
        # wire edges crossing island boundaries (recorded by the islands,
        # scoped to THIS session; a cross-island edge appears in both
        # endpoint islands' records and must be wired exactly once)
        sid = session.session_id
        wired: Set[Tuple[str, str, bool]] = set()
        for im in self.islands.values():
            record = im.cross_node_edges.get(sid, [])
            for key in record:
                if key in wired:
                    continue
                s, d, streaming = key
                if s in session.drops and d in session.drops:
                    _wire(session, s, d, streaming)
                    wired.add(key)
            remaining = [e for e in record if e not in wired]
            if remaining:
                im.cross_node_edges[sid] = remaining
            else:
                im.cross_node_edges.pop(sid, None)

    def deploy_compiled(self, session: CompiledSession,
                        pgt: CompiledPGT) -> None:
        """Recursive array-native deployment (paper Fig. 6, batched).

        One stable ``argsort`` over ``node_ids`` yields every node's
        drop-id slice; islands get their nodes' slices — no DropSpec
        views are materialised anywhere on this path.
        """
        session.deploy()
        node_ids = pgt.node_ids
        if node_ids.size and int(node_ids.min()) < 0:
            first = int(np.flatnonzero(node_ids < 0)[0])
            raise ValueError(
                f"drop {pgt.uid_of(first)} not mapped to a node; "
                "run mapping.map_partitions first")
        by_island: Dict[str, Dict[str, np.ndarray]] = {}
        for name, indices in _node_slices(pgt).items():
            im = self._island_of(name)
            by_island.setdefault(im.name, {})[name] = indices
        for iname, by_node in by_island.items():
            self.islands[iname].deploy_compiled(session, pgt, by_node)
        if pgt.num_edges:
            session.cross_node_edges = int(
                (node_ids[pgt.edge_src] != node_ids[pgt.edge_dst]).sum())
        self._sessions[session.session_id] = session  # type: ignore[assignment]

    def refresh_compiled_slices(
            self, session: CompiledSession, pgt: CompiledPGT,
            moved_by_node: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Re-register per-node drop-id slices after ``node_ids`` changed
        (the batched analogue of re-deploying migrated drops onto their
        new Node Managers).

        With ``moved_by_node`` (new node -> migrated drop ids, from fault
        recovery) the update is incremental — O(moved + slices touched)
        instead of re-argsorting the whole graph; without it, slices are
        rebuilt from scratch."""
        nms = self.node_managers()
        if moved_by_node is None or not session.node_slices:
            sid = session.session_id
            for nm in nms.values():
                nm.compiled_sessions.pop(sid, None)
            session.node_slices.clear()
            for name, indices in _node_slices(pgt).items():
                self._island_of(name)   # placement must still be managed
                nms[name].register_compiled(session, indices)
            return
        gained = dict(moved_by_node)
        for node, old in list(session.node_slices.items()):
            add = gained.pop(node, None)
            if nms[node].info.alive:
                # live slices only ever gain (drops migrate OFF dead nodes)
                if add is not None:
                    nms[node].register_compiled(
                        session, np.concatenate([old, add]))
                continue
            # dead node: keep only the drops still placed there (terminal
            # survivors); everything migrated points elsewhere now
            keep = old[pgt.node_ids[old] == pgt.node_id_for(node)]
            new = keep if add is None else np.concatenate([keep, add])
            nms[node].register_compiled(session, new)
        for node, add in gained.items():   # nodes with no prior slice
            self._island_of(node)
            nms[node].register_compiled(session, add)

    def node_managers(self) -> Dict[str, NodeDropManager]:
        out: Dict[str, NodeDropManager] = {}
        for im in self.islands.values():
            out.update(im.node_managers)
        return out

    def live_node_managers(self) -> Dict[str, NodeDropManager]:
        """Node managers still alive (the migration-target view)."""
        return {n: nm for n, nm in self.node_managers().items()
                if nm.info.alive}

    def node_executors(self) -> Dict[str, ThreadPoolExecutor]:
        """Per-node thread pools of the live nodes — what the compiled
        engine's threaded wave dispatch overlaps Python-app batches on
        (``exec_compiled.execute_frontier(..., executors=...)``)."""
        return {n: nm.executor
                for n, nm in self.node_managers().items()
                if nm.info.alive}

    def dead_nodes(self) -> List[str]:
        return [n for n, nm in self.node_managers().items()
                if not nm.info.alive]

    def shutdown(self) -> None:
        for nm in self.node_managers().values():
            nm.shutdown()


def _node_slices(pgt: CompiledPGT) -> Dict[str, np.ndarray]:
    """Per-node drop-id index slices from ``node_ids`` — one stable
    argsort, shared by ``deploy_compiled`` and slice re-registration."""
    node_ids = pgt.node_ids
    order = np.argsort(node_ids, kind="stable").astype(np.int64)
    uniq, starts = np.unique(node_ids[order], return_index=True)
    bounds = np.append(starts, node_ids.size)
    return {pgt.node_names[nid]: order[bounds[k]:bounds[k + 1]]
            for k, nid in enumerate(uniq.tolist())}


def _wire(session: Session, src: str, dst: str, streaming: bool) -> None:
    s, d = session.drops[src], session.drops[dst]
    if isinstance(s, DataDrop) and isinstance(d, AppDrop):
        d.add_input(s, streaming=streaming)
    elif isinstance(s, AppDrop) and isinstance(d, DataDrop):
        s.add_output(d)
    else:
        raise ValueError(f"invalid edge {src}->{dst}: "
                         f"{type(s).__name__}->{type(d).__name__}")


# ---------------------------------------------------------------------------
# Convenience topology builder
# ---------------------------------------------------------------------------


def make_cluster(num_nodes: int, num_islands: int = 1,
                 workers_per_node: int = 4, workers: str = "thread",
                 shm_min_bytes: Optional[int] = None
                 ) -> Tuple[MasterDropManager, List[NodeInfo]]:
    """Build a Master/Island/Node manager hierarchy (paper Fig. 6).

    ``workers="process"`` gives every node a crash-isolated spawn worker
    (:class:`ProcNodeDropManager`) and every island one shared
    :class:`~repro.core.procpool.PayloadPlane`; ``shm_min_bytes`` tunes the
    array-size threshold below which values ship pickled instead of via
    shared memory (see ``docs/multiprocess.md``).
    """
    if num_islands < 1 or num_nodes < num_islands:
        raise ValueError("need >=1 island and nodes >= islands")
    if workers not in ("thread", "process"):
        raise ValueError(f"unknown workers mode {workers!r}")
    nodes: List[NodeInfo] = []
    islands: List[DataIslandDropManager] = []
    per = num_nodes // num_islands
    extra = num_nodes % num_islands
    idx = 0
    for i in range(num_islands):
        count = per + (1 if i < extra else 0)
        plane: Optional[PayloadPlane] = None
        if workers == "process":
            plane = (PayloadPlane() if shm_min_bytes is None
                     else PayloadPlane(shm_min_bytes=shm_min_bytes))
        nms: List[NodeDropManager] = []
        for _ in range(count):
            info = NodeInfo(name=f"node{idx}", island=f"island{i}")
            nodes.append(info)
            if plane is not None:
                nms.append(ProcNodeDropManager(
                    info, plane, max_workers=workers_per_node,
                    shm_min_bytes=shm_min_bytes))
            else:
                nms.append(NodeDropManager(info,
                                           max_workers=workers_per_node))
            idx += 1
        islands.append(DataIslandDropManager(f"island{i}", nms))
    return MasterDropManager(islands), nodes
