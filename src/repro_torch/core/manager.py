"""Resident multi-tenant engine (paper §3.5 — the MM/DIM/NM daemons).

The paper's Drop Managers are long-lived services: a Master Manager is
"a single point of contact" that stays up across observations, and each
observation is just a new *session* on the already-running hierarchy.
:class:`EngineManager` is that shape for the compiled path:

* one resident cluster (``make_cluster``) whose per-node thread pools
  are created **once** and shared by every session — ``Pipeline`` used
  to rebuild them per run,
* a :class:`~repro.core.templates.TemplateCache` so repeated
  submissions of the same logical-graph shape skip translate+map and
  pay only an O(drops) :meth:`~repro.core.templates.GraphTemplate.materialize`,
* bounded **admission control**: at most ``max_concurrent`` sessions
  execute at once and at most ``max_pending`` wait; beyond that
  ``submit`` raises :class:`AdmissionError` (or blocks, if asked to)
  instead of letting queue depth grow without bound,
* per-session **error isolation**: a failing app (or a crashing
  dispatch) marks *that* session's report failed and never unwinds the
  manager or its neighbours,
* session **close/eviction** that actually frees the dense payload
  table (:meth:`~repro.core.session.CompiledSession.close`) and
  unregisters the session's slices from every Node Drop Manager.

``benchmarks/bench_serve.py`` measures this as sustained sessions/s
with p50/p99 session latency — the millions-of-users serving shape the
ROADMAP targets.
"""
from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from .engine import ExecutionReport
from .events import EventBus
from .logical import LogicalGraph
from .session import CompiledSession, SessionState
from .telemetry import (LATENCY_BUCKETS_S, MetricsRegistry,
                        TelemetryConfig)
from .templates import GraphTemplate, TemplateCache, structural_hash

__all__ = ["AdmissionError", "SessionTicket", "EngineManager"]


class AdmissionError(RuntimeError):
    """The manager's admission queue is full (``max_concurrent`` running
    plus ``max_pending`` waiting); the caller should back off and retry."""


class SessionTicket:
    """Handle for one submitted session: its future report + timings.

    ``latency`` is the *session* latency a client observes — submit to
    report, queueing included — which is what bench_serve's p50/p99
    quantiles are computed over.
    """

    __slots__ = ("session_id", "template_key", "session", "future",
                 "submitted_at", "started_at", "finished_at", "_accounted")

    def __init__(self, session_id: str, template_key: str,
                 session: CompiledSession, future: "Future[ExecutionReport]"
                 ) -> None:
        self.session_id = session_id
        self.template_key = template_key
        self.session = session
        self.future = future
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._accounted = threading.Event()   # manager _on_done ran

    def result(self, timeout: Optional[float] = None) -> ExecutionReport:
        report = self.future.result(timeout)
        # the done-callback stamps finished_at, but future waiters can
        # wake *before* callbacks run — stamp here too so latency is
        # never None, and wait for the manager's accounting callback so
        # stats()/metrics are consistent once result() has returned
        if self.finished_at is None:
            self.finished_at = time.monotonic()
        self._accounted.wait(timeout=5.0)
        return report

    def done(self) -> bool:
        return self.future.done()

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def queue_delay(self) -> Optional[float]:
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at


class EngineManager:
    """Resident compiled-path engine: template cache + concurrent sessions.

    Usage::

        with EngineManager(num_nodes=4, max_concurrent=4) as mgr:
            t1 = mgr.submit(lg, inputs={"in": 1})       # cold: translate+map
            t2 = mgr.submit(lg, inputs={"in": 2})       # warm: cache hit
            r1, r2 = t1.result(), t2.result()

    All sessions of one template share its ``CompiledPGT`` arrays
    (read-only) and the manager's node thread pools; each gets fresh
    state/payload/error storage, so concurrent sessions are fully
    isolated (``tests/test_serving.py``).
    """

    def __init__(self, num_nodes: int = 2, num_islands: int = 1,
                 workers_per_node: int = 4, dop: int = 8,
                 algorithm: str = "min_time",
                 deadline: Optional[float] = None,
                 max_templates: int = 8,
                 max_concurrent: int = 4,
                 max_pending: int = 64,
                 keep_finished: int = 32,
                 telemetry: Optional[TelemetryConfig] = None,
                 workers: str = "thread") -> None:
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if max_pending < 0:
            raise ValueError("max_pending must be >= 0")
        from .managers import make_cluster
        self.master, self.nodes = make_cluster(
            num_nodes, num_islands, workers_per_node, workers=workers)
        self.dop = dop
        self.algorithm = algorithm
        self.deadline = deadline
        self.telemetry = telemetry if telemetry is not None \
            else TelemetryConfig()
        self.metrics = MetricsRegistry() if self.telemetry.metrics else None
        if self.metrics is not None:
            # pre-created handles: submit/_on_done touch metric locks
            # only, never the registry dict
            self._m_submitted = self.metrics.counter("manager.submitted")
            self._m_rejected = self.metrics.counter("manager.rejected")
            self._m_completed = self.metrics.counter("manager.completed")
            self._m_failed = self.metrics.counter("manager.failed")
            self._m_queue = self.metrics.gauge("manager.queue_depth")
            self._m_latency = self.metrics.histogram(
                "manager.session_latency_s", LATENCY_BUCKETS_S)
        self.templates = TemplateCache(max_templates, metrics=self.metrics)
        self.max_concurrent = max_concurrent
        self.max_pending = max_pending
        self.keep_finished = keep_finished
        # satellite: node executors cached once for the manager's lifetime
        # (Pipeline rebuilt the dict per run; the pools themselves now also
        # outlive any single session and are shut down only by close())
        self.executors = self.master.node_executors()
        self._pool = ThreadPoolExecutor(
            max_workers=max_concurrent, thread_name_prefix="engine-session")
        # admission: running + pending slots; acquired in submit(),
        # released when the session's report future resolves
        self._slots = threading.BoundedSemaphore(max_concurrent + max_pending)
        self._lock = threading.Lock()
        self._tickets: "Dict[str, SessionTicket]" = {}
        self._finished_order: List[str] = []
        self._session_counter = 0
        self._closed = False
        self.stats_counters = {
            "submitted": 0, "completed": 0, "failed": 0,
            "rejected": 0, "closed_sessions": 0}

    # -- templates ---------------------------------------------------------
    def get_template(self, lg: LogicalGraph, *,
                     algorithm: Optional[str] = None,
                     dop: Optional[int] = None,
                     deadline: Optional[float] = None) -> GraphTemplate:
        """Cached translate+map for one logical graph shape.

        Cold path builds outside the cache lock (translate can take
        seconds at large tiers); racing builders are deduplicated by
        first-insert-wins."""
        algorithm = algorithm if algorithm is not None else self.algorithm
        dop = dop if dop is not None else self.dop
        deadline = deadline if deadline is not None else self.deadline
        key = structural_hash(lg, algorithm=algorithm, dop=dop,
                              deadline=deadline, nodes=self.nodes)
        tpl = self.templates.lookup(key)
        if tpl is not None:
            return tpl
        tpl = GraphTemplate.build(lg, self.nodes, algorithm=algorithm,
                                  dop=dop, deadline=deadline, key=key)
        return self.templates.insert(tpl)

    # -- session submission ------------------------------------------------
    def submit(self, lg: LogicalGraph, *,
               inputs: Optional[Dict[str, Any]] = None,
               timeout: float = 60.0,
               session_id: Optional[str] = None,
               block: bool = False,
               admission_timeout: Optional[float] = None) -> SessionTicket:
        """Admit one session and schedule it on the session pool.

        Non-blocking by default: raises :class:`AdmissionError` when all
        ``max_concurrent + max_pending`` slots are taken.  With
        ``block=True`` waits (up to ``admission_timeout``) for a slot.
        """
        if self._closed:
            raise RuntimeError("EngineManager is closed")
        acquired = (self._slots.acquire(timeout=admission_timeout)
                    if block else self._slots.acquire(blocking=False))
        if not acquired:
            with self._lock:
                self.stats_counters["rejected"] += 1
            if self.metrics is not None:
                self._m_rejected.inc()
            raise AdmissionError(
                f"admission queue full ({self.max_concurrent} running + "
                f"{self.max_pending} pending)")
        try:
            template = self.get_template(lg)
            if session_id is None:
                with self._lock:
                    self._session_counter += 1
                    session_id = (f"svc-{self._session_counter}-"
                                  f"{uuid.uuid4().hex[:6]}")
            session = template.materialize(session_id, master=self.master)
            if self.telemetry.timeline:
                session.enable_timeline()
            session.metrics = self.metrics
            if inputs:
                for uid, value in inputs.items():
                    session.write(uid, value)
            future = self._pool.submit(
                self._run, session, template, timeout)
        except BaseException:
            self._slots.release()
            raise
        ticket = SessionTicket(session_id, template.key, session, future)
        with self._lock:
            self._tickets[session_id] = ticket
            self.stats_counters["submitted"] += 1
        if self.metrics is not None:
            self._m_submitted.inc()
            self._m_queue.inc()

        def _on_done(fut: "Future[ExecutionReport]",
                     t: SessionTicket = ticket) -> None:
            if t.finished_at is None:
                t.finished_at = time.monotonic()
            self._slots.release()
            failed = (fut.cancelled() or fut.exception() is not None
                      or not fut.result().ok)
            with self._lock:
                self.stats_counters["failed" if failed else "completed"] += 1
                self._finished_order.append(t.session_id)
            if self.metrics is not None:
                self._m_queue.dec()
                (self._m_failed if failed else self._m_completed).inc()
                lat = t.latency
                if lat is not None:
                    self._m_latency.observe(lat)
            t._accounted.set()
            self._evict_finished()

        future.add_done_callback(_on_done)
        return ticket

    def _run(self, session: CompiledSession, template: GraphTemplate,
             timeout: float) -> ExecutionReport:
        """Execute one admitted session; never lets an exception escape
        into the pool — errors become a failed report (isolation)."""
        from .exec_compiled import execute_frontier
        ticket = self._tickets.get(session.session_id)
        if ticket is not None:
            ticket.started_at = time.monotonic()
        t0 = time.monotonic()
        try:
            finished = execute_frontier(session, timeout=timeout,
                                        executors=self.executors)
            errs = [f"{r.uid}: {(r.error_info or '')[:200]}"
                    for r in session.errors()]
            state = session.state.value if finished else "TIMEOUT"
        except Exception as exc:   # scheduler crash: this session only
            finished = False
            errs = [f"<scheduler>: {type(exc).__name__}: {exc}"[:240]]
            state = "FAILED"
        return ExecutionReport(
            session_id=session.session_id,
            state=state,
            status_counts=session.status(),
            wall_time=time.monotonic() - t0,
            events_published=session.bus.published,
            errors=errs,
        )

    def run(self, lg: LogicalGraph, *,
            inputs: Optional[Dict[str, Any]] = None,
            timeout: float = 60.0,
            session_id: Optional[str] = None) -> ExecutionReport:
        """Synchronous convenience: submit (blocking admission) + wait."""
        ticket = self.submit(lg, inputs=inputs, timeout=timeout,
                             session_id=session_id, block=True)
        return ticket.result()

    # -- session lifecycle -------------------------------------------------
    def get_session(self, session_id: str) -> Optional[CompiledSession]:
        t = self._tickets.get(session_id)
        return t.session if t is not None else None

    def close_session(self, session_id: str) -> bool:
        """Release one finished session's resources *for real*: drop the
        dense payload table and unregister its slices from every NM."""
        with self._lock:
            ticket = self._tickets.pop(session_id, None)
        if ticket is None:
            return False
        for nm in self.master.node_managers().values():
            nm.compiled_sessions.pop(session_id, None)
        self.master._sessions.pop(session_id, None)
        ticket.session.close()
        with self._lock:
            self.stats_counters["closed_sessions"] += 1
        return True

    def _evict_finished(self) -> None:
        """Retain only the newest ``keep_finished`` finished sessions;
        older ones are closed (payload tables freed) automatically."""
        to_close: List[str] = []
        with self._lock:
            self._finished_order = [
                sid for sid in self._finished_order if sid in self._tickets]
            excess = len(self._finished_order) - self.keep_finished
            if excess > 0:
                to_close = self._finished_order[:excess]
        for sid in to_close:
            self.close_session(sid)

    # -- monitoring --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self.stats_counters)
            out["open_sessions"] = len(self._tickets)
        out["templates"] = self.templates.stats()
        if self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
        return out

    # -- shutdown ----------------------------------------------------------
    def close(self, wait: bool = True) -> None:
        """Drain the session pool, close every session, then shut the
        node pools down — the one place shared executors die."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=wait)
        for sid in list(self._tickets):
            self.close_session(sid)
        self.master.shutdown()

    def __enter__(self) -> "EngineManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
