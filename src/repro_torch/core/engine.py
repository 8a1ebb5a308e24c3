"""Engine facade — the six-stage pipeline in one object (paper Fig. 1).

``Pipeline`` wires the stages together:

  compose (LGT) -> parametrise (LG) -> translate (unroll+partition, PGT)
  -> deploy (map+managers, PG) -> execute (data-activated cascade)

Each stage is independently accessible (the separation of concerns the paper
insists on); this facade is what examples, the training launcher and the
benchmarks use.
"""
from __future__ import annotations

import time
import uuid
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from .config import EngineConfig, config_from_kwargs
from .fault import FaultManager, StragglerWatcher
from .lifecycle import DataLifecycleManager
from .logical import LogicalGraph, LogicalGraphTemplate
from .managers import MasterDropManager, make_cluster
from .mapping import NodeInfo, map_partitions
from .pgt import CompiledPGT
from .resilience import (CompiledFaultManager, ResilienceConfig,
                         execute_resilient)
from .session import CompiledSession, Session, SessionState
from .telemetry import (MetricsRegistry, Span, TelemetryConfig,
                        export_chrome_trace)
from .templates import GraphTemplate, translate_lg
from .unroll import PhysicalGraphTemplate


@dataclass
class ExecutionReport:
    session_id: str
    state: str
    status_counts: Dict[str, int]
    wall_time: float
    events_published: int
    errors: List[str] = field(default_factory=list)
    speculative_wins: int = 0
    recoveries: int = 0            # node-failure recovery passes
    recovered_drops: int = 0       # drops reset + remapped across passes
    retries: int = 0               # dispatch-layer re-attempts

    @property
    def ok(self) -> bool:
        return (self.state == SessionState.FINISHED.value
                and not self.errors)

    def overhead_per_drop_us(self, payload_time: float = 0.0) -> float:
        n = sum(self.status_counts.values())
        return 1e6 * max(self.wall_time - payload_time, 0.0) / max(n, 1)


class Pipeline:
    """End-to-end driver for one logical graph on one cluster.

    ``execution`` selects the deploy+execute substrate:

    * ``"objects"`` — one Python ``Drop`` per graph node, event-driven
      (the paper's engine; the semantic oracle),
    * ``"compiled"`` — array-native: batched deploy over ``CompiledPGT``
      index slices + the frontier scheduler
      (:mod:`repro.core.exec_compiled`).  Same ``ExecutionReport``, no
      per-drop Python objects; DLM/straggler services require drop
      objects and are rejected.
    """

    def __init__(self, config: Optional[EngineConfig] = None,
                 **legacy: Any) -> None:
        if config is not None:
            if legacy:
                raise TypeError(
                    "pass either an EngineConfig or legacy keyword "
                    "arguments, not both")
            if not isinstance(config, EngineConfig):
                raise TypeError(
                    f"config must be an EngineConfig, got "
                    f"{type(config).__name__}")
            config.validate()
        else:
            if legacy:
                warnings.warn(
                    "Pipeline(**kwargs) is deprecated; pass "
                    "Pipeline(EngineConfig(...)) (repro.core.config)",
                    DeprecationWarning, stacklevel=2)
            config = config_from_kwargs(**legacy)
        self.config = config
        manager = config.manager
        if manager is not None:
            # ride a resident EngineManager: shared cluster + executors
            # + template cache; the Pipeline becomes a thin per-run view
            self.master, self.nodes = manager.master, manager.nodes
            self._owns_cluster = False
        else:
            self.master, self.nodes = make_cluster(
                config.num_nodes, config.num_islands,
                config.workers_per_node, workers=config.workers)
            self._owns_cluster = True
        # mutable working copies — benchmarks and tests tune these on a
        # built Pipeline (e.g. ``p.resilience = ResilienceConfig(...)``);
        # the frozen config records what was requested at construction
        self.manager = manager
        self.dop = config.dop
        self.algorithm = config.algorithm
        self.deadline = config.deadline
        self.enable_dlm = config.enable_dlm
        self.enable_stragglers = config.enable_stragglers
        self.execution = config.execution
        self.resilience = config.resilience
        self.stream = config.stream
        self.pgt: Optional[PhysicalGraphTemplate] = None
        self._template: Optional[GraphTemplate] = None
        self.session: Optional[Session] = None
        # FaultManager (objects) or CompiledFaultManager (compiled)
        self.fault_manager: Any = None
        self.translate_time = 0.0
        self.deploy_time = 0.0
        self.map_time = 0.0        # partition->node mapping share of deploy
        # telemetry: inherit the manager's config/registry when riding a
        # resident EngineManager (one registry per service, not per run)
        if config.telemetry is not None:
            self.telemetry = config.telemetry
        elif manager is not None:
            self.telemetry = manager.telemetry
        else:
            self.telemetry = TelemetryConfig()
        if manager is not None and manager.metrics is not None:
            self.metrics = manager.metrics
        else:
            self.metrics = MetricsRegistry() if self.telemetry.metrics \
                else None
        self.spans: List[Span] = []   # translate/map/deploy/execute

    def _record_span(self, name: str, t0: float) -> None:
        if self.telemetry.spans:
            self.spans.append(Span(name, t0, time.monotonic()))

    # -- stage 4: translate ---------------------------------------------------
    def translate(self, lg: LogicalGraph) -> PhysicalGraphTemplate:
        t0 = time.monotonic()
        if self.manager is not None:
            # resident path: translate+map once per shape, cached by
            # structural hash — repeated runs of the same LG skip both
            self._template = self.manager.get_template(
                lg, algorithm=self.algorithm, dop=self.dop,
                deadline=self.deadline)
            pgt = self._template.pgt
        else:
            self._template = None
            pgt = translate_lg(lg, algorithm=self.algorithm, dop=self.dop,
                               deadline=self.deadline)
        self.translate_time = time.monotonic() - t0
        self._record_span("translate", t0)
        self.pgt = pgt
        return pgt

    # -- stage 5: deploy ---------------------------------------------------------
    def deploy(self, pgt: Optional[PhysicalGraphTemplate] = None,
               session_id: Optional[str] = None) -> Session:
        supplied = pgt is not None
        pgt = pgt or self.pgt
        assert pgt is not None, "translate() first"
        t0 = time.monotonic()
        if (self._template is not None
                and pgt is self._template.pgt):
            # manager path: the template is already mapped and carries the
            # per-node slices — materialize is O(drops), no map, no argsort
            self.map_time = 0.0
            session = self._template.materialize(
                session_id or f"s-{uuid.uuid4().hex[:8]}",
                master=self.master)
            self.fault_manager = None
        elif self.execution == "compiled":
            if not isinstance(pgt, CompiledPGT):
                # translate() always yields a CompiledPGT now (loop-carried
                # graphs included); this lift only remains for explicitly
                # supplied dict PGTs, e.g. hand-built or deserialised ones
                # (only replace self.pgt when it IS the graph being lifted)
                pgt = CompiledPGT.from_dict_pgt(pgt)
                if not supplied:
                    self.pgt = pgt
            tm = time.monotonic()     # map share excludes the dict lift
            map_partitions(pgt, self.nodes)
            self.map_time = time.monotonic() - tm
            self._record_span("map", tm)
            session = CompiledSession(
                session_id or f"s-{uuid.uuid4().hex[:8]}", pgt)
            self.master.deploy_compiled(session, pgt)
            self.fault_manager = CompiledFaultManager(session, self.master)
        else:
            tm = time.monotonic()
            map_partitions(pgt, self.nodes)
            self.map_time = time.monotonic() - tm
            session = self.master.create_session(
                session_id or f"s-{uuid.uuid4().hex[:8]}")
            self.master.deploy(session, pgt)
            self.fault_manager = FaultManager(session, pgt, self.master)
        if isinstance(session, CompiledSession):
            if self.telemetry.timeline:
                session.enable_timeline()
            if self.metrics is not None:
                session.metrics = self.metrics
        self.deploy_time = time.monotonic() - t0
        self._record_span("deploy", t0)
        self.session = session
        return session

    # -- stage 6: execute ----------------------------------------------------------
    def execute(self, timeout: float = 60.0,
                inputs: Optional[Dict[str, Any]] = None,
                hooks: Any = None) -> ExecutionReport:
        """Run the deployed session.

        ``hooks`` (an :class:`~repro.core.exec_compiled.ExecHooks`) is
        honoured on both substrates: the compiled engine threads it into
        the frontier scheduler; the object engine bridges its drop-level
        ``streamChunk`` events onto ``hooks.on_stream_chunk`` so chunk
        observability is engine-portable.
        """
        assert self.session is not None, "deploy() first"
        session = self.session
        if isinstance(session, CompiledSession):
            return self._execute_compiled(session, timeout, inputs, hooks)
        on_chunk = getattr(hooks, "on_stream_chunk", None)
        if on_chunk is not None:
            def _bridge(event: Any) -> None:
                if event.type == "streamChunk":
                    on_chunk(session, event.source_uid,
                             event.data["consumer"], event.data["seq"])
            session.bus.subscribe_all(_bridge)
        if inputs:
            from .drop import DataDrop
            for uid, value in inputs.items():
                d = session.drops[uid]
                assert isinstance(d, DataDrop)
                d.write(value)
        dlm = DataLifecycleManager(session).start() if self.enable_dlm \
            else None
        watcher = (StragglerWatcher(session, self.master).start()
                   if self.enable_stragglers else None)
        t0 = time.monotonic()
        session.start()
        finished = session.wait(timeout)
        wall = time.monotonic() - t0
        self._record_span("execute", t0)
        if watcher:
            watcher.stop()
        if dlm:
            dlm.stop()
        errs = [f"{d.uid}: {(d.error_info or '')[:200]}"
                for d in session.errors()]
        return ExecutionReport(
            session_id=session.session_id,
            state=(session.state.value if finished else "TIMEOUT"),
            status_counts=session.status(),
            wall_time=wall,
            events_published=session.bus.published,
            errors=errs,
            speculative_wins=watcher.wins if watcher else 0,
        )

    def _execute_compiled(self, session: CompiledSession, timeout: float,
                          inputs: Optional[Dict[str, Any]],
                          hooks: Any = None) -> ExecutionReport:
        from .exec_compiled import execute_frontier
        if inputs:
            for uid, value in inputs.items():
                session.write(uid, value)
        t0 = time.monotonic()
        if self.resilience is not None:
            finished, stats = execute_resilient(
                session, self.master, self.resilience, timeout=timeout,
                fault_manager=self.fault_manager, hooks=hooks,
                stream=self.stream)
        else:
            executors = (self.manager.executors if self.manager is not None
                         else self.master.node_executors())
            finished = execute_frontier(
                session, timeout=timeout, hooks=hooks,
                executors=executors, stream=self.stream)
            stats = None
        wall = time.monotonic() - t0
        self._record_span("execute", t0)
        errs = [f"{r.uid}: {(r.error_info or '')[:200]}"
                for r in session.errors()]
        return ExecutionReport(
            session_id=session.session_id,
            state=(session.state.value if finished else "TIMEOUT"),
            status_counts=session.status(),
            wall_time=wall,
            events_published=session.bus.published,
            errors=errs,
            speculative_wins=stats.speculative_wins if stats else 0,
            recoveries=stats.recoveries if stats else 0,
            recovered_drops=stats.recovered_drops if stats else 0,
            retries=stats.retries if stats else 0,
        )

    # -- convenience: run everything -----------------------------------------------
    def run(self, lg: LogicalGraph, timeout: float = 60.0,
            inputs: Optional[Dict[str, Any]] = None,
            hooks: Any = None) -> ExecutionReport:
        self.translate(lg)
        self.deploy()
        return self.execute(timeout=timeout, inputs=inputs, hooks=hooks)

    def export_trace(self, path: str) -> Dict[str, int]:
        """Write the last session's Perfetto trace (timeline required);
        pipeline-stage spans ride along on their own track."""
        assert self.session is not None, "run a session first"
        return export_chrome_trace(
            self.session, path, spans=self.spans,
            batch_threshold=self.telemetry.trace_batch_threshold)

    def shutdown(self) -> None:
        # manager-owned clusters outlive any one Pipeline; only the
        # manager's close() may kill the shared node pools
        if self._owns_cluster:
            self.master.shutdown()

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()
