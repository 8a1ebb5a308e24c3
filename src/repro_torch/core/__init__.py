"""DALiuGE-style graph execution core (the paper's contribution).

Public surface: Drops, constructs, logical graphs, translation
(unroll+partition), mapping, managers, sessions, the engine facade,
fault handling and data lifecycle management.
"""
from .config import EngineConfig
from .constructs import Construct, Kind, LogicalEdge
from .drop import (AppDrop, AppState, DataDrop, Drop, DropState, FilePayload,
                   MemoryPayload, NullPayload, Payload, PayloadError)
from .engine import ExecutionReport, Pipeline
from .events import Event, EventBus, RecordingListener
from .exec_compiled import ExecHooks, execute_frontier
from .fault import FaultManager, StragglerWatcher, elastic_remap, with_retries
from .resilience import (CompiledFaultManager, FailureScript,
                         ResilienceConfig, ResilienceStats, ResilientRunner,
                         RetryPolicy, StragglerPolicy, execute_resilient)
from .graph_io import iter_pgt, load_lgt, load_pgt, save_lgt, save_pgt
from .lifecycle import DataLifecycleManager
from .logical import (GraphValidationError, LogicalGraph,
                      LogicalGraphTemplate)
from .manager import AdmissionError, EngineManager, SessionTicket
from .managers import (DataIslandDropManager, MasterDropManager,
                       NodeDropManager, ProcNodeDropManager, get_app,
                       make_cluster, register_app)
from .procpool import (PayloadPlane, ProcExecutor, WorkerLost,
                       WorkerTimeout)
from .mapping import NodeInfo, map_partitions, stamp_nodes
from .partition import PartitionResult, min_res, min_time
from .schedule import critical_path, partition_stats, simulate_makespan
from .pgt import CompiledPGT, DropView
from .session import (CompiledDropRef, CompiledSession, Session,
                      SessionState)
from .streaming import StreamAbort, StreamConfig, StreamTable
from .telemetry import (MetricsRegistry, Span, TelemetryConfig, Timeline,
                        export_chrome_trace)
from .templates import (GraphTemplate, TemplateCache, structural_hash,
                        translate_lg)
from .unroll import (Axis, DropSpec, PhysicalGraphTemplate, compile_unroll,
                     leaf_axes, unroll, unroll_dict)

__all__ = [
    "AdmissionError", "AppDrop", "AppState", "Axis", "CompiledDropRef",
    "CompiledFaultManager", "CompiledPGT", "CompiledSession", "Construct",
    "DataDrop", "DataIslandDropManager", "DataLifecycleManager", "Drop",
    "DropSpec", "DropState", "DropView", "EngineConfig", "EngineManager",
    "Event", "EventBus", "ExecHooks", "ExecutionReport", "FailureScript",
    "FaultManager", "FilePayload", "GraphTemplate", "GraphValidationError",
    "Kind", "LogicalEdge", "LogicalGraph", "LogicalGraphTemplate",
    "MasterDropManager", "MemoryPayload", "MetricsRegistry",
    "NodeDropManager", "NodeInfo",
    "NullPayload", "PartitionResult", "Payload", "PayloadError",
    "PayloadPlane", "PhysicalGraphTemplate", "Pipeline",
    "ProcExecutor", "ProcNodeDropManager", "RecordingListener",
    "ResilienceConfig", "ResilienceStats", "ResilientRunner", "RetryPolicy",
    "Session", "SessionState", "SessionTicket", "Span", "StragglerPolicy",
    "StragglerWatcher", "StreamAbort", "StreamConfig", "StreamTable",
    "TelemetryConfig", "TemplateCache", "Timeline", "WorkerLost",
    "WorkerTimeout",
    "compile_unroll", "critical_path",
    "elastic_remap", "execute_frontier", "execute_resilient",
    "export_chrome_trace", "get_app",
    "iter_pgt", "leaf_axes", "load_lgt", "load_pgt", "make_cluster",
    "map_partitions", "min_res", "min_time", "partition_stats",
    "register_app", "save_lgt", "save_pgt", "simulate_makespan",
    "stamp_nodes", "structural_hash", "translate_lg", "unroll",
    "unroll_dict", "with_retries",
]
