"""EngineConfig — one typed object for every Pipeline mode switch.

``Pipeline`` historically grew ~10 keyword arguments whose legal
combinations were policed inside ``__init__``.  ``EngineConfig``
collapses them into a frozen dataclass and owns *all* mode validation in
one place (:meth:`EngineConfig.validate`), so the error surface is
identical whether a caller builds a config explicitly or goes through
the legacy kwargs (which now warn with ``DeprecationWarning`` exactly
once per construction).

The split mirrors the paper's separation between graph *translation*
policy (``algorithm``/``dop``/``deadline``), cluster *shape*
(``num_nodes``/``num_islands``/``workers_per_node``) and *execution*
substrate selection (``execution``/``resilience``/``stream``/services).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Optional, Union

from .resilience import ResilienceConfig
from .streaming import StreamConfig
from .telemetry import TelemetryConfig


@dataclass(frozen=True)
class EngineConfig:
    """Validated, immutable Pipeline configuration.

    ``stream`` selects the compiled engine's chunk-granular streaming
    lane: ``None`` auto-enables it whenever the graph has streaming
    edges, a :class:`~repro.core.streaming.StreamConfig` tunes ring
    capacity/backpressure, and ``False`` degrades streaming edges to
    batch dependencies (counted + warned once).
    """

    # cluster shape
    num_nodes: int = 2
    num_islands: int = 1
    workers_per_node: int = 4
    workers: str = "thread"   # "thread" | "process" (crash-isolated spawn workers)
    # translation policy
    dop: int = 8
    algorithm: str = "min_time"
    deadline: Optional[float] = None
    # execution substrate
    execution: str = "objects"
    enable_dlm: bool = False
    enable_stragglers: bool = False
    resilience: Optional[ResilienceConfig] = None
    manager: Any = None
    telemetry: Optional[TelemetryConfig] = None
    stream: Union[StreamConfig, bool, None] = None

    def validate(self) -> "EngineConfig":
        """Raise ``ValueError`` on any illegal mode combination.

        Every Pipeline mode error originates here — tests asserting on
        the messages exercise this single chokepoint.
        """
        if self.execution not in ("objects", "compiled"):
            raise ValueError(f"unknown execution mode {self.execution!r}")
        if self.workers not in ("thread", "process"):
            raise ValueError(f"unknown workers mode {self.workers!r} "
                             "(expected 'thread' or 'process')")
        if self.workers == "process" and self.execution != "compiled":
            raise ValueError(
                "workers='process' is the compiled engine's payload-plane "
                "mode; the object path dispatches per-drop callbacks that "
                "cannot cross a process boundary (use execution='compiled')")
        if self.workers == "process" and self.manager is not None:
            raise ValueError(
                "workers= shapes the Pipeline-owned cluster; a resident "
                "EngineManager owns its own (pass workers='process' to "
                "EngineManager instead)")
        if self.execution == "compiled" and (self.enable_dlm
                                             or self.enable_stragglers):
            raise ValueError(
                "compiled execution has no per-drop objects; DLM and "
                "straggler services need execution='objects'")
        if self.resilience is not None and self.execution != "compiled":
            raise ValueError(
                "resilience= is the compiled-path subsystem "
                "(core.resilience); the object path uses "
                "enable_stragglers / FaultManager (core.fault)")
        if self.stream is not None and self.execution != "compiled":
            raise ValueError(
                "stream= tunes the compiled engine's chunk lane; the "
                "object path streams natively per drop event "
                "(use execution='compiled')")
        if isinstance(self.stream, StreamConfig):
            self.stream.validate()
        if self.manager is not None:
            # ride a resident EngineManager: shared cluster + executors
            # + template cache; the Pipeline becomes a thin per-run view
            if self.execution != "compiled":
                raise ValueError(
                    "manager= serves compiled sessions; use "
                    "execution='compiled'")
            if self.resilience is not None:
                raise ValueError(
                    "resilience= mutates the shared template PGT "
                    "(node-failure remapping rewrites node_ids); run "
                    "a standalone Pipeline for fault-injection tiers")
        return self


#: legal legacy Pipeline(...) keyword names, in declaration order
LEGACY_KWARGS = tuple(f.name for f in fields(EngineConfig))


def config_from_kwargs(**kwargs: Any) -> EngineConfig:
    """Build + validate an :class:`EngineConfig` from legacy kwargs.

    Unknown names raise ``TypeError`` (matching the old signature's
    behaviour); mode errors raise ``ValueError`` from ``validate``.
    """
    unknown = set(kwargs) - set(LEGACY_KWARGS)
    if unknown:
        raise TypeError(
            f"Pipeline() got unexpected keyword argument(s) "
            f"{sorted(unknown)}")
    return EngineConfig(**kwargs).validate()
