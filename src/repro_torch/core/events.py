"""Event system — the tokens travelling through graph edges (paper §1 item 3, §4.1).

DALiuGE fires events between Drops via direct object invocation (same node) or
ZeroMQ pub/sub (cross node).  This container is single-host, so the transport
is an in-process bus; the ``EventChannel`` interface is what a network
deployment would re-implement (the paper keeps "communication channels" cleanly
separated from bulk data operations — §4.1 — and so do we).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Event:
    """An event fired by a Drop as it transitions through its lifecycle."""

    type: str                      # e.g. "status", "producerFinished", "dropCompleted"
    source_uid: str                # uid of the Drop that fired it
    data: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.monotonic)


Listener = Callable[[Event], None]


class EventChannel:
    """Abstract transport for events between managers/nodes."""

    def publish(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def subscribe(self, source_uid: str, listener: Listener) -> None:  # pragma: no cover
        raise NotImplementedError


class EventBus(EventChannel):
    """In-process pub/sub bus.

    Thread-safe; listeners are invoked synchronously on the publishing thread
    (the decentralised cascade of the paper: a completed Data Drop directly
    triggers its consumers, which may schedule work on their own executor).
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._subs: Dict[str, List[Listener]] = defaultdict(list)
        self._global_subs: List[Listener] = []
        self.published = 0  # instrumentation for the overhead benchmark

    def subscribe(self, source_uid: str, listener: Listener) -> None:
        with self._lock:
            self._subs[source_uid].append(listener)

    def subscribe_all(self, listener: Listener) -> None:
        with self._lock:
            self._global_subs.append(listener)

    def unsubscribe(self, source_uid: str, listener: Listener) -> None:
        with self._lock:
            if listener in self._subs.get(source_uid, []):
                self._subs[source_uid].remove(listener)

    def publish(self, event: Event) -> None:
        with self._lock:
            listeners = list(self._subs.get(event.source_uid, ()))
            listeners.extend(self._global_subs)
            self.published += 1
        for listener in listeners:
            listener(event)


class RecordingListener:
    """Test/benchmark helper — records every event it sees."""

    def __init__(self) -> None:
        self.events: List[Event] = []
        self._lock = threading.Lock()

    def __call__(self, event: Event) -> None:
        with self._lock:
            self.events.append(event)

    def of_type(self, type_: str) -> List[Event]:
        with self._lock:
            return [e for e in self.events if e.type == type_]
