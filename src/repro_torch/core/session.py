"""Sessions — isolated physical-graph executions (paper §3.5).

"Sessions are completely isolated from one another. ... Sessions have a simple
lifecycle: they are first created, then a complete or a partial PG is attached
to them, after which the graph can be deployed.  This leaves the session in a
running state until the graph has finished its execution."

Two session flavours share the same monitoring/checkpoint API:

* :class:`Session` — one Python :class:`~repro.core.drop.Drop` object per
  graph node, event-driven (the paper's object engine; the semantic oracle),
* :class:`CompiledSession` — drop state held in flat numpy arrays over a
  :class:`~repro.core.pgt.CompiledPGT`, executed wave-by-wave by the
  frontier scheduler in :mod:`repro.core.exec_compiled`.  No per-drop
  Python objects exist; payload values live in one dense table.
"""
from __future__ import annotations

import enum
import json
import pickle
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from .drop import AppDrop, DataDrop, Drop, DropState, MemoryPayload
from .events import Event, EventBus
from .pgt import KIND_DATA, CompiledPGT
from .util import safe_uid as _safe


class SessionState(str, enum.Enum):
    PRISTINE = "PRISTINE"
    BUILDING = "BUILDING"
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    CANCELLED = "CANCELLED"
    FAILED = "FAILED"


#: session states no lifecycle transition may leave
_TERMINAL_SESSION = {SessionState.FINISHED, SessionState.CANCELLED,
                     SessionState.FAILED}


_TERMINAL_DROP = {DropState.COMPLETED, DropState.ERROR, DropState.CANCELLED,
                  DropState.SKIPPED, DropState.EXPIRED, DropState.DELETED}


class Session:
    def __init__(self, session_id: str, bus: Optional[EventBus] = None) -> None:
        self.session_id = session_id
        self.bus = bus or EventBus()
        self.state = SessionState.PRISTINE
        self.drops: Dict[str, Drop] = {}
        self._finished = threading.Event()
        self._terminal: set = set()     # incremental completion tracking
        self._lock = threading.Lock()
        self.created_at = time.monotonic()
        self.bus.subscribe_all(self._on_event)

    # -- graph attachment --------------------------------------------------------
    def add_drop(self, drop: Drop) -> None:
        self.state = SessionState.BUILDING
        self.drops[drop.uid] = drop

    # -- execution ----------------------------------------------------------------
    def deploy(self) -> None:
        self.state = SessionState.DEPLOYING

    def start(self) -> None:
        """Trigger root drops (paper §3.6)."""
        self.state = SessionState.RUNNING
        roots_data: List[DataDrop] = []
        roots_app: List[AppDrop] = []
        for d in self.drops.values():
            if isinstance(d, DataDrop) and not d.producers:
                roots_data.append(d)
            elif isinstance(d, AppDrop) and not d.inputs \
                    and not d.streaming_inputs:
                roots_app.append(d)
        # root data: "their data is considered to be present and therefore
        # they are marked as completed"
        for d in roots_data:
            if d.state in (DropState.INITIALIZED, DropState.WRITING):
                d.set_completed()
        for a in roots_app:
            if a.state is DropState.INITIALIZED:
                a.trigger_root()
        self._check_finished()

    def _on_event(self, event: Any) -> None:
        # incremental completion tracking: O(1) per event, not O(N) —
        # the decentralised engine must stay flat-overhead as graphs grow
        # (paper Fig. 8)
        if event.type != "status":
            return
        uid = event.source_uid
        d = self.drops.get(uid)
        if d is None:
            return
        with self._lock:
            if d.state in _TERMINAL_DROP:
                self._terminal.add(uid)
            else:
                self._terminal.discard(uid)   # fault recovery resets drops
            done = (self.state is SessionState.RUNNING
                    and len(self._terminal) == len(self.drops))
        if done:
            self._check_finished()

    def _check_finished(self) -> None:
        if self.state is not SessionState.RUNNING:
            return
        if all(d.state in _TERMINAL_DROP for d in self.drops.values()):
            self.state = SessionState.FINISHED
            self._finished.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._check_finished()
        return self._finished.wait(timeout)

    def reopen(self) -> None:
        """Back to RUNNING after drops were reset (fault recovery)."""
        self.state = SessionState.RUNNING
        self._rebuild_terminal()
        self._finished.clear()

    def _rebuild_terminal(self) -> None:
        """Resync the incremental tracker after out-of-band state changes
        (checkpoint restore / fault recovery set states without events)."""
        with self._lock:
            self._terminal = {u for u, d in self.drops.items()
                              if d.state in _TERMINAL_DROP}

    def cancel(self) -> None:
        for d in self.drops.values():
            d.cancel()
        self.state = SessionState.CANCELLED
        self._finished.set()

    def fail(self, reason: str) -> None:
        """Mark the session FAILED (node shutdown abandoned in-flight work,
        lost worker, ...).  No-op once terminal."""
        if self.state in _TERMINAL_SESSION:
            return
        self.error_reason = reason
        self.state = SessionState.FAILED
        self.bus.publish(Event("sessionFailed", self.session_id,
                               {"reason": reason}))
        self._finished.set()

    # -- monitoring (paper: DMs "allow users to query and monitor graph
    # execution status") -----------------------------------------------------------
    def status(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for d in self.drops.values():
            counts[d.state.value] = counts.get(d.state.value, 0) + 1
        return counts

    def errors(self) -> List[Drop]:
        return [d for d in self.drops.values()
                if d.state is DropState.ERROR]

    # -- checkpoint / restart ---------------------------------------------------------
    def checkpoint(self, directory: str,
                   spill_payloads: bool = True) -> str:
        """Persist all drop states (+ completed in-memory payloads)."""
        path = Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        records = {uid: d.to_record() for uid, d in self.drops.items()}
        if spill_payloads:
            pdir = path / "payloads"
            pdir.mkdir(exist_ok=True)
            for uid, d in self.drops.items():
                if (isinstance(d, DataDrop)
                        and d.state is DropState.COMPLETED
                        and isinstance(d.payload, MemoryPayload)
                        and d.payload.exists()):
                    with open(pdir / f"{_safe(uid)}.pkl", "wb") as fh:
                        pickle.dump(d.payload.read(), fh,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                    records[uid]["spilled"] = True
        manifest = path / "session.json"
        with open(manifest, "w") as fh:
            json.dump({"session_id": self.session_id,
                       "records": records}, fh)
        return str(manifest)

    def restore(self, directory: str) -> None:
        """Restore drop states from a checkpoint into an already-built graph."""
        path = Path(directory)
        with open(path / "session.json") as fh:
            data = json.load(fh)
        records = data["records"]
        for uid, rec in records.items():
            d = self.drops.get(uid)
            if d is None:
                continue
            if rec.get("spilled") and isinstance(d, DataDrop):
                with open(path / "payloads" / f"{_safe(uid)}.pkl", "rb") as fh:
                    d.payload.write(pickle.load(fh))
            d.restore_record(rec)

    def resume(self) -> None:
        """Continue a restored session: re-fire completions for COMPLETED
        data drops so not-yet-run consumers get triggered; reset apps that
        were mid-flight."""
        self.state = SessionState.RUNNING
        self._rebuild_terminal()
        from .drop import AppState
        for d in self.drops.values():
            if isinstance(d, AppDrop) and d.exec_state is AppState.RUNNING:
                # was mid-flight at checkpoint time: re-run
                d.exec_state = AppState.NOT_RUN
                d._state = DropState.INITIALIZED
        for d in list(self.drops.values()):
            if isinstance(d, DataDrop) and d.state is DropState.COMPLETED:
                for c in d.consumers:
                    if (isinstance(c, AppDrop)
                            and c.exec_state is AppState.NOT_RUN):
                        c.on_input_completed(d)
        # restart roots that never ran
        for d in self.drops.values():
            if (isinstance(d, AppDrop) and not d.inputs
                    and d.exec_state is AppState.NOT_RUN):
                d.trigger_root()
            if (isinstance(d, DataDrop) and not d.producers
                    and d.state is DropState.INITIALIZED):
                d.set_completed()
        self._check_finished()


# ---------------------------------------------------------------------------
# Compiled sessions — array-native drop state (no per-drop Python objects)
# ---------------------------------------------------------------------------

# int8 drop-state codes used by CompiledSession / the frontier scheduler
ST_INIT = 0
ST_COMPLETED = 1
ST_ERROR = 2
ST_CANCELLED = 3
ST_SKIPPED = 4

_ST_NAMES = (DropState.INITIALIZED.value, DropState.COMPLETED.value,
             DropState.ERROR.value, DropState.CANCELLED.value,
             DropState.SKIPPED.value)

# payload-kind codes (per data drop)
PK_MEMORY = 0
PK_FILE = 1
PK_NULL = 2
_PK_CODE_OF = {"memory": PK_MEMORY, "file": PK_FILE, "null": PK_NULL}


class CompiledDropRef:
    """Tiny uid/state/error view over one row of a CompiledSession
    (what ``errors()`` returns; duck-types the bits of ``Drop`` that the
    engine and monitoring consume).  Also the base for the app-function
    shims in :mod:`repro.core.exec_compiled`."""

    __slots__ = ("s", "idx")

    def __init__(self, session: "CompiledSession", idx: int) -> None:
        self.s = session
        self.idx = idx

    @property
    def session(self) -> "CompiledSession":
        return self.s

    @property
    def uid(self) -> str:
        return self.s.pgt.uid_of(self.idx)

    @property
    def state(self) -> DropState:
        return DropState(_ST_NAMES[self.s.drop_state[self.idx]])

    @property
    def error_info(self) -> Optional[str]:
        return self.s.error_info.get(self.idx)

    @property
    def node(self) -> Optional[str]:
        nid = self.s.pgt.node_ids[self.idx]
        return None if nid < 0 else self.s.pgt.node_names[nid]

    def read(self) -> Any:
        return self.s._read_idx(self.idx)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.uid} {self.state.value}>"


class CompiledSession:
    """A session executing directly on ``CompiledPGT`` arrays.

    Shares the :class:`Session` monitoring/lifecycle API — ``status()``,
    ``wait()``, ``errors()``, ``checkpoint()``/``restore()``, ``cancel()``
    — but holds *all* drop state in flat arrays:

    * ``drop_state``  — int8 state codes (``ST_*``),
    * ``payloads`` / ``payload_present`` — dense value table for data
      drops (the vectorised equivalent of per-drop ``MemoryPayload``),
    * ``error_info`` — sparse ``{drop id: message}`` map,
    * ``node_slices`` — per-node drop-id index arrays, filled by the
      batched deploy (``MasterDropManager.deploy_compiled``).

    Execution is driven by :func:`repro.core.exec_compiled.execute_frontier`
    — the session itself is pure state + bookkeeping.
    """

    def __init__(self, session_id: str, pgt: CompiledPGT,
                 bus: Optional[EventBus] = None) -> None:
        self.session_id = session_id
        self.pgt = pgt
        self.bus = bus or EventBus()
        self.state = SessionState.PRISTINE
        n = pgt.num_drops
        self.num_drops = n
        self.drop_state = np.zeros(n, dtype=np.int8)
        self.payloads = np.full(n, None, dtype=object)   # dense value table
        self.payload_present = np.zeros(n, dtype=bool)
        self.error_info: Dict[int, str] = {}
        self.node_slices: Dict[str, np.ndarray] = {}
        self.cross_node_edges = 0          # stat recorded at deploy
        self.closed = False                # close() frees the payload table
        # telemetry (both None unless enabled — TelemetryConfig default
        # must allocate nothing): per-drop Timeline arrays + the shared
        # MetricsRegistry the scheduler/resilience layers update
        self.timeline = None               # .telemetry.Timeline | None
        self.metrics = None                # .telemetry.MetricsRegistry | None
        # streaming chunk rings (None unless the graph has active
        # streaming edges AND enable_streaming ran — batch graphs pay
        # nothing; see .streaming.StreamTable)
        self.stream = None                 # .streaming.StreamTable | None
        # resilience counters (maintained by core.resilience; always
        # present so monitoring code can read them unconditionally)
        self.recoveries = 0                # node-failure recovery passes
        self.recovered_drops = 0           # drops reset + remapped, total
        self.speculative_wins = 0          # straggler duplicates that won
        self.retries = 0                   # dispatch-layer re-attempts
        self._finished = threading.Event()
        self.created_at = time.monotonic()
        # payload-kind code per drop (PK_*; apps carry PK_MEMORY, unused)
        gidx = pgt.group_idx_arr()
        gpk = np.fromiter(
            (_PK_CODE_OF.get(g.payload_kind, PK_MEMORY) for g in pgt.groups),
            dtype=np.int8, count=len(pgt.groups))
        self.payload_kind = gpk[gidx] if len(pgt.groups) else \
            np.zeros(n, dtype=np.int8)

    # -- telemetry ---------------------------------------------------------
    def enable_timeline(self) -> None:
        """Allocate the per-drop timeline arrays (idempotent).  Kept as
        an explicit opt-in so default sessions pay nothing — 4 extra
        arrays is 280 MB at the 10M-drop tier."""
        if self.timeline is None:
            from .telemetry import Timeline
            self.timeline = Timeline(self)

    # -- streaming ---------------------------------------------------------
    def enable_streaming(self, config=None):
        """Build the per-streaming-edge chunk-ring table (idempotent).

        Returns the :class:`repro.core.streaming.StreamTable`, or None
        when the graph has no *active* streaming edges (streaming flag +
        data→app + streaming-marked consumer func) — pure-batch sessions
        allocate nothing.  Seeds written before this call are pushed as
        first chunks (see ``StreamTable.build``)."""
        if self.stream is None and not self.closed:
            from .streaming import StreamTable
            self.stream = StreamTable.build(self, config)
        return self.stream

    def record_error(self, idx: int, msg: str) -> None:
        """Record a drop failure: error_info + a ``dropFailed`` event on
        the session bus (traceback last line as summary) — the compiled
        engine's bridge to ``RecordingListener``-style tooling."""
        i = int(idx)
        self.error_info[i] = msg
        lines = [ln for ln in msg.strip().splitlines() if ln.strip()]
        summary = lines[-1][:200] if lines else ""
        self.bus.publish(Event("dropFailed", self.pgt.uid_of(i),
                               {"session": self.session_id,
                                "summary": summary}))

    # -- lifecycle ---------------------------------------------------------
    def deploy(self) -> None:
        self.state = SessionState.DEPLOYING

    def start(self) -> None:
        # publish only on the *first* transition to RUNNING — fault
        # recovery resumes via reopen()+execute_frontier and must not
        # produce duplicate sessionStarted events
        if self.state is not SessionState.RUNNING:
            self.bus.publish(Event("sessionStarted", self.session_id,
                                   {"num_drops": self.num_drops}))
        self.state = SessionState.RUNNING

    def finish(self) -> None:
        n_err = len(self.error_info)
        self.bus.publish(Event(
            "sessionFailed" if n_err else "sessionFinished",
            self.session_id,
            {"num_drops": self.num_drops, "errors": n_err}))
        self.state = SessionState.FINISHED
        self._finished.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)

    def reopen(self) -> None:
        """Back to RUNNING after state rows were reset (fault recovery) —
        the array-native mirror of :meth:`Session.reopen`.  The frontier
        scheduler re-derives its readiness counters from the state array,
        so execution resumes mid-wave with ``execute_frontier``."""
        self.state = SessionState.RUNNING
        self._finished.clear()

    def cancel(self) -> None:
        self.drop_state[self.drop_state == ST_INIT] = ST_CANCELLED
        self.state = SessionState.CANCELLED
        self._finished.set()

    def fail(self, reason: str) -> None:
        """Mark the session FAILED (node shutdown abandoned in-flight work,
        lost worker, ...).  No-op once terminal."""
        if self.state in _TERMINAL_SESSION:
            return
        self.error_reason = reason
        self.state = SessionState.FAILED
        self.bus.publish(Event("sessionFailed", self.session_id,
                               {"reason": reason}))
        self._finished.set()

    def close(self) -> None:
        """Release the session's mutable storage (resident-manager
        eviction).  The dense payload table is the dominant per-session
        allocation — dropping it is what makes closing a session under
        :class:`repro.core.manager.EngineManager` actually free memory;
        the shared template ``CompiledPGT`` is untouched.  Subsequent
        reads/writes raise ``PayloadError``."""
        self.closed = True
        self.payloads = np.empty(0, dtype=object)
        self.payload_present = np.empty(0, dtype=bool)
        self.error_info = {}
        self.node_slices = {}
        self.stream = None
        self._finished.set()

    # -- data access (input seeding / result readout) ----------------------
    def index_of(self, uid: str) -> int:
        return self.pgt.index_of(uid)

    def write(self, uid: str, value: Any) -> None:
        """Seed an input payload (root data drops, pre-execution).

        State guard matches the object oracle: ``Drop.write`` only
        accepts writes before the drop is terminal."""
        from .drop import PayloadError
        if self.closed:
            raise PayloadError(f"session {self.session_id} is closed")
        idx = self.index_of(uid)
        if self.pgt.kind_arr[idx] != KIND_DATA:
            raise ValueError(f"cannot write app drop {uid!r}")
        if self.drop_state[idx] != ST_INIT:
            raise PayloadError(f"cannot write drop {uid} in state "
                               f"{_ST_NAMES[self.drop_state[idx]]}")
        self.payloads[idx] = value
        self.payload_present[idx] = True
        if self.stream is not None and self.stream.is_src[idx]:
            self.stream.push(idx, value)

    def read(self, uid: str) -> Any:
        return self._read_idx(self.index_of(uid))

    def _read_idx(self, idx: int) -> Any:
        from .drop import PayloadError
        if self.closed:
            raise PayloadError(f"session {self.session_id} is closed")
        if self.payload_kind[idx] == PK_NULL:
            return None
        if not self.payload_present[idx]:
            if self.payload_kind[idx] == PK_FILE:
                path = self._file_path(idx)
                if Path(path).exists():
                    with open(path, "rb") as fh:
                        return pickle.load(fh)
            raise PayloadError("payload not present")
        return self.payloads[idx]

    def _write_idx(self, idx: int, value: Any) -> None:
        """Payload write from a producing app (registry shim path)."""
        self.payloads[idx] = value
        self.payload_present[idx] = True
        if self.stream is not None and self.stream.is_src[idx]:
            self.stream.push(idx, value)
        if self.payload_kind[idx] == PK_FILE:
            path = Path(self._file_path(idx))
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "wb") as fh:
                pickle.dump(value, fh, protocol=pickle.HIGHEST_PROTOCOL)

    def state_of(self, uid: str) -> DropState:
        return DropState(_ST_NAMES[self.drop_state[self.index_of(uid)]])

    def _file_path(self, idx: int) -> str:
        params = self.pgt.params_of(idx)
        return params.get(
            "path", f"/tmp/repro_drops/{_safe(self.pgt.uid_of(idx))}.pkl")

    # -- monitoring ----------------------------------------------------------
    def status(self) -> Dict[str, int]:
        counts = np.bincount(self.drop_state, minlength=len(_ST_NAMES))
        return {_ST_NAMES[c]: int(v)
                for c, v in enumerate(counts) if v}

    def errors(self) -> List[CompiledDropRef]:
        return [CompiledDropRef(self, int(i))
                for i in np.flatnonzero(self.drop_state == ST_ERROR)]

    # -- checkpoint / restart ------------------------------------------------
    def checkpoint(self, directory: str,
                   spill_payloads: bool = True) -> str:
        """Persist the state arrays (+ present payload values) — the
        array-native analogue of ``Session.checkpoint``."""
        path = Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "drop_state.npy", self.drop_state)
        if spill_payloads:
            present = np.flatnonzero(self.payload_present)
            values = {int(i): self.payloads[int(i)] for i in present}
            with open(path / "payloads.pkl", "wb") as fh:
                pickle.dump(values, fh, protocol=pickle.HIGHEST_PROTOCOL)
        manifest = path / "compiled_session.json"
        with open(manifest, "w") as fh:
            json.dump({"session_id": self.session_id,
                       "num_drops": self.num_drops,
                       "format": "compiled-v1",
                       "spill_payloads": bool(spill_payloads),
                       "errors": {str(i): msg
                                  for i, msg in self.error_info.items()}},
                      fh)
        return str(manifest)

    def restore(self, directory: str) -> None:
        """Restore state arrays from a checkpoint into this session.
        Execution can then continue with ``execute_frontier`` (the
        scheduler derives ``pending_inputs`` from terminal states)."""
        path = Path(directory)
        with open(path / "compiled_session.json") as fh:
            data = json.load(fh)
        if data.get("num_drops") != self.num_drops:
            raise ValueError(
                f"checkpoint has {data.get('num_drops')} drops, session "
                f"graph has {self.num_drops}")
        self.drop_state = np.load(path / "drop_state.npy")
        self.error_info = {int(i): msg
                           for i, msg in data.get("errors", {}).items()}
        ppath = path / "payloads.pkl"
        if data.get("spill_payloads") and ppath.exists():
            with open(ppath, "rb") as fh:
                values = pickle.load(fh)
            self.payloads = np.full(self.num_drops, None, dtype=object)
            self.payload_present = np.zeros(self.num_drops, dtype=bool)
            for i, v in values.items():
                self.payloads[i] = v
                self.payload_present[i] = True
        self._finished.clear()
        # in-flight stream chunks are not checkpointed (checkpoint at
        # stream boundaries); drop the table so the next execute rebuilds
        # it and re-seeds rings from restored payloads
        self.stream = None
        if bool((self.drop_state != ST_INIT).all()):
            self.finish()
