"""Drops — the generalised graph nodes of DALiuGE (paper §4).

Both *data* and *applications* are nodes.  A Drop wraps a generic payload with
lifecycle state, provenance, and event behaviour, "making data virtually
active" (§4).  Payloads are strictly write-once / read-many (§2.3, §4); Drops
themselves are stateful and checkpointable.

State machine (paper Fig. 11)::

    INITIALIZED -> [WRITING] -> COMPLETED -> EXPIRED -> DELETED
                 \\-> ERROR (any I/O or execution error)
                 \\-> CANCELLED / SKIPPED

Application Drops additionally track an execution status
(NOT_RUN -> RUNNING -> FINISHED | ERROR).
"""
from __future__ import annotations

import enum
import pickle
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

from .events import Event, EventBus


class DropState(str, enum.Enum):
    INITIALIZED = "INITIALIZED"
    WRITING = "WRITING"
    COMPLETED = "COMPLETED"
    ERROR = "ERROR"
    EXPIRED = "EXPIRED"
    DELETED = "DELETED"
    CANCELLED = "CANCELLED"
    SKIPPED = "SKIPPED"


class AppState(str, enum.Enum):
    NOT_RUN = "NOT_RUN"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    ERROR = "ERROR"
    CANCELLED = "CANCELLED"
    SKIPPED = "SKIPPED"


_TERMINAL = {DropState.COMPLETED, DropState.ERROR, DropState.CANCELLED,
             DropState.SKIPPED, DropState.EXPIRED, DropState.DELETED}


# ---------------------------------------------------------------------------
# Payloads — write-once / read-many (§4.2 "Drop I/O")
# ---------------------------------------------------------------------------


class PayloadError(RuntimeError):
    pass


def buffer_nbytes(value) -> "int | None":
    """Byte size of a buffer-protocol value (bytes, bytearray, array.array,
    mmap, ...) without serialising it; None for opaque objects."""
    try:
        return memoryview(value).nbytes
    except TypeError:
        return None


class Payload:
    """I/O abstraction over a Drop's data (paper §4.2 option 1).

    open/read/write/close POSIX-style byte/object model.  Write-once:
    a second ``write`` after ``seal`` raises.
    """

    def __init__(self) -> None:
        self._sealed = False
        self._lock = threading.Lock()

    # -- interface ---------------------------------------------------------
    def write(self, value: Any) -> None:
        with self._lock:
            if self._sealed:
                raise PayloadError("payload is write-once and already sealed")
            self._write(value)

    def seal(self) -> None:
        with self._lock:
            self._sealed = True

    @property
    def sealed(self) -> bool:
        return self._sealed

    def read(self) -> Any:
        return self._read()

    def exists(self) -> bool:
        raise NotImplementedError

    def delete(self) -> None:
        raise NotImplementedError

    def nbytes(self) -> int:
        return 0

    @property
    def data_url(self) -> str:
        raise NotImplementedError

    # -- impl hooks ----------------------------------------------------------
    def _write(self, value: Any) -> None:
        raise NotImplementedError

    def _read(self) -> Any:
        raise NotImplementedError


class MemoryPayload(Payload):
    """In-memory payload (paper's InMemoryDataDROP, used by MUSER §6)."""

    def __init__(self) -> None:
        super().__init__()
        self._value: Any = None
        self._present = False

    def _write(self, value: Any) -> None:
        self._value = value
        self._present = True

    def _read(self) -> Any:
        if not self._present:
            raise PayloadError("payload not present")
        return self._value

    def exists(self) -> bool:
        return self._present

    def delete(self) -> None:
        self._value = None
        self._present = False

    def nbytes(self) -> int:
        v = self._value
        if v is None:
            return 0
        if hasattr(v, "nbytes"):
            try:
                return int(v.nbytes)
            except TypeError:
                pass
        n = buffer_nbytes(v)
        if n is not None:
            return n
        try:
            return len(pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL))
        except Exception:
            return 0

    @property
    def data_url(self) -> str:
        return f"mem://{id(self):x}"


class FilePayload(Payload):
    """File-backed payload (paper's FileDROP), pickle serialised."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self._path = Path(path)

    def _write(self, value: Any) -> None:
        self._path.parent.mkdir(parents=True, exist_ok=True)
        with open(self._path, "wb") as fh:
            pickle.dump(value, fh, protocol=pickle.HIGHEST_PROTOCOL)

    def _read(self) -> Any:
        if not self._path.exists():
            raise PayloadError(f"{self._path} not present")
        with open(self._path, "rb") as fh:
            return pickle.load(fh)

    def exists(self) -> bool:
        return self._path.exists()

    def delete(self) -> None:
        if self._path.exists():
            self._path.unlink()

    def nbytes(self) -> int:
        return self._path.stat().st_size if self._path.exists() else 0

    @property
    def data_url(self) -> str:
        return f"file://{self._path}"


class NullPayload(Payload):
    """Payload-less Drop (pure barrier / signal)."""

    def _write(self, value: Any) -> None:
        pass

    def _read(self) -> Any:
        return None

    def exists(self) -> bool:
        return True

    def delete(self) -> None:
        pass

    @property
    def data_url(self) -> str:
        return "null://"


def make_payload(kind: str, *, path: Optional[str] = None) -> Payload:
    if kind == "memory":
        return MemoryPayload()
    if kind == "file":
        assert path is not None, "file payload requires a path"
        return FilePayload(path)
    if kind == "null":
        return NullPayload()
    raise ValueError(f"unknown payload kind {kind!r}")


# ---------------------------------------------------------------------------
# Drops
# ---------------------------------------------------------------------------


class Drop:
    """Abstract Drop: uid, state machine, event firing (paper §4, Fig. 9/11)."""

    def __init__(self, uid: str, *, bus: Optional[EventBus] = None,
                 lifetime: Optional[float] = None, node: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.uid = uid
        self.bus = bus or EventBus()
        self.node = node                       # physical placement (set at deploy)
        self.lifetime = lifetime               # seconds until EXPIRED (None = pinned)
        self.meta: Dict[str, Any] = dict(meta or {})
        self._state = DropState.INITIALIZED
        self._state_lock = threading.RLock()
        self.completed_at: Optional[float] = None
        self.error_info: Optional[str] = None

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> DropState:
        return self._state

    def _set_state(self, new: DropState, **event_data: Any) -> None:
        with self._state_lock:
            if self._state == new:
                return
            if self._state in _TERMINAL and new not in (
                    DropState.EXPIRED, DropState.DELETED):
                # terminal states only advance along the lifecycle tail
                if not (self._state is DropState.COMPLETED and new in
                        (DropState.EXPIRED, DropState.DELETED)):
                    return
            self._state = new
        self.fire("status", status=new.value, **event_data)

    def fire(self, type_: str, **data: Any) -> None:
        self.bus.publish(Event(type=type_, source_uid=self.uid, data=data))

    # -- lifecycle tail (§4.3) ------------------------------------------------
    def expire(self) -> None:
        if self._state is DropState.COMPLETED:
            self._set_state(DropState.EXPIRED)

    def delete(self) -> None:
        if self._state in (DropState.EXPIRED, DropState.COMPLETED,
                           DropState.ERROR):
            self._set_state(DropState.DELETED)

    def cancel(self) -> None:
        if self._state not in _TERMINAL:
            self._set_state(DropState.CANCELLED)

    def skip(self) -> None:
        if self._state not in _TERMINAL:
            self._set_state(DropState.SKIPPED)
            self.fire("dropSkipped")

    # -- checkpointing (Drop state persistence, paper §4) ----------------------
    def to_record(self) -> Dict[str, Any]:
        return {
            "uid": self.uid,
            "type": type(self).__name__,
            "state": self._state.value,
            "node": self.node,
            "completed_at": self.completed_at,
            "error_info": self.error_info,
            "meta": self.meta,
        }

    def restore_record(self, rec: Dict[str, Any]) -> None:
        self._state = DropState(rec["state"])
        self.node = rec.get("node")
        self.completed_at = rec.get("completed_at")
        self.error_info = rec.get("error_info")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.uid} {self._state.value}>"


class DataDrop(Drop):
    """A Data Drop: payload + producers/consumers (paper §4, Fig. 10)."""

    def __init__(self, uid: str, *, payload: Optional[Payload] = None,
                 **kw: Any) -> None:
        super().__init__(uid, **kw)
        self.payload = payload or MemoryPayload()
        self.producers: List["AppDrop"] = []
        self.consumers: List["AppDrop"] = []
        self.streaming_consumers: List["AppDrop"] = []
        self._finished_producers = 0
        self._errored_producers = 0
        self._chunk_seq = 0          # chunks written (streaming fan-out)

    # -- graph wiring ----------------------------------------------------------
    def add_producer(self, app: "AppDrop") -> None:
        if app not in self.producers:
            self.producers.append(app)
            if self not in app.outputs:
                app.outputs.append(self)

    def add_consumer(self, app: "AppDrop", streaming: bool = False) -> None:
        tgt = self.streaming_consumers if streaming else self.consumers
        if app not in tgt:
            tgt.append(app)
            ins = app.streaming_inputs if streaming else app.inputs
            if self not in ins:
                ins.append(self)

    # -- data access -------------------------------------------------------------
    def write(self, value: Any) -> None:
        if self.state not in (DropState.INITIALIZED, DropState.WRITING):
            raise PayloadError(
                f"cannot write drop {self.uid} in state {self.state}")
        self._set_state(DropState.WRITING)
        self.payload.write(value)
        if self.streaming_consumers:
            seq = self._chunk_seq
            self._chunk_seq = seq + 1
            for sc in self.streaming_consumers:
                sc.on_stream_chunk(self, value)
                # one event per delivery: the hooks bridge
                # (Pipeline.execute on_stream_chunk) subscribes to these
                self.fire("streamChunk", consumer=sc.uid, seq=seq)

    def read(self) -> Any:
        if self.state in (DropState.EXPIRED, DropState.DELETED):
            raise PayloadError(f"drop {self.uid} expired/deleted; read denied")
        return self.payload.read()

    @property
    def data_url(self) -> str:
        return self.payload.data_url

    def nbytes(self) -> int:
        return self.payload.nbytes()

    # -- event-driven completion (§3.6) ------------------------------------------
    def set_completed(self) -> None:
        """Mark payload fully present -> COMPLETED; notify consumers."""
        if self.state in _TERMINAL:
            return
        self.payload.seal()
        self.completed_at = time.monotonic()
        self._set_state(DropState.COMPLETED)
        self.fire("dropCompleted")
        for c in list(self.consumers):
            c.on_input_completed(self)
        for sc in list(self.streaming_consumers):
            sc.on_input_completed(self)

    def set_error(self, info: str = "") -> None:
        if self.state in _TERMINAL:
            return
        self.error_info = info
        self._set_state(DropState.ERROR)
        self.fire("dropError", info=info)
        for c in list(self.consumers) + list(self.streaming_consumers):
            c.on_input_error(self)

    def on_producer_finished(self, app: "AppDrop") -> None:
        """Paper §3.6: a data Drop completes once ALL its producers finish."""
        with self._state_lock:
            self._finished_producers += 1
            done = (self._finished_producers + self._errored_producers
                    >= len(self.producers))
        if done:
            self.set_completed()

    def on_producer_error(self, app: "AppDrop") -> None:
        """§3.6: Data Drops move to ERROR if ANY of their producers error."""
        with self._state_lock:
            self._errored_producers += 1
        self.set_error(f"producer {app.uid} errored")

    def to_record(self) -> Dict[str, Any]:
        rec = super().to_record()
        rec.update(
            finished_producers=self._finished_producers,
            errored_producers=self._errored_producers,
            data_url=self.data_url,
            payload_sealed=self.payload.sealed,
        )
        return rec

    def restore_record(self, rec: Dict[str, Any]) -> None:
        super().restore_record(rec)
        self._finished_producers = rec.get("finished_producers", 0)
        self._errored_producers = rec.get("errored_producers", 0)
        if rec.get("payload_sealed"):
            self.payload.seal()


def _drop_order_key(d: "Drop"):
    oid = d.meta.get("oid")
    return (tuple(oid) if oid else (), d.uid)


class AppDrop(Drop):
    """An Application Drop: a stateless task in a stateful wrapper (paper §3, §4).

    Batch semantics (§3.6): waits until every input is resolved
    (COMPLETED or ERROR); runs if the errored fraction is <= the
    error-tolerance threshold ``t`` (Fig. 7), else moves to ERROR.
    """

    def __init__(self, uid: str, func: Optional[Callable[..., Any]] = None, *,
                 error_threshold: float = 0.0, executor: Optional[Any] = None,
                 **kw: Any) -> None:
        super().__init__(uid, **kw)
        self.func = func
        self.error_threshold = float(error_threshold)   # t in the paper
        # per-drop scratch for streaming chunk handlers (cross-chunk
        # accumulation between on_stream_chunk calls; the compiled
        # engine's _StreamAppRef mirrors it)
        self.scratch: Dict[str, Any] = {}
        self.inputs: List[DataDrop] = []
        self.streaming_inputs: List[DataDrop] = []
        self.outputs: List[DataDrop] = []
        self.exec_state = AppState.NOT_RUN
        self._resolved: Dict[str, bool] = {}   # uid -> errored?
        self._exec_lock = threading.Lock()
        self._executor = executor               # set by the NodeDropManager
        self.run_duration: Optional[float] = None
        self.attempts = 0

    # -- graph wiring ------------------------------------------------------------
    def add_input(self, d: DataDrop, streaming: bool = False) -> None:
        d.add_consumer(self, streaming=streaming)

    def add_output(self, d: DataDrop) -> None:
        d.add_producer(self)

    # -- event handlers (§3.6) -----------------------------------------------------
    def on_input_completed(self, d: DataDrop) -> None:
        self._record_resolution(d.uid, errored=False)

    def on_input_error(self, d: DataDrop) -> None:
        self._record_resolution(d.uid, errored=True)

    def on_stream_chunk(self, d: DataDrop, value: Any) -> None:
        """Streaming consumers process input continuously (§4, Fig. 10)."""
        if self.func is not None and getattr(self.func, "streaming", False):
            self.func(value, self)

    def _record_resolution(self, uid: str, errored: bool) -> None:
        with self._exec_lock:
            self._resolved[uid] = errored
            n_in = len(self.inputs) + len(self.streaming_inputs)
            if len(self._resolved) < n_in:
                return
            n_err = sum(1 for e in self._resolved.values() if e)
            frac_err = n_err / max(n_in, 1)
            already = self.exec_state is not AppState.NOT_RUN
        if already or self.state in _TERMINAL:
            return
        if frac_err > self.error_threshold:
            self.set_error(
                f"{n_err}/{n_in} inputs errored > t={self.error_threshold}")
        else:
            self._submit()

    # -- execution -------------------------------------------------------------
    def _submit(self) -> None:
        if self._executor is not None:
            self._executor.submit(self.execute)
        else:
            self.execute()

    def execute(self) -> None:
        with self._exec_lock:
            if self.exec_state is not AppState.NOT_RUN:
                return
            self.exec_state = AppState.RUNNING
        self.attempts += 1
        self.fire("execStatus", status=AppState.RUNNING.value)
        t0 = time.monotonic()
        try:
            if self.func is not None:
                ok_inputs = [d for d in self.inputs
                             if d.state is DropState.COMPLETED]
                # deterministic input order regardless of wiring order
                # (cross-node edges are wired later by the island manager)
                ok_inputs.sort(key=_drop_order_key)
                if getattr(self.func, "streaming", False):
                    # streaming-marked func: chunks were delivered via
                    # on_stream_chunk; batch resolution runs only the
                    # optional finalizer (§4 — the consumer completes
                    # when its producers do)
                    fin = getattr(self.func, "finish", None)
                    if fin is not None:
                        fin(ok_inputs, list(self.outputs), self)
                else:
                    self.func(ok_inputs, list(self.outputs), self)
            self.run_duration = time.monotonic() - t0
            self._finish_ok()
        except Exception:  # noqa: BLE001 - app failures become drop ERRORs
            self.run_duration = time.monotonic() - t0
            self.set_error(traceback.format_exc(limit=8))

    def _finish_ok(self) -> None:
        with self._exec_lock:
            if self.exec_state in (AppState.FINISHED, AppState.ERROR,
                                   AppState.CANCELLED):
                return  # a speculative duplicate already committed
            self.exec_state = AppState.FINISHED
        self.completed_at = time.monotonic()
        self._set_state(DropState.COMPLETED)
        self.fire("producerFinished")
        for out in list(self.outputs):
            out.on_producer_finished(self)

    def commit_speculative(self) -> bool:
        """Commit a speculative duplicate's result (straggler mitigation).

        First finisher wins; the guard makes the loser a no-op.  Safe for
        idempotent (pure) apps — the write-once payload holds one value.
        """
        with self._exec_lock:
            if self.exec_state in (AppState.FINISHED, AppState.ERROR,
                                   AppState.CANCELLED):
                return False
            self.exec_state = AppState.FINISHED
        self.completed_at = time.monotonic()
        self._set_state(DropState.COMPLETED)
        self.fire("producerFinished", speculative=True)
        for out in list(self.outputs):
            out.on_producer_finished(self)
        return True

    def set_error(self, info: str = "") -> None:
        self.exec_state = AppState.ERROR
        self.error_info = info
        self._set_state(DropState.ERROR)
        self.fire("dropError", info=info)
        for out in list(self.outputs):
            out.on_producer_error(self)

    def skip(self) -> None:
        super().skip()
        self.exec_state = AppState.SKIPPED
        for out in list(self.outputs):
            out.on_producer_finished(self)

    # -- root trigger -------------------------------------------------------------
    def trigger_root(self) -> None:
        """Apps without inputs are roots; started directly at session start."""
        if not self.inputs and not self.streaming_inputs:
            self._submit()

    def to_record(self) -> Dict[str, Any]:
        rec = super().to_record()
        rec.update(exec_state=self.exec_state.value,
                   resolved=dict(self._resolved), attempts=self.attempts)
        return rec

    def restore_record(self, rec: Dict[str, Any]) -> None:
        super().restore_record(rec)
        self.exec_state = AppState(rec.get("exec_state", "NOT_RUN"))
        self._resolved = dict(rec.get("resolved", {}))
        self.attempts = rec.get("attempts", 0)
