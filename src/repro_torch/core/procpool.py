"""Process-backed node execution: spawn workers + a shared-memory payload plane.

DALiuGE's node/island Drop Managers are real OS processes; apps on different
nodes never share a GIL and a crashed app takes down only its own manager.
This module gives the compiled engine the same shape behind the existing
``node_executors()`` contract:

- :class:`ProcExecutor` — one spawn-based worker process per node, driven by a
  duplex-pipe mailbox.  The scheduler ships *work orders* (drop indices plus
  pre-resolved input references), never graph objects, and the worker replies
  with per-drop status, staged output writes, and monotonic timing stamps.
- :class:`PayloadPlane` — a per-island registry of
  ``multiprocessing.shared_memory`` segments.  Array payloads (``numpy``
  buffers over a size threshold) cross the process boundary as ``(segment,
  dtype, shape)`` descriptors and are mapped zero-copy on both sides; pickle
  is reserved for opaque (non-buffer) values and island-boundary edges, whose
  descriptor cache never spans planes.
- :class:`WorkerLost` — raised when a worker dies (SIGKILL, hard crash, wedged
  past its grace).  Callers treat it exactly like a scripted node failure:
  ``execute_resilient`` fails the node and recovers via the lineage machinery.

Workers are crash-isolated but *not* respawned: a lost worker is a lost node,
and recovery migrates its drops to surviving nodes — the same permanent-death
model the thread-backed recovery tier simulates.

Resource-tracker note (Python <= 3.12): ``SharedMemory`` registers every
segment it creates *or attaches* with the resource tracker.  Spawn workers
inherit the parent's tracker process, whose cache is a per-name set, so the
create/attach registrations collapse to one entry and the plane's single
``unlink()`` at close (which unregisters internally) balances it — no manual
``resource_tracker.unregister`` calls, which would leave the later unlink
unmatched and error the tracker.  Segments belonging to a worker killed
mid-batch stay registered until the plane unlinks them; any the plane never
saw are reaped by the tracker at interpreter exit instead of leaking into
``/dev/shm``.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import threading
import time
import traceback
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from multiprocessing.shared_memory import SharedMemory
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .drop import PayloadError

__all__ = [
    "DEFAULT_SHM_MIN_BYTES",
    "PayloadPlane",
    "ProcExecutor",
    "TrackingThreadPool",
    "WorkerLost",
    "WorkerTimeout",
]

#: Arrays below this many bytes ship inline (pickled into the mailbox blob);
#: at or above it they ride the shared-memory plane.  Small arrays are cheaper
#: to copy than to segment (one shm segment costs a file descriptor + mmap).
DEFAULT_SHM_MIN_BYTES = 64 * 1024

_PROTO = pickle.HIGHEST_PROTOCOL
_mp = multiprocessing.get_context("spawn")


class WorkerLost(RuntimeError):
    """A node's worker process died (or wedged past grace) mid-execution.

    Carries the node names whose workers are gone; the resilience loop treats
    them exactly like scripted node failures and recovers via lineage.
    """

    def __init__(self, nodes: Sequence[str]):
        self.nodes: List[str] = list(nodes)
        super().__init__(f"worker process lost for node(s): {', '.join(self.nodes)}")


class WorkerTimeout(RuntimeError):
    """A mailbox round trip exceeded its budget but the worker is still alive."""


def _create_segment(nbytes: int) -> SharedMemory:
    return SharedMemory(create=True, size=max(1, int(nbytes)))


def _is_plane_array(v: Any, min_bytes: int) -> bool:
    return (
        isinstance(v, np.ndarray)
        and not v.dtype.hasobject
        and v.nbytes >= min_bytes
    )


class TrackingThreadPool(ThreadPoolExecutor):
    """ThreadPoolExecutor that remembers outstanding futures so shutdown can
    drain in-flight work with a bounded grace instead of abandoning it."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._tracked: set = set()
        self._track_lock = threading.Lock()

    def submit(self, fn: Callable[..., Any], /, *args: Any, **kwargs: Any) -> Future:
        fut = super().submit(fn, *args, **kwargs)
        with self._track_lock:
            self._tracked.add(fut)
        fut.add_done_callback(self._discard)
        return fut

    def _discard(self, fut: Future) -> None:
        with self._track_lock:
            self._tracked.discard(fut)

    def drain(self, grace: float) -> List[Future]:
        """Wait up to *grace* seconds for queued + running work; return the
        futures still unfinished (work that would be abandoned)."""
        with self._track_lock:
            futs = list(self._tracked)
        deadline = time.monotonic() + max(0.0, grace)
        leftover: List[Future] = []
        for fut in futs:
            try:
                fut.result(timeout=max(0.0, deadline - time.monotonic()))
            except _FutureTimeout:
                leftover.append(fut)
            except (CancelledError, Exception):
                # work-level failures are the session's problem, not drain's
                pass
        return leftover


class PayloadPlane:
    """Parent-side registry of shared-memory payload segments for one island.

    Array values cross process boundaries as ``("shm", (name, dtype, shape))``
    descriptors.  The plane caches ``id(array) -> descriptor`` (pinning the
    array so ids stay valid), so an array produced by one worker and consumed
    by another on the same island ships as a descriptor only — zero copies,
    zero pickling.  A cross-island edge consults a *different* plane, misses
    the cache, and falls back to an export copy (or pickle below threshold):
    exactly the "pickle only for non-buffer objects and island-boundary
    edges" contract.

    Reference-counted by the node managers that share it; the last release
    unlinks every segment.
    """

    def __init__(self, shm_min_bytes: int = DEFAULT_SHM_MIN_BYTES):
        self.shm_min_bytes = int(shm_min_bytes)
        self._lock = threading.Lock()
        self._segments: Dict[str, SharedMemory] = {}
        self._by_id: Dict[int, Tuple[np.ndarray, tuple]] = {}
        self._refs = 0
        self._closed = False
        self.stats: Dict[str, int] = {
            "shm_exports": 0,      # parent heap array copied into a fresh segment
            "shm_passthrough": 0,  # descriptor cache hit: shipped with no copy
            "shm_results": 0,      # worker-produced segment mapped zero-copy
            "raw_values": 0,       # non-array / sub-threshold value pickled inline
        }

    # -- lifecycle ---------------------------------------------------------
    def retain(self) -> None:
        with self._lock:
            self._refs += 1

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            last = self._refs <= 0
        if last:
            self.close()

    def close(self) -> None:
        with self._lock:
            segs = list(self._segments.values())
            self._segments.clear()
            self._by_id.clear()
            self._closed = True
        for seg in segs:
            try:
                seg.close()
            except Exception:
                pass
            try:
                seg.unlink()
            except Exception:
                pass

    @property
    def closed(self) -> bool:
        return self._closed

    # -- wire encoding -----------------------------------------------------
    def encode(self, value: Any) -> Tuple[str, Any]:
        """Encode one input value for the mailbox: a shm descriptor for plane
        arrays (cache hit = no copy at all), the raw value otherwise."""
        if not _is_plane_array(value, self.shm_min_bytes):
            with self._lock:
                self.stats["raw_values"] += 1
            return ("raw", value)
        with self._lock:
            hit = self._by_id.get(id(value))
            if hit is not None and hit[0] is value:
                self.stats["shm_passthrough"] += 1
                return ("shm", hit[1])
        contig = np.ascontiguousarray(value)
        seg = _create_segment(contig.nbytes)
        np.ndarray(contig.shape, dtype=contig.dtype, buffer=seg.buf)[...] = contig
        desc = (seg.name, contig.dtype.str, contig.shape)
        with self._lock:
            self._segments[seg.name] = seg
            self._by_id[id(value)] = (value, desc)
            self.stats["shm_exports"] += 1
        return ("shm", desc)

    def attach(self, desc: tuple) -> np.ndarray:
        """Map a worker-exported segment zero-copy and pin it in the cache so
        forwarding it to another worker ships the descriptor only."""
        name, dtype, shape = desc
        with self._lock:
            seg = self._segments.get(name)
            if seg is None:
                seg = SharedMemory(name=name)
                self._segments[name] = seg
            arr = np.ndarray(tuple(shape), dtype=np.dtype(dtype), buffer=seg.buf)
            self._by_id[id(arr)] = (arr, desc)
            self.stats["shm_results"] += 1
        return arr

    def decode(self, wire: Tuple[str, Any]) -> Any:
        tag, payload = wire
        if tag == "shm":
            return self.attach(payload)
        if tag == "rawb":
            return pickle.loads(payload)
        return payload

    def discard_segment(self, name: str) -> None:
        """Unlink an orphaned worker-side segment (errored drop's partial writes)."""
        with self._lock:
            seg = self._segments.pop(name, None)
        try:
            if seg is None:
                seg = SharedMemory(name=name)
            seg.close()
            seg.unlink()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Worker side.  Everything below the fold runs in the spawned child process;
# it imports only this module (plus numpy / drop), never the scheduler.
# ---------------------------------------------------------------------------
class _WorkerInRef:
    """Input reference handed to the app inside the worker.  Values were
    resolved parent-side; a parent read failure re-raises as PayloadError at
    ``read()`` time, matching in-process lazy-read semantics."""

    __slots__ = ("uid", "meta", "_value", "_error")

    def __init__(self, uid: str, meta: Dict[str, Any], value: Any, error: Optional[str]):
        self.uid = uid
        self.meta = meta
        self._value = value
        self._error = error

    def read(self) -> Any:
        if self._error is not None:
            raise PayloadError(self._error)
        return self._value


class _WorkerOutRef:
    """Output reference: writes are staged locally and shipped back in the
    reply; the parent replays them into the session payload table."""

    __slots__ = ("idx", "uid", "meta", "_writes")

    def __init__(self, idx: int, uid: str, meta: Dict[str, Any], writes: List[Tuple[int, Any]]):
        self.idx = idx
        self.uid = uid
        self.meta = meta
        self._writes = writes

    def write(self, value: Any) -> None:
        self._writes.append((self.idx, value))


class _WorkerAppRef:
    __slots__ = ("uid", "meta", "node", "scratch")

    def __init__(self, uid: str, meta: Dict[str, Any], node: Optional[str]):
        self.uid = uid
        self.meta = meta
        self.node = node
        self.scratch: Dict[str, Any] = {}


def _decode_input(wire: Tuple[str, Any], segments: Dict[str, SharedMemory]) -> Any:
    tag, payload = wire
    if tag != "shm":
        return payload
    name, dtype, shape = payload
    seg = segments.get(name)
    if seg is None:
        seg = SharedMemory(name=name)
        segments[name] = seg
    return np.ndarray(tuple(shape), dtype=np.dtype(dtype), buffer=seg.buf)


def _encode_output(value: Any, min_bytes: int) -> Tuple[str, Any]:
    if _is_plane_array(value, min_bytes):
        contig = np.ascontiguousarray(value)
        seg = _create_segment(contig.nbytes)
        np.ndarray(contig.shape, dtype=contig.dtype, buffer=seg.buf)[...] = contig
        desc = (seg.name, contig.dtype.str, contig.shape)
        seg.close()  # close the mapping; the segment itself lives until unlink
        return ("shm", desc)
    return ("rawb", pickle.dumps(value, protocol=_PROTO))


def _run_spec(
    idx: int,
    blob: bytes,
    node: str,
    deadline: float,
    segments: Dict[str, SharedMemory],
    min_bytes: int,
) -> Dict[str, Any]:
    t0 = time.monotonic()
    if t0 >= deadline:
        return {"idx": idx, "status": "timeout"}
    encoded: List[Tuple[int, Tuple[str, Any]]] = []
    try:
        spec = pickle.loads(blob)
        func = spec.get("func")
        ins = [
            _WorkerInRef(uid, meta, _decode_input(wire, segments), err)
            for uid, meta, wire, err in spec.get("inputs", ())
        ]
        writes: List[Tuple[int, Any]] = []
        outs = [
            _WorkerOutRef(j, uid, meta, writes)
            for j, uid, meta in spec.get("outputs", ())
        ]
        app = _WorkerAppRef(spec.get("uid", ""), spec.get("meta", {}), node)
        if func is not None:
            if getattr(func, "streaming", False):
                fin = getattr(func, "finish", None)
                if fin is not None:
                    fin(ins, outs, app)
            else:
                func(ins, outs, app)
        for j, v in writes:
            encoded.append((j, _encode_output(v, min_bytes)))
        return {
            "idx": idx,
            "status": "ok",
            "writes": encoded,
            "t0": t0,
            "t1": time.monotonic(),
        }
    except Exception:
        return {
            "idx": idx,
            "status": "err",
            "tb": traceback.format_exc(limit=8),
            # partial shm exports from staged writes would otherwise leak
            "orphans": [d[0] for _, (tag, d) in encoded if tag == "shm"],
            "t0": t0,
            "t1": time.monotonic(),
        }


def _worker_main(conn: Any, node: str, min_bytes: int) -> None:
    """Mailbox loop of one node worker.  Requests: ("run", bid, items,
    budget) / ("ping",) / ("stop",).  Replies: ("done", bid, results) /
    ("pong", pid)."""
    segments: Dict[str, SharedMemory] = {}
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            tag = msg[0]
            if tag == "stop":
                break
            if tag == "ping":
                conn.send(("pong", os.getpid()))
                continue
            _, bid, items, budget = msg
            deadline = time.monotonic() + float(budget)
            results = [
                _run_spec(idx, blob, node, deadline, segments, min_bytes)
                for idx, blob in items
            ]
            conn.send(("done", bid, results))
    finally:
        for seg in segments.values():
            try:
                seg.close()
            except Exception:
                pass
        try:
            conn.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Parent side.
# ---------------------------------------------------------------------------
class ProcExecutor:
    """One crash-isolated spawn worker for one node, plus a small thread pool
    so existing ``executor.submit(...)`` call sites keep working.

    ``run_batch`` is the process path: it wire-encodes specs (per-spec pickle,
    so one unpicklable app poisons only its own drop), ships them through the
    mailbox, and decodes the reply.  Worker death — pipe EOF, ``is_alive()``
    false, or a wedge past ``budget + grace`` (the worker is then SIGKILLed) —
    raises :class:`WorkerLost`; the worker is never respawned.
    """

    #: extra seconds past the batch budget before a silent worker is declared
    #: wedged and killed.  Generous: a busy loop just under budget plus reply
    #: serialisation must fit.
    grace = 10.0

    def __init__(
        self,
        node: str,
        plane: PayloadPlane,
        submit_workers: int = 4,
        shm_min_bytes: Optional[int] = None,
    ):
        self.node = node
        self.plane = plane
        self.shm_min_bytes = int(
            plane.shm_min_bytes if shm_min_bytes is None else shm_min_bytes
        )
        self.on_lost: Optional[Callable[[], None]] = None
        self._threads = TrackingThreadPool(
            max_workers=submit_workers, thread_name_prefix=f"procex-{node}"
        )
        self._lock = threading.Lock()  # serialises mailbox round trips
        self._proc: Optional[Any] = None
        self._conn: Optional[Any] = None
        self._dead = False
        self._batch_seq = 0

    # -- thread-pool facade (ResilientRunner, AppDrop call sites) ----------
    def submit(self, fn: Callable[..., Any], /, *args: Any, **kwargs: Any) -> Future:
        return self._threads.submit(fn, *args, **kwargs)

    def drain(self, grace: float) -> List[Future]:
        return self._threads.drain(grace)

    # -- worker lifecycle --------------------------------------------------
    @property
    def pid(self) -> Optional[int]:
        proc = self._proc
        return proc.pid if proc is not None else None

    @property
    def dead(self) -> bool:
        return self._dead

    def _ensure_worker(self) -> None:
        if self._proc is not None:
            return
        parent_conn, child_conn = _mp.Pipe(duplex=True)
        proc = _mp.Process(
            target=_worker_main,
            args=(child_conn, self.node, self.shm_min_bytes),
            name=f"procpool-{self.node}",
            daemon=True,
        )
        proc.start()
        child_conn.close()
        self._proc = proc
        self._conn = parent_conn

    def _mark_lost(self) -> None:
        self._dead = True
        cb = self.on_lost
        if cb is not None:
            try:
                cb()
            except Exception:
                pass

    def kill(self) -> None:
        """SIGKILL the worker (recovery drills / wedge escalation)."""
        proc = self._proc
        if proc is not None and proc.is_alive():
            proc.kill()

    def shutdown(self, wait: bool = False, cancel_futures: bool = True) -> None:
        self._threads.shutdown(wait=wait, cancel_futures=cancel_futures)
        self._stop_worker()

    def _stop_worker(self) -> None:
        proc, conn = self._proc, self._conn
        self._proc, self._conn = None, None
        if conn is not None:
            try:
                conn.send(("stop",))
            except Exception:
                pass
        if proc is not None:
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=2.0)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    # -- the mailbox -------------------------------------------------------
    def run_batch(
        self, specs: Sequence[Dict[str, Any]], budget: float
    ) -> List[Dict[str, Any]]:
        """Execute *specs* in the worker; returns one result dict per spec:
        ``{"idx", "status": "ok"|"err"|"timeout", "writes": [(out_idx, value)],
        "tb", "t0", "t1"}`` with writes already plane-decoded.  Raises
        :class:`WorkerLost` if the worker dies or wedges past grace."""
        if not specs:
            return []
        with self._lock:
            if self._dead:
                raise WorkerLost([self.node])
            self._ensure_worker()
            now = time.monotonic()
            parent_fail: List[Dict[str, Any]] = []
            items: List[Tuple[int, bytes]] = []
            for spec in specs:
                try:
                    items.append(
                        (int(spec["idx"]), pickle.dumps(self._encode_spec(spec), protocol=_PROTO))
                    )
                except Exception:
                    parent_fail.append(
                        {
                            "idx": int(spec["idx"]),
                            "status": "err",
                            "tb": (
                                "app or inputs not picklable for process dispatch "
                                f"(node {self.node}):\n" + traceback.format_exc(limit=8)
                            ),
                            "t0": now,
                            "t1": now,
                        }
                    )
            if not items:
                return parent_fail
            self._batch_seq += 1
            bid = self._batch_seq
            try:
                self._conn.send(("run", bid, items, float(budget)))
            except (BrokenPipeError, OSError):
                self._mark_lost()
                raise WorkerLost([self.node]) from None
            reply = self._recv(bid, float(budget))
            return parent_fail + [self._decode_result(r) for r in reply]

    def _recv(self, bid: int, budget: float) -> List[Dict[str, Any]]:
        hard = time.monotonic() + max(budget, 0.0) + self.grace
        conn, proc = self._conn, self._proc
        while True:
            if conn.poll(0.1):
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    self._mark_lost()
                    raise WorkerLost([self.node]) from None
                if msg[0] == "done" and msg[1] == bid:
                    return msg[2]
                continue  # stale reply from a batch we gave up on
            if not proc.is_alive():
                self._mark_lost()
                raise WorkerLost([self.node])
            if time.monotonic() >= hard:
                # wedged past grace: a hung worker is indistinguishable from a
                # dead one to the scheduler, so make it actually dead
                self.kill()
                self._mark_lost()
                raise WorkerLost([self.node])

    def _encode_spec(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        wire = dict(spec)
        wire["inputs"] = [
            (uid, meta, self.plane.encode(value), err)
            for uid, meta, value, err in spec.get("inputs", ())
        ]
        return wire

    def _decode_result(self, r: Dict[str, Any]) -> Dict[str, Any]:
        if r.get("status") == "ok":
            r["writes"] = [(j, self.plane.decode(w)) for j, w in r.get("writes", ())]
        else:
            for name in r.pop("orphans", ()):
                self.plane.discard_segment(name)
        return r
