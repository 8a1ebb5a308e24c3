"""Ring-buffer chunk table for compiled streaming execution.

The object engine implements the paper's §4/Fig. 10 streaming-consumer
contract directly: ``DataDrop.write`` hands every chunk to each streaming
consumer's ``on_stream_chunk`` as it lands.  The compiled engine has no
drop objects to call back into — this module gives it the equivalent
substrate: one bounded ring of chunk references per *active* streaming
edge, sitting beside ``CompiledSession``'s dense payload table.

An edge is **active** when all of the following hold:

* ``edge_streaming`` is set on it (carried from the logical graph),
* the source is a data drop and the destination an app drop (the only
  combination the object engine honours — see ``unroll``/``_wire``),
* the destination's registered app function is *streaming-marked*
  (``func.streaming`` truthy, e.g. via ``register_app(name,
  streaming=True)``).  A non-marked consumer on a streaming edge simply
  ignores chunks in the object engine, so it stays a plain batch
  dependency here too — that is contract, not degradation.

Every ``CompiledSession._write_idx``/``write`` on a ringed source pushes
the value into each of its rings.  Rings are bounded
(``StreamConfig.ring_capacity``); a full ring blocks the producer
(backpressure) until the consumer drains — the compiled analogue of the
object engine delivering chunks synchronously inside ``write``.

Cursors are *totals*: ``wcur[e]`` chunks pushed, ``rcur[e]`` consumed;
``wcur - rcur`` is the ring occupancy and ``rcur % capacity`` the next
slot to read.  Cursors and buffered chunks live on the session (not the
per-run dispatch lane), so a timed-out ``execute_frontier`` resumes
mid-stream, and recovery can invalidate them explicitly
(:meth:`StreamTable.invalidate` — see ``docs/streaming.md``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

import numpy as np

from .pgt import KIND_APP, KIND_DATA, CompiledPGT
from .session import ST_INIT

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .session import CompiledSession


class StreamAbort(Exception):
    """Raised out of a blocked ``push`` when the run is shutting down.

    ``execute_frontier`` re-raises it as a resumable timeout; buffered
    chunks and cursors survive on the session for the next attempt.
    """


@dataclass(frozen=True)
class StreamConfig:
    """Knobs for the compiled streaming lane.

    ``enabled=False`` degrades streaming edges back to batch
    dependencies (the pre-PR-9 behaviour) — the engine then emits the
    ``exec.streaming_edges_degraded`` counter and a one-time warning.
    """
    enabled: bool = True
    ring_capacity: int = 64          # chunks buffered per edge before backpressure
    backpressure_poll_s: float = 0.05  # wait granularity while a ring is full
    shutdown_grace_s: float = 5.0    # consumer-thread join budget at lane shutdown

    def validate(self) -> "StreamConfig":
        if self.ring_capacity < 1:
            raise ValueError("StreamConfig.ring_capacity must be >= 1")
        if self.backpressure_poll_s <= 0:
            raise ValueError("StreamConfig.backpressure_poll_s must be > 0")
        if self.shutdown_grace_s <= 0:
            raise ValueError("StreamConfig.shutdown_grace_s must be > 0")
        return self


def streaming_candidates(pgt: CompiledPGT) -> np.ndarray:
    """Edge ids of data→app streaming edges (before the func-mark filter)."""
    if not pgt.num_edges or not pgt.edge_streaming.any():
        return np.empty(0, dtype=np.int64)
    mask = (pgt.edge_streaming
            & (pgt.kind_arr[pgt.edge_src] == KIND_DATA)
            & (pgt.kind_arr[pgt.edge_dst] == KIND_APP))
    return np.flatnonzero(mask).astype(np.int64)


def active_stream_edges(pgt: CompiledPGT) -> np.ndarray:
    """Candidate edges whose consumer app function is streaming-marked."""
    cand = streaming_candidates(pgt)
    if not cand.size:
        return cand
    from .managers import _APP_REGISTRY  # lazy: avoid import cycle
    keep: List[int] = []
    marked: Dict[int, bool] = {}   # consumer idx -> streaming-marked?
    for e in cand.tolist():
        dst = int(pgt.edge_dst[e])
        ok = marked.get(dst)
        if ok is None:
            name = pgt.app_of(dst)
            func = _APP_REGISTRY.get(name) if name else None
            ok = bool(getattr(func, "streaming", False))
            marked[dst] = ok
        if ok:
            keep.append(e)
    return np.asarray(keep, dtype=np.int64)


class StreamTable:
    """Per-active-streaming-edge chunk rings + cursors.

    One instance per :class:`CompiledSession` (``session.stream``),
    created lazily by ``CompiledSession.enable_streaming``.  All mutable
    state is guarded by one condition variable — chunks are coarse
    (application-level values), so a single lock is not a bottleneck.
    """

    def __init__(self, session: "CompiledSession", edge_ids: np.ndarray,
                 config: StreamConfig) -> None:
        pgt = session.pgt
        self.session = session
        self.config = config.validate()
        self.capacity = int(config.ring_capacity)
        self.edge_ids = edge_ids                       # global edge ids
        self.src = pgt.edge_src[edge_ids].astype(np.int64)
        self.dst = pgt.edge_dst[edge_ids].astype(np.int64)
        self.n_edges = int(edge_ids.shape[0])
        self.chunks = np.full((self.n_edges, self.capacity), None,
                              dtype=object)
        self.wcur = np.zeros(self.n_edges, dtype=np.int64)  # total pushed
        self.rcur = np.zeros(self.n_edges, dtype=np.int64)  # total consumed
        # fast membership masks over all drops
        n = pgt.num_drops
        self.is_src = np.zeros(n, dtype=bool)
        self.is_src[self.src] = True
        self.is_consumer = np.zeros(n, dtype=bool)
        self.is_consumer[self.dst] = True
        # drop idx -> local edge ids
        self.rings_of_src: Dict[int, List[int]] = {}
        self.edges_of_dst: Dict[int, List[int]] = {}
        for k in range(self.n_edges):
            self.rings_of_src.setdefault(int(self.src[k]), []).append(k)
            self.edges_of_dst.setdefault(int(self.dst[k]), []).append(k)
        # stream vs batch in-degree split (diagnostic + tests)
        self.stream_in_deg = np.zeros(n, dtype=np.int64)
        np.add.at(self.stream_in_deg, self.dst, 1)
        # coordination
        self.cond = threading.Condition()
        self._attached = False        # a dispatch lane is consuming
        self._shutdown = False
        # stale-lane write fence: bumped by fence() when a lane shuts down
        # with consumer threads still alive; refs minted under an older
        # generation refuse to mutate rings/payloads afterwards
        self.generation = 0
        self.deadline = float("inf")  # run deadline, set by attach()
        self.on_first_chunk: Optional[Callable[[int], None]] = None
        self.on_backpressure: Optional[Callable[[int, int, float], None]] = None
        # persistent per-consumer app refs (cross-chunk state; survives
        # resumable timeouts, reset by recovery invalidation)
        self.app_refs: Dict[int, Any] = {}
        # stats
        self.backpressure_waits = 0
        self.chunks_pushed = 0
        self.chunks_dropped = 0       # unconsumed pushes with no lane attached

    # ------------------------------------------------------------------
    # construction helper
    # ------------------------------------------------------------------
    @classmethod
    def build(cls, session: "CompiledSession",
              config: Optional[StreamConfig] = None
              ) -> Optional["StreamTable"]:
        """Build the table for a session, or None if no active edges.

        Seeds already written through ``session.write`` *before* the
        table existed (direct ``execute_frontier`` callers) are
        reconciled: each untouched ring whose source payload is present
        receives that payload as its first chunk.
        """
        edge_ids = active_stream_edges(session.pgt)
        if not edge_ids.size:
            return None
        tbl = cls(session, edge_ids, config or StreamConfig())
        for k in range(tbl.n_edges):
            s_idx = int(tbl.src[k])
            if session.payload_present[s_idx] and tbl.wcur[k] == 0:
                tbl.chunks[k, 0] = session.payloads[s_idx]
                tbl.wcur[k] = 1
                tbl.chunks_pushed += 1
        return tbl

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------
    def push(self, src_idx: int, value: Any) -> None:
        """Append ``value`` to every ring fed by drop ``src_idx``.

        Blocks (backpressure) while a ring is full and a dispatch lane
        is attached; without a lane the oldest chunk is overwritten and
        counted in ``chunks_dropped`` (nothing is consuming — blocking
        would deadlock the caller).
        """
        rings = self.rings_of_src.get(int(src_idx))
        if not rings:
            return
        state = self.session.drop_state
        activate: List[int] = []
        with self.cond:
            for k in rings:
                dst = int(self.dst[k])
                if state[dst] != ST_INIT:
                    continue       # consumer already terminal: discard
                waited = 0.0
                while self.wcur[k] - self.rcur[k] >= self.capacity:
                    if self._shutdown or not self._attached:
                        if self._shutdown:
                            raise StreamAbort(
                                f"stream push to ring {k} aborted")
                        # no consumer running: keep the newest chunks
                        self.rcur[k] += 1
                        self.chunks_dropped += 1
                        break
                    if time.monotonic() > self.deadline:
                        raise StreamAbort(
                            f"stream push to ring {k} blocked past the "
                            "run deadline (backpressure)")
                    self.backpressure_waits += 1
                    cb = self.on_backpressure
                    if cb is not None:
                        cb(int(src_idx), dst, waited)
                    self.cond.wait(self.config.backpressure_poll_s)
                    waited += self.config.backpressure_poll_s
                    if state[dst] != ST_INIT:
                        break
                if state[dst] != ST_INIT:
                    continue
                first = self.wcur[k] == self.rcur[k]
                self.chunks[k, int(self.wcur[k]) % self.capacity] = value
                self.wcur[k] += 1
                self.chunks_pushed += 1
                if first and dst not in activate:
                    activate.append(dst)
            self.cond.notify_all()
        cb = self.on_first_chunk
        if cb is not None:
            for dst in activate:
                cb(dst)

    # ------------------------------------------------------------------
    # consumer side (called by the dispatch lane, under ``self.cond``)
    # ------------------------------------------------------------------
    def pop_ready_locked(self, dst_idx: int):
        """Pop one buffered chunk for a consumer: ``(local_edge, seq,
        value)`` or None.  Caller must hold ``self.cond``."""
        for k in self.edges_of_dst.get(int(dst_idx), ()):
            if self.rcur[k] < self.wcur[k]:
                slot = int(self.rcur[k]) % self.capacity
                value = self.chunks[k, slot]
                self.chunks[k, slot] = None
                seq = int(self.rcur[k])
                self.rcur[k] += 1
                self.cond.notify_all()   # wake producers blocked on full
                return k, seq, value
        return None

    def pending_chunks(self, dst_idx: int) -> int:
        with self.cond:
            return int(sum(self.wcur[k] - self.rcur[k]
                           for k in self.edges_of_dst.get(int(dst_idx), ())))

    # ------------------------------------------------------------------
    # lane lifecycle
    # ------------------------------------------------------------------
    def attach(self, on_first_chunk: Callable[[int], None],
               on_backpressure: Optional[Callable] = None,
               deadline: float = float("inf")) -> None:
        with self.cond:
            self._attached = True
            self._shutdown = False
            self.on_first_chunk = on_first_chunk
            self.on_backpressure = on_backpressure
            self.deadline = deadline

    def detach(self) -> None:
        with self.cond:
            self._attached = False
            self.on_first_chunk = None
            self.on_backpressure = None
            self.cond.notify_all()

    def shutdown(self) -> None:
        """Abort blocked producers (resumable timeout / interrupt)."""
        with self.cond:
            self._shutdown = True
            self.cond.notify_all()

    def fence(self) -> int:
        """Invalidate every outstanding lane reference: refs minted under an
        older generation raise :class:`StreamAbort` on write and their
        consumer loops exit at the next wakeup.  Called when a lane shuts
        down with wedged consumer threads still alive, so a thread that
        eventually unwedges cannot mutate rings or payloads behind a
        resumable reopen."""
        with self.cond:
            self.generation += 1
            self.cond.notify_all()
            return self.generation

    # ------------------------------------------------------------------
    # recovery integration
    # ------------------------------------------------------------------
    def invalidate(self, lost_mask: np.ndarray) -> int:
        """Reset rings touched by a recovery pass.

        ``lost_mask`` is a boolean mask over drops that were reset to
        INIT (lost data + producers being re-run).  For every ring whose
        source will re-stream or whose consumer restarts, cursors drop
        back to zero and buffered chunks are cleared; the consumer's
        persistent app ref (cross-chunk state) is discarded so the
        re-delivered stream is consumed from scratch.  Rings whose
        consumer already completed are left alone — late re-pushes are
        discarded by ``push``'s terminal-state check.

        Root sources (no producer to re-run) that keep their payload are
        re-seeded with it as a single chunk, mirroring the object
        engine's one ``write`` per root seed.

        Returns the number of rings reset.
        """
        state = self.session.drop_state
        reset = 0
        with self.cond:
            for k in range(self.n_edges):
                s_idx, dst = int(self.src[k]), int(self.dst[k])
                if not (lost_mask[s_idx] or lost_mask[dst]):
                    continue
                if state[dst] != ST_INIT:
                    continue       # completed consumer: keep its result
                self.wcur[k] = 0
                self.rcur[k] = 0
                self.chunks[k, :] = None
                self.app_refs.pop(dst, None)
                reset += 1
                if (not lost_mask[s_idx]
                        and self.session.payload_present[s_idx]):
                    # durable source that is NOT re-running: re-seed
                    self.chunks[k, 0] = self.session.payloads[s_idx]
                    self.wcur[k] = 1
            self.cond.notify_all()
        return reset

    def expand_lost(self, lost: np.ndarray) -> np.ndarray:
        """Grow a recovery lost-set so partially-consumed streams replay.

        A consumer that is being reset (``dst`` in ``lost``) with
        consumed chunks (``rcur > 0``) cannot replay them from the ring
        — they are gone.  The only way to re-deliver the same chunk
        sequence is to re-run the producing apps, so the source data
        drop and its COMPLETED producers join the lost set (transitively
        pulling any of *their* inputs that are no longer readable, same
        durability rule as ``CompiledFaultManager.lost_set``).  Root
        sources (no producers) are instead re-seeded by
        :meth:`invalidate`.
        """
        if not self.n_edges:
            return lost
        s = self.session
        pgt = s.pgt
        from .session import PK_FILE, ST_COMPLETED
        in_indptr, in_cols = pgt.in_csr()
        lost_set = set(int(i) for i in lost.tolist())
        frontier: List[int] = []

        def _add(idx: int) -> None:
            if idx not in lost_set:
                lost_set.add(idx)
                frontier.append(idx)

        with self.cond:
            for k in range(self.n_edges):
                s_idx, dst = int(self.src[k]), int(self.dst[k])
                if dst in lost_set and int(self.rcur[k]) > 0:
                    preds = in_cols[in_indptr[s_idx]:in_indptr[s_idx + 1]]
                    if preds.size:
                        _add(s_idx)
        while frontier:
            idx = frontier.pop()
            if pgt.kind_arr[idx] == KIND_DATA:
                # data being re-written: re-run its completed producers
                preds = in_cols[in_indptr[idx]:in_indptr[idx + 1]]
                for p in preds.tolist():
                    if s.drop_state[p] == ST_COMPLETED:
                        _add(int(p))
            else:
                # app being re-run: its inputs must be readable
                preds = in_cols[in_indptr[idx]:in_indptr[idx + 1]]
                for p in preds.tolist():
                    if (s.drop_state[p] == ST_COMPLETED
                            and not s.payload_present[p]
                            and s.payload_kind[p] != PK_FILE):
                        _add(int(p))
        if len(lost_set) == lost.shape[0]:
            return lost
        return np.fromiter(sorted(lost_set), dtype=np.int64,
                           count=len(lost_set))
