"""Resilience for the compiled engine (paper §3.6 + §7, array-native).

``core.fault`` implements node-failure migration, straggler speculation
and bounded retries for the *object* engine — per-drop Python objects,
per-drop recursion.  This module is the same failure model lifted onto
the ``CompiledPGT`` / ``CompiledSession`` state arrays, where the
compiled path's 100x throughput advantage lives:

* **Node failure + lineage recovery** — :class:`CompiledFaultManager`
  computes the lost set (non-terminal drops on dead nodes plus volatile
  COMPLETED memory payloads there) and its upstream closure with
  vectorized reverse-CSR traversals (``pgt.in_csr`` + ``csr_gather``),
  remaps lost drops onto live nodes round-robin, resets state/payload
  rows in bulk and lets ``execute_frontier`` resume mid-wave — the
  scheduler re-derives its readiness counters from the state array.

* **Straggler speculation** — :class:`ResilientRunner` plugs into the
  dispatch layer (``ExecHooks.python_runner``): per-node wave batches run
  on the node's thread pool with deadline tracking; an app slower than
  ``factor`` x the median completed duration is duplicated onto the
  least-loaded live node, and the first writer commits into the dense
  payload table (the loser's buffered writes are discarded — no payload
  corruption, unlike raw double-execution).

* **Bounded retry** — a dispatch-layer policy (exponential backoff, no
  terminal sleep) instead of the object path's per-app ``with_retries``
  wrapper.

The object engine remains the semantic oracle: compiled recovery must
produce the same final status counts and payload values as
``fault.FaultManager.recover`` on identical failure scripts
(``tests/test_resilience_equiv.py`` enforces it).
"""
from __future__ import annotations

import statistics
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .exec_compiled import ExecHooks, _DataRef, _WaveTimeout, \
    execute_frontier, node_batches
from .managers import MasterDropManager
from .pgt import KIND_DATA, CompiledPGT, csr_gather
from .procpool import WorkerLost
from .session import (PK_FILE, PK_MEMORY, PK_NULL, ST_COMPLETED, ST_ERROR,
                      ST_INIT, CompiledSession)

__all__ = [
    "CompiledFaultManager", "FailureScript", "NodeFailureInterrupt",
    "ResilienceConfig", "ResilienceStats", "ResilientRunner", "RetryPolicy",
    "StragglerPolicy", "execute_resilient",
]


# ---------------------------------------------------------------------------
# Policy / configuration
# ---------------------------------------------------------------------------


@dataclass
class RetryPolicy:
    """Bounded re-attempts for registry apps (transient-failure guard)."""
    max_attempts: int = 3
    backoff: float = 0.0           # seconds; exponential: backoff * 2^k


@dataclass
class StragglerPolicy:
    """Speculative duplicate dispatch for slow apps (wave-deadline based).

    An app still uncommitted after ``factor`` x the median completed app
    duration (but at least ``min_runtime`` seconds) is duplicated onto the
    least-loaded live node; first writer wins."""
    factor: float = 3.0
    min_runtime: float = 0.05
    poll: float = 0.01


@dataclass
class FailureScript:
    """Scripted node death: kill ``node`` once the terminal-drop fraction
    reaches ``at_fraction`` (0.0 = before the first wave)."""
    node: str
    at_fraction: float = 0.5


@dataclass
class ResilienceConfig:
    failures: List[FailureScript] = field(default_factory=list)
    stragglers: Optional[StragglerPolicy] = None
    retry: Optional[RetryPolicy] = None

    @property
    def needs_runner(self) -> bool:
        return self.stragglers is not None or self.retry is not None


@dataclass
class ResilienceStats:
    recoveries: int = 0
    recovered_drops: int = 0
    speculative_wins: int = 0
    speculative_losses: int = 0
    retries: int = 0
    failed_nodes: List[str] = field(default_factory=list)
    recovery_seconds: float = 0.0      # lost-set closure+remap+reset, total


# ---------------------------------------------------------------------------
# Node failure + array-native lineage recovery
# ---------------------------------------------------------------------------


class CompiledFaultManager:
    """Array-native mirror of :class:`repro.core.fault.FaultManager`.

    Same failure model, no per-drop recursion: the lost set and its
    upstream closure are computed with bulk boolean masks and reverse-CSR
    gathers, so a 100k-drop recovery costs milliseconds (benchmarked by
    ``bench_execute.py --tier recovery``).
    """

    def __init__(self, session: CompiledSession,
                 master: MasterDropManager) -> None:
        self.session = session
        self.master = master
        self.stats = ResilienceStats()
        # one drop-id array per recovery pass (reset + remapped)
        self.recovered: List[np.ndarray] = []
        self._nid_dead: Optional[np.ndarray] = None   # set by lost_set()
        self._root_data: Optional[np.ndarray] = None  # bool cache

    # -- failure injection -------------------------------------------------
    def fail_node(self, node: str) -> None:
        nm = self.master.node_managers()[node]
        nm.fail()
        if node not in self.stats.failed_nodes:
            self.stats.failed_nodes.append(node)

    # -- lost set ----------------------------------------------------------
    def lost_set(self) -> np.ndarray:
        """Drop ids that must be re-executed after node death.

        Mirrors ``FaultManager.recover`` steps 1-3, vectorized:

        1. dead placement mask over ``pgt.node_ids``;
        2. initial lost set = non-terminal (INIT) drops on dead nodes
           plus COMPLETED *memory*-payload data drops there (memory died
           with the node; file payloads survive on shared storage; root
           data drops are pipeline inputs — durable by contract);
        3. upstream closure over the reverse CSR: a lost data drop pulls
           in its COMPLETED producers (they must re-run to regenerate the
           payload); a lost COMPLETED app pulls in every COMPLETED input
           whose payload is no longer readable (not durable).

        Unlike the oracle's per-drop recursion — which also walks and
        "resets" the not-yet-run INIT region upstream of lost drops (a
        no-op reset) — the closure expands only through the COMPLETED
        lineage that genuinely needs recomputation, so its cost scales
        with the recompute set, not the unexecuted graph.  Final states
        and payloads are identical (``tests/test_resilience_equiv.py``).
        """
        s, pgt = self.session, self.session.pgt
        dead_names = self.master.dead_nodes()
        if not dead_names:
            return np.empty(0, dtype=np.int64)
        # node-id lookup table beats np.isin (no sort of node_ids);
        # after the initial dead scan everything below operates on
        # subsets, so the closure scales with the lost set, not with n
        nid_dead = np.zeros(len(pgt.node_names), dtype=bool)
        nid_dead[[pgt.node_id_for(n) for n in dead_names]] = True
        self._nid_dead = nid_dead          # reused by recover()
        state = s.drop_state
        n = pgt.num_drops
        kind = pgt.kind_arr
        pk = s.payload_kind
        present = s.payload_present
        if self._root_data is None:
            self._root_data = (kind == KIND_DATA) & (pgt.in_degrees() == 0)
        root_data = self._root_data
        if s.node_slices:
            # the deploy/recovery-maintained per-node slices ARE the
            # dead placement set — no full-graph scan needed
            parts = [s.node_slices[nm] for nm in dead_names
                     if nm in s.node_slices]
            if not parts:
                return np.empty(0, dtype=np.int64)
            didx = parts[0] if len(parts) == 1 else np.concatenate(parts)
        else:
            didx = np.flatnonzero(nid_dead[pgt.node_ids])
        if didx.size == 0:
            return np.empty(0, dtype=np.int64)
        dst = state[didx]
        dvol = (kind[didx] == KIND_DATA) & (pk[didx] == PK_MEMORY)
        sel = didx[~root_data[didx]
                   & ((dst == ST_INIT) | ((dst == ST_COMPLETED) & dvol))]
        if sel.size == 0:
            return np.empty(0, dtype=np.int64)
        lost = np.zeros(n, dtype=bool)
        lost[sel] = True
        chunks = [sel]

        in_indptr, in_cols = pgt.in_csr()
        frontier = sel
        while frontier.size:
            is_d = kind[frontier] == KIND_DATA
            data_f = frontier[is_d]
            # only COMPLETED apps are reset-with-recompute; INIT apps on
            # dead nodes just migrate (their inputs are either durable,
            # already in the lost set, or will be produced on resume)
            app_f = frontier[~is_d]
            app_f = app_f[state[app_f] == ST_COMPLETED]
            parts = []
            if data_f.size:
                # COMPLETED producers of a lost data drop must re-run
                # (INIT producers simply run on resume)
                preds = csr_gather(in_indptr, in_cols, data_f)
                parts.append(preds[state[preds] == ST_COMPLETED])
            if app_f.size:
                # a re-run app needs every input payload readable: file
                # payloads are durable wherever they were written; memory
                # and null payloads need the value present AND the node
                # alive; root data drops are durable by contract.
                # Evaluated per gathered input - O(|ins|), not O(n).
                ins = csr_gather(in_indptr, in_cols, app_f)
                durable = (pk[ins] == PK_FILE) | (
                    ((pk[ins] == PK_NULL) | present[ins])
                    & ~nid_dead[pgt.node_ids[ins]])
                durable |= root_data[ins]
                parts.append(
                    ins[(state[ins] == ST_COMPLETED) & ~durable])
            if not parts:
                break
            cand = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if cand.size == 0:
                break
            new = np.unique(cand)          # subset sort, no O(n) scan
            new = new[~lost[new]]
            if new.size == 0:
                break
            lost[new] = True
            chunks.append(new)
            frontier = new
        return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]

    # -- recovery ----------------------------------------------------------
    def recover(self) -> np.ndarray:
        """Migrate lost drops onto live nodes and make the session
        resumable.  Returns the recovered drop-id array.

        Bulk operations only: one closure pass, one round-robin remap of
        ``node_ids``, one state/payload reset, one slice re-registration.
        ``execute_frontier`` then resumes mid-wave — its readiness
        counters are re-derived from the state array on entry.
        """
        t0 = time.monotonic()
        if not self.master.dead_nodes():
            return np.empty(0, dtype=np.int64)
        live = sorted(self.master.live_node_managers())
        if not live:
            raise RuntimeError("no live nodes left to migrate onto")
        s, pgt = self.session, self.session.pgt
        lost = self.lost_set()
        if s.stream is not None and lost.size:
            # a lost streaming consumer has irrecoverably consumed part
            # of its ring — pull its source data (and their producers)
            # into the lost set so the stream replays from chunk 0
            lost = s.stream.expand_lost(lost)
        if lost.size:
            # migrate only the lost drops placed on dead nodes; lost
            # lineage already on live nodes (producers pulled in by the
            # closure) re-runs in place — no pointless migration
            moved = lost[self._nid_dead[pgt.node_ids[lost]]]
            live_ids = np.fromiter((pgt.node_id_for(n) for n in live),
                                   dtype=np.int32, count=len(live))
            pgt.node_ids[moved] = live_ids[
                np.arange(moved.size, dtype=np.int64) % live_ids.size]
            s.drop_state[lost] = ST_INIT
            lost_data = lost[pgt.kind_arr[lost] == KIND_DATA]
            s.payloads[lost_data] = None
            s.payload_present[lost_data] = False
            # round-robin strides give each target node its slice directly
            moved_by_node = {live[t]: moved[t::live_ids.size]
                             for t in range(live_ids.size)}
            self.master.refresh_compiled_slices(s, pgt, moved_by_node)
            if s.stream is not None:
                mask = np.zeros(len(pgt), dtype=bool)
                mask[lost] = True
                s.stream.invalidate(mask)
            self.recovered.append(lost)
        s.reopen()
        s.recoveries += 1
        s.recovered_drops += int(lost.size)
        self.stats.recoveries += 1
        self.stats.recovered_drops += int(lost.size)
        self.stats.recovery_seconds += time.monotonic() - t0
        if s.metrics is not None:
            s.metrics.counter("resilience.recoveries").inc()
            s.metrics.counter("resilience.recovered_drops").inc(
                int(lost.size))
        return lost


# ---------------------------------------------------------------------------
# Straggler speculation + retry — the dispatch-layer runner
# ---------------------------------------------------------------------------


class _StagedRef(_DataRef):
    """Output ref that buffers writes instead of touching the payload
    table — the commit happens atomically, first-writer-wins."""

    __slots__ = ("buf",)

    def __init__(self, session: CompiledSession, idx: int,
                 buf: List[Tuple[int, object]]) -> None:
        super().__init__(session, idx)
        self.buf = buf

    def write(self, value) -> None:
        self.buf.append((self.idx, value))

    def read(self):
        for j, v in reversed(self.buf):
            if j == self.idx:
                return v
        return super().read()


class ResilientRunner:
    """``ExecHooks.python_runner``: threaded per-node dispatch with
    bounded retry and straggler speculation.

    The wave's Python apps arrive node-sorted; each node's batch is
    submitted to that node's thread pool (all nodes overlap — the object
    engine's wave parallelism, which the plain compiled path serialises).
    The dispatching thread tracks per-app deadlines against the running
    median and duplicates overdue apps onto the least-loaded live node.
    Both the primary and the duplicate run with *staged* output refs;
    whoever finishes first commits its buffer into the dense payload
    table under one lock and flips the state row — the loser's commit is
    a no-op and its writes are dropped.
    """

    def __init__(self, master: MasterDropManager, config: ResilienceConfig,
                 stats: ResilienceStats) -> None:
        self.master = master
        self.retry = config.retry
        self.strag = config.stragglers
        self.stats = stats
        self._lock = threading.Lock()
        # bounded window: the straggler threshold tracks recent behaviour
        # and the per-poll median stays O(window), not O(run history)
        self._durations: deque = deque(maxlen=256)
        self._rr = 0                      # round-robin tie-break cursor
        self._inflight: Dict[str, int] = {}
        # bumped by fault recovery (invalidate()): work started before a
        # recovery must never commit into the reset state rows
        self._epoch = 0

    def invalidate(self) -> None:
        """Discard all in-flight work at commit time (called after a
        node-failure recovery reset state rows to INIT — a leftover
        primary/duplicate thread committing a stale pre-failure buffer
        would otherwise flip a reset drop COMPLETED behind the resumed
        scheduler's back and stall its successors)."""
        with self._lock:
            self._epoch += 1

    # -- entry (the wave's Python apps, node-sorted) -----------------------
    def __call__(self, ctx, ids: np.ndarray) -> None:
        if self.strag is None:
            for i in ids.tolist():
                if time.monotonic() > ctx.deadline:
                    raise _WaveTimeout
                epoch = self._epoch
                t0 = time.monotonic()
                self._commit(ctx, int(i), *self._attempts(ctx, int(i)),
                             epoch=epoch, t0=t0)
            return
        self._threaded_wave(ctx, ids)

    def _threaded_wave(self, ctx, ids: np.ndarray) -> None:
        pgt = ctx.pgt
        nms = self.master.node_managers()
        # filled by the worker when the app actually STARTS running —
        # queue wait must not count toward the straggler deadline (the
        # object-path watcher clocks from the RUNNING event, and
        # mass-speculating a deep queued batch doubles the wave's work)
        started: Dict[int, float] = {}
        speculated: Set[int] = set()
        home: Dict[int, str] = {}

        # one epoch for the whole wave, captured before any submit: a
        # recovery can only happen at a wave boundary, so any work from
        # this wave that outlives one is stale by construction
        epoch = self._epoch

        def primary(i: int, node: str) -> None:
            t0 = time.monotonic()
            started[i] = t0
            try:
                self._commit(ctx, i, *self._attempts(ctx, i), epoch=epoch,
                             t0=t0)
            except (WorkerLost, _WaveTimeout):
                # drop stays INIT; the poll loop below surfaces the dead
                # node / deadline for the whole wave
                pass
            finally:
                with self._lock:
                    self._inflight[node] = self._inflight.get(node, 1) - 1
                    self._durations.append(time.monotonic() - t0)

        # submit every node's batch — all nodes overlap
        for batch in node_batches(pgt, ids):
            node = pgt.node_names[int(pgt.node_ids[int(batch[0])])]
            nm = nms.get(node)
            if nm is None or not nm.info.alive:
                # placement no longer live (mid-recovery edge): run inline
                for i in batch.tolist():
                    if time.monotonic() > ctx.deadline:
                        raise _WaveTimeout
                    t0 = time.monotonic()
                    self._commit(ctx, int(i),
                                 *self._attempts(ctx, int(i)), epoch=epoch,
                                 t0=t0)
                continue
            with self._lock:
                self._inflight[node] = \
                    self._inflight.get(node, 0) + int(batch.size)
            for i in batch.tolist():
                home[int(i)] = node
                nm.executor.submit(primary, int(i), node)

        state = ctx.s.drop_state
        while True:
            pending = ids[state[ids] == ST_INIT]
            if pending.size == 0:
                return
            # a worker process that died mid-wave leaves its drops INIT
            # forever; surface the dead home nodes so the resilient loop
            # recovers instead of spinning to the deadline
            dead = sorted({home[int(i)] for i in pending.tolist()
                           if home.get(int(i)) is not None
                           and not nms[home[int(i)]].info.alive})
            if dead:
                raise WorkerLost(dead)
            if time.monotonic() > ctx.deadline:
                raise _WaveTimeout   # committed work stays; resumable
            threshold = self._threshold()
            if threshold is not None:
                now = time.monotonic()
                for i in pending.tolist():
                    t0 = started.get(i)   # None = still queued, not slow
                    if t0 is not None and i not in speculated \
                            and now - t0 > threshold:
                        speculated.add(i)
                        self._speculate(ctx, i, home[i], epoch=epoch)
            time.sleep(self.strag.poll)

    # -- straggler speculation ---------------------------------------------
    def _threshold(self) -> Optional[float]:
        with self._lock:
            durs = list(self._durations)   # bounded snapshot (maxlen)
        if len(durs) < 3:
            return None
        return max(self.strag.factor * statistics.median(durs),
                   self.strag.min_runtime)

    def _speculate(self, ctx, i: int, home: str,
                   epoch: Optional[int] = None) -> None:
        """Duplicate app ``i`` onto the least-loaded live node (round-robin
        among ties), first-writer-wins."""
        live = self.master.live_node_managers()
        cands = [nm for n, nm in sorted(live.items()) if n != home]
        if not cands:
            return
        with self._lock:
            low = min(self._inflight.get(nm.name, 0) for nm in cands)
            tied = [nm for nm in cands
                    if self._inflight.get(nm.name, 0) == low]
            target = tied[self._rr % len(tied)]
            self._rr += 1
            self._inflight[target.name] = \
                self._inflight.get(target.name, 0) + 1

        wave_epoch = self._epoch if epoch is None else epoch

        def dup() -> None:
            t0 = time.monotonic()
            try:
                # run on the TARGET node (on a process-backed cluster the
                # duplicate executes in the target's worker process)
                buf, err = self._attempts(ctx, i, node=target.name)
                if err is None:
                    # a winning duplicate records the node that actually
                    # executed the drop, not its original placement
                    self._commit(ctx, i, buf, None, speculative=True,
                                 epoch=wave_epoch, t0=t0,
                                 node=ctx.pgt.node_id_for(target.name))
                else:
                    with self._lock:
                        self.stats.speculative_losses += 1
            except (WorkerLost, _WaveTimeout):
                # the target died or ran out of budget: the duplicate just
                # loses; the primary (or a recovery) still owns the drop
                with self._lock:
                    self.stats.speculative_losses += 1
            finally:
                with self._lock:
                    self._inflight[target.name] = \
                        self._inflight.get(target.name, 1) - 1

        target.executor.submit(dup)

    # -- staged execution with bounded retry -------------------------------
    def _attempts(self, ctx, i: int, node: Optional[str] = None):
        """Run app ``i`` with staged outputs; returns (buffer, error).

        ``node`` overrides the placement node (speculative duplicates run
        on their target).  On a process-backed node the attempt ships to
        that node's worker; :class:`WorkerLost` propagates — a dead worker
        is a node failure, never an app error."""
        ex = self._proc_executor(ctx, i, node)
        if ex is not None:
            return self._attempts_proc(ctx, i, ex)
        attempts = self.retry.max_attempts if self.retry else 1
        backoff = self.retry.backoff if self.retry else 0.0
        err: Optional[str] = None
        for k in range(attempts):
            buf: List[Tuple[int, object]] = []
            try:
                func, ins, outs, app = ctx.app_call(
                    i, out_ref=lambda s, j: _StagedRef(s, j, buf))
                if func is not None:
                    if getattr(func, "streaming", False):
                        # degraded/batch resolution of a streaming app:
                        # run its finish stage if present, skip otherwise
                        fin = getattr(func, "finish", None)
                        if fin is not None:
                            fin(ins, outs, app)
                    else:
                        func(ins, outs, app)
                return buf, None
            except Exception:  # noqa: BLE001 - becomes a drop ERROR
                err = traceback.format_exc(limit=8)
                if k + 1 < attempts:
                    with self._lock:
                        self.stats.retries += 1
                        ctx.s.retries += 1
                    if ctx.s.metrics is not None:
                        ctx.s.metrics.counter("resilience.retries").inc()
                    if backoff:          # no sleep after the final attempt
                        time.sleep(backoff * (2 ** k))
        return None, err

    def _proc_executor(self, ctx, i: int, node: Optional[str]):
        """The live process-backed executor app ``i`` should run on, or
        None (thread-backed node, dead node, unplaced drop — all fall back
        to the in-process staged path)."""
        if node is None:
            nid = int(ctx.pgt.node_ids[i])
            if nid < 0:
                return None
            node = ctx.pgt.node_names[nid]
        nm = self.master.node_managers().get(node)
        if nm is None or not nm.info.alive:
            return None
        ex = nm.executor
        return ex if hasattr(ex, "run_batch") else None

    def _attempts_proc(self, ctx, i: int, ex):
        """Process-backed attempt loop: same retry policy, with the app
        executed in the node's worker and its writes returned as the
        staged buffer for the normal first-writer-wins commit."""
        attempts = self.retry.max_attempts if self.retry else 1
        backoff = self.retry.backoff if self.retry else 0.0
        err: Optional[str] = None
        for k in range(attempts):
            spec = ctx.proc_spec(i)
            tb = spec.get("parent_tb")
            if tb is not None:
                return None, tb
            budget = ctx.deadline - time.monotonic()
            if budget <= 0:
                raise _WaveTimeout
            res = ex.run_batch([spec], budget)[0]   # WorkerLost propagates
            if res["status"] == "ok":
                return list(res["writes"]), None
            if res["status"] == "timeout":
                raise _WaveTimeout
            err = res["tb"]
            if k + 1 < attempts:
                with self._lock:
                    self.stats.retries += 1
                    ctx.s.retries += 1
                if ctx.s.metrics is not None:
                    ctx.s.metrics.counter("resilience.retries").inc()
                if backoff:
                    time.sleep(backoff * (2 ** k))
        return None, err

    def _commit(self, ctx, i: int, buf, err: Optional[str],
                speculative: bool = False, epoch: int = 0,
                t0: Optional[float] = None,
                node: Optional[int] = None) -> bool:
        """First-writer-wins commit into the payload table + state row.

        ``epoch`` is the runner epoch captured when the attempt started;
        a recovery in between (``invalidate()``) makes the buffer stale
        — the drop was reset to INIT for *re-execution*, and committing
        would hide it from the resumed scheduler's frontier.

        ``t0``/``node`` feed the session timeline: the *winning* attempt
        stamps its own start time and executing node (a speculative win
        records the duplicate's node, not the original placement)."""
        s = ctx.s
        with self._lock:
            if epoch != self._epoch or s.drop_state[i] != ST_INIT:
                if speculative:
                    self.stats.speculative_losses += 1
                return False
            if err is None:
                try:
                    for j, v in buf:
                        s._write_idx(j, v)
                except Exception:  # noqa: BLE001 - spill failures (file
                    # payload mkdir/pickle) become drop ERRORs, exactly
                    # as the plain dispatch path records them
                    s.drop_state[i] = ST_ERROR
                    s.record_error(i, traceback.format_exc(limit=8))
                    self._stamp(ctx, i, t0, node)
                    return True
                s.drop_state[i] = ST_COMPLETED
                if speculative:
                    self.stats.speculative_wins += 1
                    s.speculative_wins += 1
                    if s.metrics is not None:
                        s.metrics.counter(
                            "resilience.speculative_wins").inc()
            else:
                s.drop_state[i] = ST_ERROR
                s.record_error(i, err)
            self._stamp(ctx, i, t0, node)
        return True

    @staticmethod
    def _stamp(ctx, i: int, t0: Optional[float],
               node: Optional[int]) -> None:
        if ctx.tl is not None:
            t1 = time.monotonic()
            ctx.tl.stamp(int(i), t1 if t0 is None else t0, t1,
                         ctx.wave, node=node)


# ---------------------------------------------------------------------------
# The resilient execution loop
# ---------------------------------------------------------------------------


class NodeFailureInterrupt(Exception):
    """Control-flow signal: a failure script fired at a wave boundary."""

    def __init__(self, nodes: List[str]) -> None:
        super().__init__(f"node failure injected: {nodes}")
        self.nodes = nodes


def execute_resilient(session: CompiledSession, master: MasterDropManager,
                      config: ResilienceConfig, timeout: float = 60.0,
                      fault_manager: Optional[CompiledFaultManager] = None,
                      hooks: Optional[ExecHooks] = None,
                      stream=None) -> Tuple[bool, ResilienceStats]:
    """Run a deployed compiled session under a resilience policy.

    Drives ``execute_frontier`` with hooks: scripted node failures fire at
    wave boundaries (where every drop is terminal or INIT — no in-flight
    state), recovery resets/remaps the lost lineage, and the loop resumes
    the scheduler until the graph finishes or the deadline expires.

    ``hooks`` merges user observability into the internal failure-script
    hooks: a user ``on_wave`` runs before the failure check, and
    ``on_stream_chunk``/``on_backpressure`` pass straight through.
    ``stream`` forwards to :func:`execute_frontier` unchanged.
    """
    fm = fault_manager or CompiledFaultManager(session, master)
    stats = fm.stats
    runner = ResilientRunner(master, config, stats) \
        if config.needs_runner else None
    pending = sorted(config.failures, key=lambda f: f.at_fraction)
    fired: Set[int] = set()
    user_wave = hooks.on_wave if hooks is not None else None

    def on_wave(sess: CompiledSession, completed: int, total: int) -> None:
        if user_wave is not None:
            user_wave(sess, completed, total)
        frac = completed / max(total, 1)
        trig = [f for f in pending
                if id(f) not in fired and frac >= f.at_fraction]
        if trig:
            fired.update(id(f) for f in trig)
            raise NodeFailureInterrupt([f.node for f in trig])

    hooks = ExecHooks(
        on_wave=on_wave if (pending or user_wave is not None) else None,
        python_runner=runner,
        on_stream_chunk=hooks.on_stream_chunk if hooks is not None else None,
        on_backpressure=hooks.on_backpressure if hooks is not None else None)
    deadline = time.monotonic() + timeout
    while True:
        budget = deadline - time.monotonic()
        if budget <= 0:
            return False, stats
        try:
            # failure-only configs (no runner hook) still get the default
            # threaded per-node wave overlap; recomputed per resume so
            # freshly-dead nodes drop out of the executor map
            finished = execute_frontier(
                session, timeout=budget, hooks=hooks,
                executors=None if runner is not None
                else master.node_executors(), stream=stream)
            return finished, stats
        except (NodeFailureInterrupt, WorkerLost) as nf:
            # scripted failure (wave boundary) or a real worker-process
            # death (mid-wave SIGKILL / crash / wedge): same recovery path
            for node in nf.nodes:
                nm = master.node_managers().get(node)
                if nm is not None and nm.info.alive:
                    fm.fail_node(node)
                elif node not in stats.failed_nodes:
                    # worker death already flipped info.alive via on_lost;
                    # keep the failure ledger consistent with fail_node
                    stats.failed_nodes.append(node)
            if runner is not None:
                # invalidate BEFORE the state reset: a leftover thread
                # committing between recover() and a later invalidate()
                # would pass the epoch check against just-reset rows
                runner.invalidate()
            fm.recover()
