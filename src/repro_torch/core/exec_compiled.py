"""Compiled execution — the deploy+execute fast path over ``CompiledPGT``.

PR 1 lifted the *translate* stage onto flat numpy arrays (``CompiledPGT``);
this module lifts stages 5–6 the same way, completing the paper's
data-activated regime for *executable* graphs: no per-drop Python ``Drop``
objects, no thread-pool futures, no per-event callback chains.

* **Deploy** (``MasterDropManager.deploy_compiled``) validates placement
  and hands each Node Drop Manager an *index slice* of the CSR arrays —
  one ``argsort`` over ``node_ids`` instead of one ``_instantiate`` call
  per DropSpec.

* **Execute** (:func:`execute_frontier`) is a frontier scheduler: drop
  state lives in a single int8 array on the :class:`CompiledSession`,
  readiness in a ``pending_inputs`` in-degree counter array.  Execution
  proceeds wave-by-wave — complete all ready data drops, fire all runnable
  apps of the frontier (one batched dispatch per node, with vectorised
  fast paths for ``noop``/``identity``/``sleep`` and the app registry
  invoked only for apps with real Python work), then advance every
  successor's in-degree with one ``np.add.at`` per wave.

Semantics contract (the object engine in ``drop.py``/``session.py`` is
the oracle; ``tests/test_exec_equiv.py`` enforces it):

* a data drop COMPLETES when all producers resolved and none errored,
  ERRORs as soon as any producer errored;
* an app runs when all inputs are resolved and the errored fraction is
  within its error threshold ``t`` (paper Fig. 7), consuming only the
  COMPLETED inputs sorted by ``(oid, uid)``; otherwise it ERRORs;
* payload values are write-once at wave granularity; memory payloads live
  in the session's dense table.

Streaming edges run chunk-granular (PR 9): writes to a ringed source
data drop land in per-edge chunk rings (``core/streaming.py``) and a
dedicated consumer thread per streaming consumer processes them while
the producer is still running — the paper's §4/Fig. 10 data-activated
contract, previously object-engine-only.  Pure-batch subgraphs are
untouched: the lane only exists when the graph has *active* streaming
edges, and only stream-producing apps leave the vectorised fast paths.

Deliberate divergences (documented in ``docs/execute.md``): waves run
single-threaded (``sleep`` apps in one wave cost ``max(seconds)``, i.e.
ideal parallelism), and no per-drop *success* events are published on
the hot path — that is the point.  Observability is opt-in and
array-native instead: per-drop timeline stamps, chunk spans and
wave-granular metrics via ``core/telemetry.py`` (``TelemetryConfig``),
while session lifecycle and drop *failures* do surface on the session
``EventBus`` (see ``docs/observability.md``).
"""
from __future__ import annotations

import threading
import time
import traceback
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .managers import _APP_REGISTRY, BUILTIN_FAST_APPS, get_app
from .pgt import (KIND_APP, KIND_DATA, CompiledPGT, csr_gather,
                  csr_gather_with_counts)
from .procpool import WorkerLost
from .session import (PK_FILE, PK_NULL, ST_COMPLETED, ST_ERROR, ST_INIT,
                      CompiledDropRef, CompiledSession)
from .streaming import StreamAbort, StreamConfig, StreamTable

# per-drop dispatch codes (apps only; data drops never dispatch)
CODE_PYTHON = 0      # registry app with real Python work
CODE_NONE = 1        # no app function: complete, write nothing
CODE_NOOP = 2        # write None to all outputs
CODE_IDENTITY = 3    # forward the single input (or the input list)
CODE_SLEEP = 4       # sleep, then write None to all outputs

_FAST_CODE = {"noop": CODE_NOOP, "identity": CODE_IDENTITY,
              "sleep": CODE_SLEEP}


def _dispatch_code(app: Optional[str]) -> int:
    """Dispatch code for one app name.  A fast code applies only while
    the registry entry still IS the built-in implementation — users may
    re-register 'noop'/'identity'/'sleep', and the object oracle would
    run their function, so the compiled engine must too."""
    if not app:
        return CODE_NONE
    code = _FAST_CODE.get(app, CODE_PYTHON)
    if code != CODE_PYTHON and \
            _APP_REGISTRY.get(app) is not BUILTIN_FAST_APPS.get(app):
        return CODE_PYTHON
    return code


class _WaveTimeout(Exception):
    """Raised mid-wave when the execution deadline expires.

    Safe to abort anywhere: the scheduler derives its counters from the
    state array on entry, so a partially-processed wave (some drops
    terminal, some still INIT) resumes exactly where it stopped."""


class ExecHooks:
    """Scheduler extension points — the one hooks protocol shared by
    ``Pipeline.execute``, :func:`execute_frontier` and
    ``launch/serve.py`` (consumed by :mod:`repro.core.resilience` too).

    * ``on_wave(session, completed, total)`` — called at the top of every
      wave, when all drop state is consistent (everything terminal or
      INIT, no in-flight work).  May raise to abort the run; the state
      array stays resumable.
    * ``python_runner(ctx, ids)`` — replaces the sequential registry-app
      loop for the wave's Python apps (``ctx`` is the ``_Dispatch``;
      ``ids`` are node-sorted and may span nodes).  Must leave every id
      terminal, or raise ``_WaveTimeout`` past ``ctx.deadline``.
    * ``on_stream_chunk(session, src_uid, dst_uid, seq)`` — one call per
      chunk *consumed* by a streaming consumer (compiled lane) or per
      chunk *delivered* by ``DataDrop.write`` (object engine).  Runs on
      the consumer's thread; an exception marks that consumer ERROR.
    * ``on_backpressure(session, src_uid, dst_uid, waited_s)`` — a
      producer is blocked on a full chunk ring (compiled lane only; the
      object engine delivers chunks synchronously inside ``write`` and
      never queues them).
    """

    __slots__ = ("on_wave", "python_runner", "on_stream_chunk",
                 "on_backpressure")

    def __init__(self, on_wave=None, python_runner=None,
                 on_stream_chunk=None, on_backpressure=None) -> None:
        self.on_wave = on_wave
        self.python_runner = python_runner
        self.on_stream_chunk = on_stream_chunk
        self.on_backpressure = on_backpressure


# shared with pgt.py (kept as module aliases — the scheduler's hot loop
# and the resilience closure gather CSR rows the same way)
_gather = csr_gather
_gather_with_counts = csr_gather_with_counts


def node_batches(pgt: CompiledPGT, ids: np.ndarray) -> List[np.ndarray]:
    """Split drop ids into per-placement-node batches (stable order).

    Shared by the default threaded wave dispatch below and the
    resilience runner's speculative dispatch (same argsort-and-split)."""
    nodes = pgt.node_ids[ids]
    order = np.argsort(nodes, kind="stable")
    run = ids[order]
    bounds = np.flatnonzero(np.diff(nodes[order])) + 1
    return np.split(run, bounds)


# ---------------------------------------------------------------------------
# Registry-app shims — what an app function sees instead of real Drops
# ---------------------------------------------------------------------------


class _DataRef(CompiledDropRef):
    """Duck-types the slice of ``DataDrop`` that app functions consume:
    ``read()``/``write()`` against the session's dense payload table
    (uid/node/read come from the shared row view)."""

    __slots__ = ()

    @property
    def meta(self) -> Dict[str, Any]:
        return _drop_meta(self.s.pgt, self.idx)

    def write(self, value: Any) -> None:
        self.s._write_idx(self.idx, value)

    def nbytes(self) -> int:
        v = self.s.payloads[self.idx]
        return int(getattr(v, "nbytes", 0))


class _FencedDataRef(_DataRef):
    """Output ref handed to streaming chunk handlers: writes are fenced by
    the ``StreamTable`` generation, so a wedged consumer thread from a
    shut-down lane that eventually unwedges cannot mutate payloads/rings
    behind a resumable reopen."""

    __slots__ = ("tbl", "gen")

    def __init__(self, session: CompiledSession, idx: int,
                 tbl: StreamTable, gen: int) -> None:
        super().__init__(session, idx)
        self.tbl = tbl
        self.gen = gen

    def write(self, value: Any) -> None:
        if self.tbl.generation != self.gen:
            raise StreamAbort(
                f"stale stream-lane write fenced (lane generation {self.gen}, "
                f"table at {self.tbl.generation})")
        super().write(value)


class _AppRef(CompiledDropRef):
    """Duck-types the slice of ``AppDrop`` an app function consumes
    (``app.meta`` with oid/construct/params, ``app.uid``, ``app.node``,
    and ``app.scratch`` — the per-drop scratch dict streaming handlers
    use for cross-chunk accumulation, mirroring ``AppDrop.scratch``)."""

    __slots__ = ("_meta", "scratch")

    def __init__(self, session: CompiledSession, idx: int) -> None:
        super().__init__(session, idx)
        self._meta: Optional[Dict[str, Any]] = None
        self.scratch: Dict[str, Any] = {}

    @property
    def meta(self) -> Dict[str, Any]:
        if self._meta is None:
            m = _drop_meta(self.s.pgt, self.idx)
            m["execution_time"] = float(self.s.pgt.exec_arr[self.idx])
            self._meta = m
        return self._meta


class _StreamAppRef(_AppRef):
    """The persistent app ref a streaming consumer sees across chunks.

    Stored in ``StreamTable.app_refs`` so ``app.scratch`` survives
    resumable timeouts; recovery invalidation discards it (the consumer
    re-accumulates from the re-delivered stream).  ``outputs`` lets a
    chunk handler emit downstream chunks incrementally."""

    __slots__ = ("outputs", "gen")

    def __init__(self, session: CompiledSession, idx: int,
                 outputs: List[_DataRef], gen: int = 0) -> None:
        super().__init__(session, idx)
        self.outputs = outputs
        self.gen = gen


def _drop_meta(pgt: CompiledPGT, idx: int) -> Dict[str, Any]:
    # same layout NodeDropManager._instantiate builds for real Drops
    return {"oid": pgt.oid_of(idx), "construct": pgt.group_of(idx).name,
            **pgt.params_of(idx)}


# ---------------------------------------------------------------------------
# Batched per-node dispatch
# ---------------------------------------------------------------------------


class _Dispatch:
    """Precomputed dispatch tables + the per-wave app execution logic."""

    def __init__(self, session: CompiledSession,
                 hooks: Optional[ExecHooks] = None,
                 executors: Optional[Dict[str, Any]] = None,
                 stream_table: Optional[StreamTable] = None) -> None:
        pgt = session.pgt
        self.s = session
        self.pgt = pgt
        self.hooks = hooks
        # node name -> thread pool: Python-app waves spanning several
        # nodes overlap (one worker task per node batch); None/empty
        # keeps the sequential in-thread dispatch
        self.executors = executors or {}
        # process-backed executors (ProcExecutor: has run_batch) get their
        # Python-app batches shipped to the node's worker process
        self.proc_nodes = {name for name, ex in self.executors.items()
                           if hasattr(ex, "run_batch")}
        n = pgt.num_drops
        self.out_indptr, self.out_cols, _ = pgt.out_csr_with_eid()
        self.in_indptr, self.in_cols, in_eid = pgt.in_csr_with_eid()
        self.in_deg = pgt.in_degrees()
        # oracle contract: streaming inputs live in app.streaming_inputs,
        # never in app.inputs, so they are invisible to the batch input
        # list (AppDrop.execute builds ok_inputs from self.inputs only).
        # This holds whether or not a chunk lane is active: in degraded
        # (batch) mode the edge is still a dependency, just not a readable
        # batch input.  in_stream is aligned with in_cols; stream_cons
        # marks apps with >= 1 streaming in-edge so fast paths skip them.
        self.in_stream: Optional[np.ndarray] = None
        self.stream_cons: Optional[np.ndarray] = None
        if pgt.has_streaming_edges():
            sm = pgt.edge_streaming & \
                (pgt.kind_arr[pgt.edge_src] == KIND_DATA) & \
                (pgt.kind_arr[pgt.edge_dst] == KIND_APP)
            if sm.any():
                self.in_stream = sm[in_eid]
                cons = np.zeros(n, dtype=bool)
                cons[pgt.edge_dst[sm]] = True
                self.stream_cons = cons
        gidx = pgt.group_idx_arr()
        if len(pgt.groups):
            gcode = np.fromiter(
                (_dispatch_code(g.app) for g in pgt.groups),
                dtype=np.int8, count=len(pgt.groups))
            self.app_code = gcode[gidx]
            gthr = np.fromiter((g.error_threshold for g in pgt.groups),
                               dtype=np.float64, count=len(pgt.groups))
            self.thr = pgt.err_arr if pgt.err_arr is not None \
                else gthr[gidx]
        else:
            self.app_code = np.zeros(n, dtype=np.int8)
            self.thr = np.zeros(n, dtype=np.float64)
        # the vectorised noop/identity fast paths write only the payload
        # table; graphs with file-backed payloads take the per-app path so
        # spill files appear exactly as the object engine would write them
        self.fast_ok = not bool((session.payload_kind == PK_FILE).any())
        # apps writing into ringed stream sources must take the registry
        # path: every chunk has to go through _write_idx (the vectorised
        # fast paths bulk-write the payload table and would skip rings)
        self.stream = stream_table
        if stream_table is not None and stream_table.n_edges:
            prod = np.zeros(n, dtype=bool)
            feeds_ring = stream_table.is_src[pgt.edge_dst]
            if feeds_ring.any():
                prod[pgt.edge_src[feeds_ring]] = True
            self.stream_prod: Optional[np.ndarray] = prod
        else:
            self.stream_prod = None
        self.deadline = float("inf")   # set per run by execute_frontier
        # telemetry (off unless the session carries a Timeline/registry):
        # fast paths stamp whole batches, _run_python stamps per app
        self.tl = session.timeline
        self.wave = 0                  # current wave index, for stamps
        self.m_batches = None          # Counter("exec.dispatch_batches")

    # -- wave entry ---------------------------------------------------------
    def dispatch(self, run_ids: np.ndarray) -> None:
        """Fire all runnable apps of one wave.

        Sleep apps are handled wave-wide first (the whole wave runs
        concurrently in the object engine, so one ``max(seconds)`` sleep
        models it — NOT one per node); everything else goes out as one
        batched dispatch per node.  Registry (Python) apps of the whole
        wave are dispatched together, node-sorted, so a resilience runner
        can overlap per-node batches and speculate across nodes."""
        if run_ids.size == 0:
            return
        codes = self.codes_of(run_ids)
        sleep_ids = run_ids[codes == CODE_SLEEP]
        if sleep_ids.size:
            self._sleep_batch(sleep_ids)
            run_ids = run_ids[codes != CODE_SLEEP]
            if run_ids.size == 0:
                return
        nodes = self.pgt.node_ids[run_ids]
        order = np.lexsort((run_ids, nodes))
        run = run_ids[order]
        bounds = np.flatnonzero(np.diff(nodes[order])) + 1
        batches = np.split(run, bounds)
        if self.m_batches is not None:
            self.m_batches.inc(len(batches))
        python_parts = [self._dispatch_batch(batch) for batch in batches]
        self._run_python_batch(np.concatenate(python_parts))

    def codes_of(self, ids: np.ndarray) -> np.ndarray:
        """Dispatch codes for a batch, with stream producers forced onto
        the registry path (their writes must push chunks one by one)."""
        codes = self.app_code[ids]
        if self.stream_prod is not None:
            codes = np.where(self.stream_prod[ids] & (codes != CODE_NONE),
                             CODE_PYTHON, codes)
        if self.stream_cons is not None:
            # apps with streaming in-edges must take the registry path:
            # the vectorised fast paths read the raw in-CSR and would
            # treat the streaming edge as a readable batch input
            codes = np.where(self.stream_cons[ids] & (codes != CODE_NONE),
                             CODE_PYTHON, codes)
        return codes

    def _stamp_batch(self, ids: np.ndarray, t0: float) -> None:
        """Timeline-stamp a terminal fast-path batch (end = now)."""
        if self.tl is not None and ids.size:
            self.tl.stamp_batch(ids, t0, time.monotonic(), self.wave)

    def _dispatch_batch(self, batch: np.ndarray) -> np.ndarray:
        """Run the fast-path apps of one per-node batch; return the
        registry (Python) apps for the wave-wide dispatch."""
        codes = self.codes_of(batch)
        t0 = time.monotonic() if self.tl is not None else 0.0
        none_ids = batch[codes == CODE_NONE]
        if none_ids.size:
            self.s.drop_state[none_ids] = ST_COMPLETED
            self._stamp_batch(none_ids, t0)
        noop_ids = batch[codes == CODE_NOOP]
        if noop_ids.size:
            self._write_none_outputs(noop_ids)
        ident_ids = batch[codes == CODE_IDENTITY]
        if ident_ids.size:
            self._identity_batch(ident_ids)
        return batch[codes == CODE_PYTHON]

    def _run_python_batch(self, ids: np.ndarray) -> None:
        """Registry-path dispatch, deadline-checked per app (a wide wave
        of Python apps must not overshoot the execution timeout).

        A resilience ``python_runner`` hook takes over the whole per-node
        batch (threaded dispatch, retries, straggler speculation);
        otherwise, with node executors available, per-node batches run
        concurrently on the node thread pools — the object engine's wave
        parallelism, which the plain sequential loop used to serialise."""
        if ids.size and self.hooks is not None \
                and self.hooks.python_runner is not None:
            self.hooks.python_runner(self, ids)
            return
        if self.executors and ids.size and (self.proc_nodes or ids.size > 1):
            self._run_python_threaded(ids)
            return
        self._run_python_seq(ids)

    def _run_python_seq(self, ids: np.ndarray) -> None:
        for i in ids.tolist():
            if time.monotonic() > self.deadline:
                raise _WaveTimeout
            self._run_python(i)

    def _run_python_threaded(self, ids: np.ndarray) -> None:
        """Overlap the wave's per-node batches on the node thread pools.

        Every app still lands in a terminal state exactly as on the
        sequential path (``_run_python`` catches app exceptions); batches
        on nodes without an executor (or unplaced drops) run inline.  A
        deadline overrun in any batch surfaces as one ``_WaveTimeout``
        after all batches stopped — the state array stays resumable."""
        batches = node_batches(self.pgt, ids)
        if len(batches) <= 1 and not self.proc_nodes:
            self._run_python_seq(ids)
            return
        node_ids = self.pgt.node_ids
        names = self.pgt.node_names
        futures = []
        inline: List[np.ndarray] = []
        for batch in batches:
            nid = int(node_ids[int(batch[0])])
            ex = self.executors.get(names[nid]) if nid >= 0 else None
            if ex is None:
                inline.append(batch)
            elif hasattr(ex, "run_batch"):
                # process-backed node: ship the batch to the worker, except
                # stream producers/consumers — their chunk-granular writes
                # must land in the parent's rings as they happen
                keep = np.ones(batch.size, dtype=bool)
                if self.stream_prod is not None:
                    keep &= ~self.stream_prod[batch]
                if self.stream_cons is not None:
                    keep &= ~self.stream_cons[batch]
                local = batch[~keep]
                remote = batch[keep]
                if local.size:
                    inline.append(local)
                if remote.size:
                    futures.append(
                        ex.submit(self._run_proc_batch, remote, ex, nid))
            else:
                futures.append(ex.submit(self._run_python_seq, batch))
        timed_out = False
        lost: List[str] = []
        for batch in inline:
            try:
                self._run_python_seq(batch)
            except _WaveTimeout:
                timed_out = True     # keep draining; workers stop on the
                #                      same deadline within one app each
        for f in futures:
            try:
                f.result()
            except _WaveTimeout:
                timed_out = True
            except WorkerLost as wl:
                lost.extend(wl.nodes)
        if lost:
            # takes precedence over a deadline overrun: drops on the lost
            # node(s) can never finish without recovery
            raise WorkerLost(sorted(set(lost)))
        if timed_out:
            raise _WaveTimeout

    # -- fast paths ---------------------------------------------------------
    def _write_none_outputs(self, ids: np.ndarray,
                            t0: Optional[float] = None) -> None:
        """noop semantics: write ``None`` to every output, complete.
        ``t0`` carries a caller's earlier start stamp (the sleep batch
        starts *before* it sleeps)."""
        if not self.fast_ok:
            self._run_python_batch(ids)
            return
        s = self.s
        start = (time.monotonic() if t0 is None else t0) \
            if self.tl is not None else 0.0
        dsts = _gather(self.out_indptr, self.out_cols, ids)
        if dsts.size:
            s.payloads[dsts] = None
            s.payload_present[dsts] = True
        s.drop_state[ids] = ST_COMPLETED
        self._stamp_batch(ids, start)

    def _sleep_batch(self, ids: np.ndarray) -> None:
        """One wave of sleeps runs concurrently in the object engine; the
        compiled engine models ideal parallelism: sleep the max once.

        On the registry fallback (file payloads present) each app sleeps
        individually inside ``_run_python`` — no batched sleep on top."""
        if not self.fast_ok:
            self._run_python_batch(ids)
            return
        t0 = time.monotonic() if self.tl is not None else None
        secs = max(self._sleep_seconds(i) for i in ids.tolist())
        if secs > 0:
            remaining = self.deadline - time.monotonic()
            if secs > remaining:
                time.sleep(max(remaining, 0.0))
                raise _WaveTimeout
            time.sleep(secs)
        self._write_none_outputs(ids, t0)

    def _sleep_seconds(self, i: int) -> float:
        ov = self.pgt._params_override.get(i)
        if ov is not None and "seconds" in ov:
            return float(ov["seconds"])
        return float(self.pgt.group_of(i).params.get("seconds", 0.001))

    def _identity_batch(self, ids: np.ndarray) -> None:
        if not self.fast_ok:
            self._run_python_batch(ids)
            return
        t0 = time.monotonic() if self.tl is not None else 0.0
        s = self.s
        single = ids[self.in_deg[ids] == 1]
        # multi-input: general list semantics via the registry path
        self._run_python_batch(ids[self.in_deg[ids] != 1])
        if single.size == 0:
            return
        preds = self.in_cols[self.in_indptr[single]]
        completed = s.drop_state[preds] == ST_COMPLETED
        readable = s.payload_present[preds] | \
            (s.payload_kind[preds] == PK_NULL)
        hard = completed & ~readable     # absent payload -> PayloadError
        self._run_python_batch(single[hard])
        fast = ~hard
        vals = np.empty(single.size, dtype=object)
        easy = completed & readable
        vals[easy] = s.payloads[preds[easy]]
        # errored input tolerated by t: ok_inputs == [] -> identity of []
        for k in np.flatnonzero(~completed).tolist():
            vals[k] = []
        fast_ids = single[fast]
        dsts, cnt = _gather_with_counts(self.out_indptr, self.out_cols,
                                        fast_ids)
        if dsts.size:
            s.payloads[dsts] = np.repeat(vals[fast], cnt)
            s.payload_present[dsts] = True
        s.drop_state[fast_ids] = ST_COMPLETED
        self._stamp_batch(fast_ids, t0)

    # -- general path: the app registry -------------------------------------
    def app_call(self, i: int, out_ref=_DataRef):
        """(func, in_refs, out_refs, app_ref) for registry app ``i``.

        ``func`` is None for no-app drops (complete without work).  The
        resilience runner passes a staging ``out_ref`` so speculative
        duplicates buffer writes instead of touching the payload table."""
        s = self.s
        pgt = self.pgt
        name = pgt.app_of(i)
        func = get_app(name) if name else None
        if func is None:
            return None, [], [], None
        lo, hi = self.in_indptr[i], self.in_indptr[i + 1]
        ins = self.in_cols[lo:hi]
        if self.in_stream is not None:
            # streaming in-edges are dependencies, not batch inputs
            # (the oracle keeps them in app.streaming_inputs)
            ins = ins[~self.in_stream[lo:hi]]
        ok = ins[s.drop_state[ins] == ST_COMPLETED]
        refs = [_DataRef(s, int(j)) for j in ok]
        # deterministic input order (the object engine sorts by
        # (oid, uid) regardless of wiring order)
        refs.sort(key=lambda r: (pgt.oid_of(r.idx), pgt.uid_of(r.idx)))
        outs = [out_ref(s, int(j)) for j in
                self.out_cols[self.out_indptr[i]:self.out_indptr[i + 1]]]
        return func, refs, outs, _AppRef(s, int(i))

    def _run_python(self, i: int) -> None:
        s = self.s
        t0 = time.monotonic() if self.tl is not None else 0.0
        try:
            func, refs, outs, app = self.app_call(i)
            if func is not None:
                if getattr(func, "streaming", False):
                    # streaming-marked func on the batch path (streaming
                    # disabled, or wired batch-only): chunks were never
                    # delivered; run only the finalizer, as the object
                    # oracle's AppDrop.execute does
                    fin = getattr(func, "finish", None)
                    if fin is not None:
                        fin(refs, outs, app)
                else:
                    func(refs, outs, app)
            s.drop_state[i] = ST_COMPLETED
        except _WaveTimeout:
            raise
        except StreamAbort:
            # a chunk push aborted (run shutting down / past deadline):
            # resumable, not an app failure
            raise _WaveTimeout
        except Exception:  # noqa: BLE001 - app failures become drop ERRORs
            s.drop_state[i] = ST_ERROR
            s.record_error(i, traceback.format_exc(limit=8))
        if self.tl is not None:
            self.tl.stamp(int(i), t0, time.monotonic(), self.wave)

    # -- process-backed dispatch (ProcExecutor mailbox) ----------------------
    def proc_spec(self, i: int) -> Dict[str, Any]:
        """Self-contained work order for registry app ``i``: the function
        object (pickled by reference — the worker resolves it via module
        re-import), pre-read COMPLETED inputs in oracle order, and output
        drop indices.  A parent-side failure (unknown app) is returned as
        ``{"parent_tb": ...}`` so the caller errors the drop locally."""
        s, pgt = self.s, self.pgt
        i = int(i)
        spec: Dict[str, Any] = {"idx": i, "uid": pgt.uid_of(i)}
        try:
            name = pgt.app_of(i)
            func = get_app(name) if name else None
        except Exception:  # noqa: BLE001 - registry miss -> drop ERROR
            spec["parent_tb"] = traceback.format_exc(limit=8)
            return spec
        spec["func"] = func
        if func is None:
            return spec
        meta = _drop_meta(pgt, i)
        meta["execution_time"] = float(pgt.exec_arr[i])
        spec["meta"] = meta
        lo, hi = self.in_indptr[i], self.in_indptr[i + 1]
        ins = self.in_cols[lo:hi]
        if self.in_stream is not None:
            ins = ins[~self.in_stream[lo:hi]]
        ok = ins[s.drop_state[ins] == ST_COMPLETED]
        order = sorted((int(j) for j in ok),
                       key=lambda j: (pgt.oid_of(j), pgt.uid_of(j)))
        inputs = []
        for j in order:
            value, err = None, None
            try:
                value = s._read_idx(j)
            except Exception as exc:  # noqa: BLE001 - re-raised at read()
                err = f"{type(exc).__name__}: {exc}"
            inputs.append((pgt.uid_of(j), _drop_meta(pgt, j), value, err))
        spec["inputs"] = inputs
        spec["outputs"] = [
            (int(j), pgt.uid_of(int(j)), _drop_meta(pgt, int(j)))
            for j in self.out_cols[self.out_indptr[i]:self.out_indptr[i + 1]]]
        return spec

    def _run_proc_batch(self, batch: np.ndarray, ex: Any, nid: int) -> None:
        """Ship one node batch to its worker process and apply the reply.

        Raises :class:`WorkerLost` if the worker dies (caller drains all
        batches first) and ``_WaveTimeout`` on budget exhaustion — drops
        the worker never reached stay INIT, so the run is resumable."""
        s = self.s
        specs: List[Dict[str, Any]] = []
        for i in batch.tolist():
            spec = self.proc_spec(i)
            tb = spec.get("parent_tb")
            if tb is not None:
                t = time.monotonic()
                s.drop_state[i] = ST_ERROR
                s.record_error(i, tb)
                if self.tl is not None:
                    self.tl.stamp(int(i), t, t, self.wave, node=nid)
            else:
                specs.append(spec)
        budget = self.deadline - time.monotonic()
        if budget <= 0:
            raise _WaveTimeout
        results = ex.run_batch(specs, budget)
        if self._apply_proc_results(results, nid):
            raise _WaveTimeout

    def _apply_proc_results(self, results: List[Dict[str, Any]],
                            nid: int) -> bool:
        """Replay worker results into the session; True if any timed out.

        Concurrent calls (one per node thread) touch row-disjoint state,
        the same contract as the threaded in-process dispatch.  Worker
        stamps are CLOCK_MONOTONIC, comparable across Linux processes, so
        they merge into the Timeline unadjusted."""
        s = self.s
        timed_out = False
        for r in results:
            i = int(r["idx"])
            status = r["status"]
            if status == "timeout":
                timed_out = True
                continue
            if status == "ok":
                try:
                    for j, v in r["writes"]:
                        s._write_idx(int(j), v)
                    s.drop_state[i] = ST_COMPLETED
                except Exception:  # noqa: BLE001 - replay failure -> ERROR
                    s.drop_state[i] = ST_ERROR
                    s.record_error(i, traceback.format_exc(limit=8))
            else:
                s.drop_state[i] = ST_ERROR
                s.record_error(i, r["tb"])
            if self.tl is not None:
                t1 = r.get("t1", time.monotonic())
                self.tl.stamp(i, r.get("t0", t1), t1, self.wave, node=nid)
        return timed_out


# ---------------------------------------------------------------------------
# The streaming dispatch lane
# ---------------------------------------------------------------------------


_degrade_warned = False   # one-time process warning (reset in tests)


def _warn_degraded(n_edges: int) -> None:
    global _degrade_warned
    if not _degrade_warned:
        _degrade_warned = True
        warnings.warn(
            f"{n_edges} active streaming edge(s) degraded to batch "
            "dependencies (streaming disabled for this run); consumers "
            "will not receive chunks — see docs/streaming.md",
            RuntimeWarning, stacklevel=3)


class _StreamLane:
    """Per-run chunk-consumption lane over a session's ``StreamTable``.

    One daemon thread per *activated* streaming consumer: the first
    chunk landing in any of a consumer's rings spawns its thread, which
    drains chunks (``func(value, app)`` per chunk) concurrently with the
    wave loop still dispatching producers — that concurrency IS the
    producer/consumer overlap the streaming tier measures.  When the
    scheduler later finds the consumer frontier-ready (all inputs
    terminal — the oracle's resolution condition), ``finalize_wave``
    waits for the thread to drain and run the func's optional
    ``finish(ok_inputs, outputs, app)``, leaving the drop terminal.

    Run-scoped state only (threads, resolved set, first-activity
    stamps); cursors, buffered chunks and per-consumer ``app.scratch``
    live on the :class:`StreamTable` and survive resumable timeouts.
    """

    def __init__(self, ctx: _Dispatch, table: StreamTable) -> None:
        self.ctx = ctx
        self.s = ctx.s
        self.table = table
        # lane generation: if shutdown leaves a consumer thread alive it
        # fences the table, and refs/loops of this generation go inert
        self.gen = table.generation
        self.join_grace = float(table.config.shutdown_grace_s)
        self.hooks = ctx.hooks
        self.threads: Dict[int, threading.Thread] = {}
        self.done: Dict[int, threading.Event] = {}
        self.resolved: set = set()
        self.first_t0: Dict[int, float] = {}
        self.errored: Dict[int, str] = {}
        self.chunks_processed = 0
        self.m_chunks = None          # Counter("exec.stream_chunks")
        self._shutdown = False

    # -- lifecycle ----------------------------------------------------------
    def attach(self) -> None:
        tbl = self.table
        on_bp = None
        hk = self.hooks
        if hk is not None and hk.on_backpressure is not None:
            user_bp = hk.on_backpressure
            pgt, s = self.ctx.pgt, self.s

            def on_bp(src: int, dst: int, waited: float) -> None:
                user_bp(s, pgt.uid_of(src), pgt.uid_of(dst), waited)

        tbl.attach(self.activate, on_bp, deadline=self.ctx.deadline)
        # resume: consumers with chunks buffered from a previous attempt
        # start draining immediately
        with tbl.cond:
            pend = [d for d, ks in tbl.edges_of_dst.items()
                    if self.s.drop_state[d] == ST_INIT
                    and any(tbl.rcur[k] < tbl.wcur[k] for k in ks)]
        for d in pend:
            self.activate(d)

    def shutdown(self) -> None:
        """Stop consumer threads; buffered chunks + cursors persist.

        Joins get one shared ``shutdown_grace_s`` budget.  A consumer
        wedged in its chunk handler survives the join — previously it
        leaked silently and could still mutate rings/payloads after a
        resumable reopen.  Now every survivor is reported by consumer uid
        and the table generation is fenced: the survivor's refs raise
        ``StreamAbort`` on write and its loop exits at the next wakeup."""
        tbl = self.table
        tbl.shutdown()            # unblocks producers stuck in push
        with tbl.cond:
            self._shutdown = True
            tbl.cond.notify_all()
        deadline = time.monotonic() + self.join_grace
        survivors: List[int] = []
        for c, t in list(self.threads.items()):
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                survivors.append(c)
        if survivors:
            uids = [self.ctx.pgt.uid_of(c) for c in survivors]
            warnings.warn(
                f"{len(survivors)} stream consumer thread(s) still alive "
                f"{self.join_grace:.1f}s after lane shutdown "
                f"(consumers: {uids}); fencing stale-lane writes",
                RuntimeWarning, stacklevel=2)
            tbl.fence()
        tbl.detach()

    # -- activation (first chunk) -------------------------------------------
    def activate(self, c: int) -> None:
        c = int(c)
        with self.table.cond:
            if self._shutdown or c in self.threads:
                return
            t = threading.Thread(target=self._consume, args=(c,),
                                 name=f"stream-consume-{c}", daemon=True)
            self.threads[c] = t
        t.start()

    def app_ref(self, c: int) -> _StreamAppRef:
        ref = self.table.app_refs.get(c)
        if ref is None or ref.gen != self.gen:
            ctx = self.ctx
            outs = [_FencedDataRef(self.s, int(j), self.table, self.gen)
                    for j in
                    ctx.out_cols[ctx.out_indptr[c]:ctx.out_indptr[c + 1]]]
            fresh = _StreamAppRef(self.s, c, outs, gen=self.gen)
            if ref is not None:
                # cross-chunk accumulation survives lane turnover; only
                # the fenced output refs are re-minted per generation
                fresh.scratch = ref.scratch
            self.table.app_refs[c] = fresh
            ref = fresh
        return ref

    # -- the consumer thread ------------------------------------------------
    def _consume(self, c: int) -> None:
        tbl = self.table
        s = self.s
        pgt = self.ctx.pgt
        name = pgt.app_of(c)
        func = _APP_REGISTRY.get(name) if name else None
        ref = self.app_ref(c)
        hk = self.hooks
        on_chunk = hk.on_stream_chunk if hk is not None else None
        while True:
            with tbl.cond:
                if self._shutdown or tbl.generation != self.gen:
                    return        # lane shut down / fenced as stale
                if s.drop_state[c] != ST_INIT:
                    return        # gate-failed or cancelled externally
                item = tbl.pop_ready_locked(c)
                if item is None:
                    if c in self.resolved:
                        break     # drained + resolved -> finalize
                    tbl.cond.wait(0.05)
                    continue
            k, seq, value = item
            t0 = time.monotonic()
            self.first_t0.setdefault(c, t0)
            if c not in self.errored:
                try:
                    if func is not None:
                        func(value, ref)
                    if on_chunk is not None:
                        on_chunk(s, pgt.uid_of(int(tbl.src[k])),
                                 pgt.uid_of(c), seq)
                except StreamAbort:
                    return        # downstream push aborted: resumable
                except Exception:  # noqa: BLE001 - consumer becomes ERROR
                    # keep draining (discarding) so producers unblock
                    self.errored[c] = traceback.format_exc(limit=8)
            t1 = time.monotonic()
            self.chunks_processed += 1
            if self.m_chunks is not None:
                self.m_chunks.inc()
            tl = self.ctx.tl
            if tl is not None:
                tl.stamp_chunk(c, seq, t0, t1)
        self._finalize(c)

    def _finalize(self, c: int) -> None:
        if self.table.generation != self.gen:
            return                # fenced: a fresh lane owns this consumer
        s = self.s
        ctx = self.ctx
        t0 = self.first_t0.get(c, time.monotonic())
        tb = self.errored.get(c)
        if tb is not None:
            s.drop_state[c] = ST_ERROR
            s.record_error(c, tb)
        else:
            try:
                func, refs, outs, _ = ctx.app_call(c)
                fin = getattr(func, "finish", None) \
                    if func is not None else None
                if fin is not None:
                    fin(refs, outs, self.app_ref(c))
                s.drop_state[c] = ST_COMPLETED
            except Exception:  # noqa: BLE001 - finaliser failure -> ERROR
                s.drop_state[c] = ST_ERROR
                s.record_error(c, traceback.format_exc(limit=8))
        if ctx.tl is not None:
            ctx.tl.stamp(c, t0, time.monotonic(), ctx.wave)
        ev = self.done.get(c)
        if ev is not None:
            ev.set()

    # -- scheduler side -----------------------------------------------------
    def finalize_wave(self, ids: np.ndarray) -> None:
        """Resolve frontier-ready streaming consumers and wait for each
        to finalize (drain + ``finish``).  Raises ``_WaveTimeout`` past
        the run deadline — consumed state persists on the table."""
        wait_for = []
        spawn = []
        with self.table.cond:
            for c in ids.tolist():
                c = int(c)
                ev = self.done.get(c)
                if ev is None:
                    ev = self.done[c] = threading.Event()
                self.resolved.add(c)
                if c not in self.threads:
                    # producers are terminal: chunk counts are final
                    if any(self.table.rcur[k] < self.table.wcur[k]
                           for k in self.table.edges_of_dst.get(c, ())):
                        spawn.append(c)
                    else:
                        wait_for.append((c, ev, True))   # finalize inline
                        continue
                wait_for.append((c, ev, False))
            self.table.cond.notify_all()
        for c in spawn:
            self.activate(c)
        for c, ev, inline in wait_for:
            if inline:
                self._finalize(c)
                continue
            while not ev.wait(0.1):
                if time.monotonic() > self.ctx.deadline:
                    raise _WaveTimeout

    def cancel(self, ids: np.ndarray) -> None:
        """Wake threads of consumers the threshold gate just ERRORed;
        they observe the terminal state and exit without finalizing."""
        with self.table.cond:
            for c in ids.tolist():
                self.resolved.add(int(c))
            self.table.cond.notify_all()


# ---------------------------------------------------------------------------
# The frontier scheduler
# ---------------------------------------------------------------------------


def execute_frontier(session: CompiledSession,
                     timeout: float = 60.0,
                     hooks: Optional[ExecHooks] = None,
                     executors: Optional[Dict[str, Any]] = None,
                     stream: Union[StreamConfig, bool, None] = None) -> bool:
    """Run a deployed :class:`CompiledSession` to completion, wave-by-wave.

    ``executors`` (node name -> thread pool, e.g.
    ``MasterDropManager.node_executors()``) lets registry-app waves that
    span several nodes overlap; without it Python apps run sequentially
    in the calling thread.  Vectorised fast paths are unaffected.

    ``stream`` controls the chunk-granular streaming lane: ``None``
    (default) auto-enables it when the graph has active streaming edges,
    a :class:`StreamConfig` enables it with explicit knobs, ``False``
    degrades streaming edges to batch dependencies — emitting the
    ``exec.streaming_edges_degraded`` counter and a one-time warning.

    Resume-aware: ``pending_inputs`` and the errored-predecessor counters
    are derived from the *current* state array, so a session restored from
    a checkpoint (or pre-seeded with completed drops) continues from
    exactly where it left off.  The same property makes ``hooks.on_wave``
    free to abort the run (fault injection) — recovery resets state rows
    and simply calls ``execute_frontier`` again.

    Returns True when every drop reached a terminal state within
    ``timeout``; on timeout the session is left RUNNING and False is
    returned (the engine reports state "TIMEOUT").
    """
    pgt = session.pgt
    n = pgt.num_drops
    session.start()
    if n == 0:
        if hooks is not None and hooks.on_wave is not None:
            hooks.on_wave(session, 0, 0)
        session.finish()
        return True
    state = session.drop_state
    kind = pgt.kind_arr

    # streaming lane setup — must precede _Dispatch so stream-producing
    # apps are routed off the vectorised fast paths.  Pure-batch graphs
    # take the `not has_streaming_edges()` exit and allocate nothing.
    stream_cfg: Optional[StreamConfig] = None
    if isinstance(stream, StreamConfig):
        stream_cfg = stream
        stream = stream.enabled
    enabled = stream is None or bool(stream)
    tbl: Optional[StreamTable] = None
    if pgt.has_streaming_edges():
        if enabled:
            tbl = session.enable_streaming(stream_cfg)
        else:
            from .streaming import active_stream_edges
            n_active = session.stream.n_edges if session.stream is not None \
                else int(active_stream_edges(pgt).size)
            if n_active:
                _warn_degraded(n_active)
                if session.metrics is not None:
                    session.metrics.counter(
                        "exec.streaming_edges_degraded").inc(n_active)

    in_deg = pgt.in_degrees()
    ctx = _Dispatch(session, hooks, executors, stream_table=tbl)
    out_indptr, out_cols = ctx.out_indptr, ctx.out_cols

    # readiness counters, derived from current state (fresh start or resume)
    src_state = state[pgt.edge_src]
    terminal_edges = src_state != ST_INIT
    # int32 counters throughout (in_degrees is int32): at the 10M tier
    # the three per-drop counter arrays stay at 40MB each, not 80MB
    if terminal_edges.any():
        pending = in_deg - np.bincount(
            pgt.edge_dst[terminal_edges], minlength=n).astype(np.int32)
        err_preds = np.bincount(
            pgt.edge_dst[src_state == ST_ERROR],
            minlength=n).astype(np.int32)
    else:
        pending = in_deg.copy()
        err_preds = np.zeros(n, dtype=np.int32)

    frontier = np.flatnonzero((pending == 0) & (state == ST_INIT))
    remaining = int((state == ST_INIT).sum())
    deadline = time.monotonic() + timeout
    ctx.deadline = deadline   # enforced mid-wave too (wide Python waves)

    lane: Optional[_StreamLane] = None
    if tbl is not None and tbl.n_edges:
        lane = _StreamLane(ctx, tbl)
        bp_start = tbl.backpressure_waits

    # telemetry: wave/frontier metrics at wave granularity, per-drop
    # stamps in the dispatch fast paths.  Resumed sessions keep wave
    # numbers monotone by continuing past the highest stamped index.
    tl = session.timeline
    reg = session.metrics
    if reg is not None:
        from .telemetry import FRONTIER_BUCKETS
        m_waves = reg.counter("exec.waves")
        m_front = reg.histogram("exec.frontier_size", FRONTIER_BUCKETS)
        ctx.m_batches = reg.counter("exec.dispatch_batches")
    wave_no = tl.max_wave + 1 if tl is not None else 0

    if lane is not None:
        if reg is not None:
            lane.m_chunks = reg.counter("exec.stream_chunks")
        lane.attach()

    try:
        while frontier.size:
            if time.monotonic() > deadline:
                return False
            if hooks is not None and hooks.on_wave is not None:
                # state is consistent here (all drops terminal or INIT);
                # any exception raised by the hook leaves the session
                # resumable (the finally below parks the stream lane too)
                hooks.on_wave(session, n - remaining, n)
            ctx.wave = wave_no
            if reg is not None:
                m_waves.inc()
                m_front.observe(float(frontier.size))
            wave_t0 = time.monotonic() if tl is not None else 0.0

            # 1. complete all ready data drops of the wave (vectorised)
            data_ids = frontier[kind[frontier] == KIND_DATA]
            if data_ids.size:
                bad = err_preds[data_ids] > 0
                state[data_ids[~bad]] = ST_COMPLETED
                errs = data_ids[bad]
                if errs.size:
                    state[errs] = ST_ERROR
                    for i in errs.tolist():
                        session.record_error(i, "producer errored")
                if tl is not None:
                    tl.stamp_batch(data_ids, wave_t0, time.monotonic(),
                                   wave_no)

            # 2. fire all runnable apps (threshold gate, then per-node
            # batches; frontier-ready streaming consumers go to the lane)
            app_ids = frontier[kind[frontier] != KIND_DATA]
            if app_ids.size:
                n_in = in_deg[app_ids]
                nerr = err_preds[app_ids]
                frac_err = nerr / np.maximum(n_in, 1)
                fail = frac_err > ctx.thr[app_ids]
                failed = app_ids[fail]
                if failed.size:
                    state[failed] = ST_ERROR
                    for i, ne, ni in zip(failed.tolist(),
                                         nerr[fail].tolist(),
                                         n_in[fail].tolist()):
                        session.record_error(i, (
                            f"{ne}/{ni} inputs errored > "
                            f"t={float(ctx.thr[i])}"))
                    if tl is not None:
                        tl.stamp_batch(failed, wave_t0, time.monotonic(),
                                       wave_no)
                run_ids = app_ids[~fail]
                stream_ready = None
                if lane is not None:
                    is_sc = tbl.is_consumer[run_ids]
                    if is_sc.any():
                        stream_ready = run_ids[is_sc]
                        run_ids = run_ids[~is_sc]
                    if failed.size:
                        fsc = tbl.is_consumer[failed]
                        if fsc.any():
                            lane.cancel(failed[fsc])
                try:
                    ctx.dispatch(run_ids)
                    if stream_ready is not None:
                        # batch apps of the wave have fired; now wait for
                        # the wave's streaming consumers to drain+finish
                        lane.finalize_wave(stream_ready)
                except _WaveTimeout:
                    # mid-wave abort: skip the in-degree advance;
                    # counters are re-derived from the state on resume
                    return False

            remaining -= int(frontier.size)
            wave_no += 1

            # 3. advance in-degrees: one np.add.at per wave
            succ = _gather(out_indptr, out_cols, frontier)
            if succ.size:
                np.add.at(pending, succ, -1)
                errored = frontier[state[frontier] == ST_ERROR]
                if errored.size:
                    np.add.at(err_preds,
                              _gather(out_indptr, out_cols, errored), 1)
                cand = np.unique(succ)
                frontier = cand[(pending[cand] == 0)
                                & (state[cand] == ST_INIT)]
            else:
                frontier = np.empty(0, dtype=np.int64)
    finally:
        if lane is not None:
            lane.shutdown()
            if reg is not None:
                delta = tbl.backpressure_waits - bp_start
                if delta:
                    reg.counter(
                        "exec.stream_backpressure_waits").inc(delta)

    if remaining == 0:
        if hooks is not None and hooks.on_wave is not None:
            # final wave report: progress consumers observe completed ==
            # total exactly once.  A hook exception here still leaves the
            # session resumable (all drops terminal, finish() not called);
            # the resilient loop's fired-fraction set prevents re-firing.
            hooks.on_wave(session, n, n)
        if reg is not None:
            # count_nonzero on the int8 state is ~10x cheaper than a
            # bincount (which upcasts to intp first)
            n_err = int(np.count_nonzero(state == ST_ERROR))
            reg.counter("exec.drops_completed").inc(n - n_err)
            reg.counter("exec.drops_errored").inc(n_err)
        session.finish()
        return True
    return False
