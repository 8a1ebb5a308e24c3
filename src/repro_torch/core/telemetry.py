"""Array-native engine telemetry (paper §4.2, §5).

DALiuGE's managers expose the runtime status of every drop up the MM/DIM/NM
hierarchy so operators can watch a million-task pipeline execute; the
follow-up "Empirical Evaluation On the Applicability of the DALiuGE
Execution Framework" diagnoses pipeline behaviour from exactly that
per-drop status/timing data.  The compiled path deliberately publishes no
per-drop events — this module restores the *observability* without giving
back the throughput, by keeping telemetry in the same shape as the engine:
flat parallel arrays, stamped wave-at-a-time.

Three layers, all off by default and enabled via :class:`TelemetryConfig`:

* :class:`Timeline` — per-drop ``t_start``/``t_end`` (float64 monotonic
  seconds), wave index and executing-node arrays on a
  ``CompiledSession``.  Batch fast paths (noop/identity/sleep and data
  drops) stamp whole waves vectorized; real Python apps are stamped
  individually around the registry call, so speculation and retries show
  their true durations.
* :class:`MetricsRegistry` — process-local counters/gauges/fixed-bucket
  histograms (no external deps), wired into ``execute_frontier`` (waves,
  frontier sizes, dispatch batches), ``EngineManager`` (admission,
  queue depth, session-latency histogram, template cache traffic) and
  the resilience runner (retries, speculative wins, recoveries).
* :func:`export_chrome_trace` — Perfetto / chrome://tracing JSON: one
  track per cluster node, one slice per drop (or one aggregated slice
  per wave-batch above ``batch_threshold``), plus a pipeline-span track
  (translate/map/deploy/execute).  A 100k-drop session opens directly in
  ``ui.perfetto.dev``.

Overhead is gated: ``bench_execute.py --telemetry`` measures instrumented
vs clean drops/s and ``scripts/check_bench.py`` enforces the committed
``telemetry_overhead_pct`` ceiling (see ``docs/observability.md``).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
    "TelemetryConfig", "Timeline", "export_chrome_trace",
    "FRONTIER_BUCKETS", "LATENCY_BUCKETS_S",
]

# default fixed bucket grids (upper bounds; one overflow slot is appended)
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
FRONTIER_BUCKETS = (1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7)


@dataclass(frozen=True)
class TelemetryConfig:
    """What the engine records.  Everything defaults off (or free):
    a default-constructed config must leave the hot path untouched —
    ``tests/test_telemetry.py`` asserts no session arrays are allocated.

    * ``timeline`` — allocate + stamp the per-drop :class:`Timeline`
      arrays (4 × num_drops extra memory, a few array writes per wave);
    * ``metrics`` — create/attach a :class:`MetricsRegistry` and update
      it at wave/session granularity;
    * ``spans`` — record translate/map/deploy/execute :class:`Span`\\ s
      on the ``Pipeline`` (a handful of appends per run, kept on);
    * ``trace_batch_threshold`` — per-(node, wave) drop count above
      which :func:`export_chrome_trace` emits one aggregated slice
      instead of per-drop slices.
    """

    timeline: bool = False
    metrics: bool = False
    spans: bool = True
    trace_batch_threshold: int = 64


@dataclass
class Span:
    """One named pipeline stage interval (monotonic seconds)."""

    name: str
    t_start: float
    t_end: float

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


# ---------------------------------------------------------------------------
# Per-drop timelines
# ---------------------------------------------------------------------------


class Timeline:
    """Parallel per-drop timing arrays over one ``CompiledSession``.

    * ``t_start`` / ``t_end`` — float64 ``time.monotonic()`` stamps
      (NaN until the drop reaches a terminal state);
    * ``wave`` — int32 scheduler wave index (-1 = never stamped);
    * ``node`` — int32 id of the node that *executed* the drop — the
      placement node except for speculative straggler duplicates, where
      the winning node is recorded.

    Stamping is two-speed.  ``stamp_batch`` — the call the vectorized
    fast paths make once per wave batch — only appends ``(ids, t0, t1,
    wave)`` to a pending list: O(1) per *batch*, so the execute hot
    path pays a dozen list appends per million drops instead of
    million-element scatters (the scatters also trash the LLC mid-run,
    which taxes the scheduler's own ``ufunc.at`` passes — measured,
    that pushed instrumented overhead past 10%; deferral holds it near
    zero, gated by ``telemetry_overhead_pct`` in the bench).  The
    scatters replay once, lazily, on first array access via the
    ``t_start``/``t_end``/``wave`` properties.  Callers hand over the
    ``ids`` array (always a fresh fancy-index subset in the scheduler)
    and must not mutate it afterwards.

    The arrays themselves allocate *lazily*, at the first scalar stamp
    or read — not when telemetry is enabled.  Filling ~24 bytes/drop of
    fresh pages right before execute wipes the LLC that holds the warm
    template CSR arrays, which measured ~4% on the 1M execute wall all
    by itself; a purely fast-path run now allocates nothing until
    someone actually reads the timeline.

    ``node`` is pre-filled with the placement at allocation — the batch
    fast paths always execute on the placement node, so only scalar
    stamps ever rewrite an entry (speculative winner on a different
    node).  ``stamp`` — used by ``_run_python`` / the resilience runner
    around the actual app call — writes through immediately: real apps
    are micro-seconds-plus each, and their true per-drop timings must
    not be clobbered by a later batch replay.  Scalar and batch stamps
    always target distinct indices (one writer per drop), so replay
    order does not matter; batch stamps come from the single scheduler
    thread, and only the allocation itself is locked (scalar stamps
    race in from pool workers).
    """

    __slots__ = ("pgt", "_t_start", "_t_end", "_wave", "_node", "epoch",
                 "max_wave", "_pending", "_alloc_lock", "chunks")

    def __init__(self, session: Any) -> None:
        self.pgt = session.pgt
        self._t_start: Optional[np.ndarray] = None
        self._t_end: Optional[np.ndarray] = None
        self._wave: Optional[np.ndarray] = None
        self._node: Optional[np.ndarray] = None
        self.epoch = time.monotonic()     # export timebase reference
        self.max_wave = -1                # resume continues from here
        self._pending: List[tuple] = []   # deferred batch stamps
        self._alloc_lock = threading.Lock()
        # streaming chunk spans: (consumer idx, seq, t0, t1) per chunk
        # processed by the compiled lane.  A plain list — chunks are
        # application-granular, and appends under the GIL are atomic
        # enough for the multi-threaded consumer lanes.
        self.chunks: List[tuple] = []

    def _ensure(self) -> None:
        """Allocate the stamp arrays on first use.  Double-checked on
        ``_wave``, which is published last — an unlocked reader that
        sees it non-None sees fully initialized arrays (GIL-ordered)."""
        if self._wave is None:
            with self._alloc_lock:
                if self._wave is None:
                    n = self.pgt.num_drops
                    self._t_start = np.full(n, np.nan, dtype=np.float64)
                    self._t_end = np.full(n, np.nan, dtype=np.float64)
                    self._node = self.pgt.node_ids.astype(np.int32,
                                                          copy=True)
                    self._wave = np.full(n, -1, dtype=np.int32)

    @property
    def t_start(self) -> np.ndarray:
        self._replay()
        return self._t_start

    @property
    def t_end(self) -> np.ndarray:
        self._replay()
        return self._t_end

    @property
    def wave(self) -> np.ndarray:
        self._replay()
        return self._wave

    @property
    def node(self) -> np.ndarray:
        self._ensure()
        return self._node

    def _replay(self) -> None:
        """Materialize deferred batch stamps into the arrays (three 1-D
        scalar-broadcast scatters per batch — NumPy's fastest scatter
        path; a 2-D ``(n, 2)`` row scatter or a structured-dtype
        scatter both measure 3-5x slower)."""
        self._ensure()
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for ids, t0, t1, wave in pending:
            self._t_start[ids] = t0
            self._t_end[ids] = t1
            self._wave[ids] = wave

    def stamp_batch(self, ids: np.ndarray, t0: float, t1: float,
                    wave: int) -> None:
        """Deferred stamp for one wave's fast-path batch (O(1); the
        caller must not mutate ``ids`` afterwards)."""
        self._pending.append((ids, t0, t1, wave))
        if wave > self.max_wave:
            self.max_wave = wave

    def stamp(self, i: int, t0: float, t1: float, wave: int,
              node: Optional[int] = None) -> None:
        """Immediate scalar stamp for one registry-app execution."""
        self._ensure()
        self._t_start[i] = t0
        self._t_end[i] = t1
        self._wave[i] = wave
        if node is not None:
            self._node[i] = node
        if wave > self.max_wave:
            self.max_wave = wave

    def stamp_chunk(self, i: int, seq: int, t0: float, t1: float) -> None:
        """Record one processed stream chunk (consumer ``i``, chunk
        ``seq``).  Called from lane consumer threads."""
        self.chunks.append((int(i), int(seq), t0, t1))

    def chunk_spans(self) -> np.ndarray:
        """Chunk spans as a float64 array of rows (idx, seq, t0, t1) —
        what the streaming bench computes overlap fractions from."""
        if not self.chunks:
            return np.empty((0, 4), dtype=np.float64)
        return np.asarray(self.chunks, dtype=np.float64)

    def stamped(self) -> np.ndarray:
        """Ids of drops that have been stamped (wave >= 0)."""
        return np.flatnonzero(self.wave >= 0)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter.  ``inc`` takes one uncontended lock — callers
    sit at wave/session granularity, never per-drop."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        return self._value


class Gauge:
    """Instantaneous value (queue depth, open sessions)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram: ``uppers[i]`` is the inclusive upper
    bound of bucket ``i``; one extra overflow slot catches the rest.
    Counts live in one int64 array — ``observe_many`` bins a whole
    value array with ``searchsorted`` + ``bincount``."""

    __slots__ = ("name", "uppers", "counts", "count", "sum", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S) -> None:
        self.name = name
        self.uppers = np.asarray(sorted(buckets), dtype=np.float64)
        if self.uppers.size == 0:
            raise ValueError("histogram needs at least one bucket")
        self.counts = np.zeros(self.uppers.size + 1, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = int(np.searchsorted(self.uppers, value, side="left"))
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += value

    def observe_many(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64)
        idx = np.searchsorted(self.uppers, values, side="left")
        binned = np.bincount(idx, minlength=self.counts.size)
        with self._lock:
            self.counts += binned
            self.count += int(values.size)
            self.sum += float(values.sum())

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the ``q``-quantile
        observation (conservative — bucket resolution)."""
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            target = q * total
            cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        if i >= self.uppers.size:
            return float("inf")
        return float(self.uppers[i])

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buckets": [float(u) for u in self.uppers],
                "counts": [int(c) for c in self.counts],
                "count": int(self.count),
                "sum": float(self.sum),
            }


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Creation takes the registry lock once; afterwards callers hold the
    metric object and update it directly (each metric has its own tiny
    lock), so N concurrent manager sessions never serialize on the
    registry itself.  ``snapshot()`` returns plain JSON-serialisable
    Python values — what ``launch/serve.py --stats-json`` dumps.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, *args)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        return self._get(name, Histogram, buckets)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                v = m.value
                out["counters"][m.name] = \
                    int(v) if isinstance(v, (int, np.integer)) else float(v)
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = float(m.value)
            elif isinstance(m, Histogram):
                out["histograms"][m.name] = m.snapshot()
        return out


# ---------------------------------------------------------------------------
# Perfetto / chrome-tracing export
# ---------------------------------------------------------------------------

_TID_PIPELINE = 1      # span track
_TID_NODE0 = 2         # node tracks start here (tid = node_id + 2)


def export_chrome_trace(session: Any, path: Union[str, Path], *,
                        spans: Optional[Sequence[Span]] = None,
                        batch_threshold: int = 64) -> Dict[str, int]:
    """Write one session's timeline as chrome-tracing JSON for Perfetto.

    Track layout: one process per session, one thread track per cluster
    node (thread 1 is the pipeline-span track).  Per-(node, wave) drop
    groups with at most ``batch_threshold`` members get one "X" slice
    per drop (named by uid); larger groups collapse into a single
    aggregated wave slice spanning min ``t_start`` .. max ``t_end`` with
    the drop count in ``args`` — a 100k-drop wave is one slice, not
    100k.  Returns a summary dict (event/slice/track counts).
    """
    tl: Optional[Timeline] = getattr(session, "timeline", None)
    if tl is None:
        raise ValueError(
            "session has no timeline — run it with "
            "TelemetryConfig(timeline=True)")
    pgt = tl.pgt
    ids = tl.stamped()
    events: List[Dict[str, Any]] = []
    pid = 1
    events.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": f"session {session.session_id}"}})
    events.append({"ph": "M", "pid": pid, "tid": _TID_PIPELINE,
                   "name": "thread_name", "args": {"name": "pipeline"}})
    tracks = 1
    for nid, node_name in enumerate(pgt.node_names):
        events.append({"ph": "M", "pid": pid, "tid": _TID_NODE0 + nid,
                       "name": "thread_name", "args": {"name": node_name}})
        tracks += 1
    unplaced_tid = _TID_NODE0 + len(pgt.node_names)

    # common timebase: earliest stamp across drops, chunks and spans
    chunk_rows = tl.chunk_spans()
    bases = []
    if ids.size:
        bases.append(float(np.nanmin(tl.t_start[ids])))
    if chunk_rows.shape[0]:
        bases.append(float(chunk_rows[:, 2].min()))
    for sp in spans or ():
        bases.append(sp.t_start)
    t_base = min(bases) if bases else tl.epoch

    def us(t: float) -> float:
        return round((t - t_base) * 1e6, 3)

    slices = 0
    for sp in spans or ():
        events.append({
            "ph": "X", "pid": pid, "tid": _TID_PIPELINE, "name": sp.name,
            "ts": us(sp.t_start),
            "dur": max(round(sp.duration * 1e6, 3), 0.01)})
        slices += 1

    if ids.size:
        waves = tl.wave[ids]
        nodes = tl.node[ids]
        # pack (node, wave) -> group key; node -1 maps to the last track
        nkey = np.where(nodes >= 0, nodes,
                        len(pgt.node_names)).astype(np.int64)
        key = nkey * (int(waves.max()) + 1) + waves
        order = np.argsort(key, kind="stable")
        bounds = np.flatnonzero(np.diff(key[order])) + 1
        used_unplaced = False
        for grp in np.split(order, bounds):
            g = ids[grp]
            nid = int(nodes[grp[0]])
            wave = int(waves[grp[0]])
            tid = _TID_NODE0 + nid if nid >= 0 else unplaced_tid
            used_unplaced |= nid < 0
            if g.size > batch_threshold:
                t0 = float(np.nanmin(tl.t_start[g]))
                t1 = float(np.nanmax(tl.t_end[g]))
                events.append({
                    "ph": "X", "pid": pid, "tid": tid,
                    "name": f"wave {wave} [{g.size} drops]",
                    "ts": us(t0),
                    "dur": max(round((t1 - t0) * 1e6, 3), 0.01),
                    "args": {"wave": wave, "drops": int(g.size)}})
                slices += 1
            else:
                state = session.drop_state
                from .session import _ST_NAMES
                for i in g.tolist():
                    events.append({
                        "ph": "X", "pid": pid, "tid": tid,
                        "name": pgt.uid_of(i),
                        "ts": us(float(tl.t_start[i])),
                        "dur": max(round(
                            (float(tl.t_end[i])
                             - float(tl.t_start[i])) * 1e6, 3), 0.01),
                        "args": {"wave": wave,
                                 "state": _ST_NAMES[state[i]]}})
                    slices += 1
        if used_unplaced:
            events.append({"ph": "M", "pid": pid, "tid": unplaced_tid,
                           "name": "thread_name",
                           "args": {"name": "unplaced"}})
            tracks += 1

    # streaming chunk spans: one slice per processed chunk on the
    # consumer's node track — this is where producer/consumer overlap
    # becomes visible (chunk slices sitting under a producer's slice)
    node_ids = pgt.node_ids
    for idx, seq, t0, t1 in tl.chunks:
        nid = int(node_ids[idx])
        tid = _TID_NODE0 + nid if nid >= 0 else unplaced_tid
        events.append({
            "ph": "X", "pid": pid, "tid": tid,
            "name": f"{pgt.uid_of(int(idx))} · chunk {int(seq)}",
            "ts": us(float(t0)),
            "dur": max(round((float(t1) - float(t0)) * 1e6, 3), 0.01),
            "args": {"chunk": int(seq)}})
        slices += 1

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return {"events": len(events), "slices": slices, "tracks": tracks,
            "drops_stamped": int(ids.size)}
