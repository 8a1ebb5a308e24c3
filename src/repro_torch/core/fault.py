"""Fault tolerance: stragglers, node failure, retries (paper §3.6 + §7).

The paper ships event-propagated failure with the error-tolerance threshold
``t`` (implemented in ``drop.AppDrop``) and lists node-failure migration as
future work ("dynamically migrating Drops from failed nodes to healthy ones
... in order to resume their execution there").  We implement it, plus
speculative straggler re-execution — both required for 1000+-node operation.

Recovery is lineage-based and safe because payloads are write-once: any lost
Drop can be reconstructed by re-running its producers, recursively, until
durable (file-backed) or surviving payloads are reached.
"""
from __future__ import annotations

import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set

from .drop import (AppDrop, AppState, DataDrop, Drop, DropState,
                   FilePayload, MemoryPayload)
from .managers import MasterDropManager, NodeDropManager
from .mapping import NodeInfo
from .session import Session
from .unroll import PhysicalGraphTemplate


# ---------------------------------------------------------------------------
# Retry wrapper
# ---------------------------------------------------------------------------


def with_retries(fn: Callable, max_attempts: int = 3,
                 backoff: float = 0.0) -> Callable:
    """Wrap an app function with bounded retries (transient-failure guard)."""

    def wrapped(inputs: List[DataDrop], outputs: List[DataDrop],
                app: AppDrop) -> None:
        last: Optional[BaseException] = None
        for attempt in range(max_attempts):
            try:
                return fn(inputs, outputs, app)
            except Exception as exc:  # noqa: BLE001
                last = exc
                app.meta["retries"] = attempt + 1
                if backoff and attempt + 1 < max_attempts:
                    # back off only between attempts — sleeping after the
                    # final failure just delays the re-raise
                    time.sleep(backoff * (2 ** attempt))
        raise last  # type: ignore[misc]

    return wrapped


# ---------------------------------------------------------------------------
# Straggler mitigation — speculative re-execution
# ---------------------------------------------------------------------------


class StragglerWatcher:
    """Monitors RUNNING app drops; duplicates ones slower than
    ``factor`` x median completed duration.  First finisher commits; the
    loser's commit is a guarded no-op (requires idempotent apps — true for
    pure functions, which all JAX steps are)."""

    def __init__(self, session: Session, master: MasterDropManager,
                 factor: float = 3.0, min_runtime: float = 0.05,
                 poll: float = 0.02) -> None:
        self.session = session
        self.master = master
        self.factor = factor
        self.min_runtime = min_runtime
        self.poll = poll
        self.speculated: Set[str] = set()
        self.wins = 0
        self._stop = threading.Event()
        self._rr = 0                      # round-robin tie-break cursor
        self._started: Dict[str, float] = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        session.bus.subscribe_all(self._on_event)

    def _on_event(self, ev) -> None:
        if ev.type == "execStatus" and ev.data.get("status") == "RUNNING":
            self._started.setdefault(ev.source_uid, time.monotonic())

    def start(self) -> "StragglerWatcher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _median_duration(self) -> Optional[float]:
        durs = [d.run_duration for d in self.session.drops.values()
                if isinstance(d, AppDrop) and d.run_duration is not None]
        return statistics.median(durs) if len(durs) >= 3 else None

    def _run(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.poll)
            med = self._median_duration()
            if med is None:
                continue
            now = time.monotonic()
            threshold = max(self.factor * med, self.min_runtime)
            for uid, t0 in list(self._started.items()):
                if uid in self.speculated:
                    continue
                d = self.session.drops.get(uid)
                if (isinstance(d, AppDrop)
                        and d.exec_state is AppState.RUNNING
                        and now - t0 > threshold):
                    self.speculated.add(uid)
                    self._speculate(d)

    def _speculate(self, app: AppDrop) -> None:
        """Run a duplicate on the least-loaded other live node (round-robin
        among ties — always picking ``nms[0]`` piled every duplicate onto
        one node and made *it* the next straggler)."""
        nms = [nm for nm in self.master.node_managers().values()
               if nm.info.alive and nm.name != app.node]
        target = self._pick_target(nms)

        def dup() -> None:
            try:
                ok_inputs = [d for d in app.inputs
                             if d.state is DropState.COMPLETED]
                if app.func is not None:
                    app.func(ok_inputs, list(app.outputs), app)
                committed = app.commit_speculative()
                if committed:
                    self.wins += 1
            except Exception:  # noqa: BLE001 - loser may race on payloads
                pass

        if target is not None:
            target.executor.submit(dup)
        else:
            threading.Thread(target=dup, daemon=True).start()

    def _pick_target(self, nms: List[NodeDropManager]
                     ) -> Optional[NodeDropManager]:
        """Least-loaded candidate (RUNNING apps placed on it), rotating
        through ties so duplicates spread across equally-idle nodes."""
        if not nms:
            return None
        loads: Dict[str, int] = {}
        for d in self.session.drops.values():
            if (isinstance(d, AppDrop)
                    and d.exec_state is AppState.RUNNING and d.node):
                loads[d.node] = loads.get(d.node, 0) + 1
        low = min(loads.get(nm.name, 0) for nm in nms)
        tied = [nm for nm in nms if loads.get(nm.name, 0) == low]
        pick = tied[self._rr % len(tied)]
        self._rr += 1
        return pick


# ---------------------------------------------------------------------------
# Node failure + lineage recovery (paper §7 future work, implemented)
# ---------------------------------------------------------------------------


class FaultManager:
    def __init__(self, session: Session, pgt: PhysicalGraphTemplate,
                 master: MasterDropManager) -> None:
        self.session = session
        self.pgt = pgt
        self.master = master
        self.recovered: List[str] = []

    def fail_node(self, node: str) -> None:
        nm = self.master.node_managers()[node]
        nm.fail()

    def recover(self) -> List[str]:
        """Migrate Drops off dead nodes and re-execute lost lineage.

        1. Find drops placed on dead nodes.
        2. Lost set = non-terminal drops there + COMPLETED *memory* payload
           data drops there (memory died with the node).  File payloads
           survive (shared/durable storage).
        3. Extend the lost set upstream: a lost data drop's producers must
           re-run; extend downstream: consumers that already used lost data
           are fine (write-once), but not-yet-run consumers just wait.
        4. Re-map lost drops onto live nodes, reset state, re-trigger.
        """
        dead = {n for n, nm in self.master.node_managers().items()
                if not nm.info.alive}
        if not dead:
            return []
        lost: Set[str] = set()
        for uid, drop in self.session.drops.items():
            if drop.node not in dead:
                continue
            if (isinstance(drop, DataDrop) and not drop.producers):
                # root data drops are pipeline INPUTS: durable by contract
                # (they come from external storage, not from a producer we
                # could re-run).  Never reset them.
                continue
            if drop.state in (DropState.COMPLETED,):
                if (isinstance(drop, DataDrop)
                        and isinstance(drop.payload, MemoryPayload)):
                    lost.add(uid)          # volatile payload lost
                elif isinstance(drop, AppDrop):
                    pass                   # finished app: nothing to lose
            elif drop.state in (DropState.ERROR, DropState.CANCELLED,
                                DropState.SKIPPED, DropState.EXPIRED,
                                DropState.DELETED):
                pass
            else:
                lost.add(uid)              # was pending/running there

        # upstream closure: to recompute a lost data drop we re-run its
        # producers; a producer needs ITS inputs present - recurse on any
        # input whose payload is itself gone.
        frontier = list(lost)
        while frontier:
            uid = frontier.pop()
            drop = self.session.drops[uid]
            if isinstance(drop, DataDrop):
                for prod in drop.producers:
                    if prod.uid not in lost:
                        lost.add(prod.uid)
                        frontier.append(prod.uid)
            else:
                for inp in drop.inputs:  # type: ignore[union-attr]
                    payload_ok = (inp.state is DropState.COMPLETED
                                  and inp.payload.exists()
                                  and inp.node not in dead) or \
                                 (inp.state is DropState.COMPLETED
                                  and isinstance(inp.payload, FilePayload)
                                  and inp.payload.exists()) or \
                                 (not inp.producers)   # roots are durable
                    if not payload_ok and inp.uid not in lost:
                        lost.add(inp.uid)
                        frontier.append(inp.uid)

        # choose live nodes round-robin for migration
        live = [n for n, nm in self.master.node_managers().items()
                if nm.info.alive]
        if not live:
            raise RuntimeError("no live nodes left to migrate onto")
        nms = self.master.node_managers()

        for i, uid in enumerate(sorted(lost)):
            drop = self.session.drops[uid]
            target = live[i % len(live)]
            drop.node = target
            if isinstance(drop, AppDrop):
                drop.exec_state = AppState.NOT_RUN
                drop._state = DropState.INITIALIZED
                drop._resolved = {
                    u: e for u, e in drop._resolved.items()
                    if u not in lost}
                drop._executor = nms[target].executor
            else:
                assert isinstance(drop, DataDrop)
                drop._state = DropState.INITIALIZED
                drop.payload = type(drop.payload)() \
                    if isinstance(drop.payload, MemoryPayload) \
                    else drop.payload
                drop._finished_producers = sum(
                    1 for p in drop.producers if p.uid not in lost
                    and p.state is DropState.COMPLETED)
                drop._errored_producers = sum(
                    1 for p in drop.producers if p.uid not in lost
                    and p.state is DropState.ERROR)
            self.recovered.append(uid)

        # also: downstream apps that were waiting on lost drops must forget
        # their resolution record for them
        for uid, drop in self.session.drops.items():
            if isinstance(drop, AppDrop) and uid not in lost \
                    and drop.exec_state is AppState.NOT_RUN:
                for lost_uid in lost:
                    drop._resolved.pop(lost_uid, None)

        # the session is live again: clear its finished latch
        self.session.reopen()

        # re-trigger: completed surviving inputs re-fire to migrated apps;
        # migrated roots restart.
        for uid in sorted(lost):
            drop = self.session.drops[uid]
            if isinstance(drop, AppDrop):
                if not drop.inputs and not drop.streaming_inputs:
                    drop.trigger_root()
                else:
                    for inp in drop.inputs:
                        if inp.state is DropState.COMPLETED:
                            drop.on_input_completed(inp)
            else:
                assert isinstance(drop, DataDrop)
                if not drop.producers:
                    drop.set_completed()
        return self.recovered


# ---------------------------------------------------------------------------
# Elastic scaling — re-map a PGT onto a changed node set (beyond paper)
# ---------------------------------------------------------------------------


def elastic_remap(pgt: PhysicalGraphTemplate,
                  nodes: Sequence[NodeInfo]) -> Dict[int, str]:
    """Re-run the resource-mapping stage on the current live node set.

    Because the PGT partitioning stage is resource-oblivious (paper's
    two-phase scheduling), scaling up/down only repeats the cheap mapping
    step — this is the paper's decoupling paying off at run time.
    """
    from .mapping import map_partitions
    return map_partitions(pgt, [n for n in nodes if n.alive])
