"""Data Lifecycle Management (paper §1 item 4, §4.3).

"It integrates a data lifecycle management component within the execution
engine, keeping track of Drops and migrating or deleting them automatically
when necessary."

The DLM watches COMPLETED Data Drops: after their ``lifetime`` elapses they
EXPIRE (further reads denied) and are then DELETED (payload reclaimed).
Drops flagged ``persist`` are spilled from memory to durable storage before
their volatile payload is reclaimed (the "migrating" case).
"""
from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from .drop import DataDrop, DropState, FilePayload, MemoryPayload
from .session import Session


class DataLifecycleManager:
    def __init__(self, session: Session, poll: float = 0.02,
                 spill_dir: str = "/tmp/repro_dlm") -> None:
        self.session = session
        self.poll = poll
        self.spill_dir = Path(spill_dir)
        self.expired: List[str] = []
        self.deleted: List[str] = []
        self.persisted: List[str] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "DataLifecycleManager":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def sweep(self, now: Optional[float] = None) -> None:
        """One pass over all data drops (also callable synchronously)."""
        now = time.monotonic() if now is None else now
        for uid, drop in list(self.session.drops.items()):
            if not isinstance(drop, DataDrop):
                continue
            if drop.state is DropState.COMPLETED:
                if drop.meta.get("persist") and uid not in self.persisted:
                    self._persist(drop)
                if (drop.lifetime is not None and drop.completed_at is not None
                        and now - drop.completed_at >= drop.lifetime):
                    drop.expire()
                    self.expired.append(uid)
            elif drop.state is DropState.EXPIRED:
                drop.payload.delete()
                drop.delete()
                self.deleted.append(uid)

    def _persist(self, drop: DataDrop) -> None:
        """Migrate a volatile payload to durable storage (spill)."""
        if isinstance(drop.payload, FilePayload):
            self.persisted.append(drop.uid)
            return
        if not isinstance(drop.payload, MemoryPayload):
            return
        self.spill_dir.mkdir(parents=True, exist_ok=True)
        tgt = FilePayload(str(self.spill_dir /
                              f"{drop.uid.replace('/', '_')}.pkl"))
        try:
            tgt.write(drop.payload.read())
            tgt.seal()
            drop.meta["spilled_to"] = tgt.data_url
            self.persisted.append(drop.uid)
        except Exception:  # noqa: BLE001 - persistence is best-effort
            pass

    def _run(self) -> None:
        while not self._stop.is_set():
            self.sweep()
            self._stop.wait(self.poll)
