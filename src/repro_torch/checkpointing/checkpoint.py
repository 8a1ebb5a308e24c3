"""Model/optimizer checkpointing with an async writer, PyTorch counterpart
of ``repro/checkpointing/checkpoint.py``, in the same format.

Format: ``step_<8 digits>/`` holding ``shard<s>.npz`` files (leaf ``i`` is
``leaf<i>`` in shard ``i % shards``) and a ``manifest.json`` with the step
and, per leaf, its name, key, shard, shape and dtype.  Atomic via
write-to-tmp + rename.

Leaves are in JAX's flatten order and named by ``jax.tree_util.keystr``
(``repro_torch.tree``): a TrainState gives ``.params['embed']``, ...,
``.opt.step``, ``.opt.m[...]``, ``.opt.v[...]`` and, with compression,
``.residual[...]`` (a ``None`` residual has no leaf).  So a checkpoint
written by either package restores in the other.  bf16 leaves are written
as the reference writes them, as 2-byte void (``V2``) arrays with the
manifest dtype ``bfloat16``; ``load_checkpoint`` restores them to
``torch.bfloat16`` by that dtype.  (The reference's own loader hands back
the ``V2`` array.)

The async path copies the tree to the host before it returns and hands the
copy to a writer thread, so the training loop never blocks on disk.
"""
from __future__ import annotations

import heapq
import itertools
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_path, tree_map, unflatten_like

BF16 = "bfloat16"


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array written for ``leaf``, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype == np.dtype("V2"):
        raise ValueError("a V2 leaf has no dtype of its own; pass bf16 "
                         "leaves as torch.bfloat16 tensors")
    return arr, str(arr.dtype)


def _to_host(leaf: Any) -> Any:
    """A host copy of ``leaf`` that keeps its bf16 dtype (a CPU tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_checkpoint(directory: str, step: int, tree: Any,
                    shards: int = 1) -> str:
    """Blocking save.  ``shards``: split leaves round-robin into N files."""
    d = Path(directory)
    tmp = d / f".tmp-{step}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": [], "shards": shards}
    buckets: List[Dict[str, np.ndarray]] = [dict() for _ in range(shards)]
    for i, (name, leaf) in enumerate(leaves_with_path(tree)):
        arr, dtype = _host(leaf)
        key = f"leaf{i}"
        buckets[i % shards][key] = arr
        manifest["leaves"].append(
            {"name": name, "key": key, "shard": i % shards,
             "shape": list(arr.shape), "dtype": dtype})
    for s, bucket in enumerate(buckets):
        np.savez(tmp / f"shard{s}.npz", **bucket)
    with open(tmp / "manifest.json", "w") as fh:
        json.dump(manifest, fh)
    final = d / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return str(final)


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.is_dir() and p.name.startswith("step_")]
    return max(steps) if steps else None


def _restore(arr: np.ndarray, dtype: str, like: Any) -> torch.Tensor:
    """The tensor of a saved array: bf16 by the manifest's dtype, on the
    device of ``like`` when that is a tensor (else the CPU)."""
    if dtype == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, dtype=np.dtype(dtype)))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def load_checkpoint(directory: str, tree_like: Any,
                    step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``tree_like`` (shapes validated); the
    leaves come back as tensors in the saved dtypes."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = Path(directory) / f"step_{step:08d}"
    with open(d / "manifest.json") as fh:
        manifest = json.load(fh)
    items = leaves_with_path(tree_like)
    if len(items) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"the tree {len(items)}")
    shards = [np.load(d / f"shard{s}.npz")
              for s in range(manifest["shards"])]
    try:
        out = []
        for (name, like), meta in zip(items, manifest["leaves"]):
            if list(np.shape(like)) != meta["shape"]:
                raise ValueError(f"{name}: {list(np.shape(like))} != "
                                 f"{meta['shape']}")
            out.append(_restore(shards[meta["shard"]][meta["key"]],
                                meta["dtype"], like))
    finally:
        for z in shards:
            z.close()
    return step, unflatten_like(tree_like, out)


class CheckpointManager:
    """Async, bounded-keep checkpointer, safe to call from several threads
    at once (``launch/train.py``'s checkpoint apps run on the engine's
    workers, so two may overlap).

    One writer thread at a time drains the pending saves, lowest step
    first, so writes keep their step order and ``_gc`` never runs beside
    another write; ``wait`` returns once every save handed over before it
    is on disk, and raises the first error a write hit."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: List[Tuple[int, int, Any]] = []   # a heap by step
        self._order = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: List[int] = []

    def save_async(self, step: int, tree: Any) -> None:
        host = tree_map(_to_host, tree)        # device->host copy now
        with self._lock:
            heapq.heappush(self._pending, (step, next(self._order), host))
            if self._thread is None:
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._thread = None
                    return
                step, _, host = heapq.heappop(self._pending)
            try:
                save_checkpoint(self.directory, step, host)
                self.saved_steps.append(step)
                self._gc()
            except BaseException as err:   # noqa: BLE001 - raised by wait
                with self._lock:
                    self._error = self._error or err

    def wait(self) -> None:
        while True:
            with self._lock:
                thread = self._thread
                if thread is None:
                    err, self._error = self._error, None
                    break
            thread.join()
        if err is not None:
            raise err

    def _gc(self) -> None:
        d = Path(self.directory)
        steps = sorted(int(p.name.split("_")[1]) for p in d.iterdir()
                       if p.is_dir() and p.name.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(d / f"step_{s:08d}", ignore_errors=True)

    def restore_latest(self, tree_like: Any) -> Optional[Tuple[int, Any]]:
        self.wait()
        try:
            return load_checkpoint(self.directory, tree_like)
        except FileNotFoundError:
            return None
