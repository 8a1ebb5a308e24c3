"""Graph (de)serialisation (paper §3.7).

"We currently use JSON as the serialization format for the different graphs.
JSON-encoded graphs are compressed and uncompressed on-the-fly when
transmitted.  We parse the JSON content iteratively to keep memory low for
big graphs."

We mirror that: gzip-compressed JSON for LGTs and PGTs, with an incremental
(chunked) writer/reader for physical graphs so multi-million-drop graphs never
need a single monolithic in-memory string (the paper's ijson adaptation).
"""
from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .logical import LogicalGraph, LogicalGraphTemplate
from .pgt import CompiledPGT, _uid_str
from .unroll import DropSpec, PhysicalGraphTemplate


# -- logical graphs -----------------------------------------------------------


def save_lgt(lgt: LogicalGraphTemplate, path: str) -> None:
    raw = json.dumps(lgt.to_json()).encode()
    with gzip.open(path, "wb") as fh:
        fh.write(raw)


def load_lgt(path: str) -> LogicalGraphTemplate:
    with gzip.open(path, "rb") as fh:
        return LogicalGraphTemplate.from_json(json.loads(fh.read()))


# -- physical graphs: incremental JSONL-in-gzip ---------------------------------


def _spec_to_json(s: DropSpec) -> Dict[str, Any]:
    return {
        "uid": s.uid, "kind": s.kind, "construct": s.construct,
        "oid": list(s.oid), "app": s.app, "payload_kind": s.payload_kind,
        "execution_time": s.execution_time, "data_volume": s.data_volume,
        "error_threshold": s.error_threshold, "params": s.params,
        "partition": s.partition, "node": s.node,
    }


def _spec_from_json(d: Dict[str, Any]) -> DropSpec:
    d = dict(d)
    d["oid"] = tuple(d["oid"])
    return DropSpec(**d)


def _iter_drop_records(pgt) -> Any:
    """Per-drop JSON dicts; CompiledPGTs in group-derived (array-native)
    mode are walked group by group straight off the arrays — no
    ``DropView`` attribute machinery, no per-drop group bisect — which is
    several times cheaper at million-drop scale."""
    if not (isinstance(pgt, CompiledPGT) and pgt._uids is None):
        for spec in pgt.drops.values():
            yield _spec_to_json(spec)
        return
    import itertools
    part = pgt.partition
    node_ids = pgt.node_ids
    names = pgt.node_names
    exec_arr, vol_arr = pgt.exec_arr, pgt.vol_arr
    err = pgt.err_arr
    overrides = pgt._params_override
    for g in pgt.groups:
        kind = "data" if g.kind == 1 else "app"
        ranges = [range(s) for s in g.sizes]
        for local, oid in enumerate(itertools.product(*ranges)):
            i = g.base + local
            uid = _uid_str(g.name, oid)
            nid = node_ids[i]
            yield {
                "uid": uid, "kind": kind, "construct": g.name,
                "oid": list(oid), "app": g.app,
                "payload_kind": g.payload_kind,
                "execution_time": float(exec_arr[i]),
                "data_volume": float(vol_arr[i]),
                "error_threshold": (float(err[i]) if err is not None
                                    else g.error_threshold),
                "params": overrides.get(i, g.params),
                "partition": int(part[i]),
                "node": None if nid < 0 else names[nid],
            }


def save_pgt(pgt: PhysicalGraphTemplate, path: str,
             chunk: int = 10000) -> None:
    """Stream the PGT out as gzip JSONL: header, then drops, then edges."""
    with gzip.open(path, "wt") as fh:
        fh.write(json.dumps({"type": "header", "name": pgt.name,
                             "num_drops": len(pgt.drops),
                             "num_edges": len(pgt.edges)}) + "\n")
        buf: List[Dict[str, Any]] = []
        for rec in _iter_drop_records(pgt):
            buf.append(rec)
            if len(buf) >= chunk:
                fh.write(json.dumps({"type": "drops", "items": buf}) + "\n")
                buf = []
        if buf:
            fh.write(json.dumps({"type": "drops", "items": buf}) + "\n")
        ebuf: List[List[Any]] = []
        for s, d, streaming in pgt.edges:
            ebuf.append([s, d, streaming])
            if len(ebuf) >= chunk:
                fh.write(json.dumps({"type": "edges", "items": ebuf}) + "\n")
                ebuf = []
        if ebuf:
            fh.write(json.dumps({"type": "edges", "items": ebuf}) + "\n")


def iter_pgt(path: str) -> Iterator[Tuple[str, Any]]:
    """Incremental PGT reader: yields ('header'|'drop'|'edge', payload)."""
    with gzip.open(path, "rt") as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["type"] == "header":
                yield "header", rec
            elif rec["type"] == "drops":
                for item in rec["items"]:
                    yield "drop", _spec_from_json(item)
            elif rec["type"] == "edges":
                for item in rec["items"]:
                    yield "edge", tuple(item)


def load_pgt(path: str) -> CompiledPGT:
    """Incrementally load a PGT into the array-based representation."""
    name: Optional[str] = None
    specs: List[DropSpec] = []
    edges: List[Tuple[str, str, bool]] = []
    for kind, payload in iter_pgt(path):
        if kind == "header":
            name = payload["name"]
        elif kind == "drop":
            specs.append(payload)
        else:
            edges.append(payload)
    assert name is not None, f"no header found in {path}"
    return CompiledPGT.from_specs(name, specs, edges)
