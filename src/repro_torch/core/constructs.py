"""Logical-graph constructs (paper §3.2).

The building blocks of a Logical Graph Template:

* ``Data`` and ``Component`` — the two basic constructs, templates from which
  Data Drops and Application Drops are instantiated.  ``Data`` exposes a
  *data volume* property, ``Component`` an *execution time* property (used by
  the translator's cost model).
* ``Scatter`` — data parallelism; ``num_of_copies`` parallel branches.
* ``Gather`` — data barrier; each instance consumes ``num_of_inputs``
  partitions.
* ``GroupBy`` — corner-turn / static shuffle; must be used with nested
  Scatters (validated), regrouping outer×inner partitions by the inner key.
* ``Loop`` — fixed-trip iteration; the body is replicated ``num_of_iterations``
  times with loop-carried Data nodes re-created each iteration (paper §2.3:
  "pre-generated loop structures with new Data Drops created in each
  iteration").

Constructs are pure descriptions — no jax, no threads — serialisable to JSON.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class Kind(str, enum.Enum):
    DATA = "data"
    COMPONENT = "component"
    SCATTER = "scatter"
    GATHER = "gather"
    GROUPBY = "groupby"
    LOOP = "loop"


CONTAINER_KINDS = {Kind.SCATTER, Kind.GATHER, Kind.GROUPBY, Kind.LOOP}


@dataclass
class Construct:
    """A node of the Logical Graph Template."""

    name: str
    kind: Kind
    # basic-construct properties (paper §3.2)
    data_volume: float = 0.0          # bytes, Data only
    execution_time: float = 0.0       # seconds, Component only
    payload_kind: str = "memory"      # Data only: memory|file|null
    app: Optional[str] = None         # Component only: registered app name
    error_threshold: float = 0.0      # Component only: t (Fig. 7)
    # flow-construct properties
    num_of_copies: int = 1            # Scatter
    num_of_inputs: int = 1            # Gather
    num_of_iterations: int = 1        # Loop
    group_key: str = "inner"          # GroupBy: which scatter axis groups
    loop_entry: bool = False          # Data inside Loop receiving carried value
    loop_exit: bool = False           # Data inside Loop producing carried value
    # containment
    parent: Optional[str] = None      # enclosing container construct name
    params: Dict[str, Any] = field(default_factory=dict)

    def is_container(self) -> bool:
        return self.kind in CONTAINER_KINDS

    def to_json(self) -> Dict[str, Any]:
        d = {
            "name": self.name, "kind": self.kind.value,
            "data_volume": self.data_volume,
            "execution_time": self.execution_time,
            "payload_kind": self.payload_kind, "app": self.app,
            "error_threshold": self.error_threshold,
            "num_of_copies": self.num_of_copies,
            "num_of_inputs": self.num_of_inputs,
            "num_of_iterations": self.num_of_iterations,
            "group_key": self.group_key,
            "loop_entry": self.loop_entry, "loop_exit": self.loop_exit,
            "parent": self.parent, "params": self.params,
        }
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Construct":
        d = dict(d)
        d["kind"] = Kind(d["kind"])
        return Construct(**d)


@dataclass(frozen=True)
class LogicalEdge:
    """Directed edge between constructs.

    The linking rule (paper §3.2): Data may only link to Component and vice
    versa ("tasks and data are both nodes of the graph").  Container
    constructs are transparent: edges attach to constructs *inside* them.
    """

    src: str
    dst: str
    streaming: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {"src": self.src, "dst": self.dst, "streaming": self.streaming}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "LogicalEdge":
        return LogicalEdge(**d)
