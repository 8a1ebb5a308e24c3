"""Logical Graph Templates and Logical Graphs (paper §3.2–§3.3).

An LGT is a resource-oblivious description of a pipeline.  Providing concrete
parameter values turns it into a Logical Graph (LGR) — "the only difference
between LGT and LGR are those parameter values filled in by the project PI".

Validation (paper §3.4 step 1, "analogous to the syntax checking done by
compilers"):
  * no cycles (DALiuGE does not allow cycles in the Logical Graph),
  * edges respect the Data<->Component linking rule,
  * GroupBy must sit inside nested Scatter constructs,
  * container nesting is well-formed,
  * Gather fan-in divides the number of incoming branches.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from .constructs import CONTAINER_KINDS, Construct, Kind, LogicalEdge


class GraphValidationError(ValueError):
    pass


@dataclass
class LogicalGraphTemplate:
    """A named, versioned LGT (paper: versioned repository of LGTs)."""

    name: str
    version: str = "0"
    constructs: Dict[str, Construct] = field(default_factory=dict)
    edges: List[LogicalEdge] = field(default_factory=list)
    # user-specifiable parameters (filled at Select & Parametrise, §3.3)
    parameters: Dict[str, Any] = field(default_factory=dict)

    # -- construction -----------------------------------------------------
    def add(self, c: Construct) -> Construct:
        if c.name in self.constructs:
            raise GraphValidationError(f"duplicate construct {c.name!r}")
        if c.parent is not None and c.parent not in self.constructs:
            raise GraphValidationError(
                f"parent {c.parent!r} of {c.name!r} not defined yet")
        self.constructs[c.name] = c
        return c

    def connect(self, src: str, dst: str, streaming: bool = False) -> None:
        for n in (src, dst):
            if n not in self.constructs:
                raise GraphValidationError(f"unknown construct {n!r}")
        self.edges.append(LogicalEdge(src, dst, streaming))

    # -- helpers -------------------------------------------------------------
    def ancestors(self, name: str) -> List[Construct]:
        """Chain of enclosing containers, outermost first."""
        chain: List[Construct] = []
        cur = self.constructs[name].parent
        while cur is not None:
            c = self.constructs[cur]
            chain.append(c)
            cur = c.parent
        return list(reversed(chain))

    def children(self, name: str) -> List[Construct]:
        return [c for c in self.constructs.values() if c.parent == name]

    def leaves(self) -> List[Construct]:
        return [c for c in self.constructs.values() if not c.is_container()]

    # -- validation (§3.4 step 1) ------------------------------------------------
    def validate(self) -> None:
        self._validate_nesting()
        self._validate_linking()
        self._validate_acyclic()
        self._validate_groupby()
        self._validate_loops()

    def _validate_nesting(self) -> None:
        for c in self.constructs.values():
            seen: Set[str] = set()
            cur = c.parent
            while cur is not None:
                if cur in seen:
                    raise GraphValidationError(
                        f"container cycle at {cur!r}")
                seen.add(cur)
                parent = self.constructs.get(cur)
                if parent is None:
                    raise GraphValidationError(
                        f"{c.name!r} has unknown parent {cur!r}")
                if not parent.is_container():
                    raise GraphValidationError(
                        f"{c.name!r} nested in non-container {cur!r}")
                cur = parent.parent

    def _validate_linking(self) -> None:
        for e in self.edges:
            s, d = self.constructs[e.src], self.constructs[e.dst]
            if s.is_container() or d.is_container():
                raise GraphValidationError(
                    f"edges must connect leaf constructs: {e.src}->{e.dst}")
            if s.kind == d.kind:
                raise GraphValidationError(
                    "linking rule violated (Data<->Component only): "
                    f"{e.src}({s.kind.value}) -> {e.dst}({d.kind.value})")

    def _validate_acyclic(self) -> None:
        # Loop-carried back edges are *not* edges in the LGT (the body is
        # replicated at unroll time), so the LGT must be a DAG outright.
        adj: Dict[str, List[str]] = {n: [] for n in self.constructs}
        for e in self.edges:
            adj[e.src].append(e.dst)
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in adj}

        def dfs(n: str) -> None:
            color[n] = GREY
            for m in adj[n]:
                if color[m] == GREY:
                    raise GraphValidationError(f"cycle detected through {m!r}")
                if color[m] == WHITE:
                    dfs(m)
            color[n] = BLACK

        for n in adj:
            if color[n] == WHITE:
                dfs(n)

    def _validate_groupby(self) -> None:
        """GroupBy must be used in conjunction with nested Scatters (§3.2).

        The structural check (two incoming scatter axes) happens at unroll
        time via ``AxisResolver``, because GroupBy may be spelled either
        nested inside the Scatters or as a sibling consuming their flow.
        Here we only check it is not a root with no flow at all.
        """
        for c in self.constructs.values():
            if c.kind is not Kind.GROUPBY:
                continue
            inside = {x.name for x in self.constructs.values()
                      if self._inside(x.name, c.name)}
            has_in = any(e.dst in inside and e.src not in inside
                         for e in self.edges)
            nested = any(a.kind is Kind.SCATTER
                         for a in self.ancestors(c.name))
            if not has_in and not nested:
                raise GraphValidationError(
                    f"GroupBy {c.name!r} requires nested Scatter constructs "
                    "or incoming scattered flow")

    def _inside(self, leaf: str, container: str) -> bool:
        cur = self.constructs[leaf].parent
        while cur is not None:
            if cur == container:
                return True
            cur = self.constructs[cur].parent
        return False

    def _validate_loops(self) -> None:
        for c in self.constructs.values():
            if c.kind is Kind.LOOP and c.num_of_iterations < 1:
                raise GraphValidationError(
                    f"Loop {c.name!r} needs num_of_iterations >= 1")
            if (c.loop_entry or c.loop_exit):
                if c.kind is not Kind.DATA:
                    raise GraphValidationError(
                        f"loop_entry/exit only valid on Data: {c.name!r}")
                anc = self.ancestors(c.name)
                if not any(a.kind is Kind.LOOP for a in anc):
                    raise GraphValidationError(
                        f"{c.name!r} marked loop-carried outside a Loop")

    # -- Select & Parametrise (§3.3) -----------------------------------------
    def parametrise(self, **values: Any) -> "LogicalGraph":
        """Fill user parameters -> LogicalGraph.

        Parameters are referenced by constructs via ``params`` entries of the
        form ``{"$param": "<name>"}`` or by the template-level defaults.
        """
        unknown = set(values) - set(self.parameters)
        if unknown:
            raise GraphValidationError(
                f"unknown parameters {sorted(unknown)}; "
                f"template declares {sorted(self.parameters)}")
        resolved = {**self.parameters, **values}
        lg = LogicalGraph(
            name=self.name, version=self.version,
            constructs={k: copy.deepcopy(v)
                        for k, v in self.constructs.items()},
            edges=list(self.edges), parameters=resolved)
        for c in lg.constructs.values():
            for attr in ("num_of_copies", "num_of_inputs",
                         "num_of_iterations", "data_volume",
                         "execution_time"):
                v = c.params.get(f"${attr}")
                if isinstance(v, str):
                    if v not in resolved:
                        raise GraphValidationError(
                            f"{c.name!r} references undefined parameter {v!r}")
                    setattr(c, attr, resolved[v])
        lg.validate()
        return lg

    # -- serialisation ---------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "version": self.version,
            "constructs": [c.to_json() for c in self.constructs.values()],
            "edges": [e.to_json() for e in self.edges],
            "parameters": self.parameters,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "LogicalGraphTemplate":
        lgt = cls(name=d["name"], version=d.get("version", "0"),
                  parameters=d.get("parameters", {}))
        for cd in d["constructs"]:
            lgt.add(Construct.from_json(cd))
        for ed in d["edges"]:
            lgt.edges.append(LogicalEdge.from_json(ed))
        return lgt


class LogicalGraph(LogicalGraphTemplate):
    """An LGT with all parameters bound (paper §3.3)."""
