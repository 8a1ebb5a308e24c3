"""Pythonic builder for Logical Graph Templates.

The paper's Logical Graph Editor is a web UI; the programmatic equivalent is
this small DSL.  It builds ``LogicalGraphTemplate`` objects::

    g = GraphBuilder("imaging")
    with g.scatter("by_time", 4):
        ms = g.data("split_ms", volume=1e9)
        with g.scatter("by_chan", 8):
            d = g.data("chan_ms", volume=1e8)
            g.component("degrid", app="identity", time=2.0)
            ...
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from .core.constructs import Construct, Kind
from .core.logical import LogicalGraph, LogicalGraphTemplate


class GraphBuilder:
    def __init__(self, name: str, version: str = "0",
                 parameters: Optional[Dict[str, Any]] = None) -> None:
        self.lgt = LogicalGraphTemplate(name=name, version=version,
                                        parameters=dict(parameters or {}))
        self._stack: List[str] = []

    # -- containers ---------------------------------------------------------
    @contextmanager
    def scatter(self, name: str, num_of_copies: int = 1,
                **params: Any) -> Iterator[Construct]:
        c = self.lgt.add(Construct(
            name=name, kind=Kind.SCATTER, num_of_copies=num_of_copies,
            parent=self._parent(), params=params))
        self._stack.append(name)
        try:
            yield c
        finally:
            self._stack.pop()

    @contextmanager
    def gather(self, name: str, num_of_inputs: int = 1,
               **params: Any) -> Iterator[Construct]:
        c = self.lgt.add(Construct(
            name=name, kind=Kind.GATHER, num_of_inputs=num_of_inputs,
            parent=self._parent(), params=params))
        self._stack.append(name)
        try:
            yield c
        finally:
            self._stack.pop()

    @contextmanager
    def group_by(self, name: str, **params: Any) -> Iterator[Construct]:
        c = self.lgt.add(Construct(
            name=name, kind=Kind.GROUPBY, parent=self._parent(),
            params=params))
        self._stack.append(name)
        try:
            yield c
        finally:
            self._stack.pop()

    @contextmanager
    def loop(self, name: str, num_of_iterations: int = 1,
             **params: Any) -> Iterator[Construct]:
        c = self.lgt.add(Construct(
            name=name, kind=Kind.LOOP,
            num_of_iterations=num_of_iterations,
            parent=self._parent(), params=params))
        self._stack.append(name)
        try:
            yield c
        finally:
            self._stack.pop()

    # -- leaves ---------------------------------------------------------------
    def data(self, name: str, volume: float = 0.0,
             payload: str = "memory", loop_entry: bool = False,
             loop_exit: bool = False, carries: Optional[str] = None,
             **params: Any) -> Construct:
        if carries:
            params["carries"] = carries
        return self.lgt.add(Construct(
            name=name, kind=Kind.DATA, data_volume=volume,
            payload_kind=payload, parent=self._parent(),
            loop_entry=loop_entry, loop_exit=loop_exit, params=params))

    def component(self, name: str, app: str, time: float = 0.0,
                  error_threshold: float = 0.0,
                  **params: Any) -> Construct:
        return self.lgt.add(Construct(
            name=name, kind=Kind.COMPONENT, app=app, execution_time=time,
            error_threshold=error_threshold, parent=self._parent(),
            params=params))

    # -- wiring -------------------------------------------------------------------
    def connect(self, src: str, dst: str, streaming: bool = False) -> None:
        self.lgt.connect(src, dst, streaming)

    def chain(self, *names: str) -> None:
        for a, b in zip(names, names[1:]):
            self.connect(a, b)

    def _parent(self) -> Optional[str]:
        return self._stack[-1] if self._stack else None

    # -- finish ----------------------------------------------------------------------
    def template(self) -> LogicalGraphTemplate:
        self.lgt.validate()
        return self.lgt

    def graph(self, **values: Any) -> LogicalGraph:
        return self.lgt.parametrise(**values)
