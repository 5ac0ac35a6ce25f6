"""Span tracing with explicit, pluggable clocks (a copy of
`repro.obs.trace`, which imports no JAX).

A `Tracer` records nested spans — named intervals with attributes and
a parent chain — into an in-memory list that an exporter can
write as JSONL. The clock is injected, not assumed:

  * the default is `time.monotonic`;
  * a virtual clock (`clock=lambda: sim.clock`) makes the same schedule
    produce the same trace byte for byte.

Span identity is also deterministic: ids are sequential per tracer
(`s1`, `s2`, …), never random.

There is one process-default tracer slot (`set_tracer` /
`current_tracer`). The module-level `span()` helper is the zero-cost
path: when no tracer is installed — or observability is disabled via
`obs.metrics.set_enabled(False)` — it returns a shared no-op context
manager without allocating.

>>> tr = Tracer(clock=iter(range(10)).__next__)   # fake clock: 0,1,2,...
>>> with tr.span("resolve", strategy="slerp") as sp:
...     with tr.span("plan"):
...         pass
>>> [ (s.name, s.t0, s.t1, s.parent_id) for s in tr.spans ]
[('plan', 1, 2, 's1'), ('resolve', 0, 3, None)]
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from .metrics import enabled

__all__ = ["Span", "Tracer", "NULL_TRACER", "set_tracer",
           "current_tracer", "span"]


class Span:
    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "attrs")

    def __init__(self, span_id: str, parent_id: Optional[str],
                 name: str, t0: float, attrs: Dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs

    @property
    def duration(self) -> float:
        if self.t1 is None:
            raise ValueError(f"span {self.name!r} not finished")
        return self.t1 - self.t0

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_event(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": "span", "id": self.span_id,
                             "name": self.name, "t0": self.t0,
                             "t1": self.t1}
        if self.parent_id is not None:
            d["parent"] = self.parent_id
        if self.attrs:
            d["attrs"] = dict(sorted(self.attrs.items()))
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, t0={self.t0}, t1={self.t1}, "
                f"attrs={self.attrs})")


class _ActiveSpan:
    """Context-manager handle pairing a Span with its tracer."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def set(self, **attrs: Any) -> "_ActiveSpan":
        self.span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_ActiveSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.span.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self.span)


class Tracer:
    """Collects completed spans in end order (a child always precedes
    its parent, as in the module example). `clock` is any zero-arg
    callable returning a float."""

    __slots__ = ("clock", "spans", "_stack", "_next_id", "meta")

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 **meta: Any):
        self.clock = clock
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self._next_id = 0
        self.meta = meta          # stamped on export (node id, seed, …)

    def span(self, name: str, **attrs: Any) -> _ActiveSpan:
        self._next_id += 1
        parent = self._stack[-1].span_id if self._stack else None
        sp = Span(f"s{self._next_id}", parent, name, self.clock(), attrs)
        self._stack.append(sp)
        return _ActiveSpan(self, sp)

    def _finish(self, sp: Span) -> None:
        sp.t1 = self.clock()
        # tolerate out-of-order exits (generators, manual __exit__)
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        elif sp in self._stack:
            self._stack.remove(sp)
        self.spans.append(sp)

    def events(self) -> List[Dict[str, Any]]:
        return [s.to_event() for s in self.spans]

    def clear(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self._next_id = 0


class _NullSpanHandle:
    __slots__ = ()
    span = None

    def set(self, **attrs: Any) -> "_NullSpanHandle":
        return self

    def __enter__(self) -> "_NullSpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullSpanHandle()


class _NullTracer:
    __slots__ = ()
    spans: List[Span] = []
    meta: Dict[str, Any] = {}

    def span(self, name: str, **attrs: Any) -> _NullSpanHandle:
        return _NULL_SPAN

    def events(self) -> List[Dict[str, Any]]:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = _NullTracer()

_TRACER: Any = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or with None, remove) the process-default tracer used
    by the module-level `span()` helper. Returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def current_tracer() -> Any:
    """The installed tracer, or NULL_TRACER when tracing is off (no
    tracer installed, or obs disabled)."""
    if _TRACER is None or not enabled():
        return NULL_TRACER
    return _TRACER


def span(name: str, **attrs: Any):
    """`with obs.span("engine.plan", leaves=n): ...` — records on the
    default tracer; a shared no-op handle when tracing is off."""
    t = _TRACER
    if t is None or not enabled():
        return _NULL_SPAN
    return t.span(name, **attrs)
