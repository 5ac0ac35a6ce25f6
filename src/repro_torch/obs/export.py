"""Exporters (`repro.obs.export`, which imports no JAX; the port keeps
its own copy): JSONL event log, snapshot table, bench-report adapter,
and the structured CLI event stream.

All exporters share one event vocabulary (dicts with a `kind` key):

  * `{"kind": "meta", ...}`        — one header line per JSONL file;
  * `{"kind": "span", ...}`        — from `Tracer.events()`;
  * `{"kind": "metric", "name", "value"}` — from a registry snapshot;
  * `{"kind": "event", "event", ...}`      — CLI / launch events.

JSONL lines are written with sorted keys and no whitespace so a
deterministic run (a virtual clock, sequential span ids) produces a
byte-identical trace file, equal to the reference's for equal events.
"""
from __future__ import annotations

import io
import json
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import MetricsRegistry
from .trace import Tracer

__all__ = ["to_events", "write_jsonl", "render_table", "report_rows",
           "EventLog"]


def _dump(obj: Dict[str, Any]) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def to_events(*, tracer: Optional[Tracer] = None,
              registry: Optional[MetricsRegistry] = None,
              meta: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    """Flatten a tracer and/or registry into the shared event stream."""
    events: List[Dict[str, Any]] = []
    header: Dict[str, Any] = {"kind": "meta"}
    if tracer is not None and getattr(tracer, "meta", None):
        header.update(tracer.meta)
    if meta:
        header.update(meta)
    if len(header) > 1:
        events.append(header)
    if tracer is not None:
        events.extend(tracer.events())
    if registry is not None:
        for name, value in registry.snapshot().items():
            events.append({"kind": "metric", "name": name, "value": value})
    return events


def write_jsonl(path: str, events: Iterable[Dict[str, Any]]) -> int:
    """Write events one-JSON-object-per-line; returns the line count."""
    n = 0
    with open(path, "w", encoding="utf-8") as fh:
        for ev in events:
            fh.write(_dump(ev))
            fh.write("\n")
            n += 1
    return n


def render_table(snapshot: Dict[str, float], title: str = "metrics") -> str:
    """Human-readable two-column snapshot table (fixed-width text)."""
    if not snapshot:
        return f"{title}: (empty)\n"
    keys = sorted(snapshot)
    width = max(len(k) for k in keys)
    lines = [f"{title}", "-" * max(len(title), width + 14)]
    for k in keys:
        v = snapshot[k]
        sval = f"{int(v)}" if float(v).is_integer() else f"{v:.6g}"
        lines.append(f"{k:<{width}}  {sval:>12}")
    return "\n".join(lines) + "\n"


def report_rows(snapshot: Dict[str, float],
                prefix: str = "") -> List[Tuple[str, float, str]]:
    """Adapter to a benchmark report's row shape: (name, value, note).
    The note column carries the unit inferred from the metric name."""
    rows: List[Tuple[str, float, str]] = []
    for name in sorted(snapshot):
        if prefix and not name.startswith(prefix):
            continue
        note = ""
        base = name.split("{", 1)[0]
        if base.endswith("_bytes") or base.endswith("_bytes_total"):
            note = "bytes"
        elif "_seconds" in base:
            note = "s"
        elif "_ms" in base:
            note = "ms"
        elif base.endswith("_total"):
            note = "count"
        rows.append((name, snapshot[name], note))
    return rows


class EventLog:
    """Structured stdout events for command-line tools.

    Every event has a name and fields, and carries the exact legacy
    stdout line as `text`. Verbosity:

      * quiet (-1): nothing on stdout;
      * default (0): print `text` exactly, byte for byte;
      * verbose (1): print the JSON event line instead.

    Independently of verbosity every event is appended to `.events`
    (and counted on `registry` when one is given), so `--quiet` still
    leaves a machine-readable record to export.
    """

    __slots__ = ("verbosity", "events", "registry", "stream")

    def __init__(self, verbosity: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 stream: Optional[io.TextIOBase] = None):
        self.verbosity = verbosity
        self.events: List[Dict[str, Any]] = []
        self.registry = registry
        self.stream = stream if stream is not None else sys.stdout

    @classmethod
    def from_args(cls, args: Any,
                  registry: Optional[MetricsRegistry] = None) -> "EventLog":
        """Build from argparse args with `quiet` / `verbose` booleans."""
        v = 0
        if getattr(args, "verbose", False):
            v = 1
        if getattr(args, "quiet", False):
            v = -1
        return cls(v, registry)

    def emit(self, event: str, text: str, **fields: Any) -> None:
        ev = {"kind": "event", "event": event, "text": text}
        ev.update(fields)
        self.events.append(ev)
        if self.registry is not None:
            self.registry.counter("launch_events_total").inc(event=event)
        if self.verbosity >= 1:
            print(_dump(ev), file=self.stream, flush=True)
        elif self.verbosity == 0:
            print(text, file=self.stream, flush=True)

    def dump(self, path: str) -> int:
        return write_jsonl(path, self.events)
