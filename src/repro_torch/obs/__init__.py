"""repro_torch.obs — deterministic telemetry (the counterpart of
`repro.obs`):

  * `metrics`  — catalog-declared counters/gauges/histograms with
                 labeled series; per-component registries plus a
                 process default with a zero-cost disabled path;
  * `trace`    — nested spans on explicit pluggable clocks;
  * `export`   — JSONL event log, snapshot table, bench-report rows,
                 and the structured CLI `EventLog`;
  * `probes`   — Merkle-root divergence / time-to-convergence probe,
                 Layer-1 overhead histogram (<0.5 ms paper claim),
                 wire-phase attribution for anti-entropy bytes.

Instrumentation is inert: enabling tracing never changes a merged
byte, and identical converged contribution sets produce identical
deterministic aggregates (`MetricsRegistry.aggregate()`) regardless of
delivery order.
"""
from .export import EventLog, render_table, report_rows, to_events, write_jsonl
from .metrics import (
    CATALOG, Counter, CounterView, declare, default_registry, enabled, Gauge,
    Histogram, MetricSpec, MetricsRegistry, NULL_REGISTRY, NullRegistry,
    set_enabled)
from .probes import (
    ConvergenceProbe, layer1_timer, observe_layer1, wire_phase, WIRE_PHASES)
from .trace import current_tracer, NULL_TRACER, set_tracer, Span, span, Tracer

__all__ = [
    "CATALOG", "MetricSpec", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "Counter", "Gauge", "Histogram", "CounterView",
    "declare", "default_registry", "set_enabled", "enabled",
    "Span", "Tracer", "NULL_TRACER", "set_tracer", "current_tracer",
    "span",
    "EventLog", "to_events", "write_jsonl", "render_table", "report_rows",
    "WIRE_PHASES", "wire_phase", "ConvergenceProbe", "layer1_timer",
    "observe_layer1",
]

# detcheck tier manifest (docs/ANALYSIS.md):
# SEC aggregates are convergence evidence; the clock read carries a
# reasoned allow
DETCHECK_TIER = "deterministic"
