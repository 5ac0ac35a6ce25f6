"""repro_torch.obs — the deterministic telemetry the engine and resolve
record through: catalog-declared metrics, spans, the Layer-1 overhead
probe and the convergence probe (the counterpart of `repro.obs`, cut
to what this package uses).

Instrumentation is inert: enabling tracing never changes a merged
byte, and identical converged contribution sets produce identical
values of the metrics the catalog flags deterministic.
"""
from .metrics import (
    CATALOG, Counter, CounterView, Gauge, Histogram, MetricSpec,
    MetricsRegistry)
from .probes import ConvergenceProbe, layer1_timer
from .trace import set_tracer, Span, span, Tracer

__all__ = [
    "CATALOG", "MetricSpec", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "CounterView", "Span", "Tracer", "set_tracer", "span",
    "layer1_timer", "ConvergenceProbe",
]

# detcheck tier manifest (docs/ANALYSIS.md):
# SEC aggregates are convergence evidence; the clock read carries a
# reasoned allow
DETCHECK_TIER = "deterministic"
