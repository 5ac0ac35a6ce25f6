"""Metrics registry — deterministic, catalog-declared, per-replica.

A copy of `repro.obs.metrics` (which imports no JAX, but the port
imports nothing of `repro`). The catalog is the reference's, name for
name: kinds, labels, buckets and deterministic flags.

Three metric kinds over labeled series:

  * Counter   — monotone float, `inc(n, **labels)`;
  * Gauge     — last-write-wins float, `set/inc/dec`, plus `set_max`
                (high-water marks);
  * Histogram — fixed-boundary buckets + count/sum + a bounded raw
                sample reservoir so quantiles (the p99 < 0.5 ms gate)
                are computable without a streaming sketch.

Every metric name must be declared in `CATALOG` before use. Each
`MetricSpec` also records whether the metric is *deterministic*: a pure
function of the converged contribution set (equal visible sets yield
equal values on every replica, regardless of delivery order).

Every component that owns counters (`EngineCache`, `Replica`,
`DurableStore`) owns a private registry, so two replicas in one process
never alias each other's series. A process-default registry
(`default_registry`) serves the module-level helpers; `set_enabled(False)`
swaps it for a shared `NullRegistry` whose handles do nothing.

>>> reg = MetricsRegistry()
>>> reg.counter("engine_events_total").inc(2, event="hits")
>>> reg.counter("engine_events_total").value(event="hits")
2.0
"""
from __future__ import annotations

import bisect
from collections.abc import MutableMapping
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Tuple

__all__ = [
    "CATALOG", "MetricSpec", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "Counter", "Gauge", "Histogram", "CounterView",
    "declare", "default_registry", "set_enabled", "enabled",
]

LabelKey = Tuple[Tuple[str, str], ...]


class MetricSpec(NamedTuple):
    """One declared metric: its kind, meaning, label axes, and whether
    its final aggregate is deterministic in the converged contribution
    set (vs dependent on delivery schedule or wall clock)."""
    name: str
    kind: str                       # counter | gauge | histogram
    help: str
    labels: Tuple[str, ...] = ()
    deterministic: bool = False
    buckets: Tuple[float, ...] = ()


# The declared catalog: every metric the instrumentation may emit.
# The reference's docs/OBSERVABILITY.md documents each entry;
# MetricsRegistry refuses undeclared names.
CATALOG: Dict[str, MetricSpec] = {}


def declare(name: str, kind: str, help: str, *,  # noqa: A002
            labels: Iterable[str] = (), deterministic: bool = False,
            buckets: Iterable[float] = ()) -> MetricSpec:
    if kind not in ("counter", "gauge", "histogram"):
        raise ValueError(f"unknown metric kind {kind!r}")
    spec = MetricSpec(name, kind, help, tuple(labels), deterministic,
                      tuple(buckets))
    prev = CATALOG.get(name)
    if prev is not None and prev != spec:
        raise ValueError(f"metric {name!r} already declared differently")
    CATALOG[name] = spec
    return spec


# Millisecond and second histogram boundaries (headline quantiles come
# from the sample reservoir).
_MS_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
               25.0, 50.0, 100.0)
_S_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
              10.0, 50.0)

# --------------------------------------------------------------------------
# The catalog: <subsystem>_<what>[_total for counters]; units are
# spelled in the name. Event-family counters use one name + an `event`
# label, which is what lets EngineCache.stats stay a dict-shaped view.
# --------------------------------------------------------------------------

declare("engine_events_total", "counter",
        "Merge-engine executor/cache events (per EngineCache)",
        labels=("event",), deterministic=True)
declare("engine_peak_stacked_bytes", "gauge",
        "High-water mark of stacked contribution bytes live at once",
        deterministic=True)
declare("engine_cache_resident_bytes", "gauge",
        "Bytes of merge outputs resident in the sub-root cache")
declare("engine_plan_leaves", "gauge",
        "Leaf tasks in the most recent merge plan", deterministic=True)
declare("engine_sparse_leaves_skipped", "gauge",
        "Leaves of the most recent plan not touched by every "
        "contribution: partial-subset tasks plus inherit-base leaves",
        deterministic=True)
declare("kernel_dispatch_total", "counter",
        "Kernel-frontier flat-batch dispatches by kernel (nary_accum, "
        "ties_hist, dare, quant_nary) — engine_events_total{event="
        "pallas_dispatches} stays as the all-kernel sum, under the "
        "reference's name",
        labels=("kernel",), deterministic=True)
declare("engine_quant_leaves_merged_total", "counter",
        "Leaves merged directly from int8 wire payloads by the "
        "merge-on-arrival kernel (dequantized in registers; no "
        "densified copy in device memory)", deterministic=True)
declare("resolve_fold_updates_total", "counter",
        "Contributions folded into cached accumulators by prefix-fold "
        "resumption (per EngineCache)", deterministic=True)
declare("resolve_layer1_overhead_ms", "histogram",
        "CRDT-side resolve overhead: gate + canonical order + Merkle "
        "root + seed derivation, per resolve (the paper's <0.5 ms claim)",
        buckets=_MS_BUCKETS)
# The gossip network and ConvergenceProbe record the gossip_* and probe_*
# series; the sync, net, journal, store and repair series are declared
# for the anti-entropy, transport and durability modules (ROADMAP A6).
declare("sync_events_total", "counter",
        "SyncNode protocol events (per node; the former stats dict)",
        labels=("event",))
declare("sync_handle_seconds", "histogram",
        "Time spent in SyncNode.handle per wire message",
        labels=("type",), buckets=_S_BUCKETS)
declare("sync_chunk_windows", "gauge",
        "Chunk-request windows currently outstanding (per node)")
declare("sync_source_pool", "gauge",
        "Multi-source pool size: (eid, peer) source records (per node)")
declare("sync_wire_bytes_total", "counter",
        "Anti-entropy bytes on wire by session phase",
        labels=("phase",))
declare("sync_wire_frames_total", "counter",
        "Anti-entropy frames on wire by session phase",
        labels=("phase",))
declare("net_bytes_total", "counter",
        "Frame bytes sent through a transport, by message type",
        labels=("type",))
declare("net_frames_total", "counter",
        "Frames sent through a transport, by message type",
        labels=("type",))
declare("net_peer_bytes_total", "counter",
        "Frame bytes sent per directed (src, dst) pair",
        labels=("src", "dst"))
declare("net_queue_depth", "gauge",
        "Frames queued in the transport / simulator event loop")
declare("sim_inflight_bytes", "gauge",
        "Bytes in flight in the simulated network")
declare("gossip_rounds_total", "counter",
        "Gossip rounds driven, by protocol",
        labels=("protocol",))
declare("gossip_sends_total", "counter",
        "Directed gossip pushes issued")
declare("gossip_payloads_shipped_total", "counter",
        "Payloads included in gossip pushes (placement said ship)")
declare("gossip_payloads_filtered_total", "counter",
        "Payloads withheld from gossip pushes (placed elsewhere)")
declare("probe_root_divergence", "gauge",
        "Distinct Merkle roots across the probed fleet minus one "
        "(0 = converged)", deterministic=True)
declare("probe_replica_diverged", "gauge",
        "1 while this replica's root differs from the plurality root",
        labels=("node",), deterministic=True)
declare("probe_convergence_seconds", "histogram",
        "Time from first observed root divergence to root equality "
        "(probe clock: virtual under simulation)", buckets=_S_BUCKETS)
declare("launch_events_total", "counter",
        "Structured CLI events emitted by launch/ tools",
        labels=("event",))
declare("journal_events_total", "counter",
        "Durable-store events: appends, fsyncs, replays, snapshots, "
        "compactions, torn-tail repairs (per DurableStore)",
        labels=("event",), deterministic=True)
declare("store_log_bytes", "gauge",
        "Bytes on disk across a DurableStore's blob log + WAL",
        deterministic=True)
declare("repair_events_total", "counter",
        "Replication-repair events on membership change: re-placed "
        "eids, repair fetches, shed blobs (per SyncNode)",
        labels=("event",), deterministic=True)


# ---------------------------------------------------------------------------
# Metric objects
# ---------------------------------------------------------------------------


def _label_key(spec: MetricSpec, labels: Dict[str, str]) -> LabelKey:
    if not labels:
        if spec.labels:
            raise ValueError(f"metric {spec.name!r} requires labels "
                             f"{spec.labels}")
        return ()
    if tuple(sorted(labels)) != tuple(sorted(spec.labels)):
        raise ValueError(f"metric {spec.name!r} takes labels "
                         f"{spec.labels}, got {tuple(labels)}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("spec", "_series")

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        key = _label_key(self.spec, labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._series.get(_label_key(self.spec, labels), 0.0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._series)

    def clear(self) -> None:
        self._series.clear()


class Gauge:
    __slots__ = ("spec", "_series")

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._series[_label_key(self.spec, labels)] = float(value)

    def set_max(self, value: float, **labels: str) -> None:
        """High-water mark: keep the larger of current and `value`."""
        key = _label_key(self.spec, labels)
        cur = self._series.get(key)
        if cur is None or value > cur:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(self.spec, labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        return self._series.get(_label_key(self.spec, labels), 0.0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._series)

    def clear(self) -> None:
        self._series.clear()


class _HistSeries:
    __slots__ = ("count", "sum", "bucket_counts", "samples")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.sum = 0.0
        self.bucket_counts = [0] * (n_buckets + 1)   # +inf tail bucket
        self.samples: List[float] = []


_DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 100.0, 1000.0)
_SAMPLE_CAP = 65536


class Histogram:
    """Fixed-bucket histogram + bounded raw-sample reservoir.

    The reservoir keeps the first `_SAMPLE_CAP` observations;
    `quantile()` reads from it, so p99 is exact rather than
    bucket-interpolated.
    """

    __slots__ = ("spec", "buckets", "_series")

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self.buckets: Tuple[float, ...] = spec.buckets or _DEFAULT_BUCKETS
        self._series: Dict[LabelKey, _HistSeries] = {}

    def _at(self, labels: Dict[str, str]) -> _HistSeries:
        key = _label_key(self.spec, labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets))
        return s

    def observe(self, value: float, **labels: str) -> None:
        s = self._at(labels)
        s.count += 1
        s.sum += value
        s.bucket_counts[bisect.bisect_left(self.buckets, value)] += 1
        if len(s.samples) < _SAMPLE_CAP:
            s.samples.append(value)

    def count(self, **labels: str) -> int:
        key = _label_key(self.spec, labels)
        s = self._series.get(key)
        return s.count if s is not None else 0

    def sum(self, **labels: str) -> float:
        key = _label_key(self.spec, labels)
        s = self._series.get(key)
        return s.sum if s is not None else 0.0

    def quantile(self, q: float, **labels: str) -> float:
        """Exact sample quantile (nearest-rank) from the reservoir."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1]")
        key = _label_key(self.spec, labels)
        s = self._series.get(key)
        if s is None or not s.samples:
            raise ValueError(f"histogram {self.spec.name!r} has no "
                             "samples for these labels")
        ordered = sorted(s.samples)
        rank = max(0, min(len(ordered) - 1,
                          int(q * len(ordered) + 0.5) - 1))
        return ordered[rank]

    def series(self) -> Dict[LabelKey, _HistSeries]:
        return dict(self._series)

    def clear(self) -> None:
        self._series.clear()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_KIND_CLS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """One scope's metrics (a replica, a node, a transport — or the
    process default). Metric handles are created lazily from CATALOG;
    asking for an undeclared name raises, which is what keeps the
    documented catalog honest."""

    __slots__ = ("_metrics",)

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind: str) -> Any:
        m = self._metrics.get(name)
        if m is not None:
            if m.spec.kind != kind:
                raise TypeError(f"metric {name!r} is a {m.spec.kind}, "
                                f"not a {kind}")
            return m
        spec = CATALOG.get(name)
        if spec is None:
            raise KeyError(f"metric {name!r} is not declared in the "
                           "repro_torch.obs catalog")
        if spec.kind != kind:
            raise TypeError(f"metric {name!r} is declared as a "
                            f"{spec.kind}, not a {kind}")
        m = self._metrics[name] = _KIND_CLS[kind](spec)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def metrics(self) -> List[Any]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def clear(self) -> None:
        for m in self._metrics.values():
            m.clear()

    # ------------------------------------------------------------ snapshots

    def snapshot(self) -> Dict[str, float]:
        """Flat, deterministically-keyed view of every series:
        `name{k=v,...}` -> value. Histograms contribute `_count`,
        `_sum`, and per-boundary `_bucket{le=...}` entries."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            name = m.spec.name
            if isinstance(m, Histogram):
                for key, s in sorted(m.series().items()):
                    base = _fmt(name, key)
                    out[base + "_count"] = float(s.count)
                    out[base + "_sum"] = s.sum
                    for b, c in zip(m.buckets, s.bucket_counts):
                        out[_fmt(name + "_bucket",
                                 key + (("le", repr(b)),))] = float(c)
            else:
                for key, v in sorted(m.series().items()):
                    out[_fmt(name, key)] = v
        return out

    def aggregate(self) -> Dict[str, float]:
        """The deterministic slice of the snapshot: only metrics whose
        CATALOG entry is flagged deterministic — the aggregates that
        must be identical on every replica that converged on the same
        contribution set, regardless of delivery order."""
        return {k: v for k, v in self.snapshot().items()
                if CATALOG[_base_name(k)].deterministic}

    def merged(self, *others: "MetricsRegistry") -> Dict[str, float]:
        """Union snapshot across registries (counter/count values sum,
        gauges take the max)."""
        out = dict(self.snapshot())
        for other in others:
            for k, v in other.snapshot().items():
                if k in out:
                    spec = CATALOG[_base_name(k)]
                    out[k] = max(out[k], v) if spec.kind == "gauge" \
                        else out[k] + v
                else:
                    out[k] = v
        return out


def _fmt(name: str, key: LabelKey) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


def _base_name(sample_key: str) -> str:
    name = sample_key.split("{", 1)[0]
    for suffix in ("_bucket", "_count", "_sum"):
        if name.endswith(suffix) and name not in CATALOG:
            trimmed = name[: -len(suffix)]
            if trimmed in CATALOG:
                return trimmed
    return name


# ---------------------------------------------------------------------------
# Counter-backed mapping view (stats-dict compatibility)
# ---------------------------------------------------------------------------


class CounterView(MutableMapping):
    """collections.Counter-shaped read-through view over one labeled
    counter family. `view[k] += n` increments series {label: k}; reads
    of unseen keys return 0, as `collections.Counter` does."""

    __slots__ = ("_counter", "_label")

    def __init__(self, registry: MetricsRegistry, metric: str,
                 label: str = "event"):
        self._counter = registry.counter(metric)
        self._label = label

    def _key(self, k: str) -> LabelKey:
        return ((self._label, k),)

    def __getitem__(self, k: str) -> float:
        v = self._counter._series.get(self._key(k), 0.0)
        return int(v) if float(v).is_integer() else v

    def __setitem__(self, k: str, v: float) -> None:
        cur = self._counter._series.get(self._key(k), 0.0)
        if v < cur:
            raise ValueError(f"counter {k!r} cannot decrease "
                             f"({cur} -> {v})")
        self._counter._series[self._key(k)] = float(v)

    def __delitem__(self, k: str) -> None:
        del self._counter._series[self._key(k)]

    def __iter__(self) -> Iterator[str]:
        return (key[0][1] for key in sorted(self._counter._series))

    def __len__(self) -> int:
        return len(self._counter._series)

    def __contains__(self, k: object) -> bool:
        return isinstance(k, str) and self._key(k) in self._counter._series

    def clear(self) -> None:
        self._counter.clear()

    def __repr__(self) -> str:
        return f"CounterView({dict(self)!r})"


# ---------------------------------------------------------------------------
# Null objects + process default (the zero-cost disabled path)
# ---------------------------------------------------------------------------


class _NullMetric:
    __slots__ = ()

    def inc(self, *a, **k): pass
    def dec(self, *a, **k): pass
    def set(self, *a, **k): pass
    def set_max(self, *a, **k): pass
    def observe(self, *a, **k): pass

    def value(self, **k): return 0.0
    def count(self, **k): return 0
    def sum(self, **k): return 0.0
    def series(self): return {}
    def clear(self): pass


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Registry whose every handle is a shared do-nothing metric: the
    disabled fast path. Call sites keep their shape, and a call costs
    one attribute lookup plus an empty method."""

    __slots__ = ()

    def counter(self, name: str) -> Any: return _NULL_METRIC
    def gauge(self, name: str) -> Any: return _NULL_METRIC
    def histogram(self, name: str) -> Any: return _NULL_METRIC
    def metrics(self): return []
    def clear(self): pass
    def snapshot(self): return {}
    def aggregate(self): return {}
    def merged(self, *others): return {}


NULL_REGISTRY = NullRegistry()

_DEFAULT = MetricsRegistry()
_ENABLED = True


def default_registry() -> Any:
    """The process-default registry, or the shared NullRegistry when
    observability is disabled (`set_enabled(False)`)."""
    return _DEFAULT if _ENABLED else NULL_REGISTRY


def set_enabled(flag: bool) -> bool:
    """Toggle process-level instrumentation (the default registry and
    the module-level span helper). Component-owned registries
    (`EngineCache.obs`, `Replica.obs`, ...) are unaffected: their
    counters are API surface, not optional telemetry. Returns the
    previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


def enabled() -> bool:
    return _ENABLED
