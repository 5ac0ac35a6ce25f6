"""The rest of the port's telemetry (`repro_torch.obs`) against the
reference (`repro.obs`).

Exact throughout (dict, string and file-byte equality):
  * the same op sequence on a registry gives equal `snapshot()`,
    `aggregate()` and `merged()` in both packages, histograms and
    labels included; two replicas resolving the same contributions
    give equal deterministic aggregates across the packages;
  * `NullRegistry`, `default_registry`, `set_enabled` / `enabled`,
    `current_tracer` and the module-level `span` / `layer1_timer` /
    `observe_layer1` when disabled and enabled;
  * `render_table`, `report_rows`, `to_events`, `write_jsonl` and
    `EventLog` give the reference's output for equal inputs;
  * `wire_phase` gives the reference's phase for every message type;
  * `Replica.metrics` and `Replica.trace_to` work, and the trace file
    has the reference's shape.
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as J  # noqa: E402
from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.api import Replica as JReplica  # noqa: E402
from repro.net import wire as W  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as P  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402

torch.set_num_threads(1)


def _ops(obs):
    """One op sequence on a registry of either package."""
    reg = obs.MetricsRegistry()
    reg.counter("engine_events_total").inc(2, event="hits")
    reg.counter("engine_events_total").inc(event="misses")
    reg.counter("kernel_dispatch_total").inc(3, kernel="nary_accum")
    reg.gauge("store_log_bytes").set(4096.0)
    reg.gauge("probe_replica_diverged").set(1.0, node="b")
    reg.gauge("probe_replica_diverged").set(0.0, node="a")
    h = reg.histogram("resolve_layer1_overhead_ms")
    for v in (0.01, 0.2, 0.3, 7.5, 120.0):
        h.observe(v)
    reg.histogram("probe_convergence_seconds").observe(3.0)
    return reg


def test_snapshot_aggregate_merged_equal():
    a_p, a_j = _ops(P), _ops(J)
    assert a_p.snapshot() == a_j.snapshot()
    assert a_p.aggregate() == a_j.aggregate()
    assert a_p.aggregate() and a_p.aggregate() != a_p.snapshot()
    b_p, b_j = P.MetricsRegistry(), J.MetricsRegistry()
    for b in (b_p, b_j):
        b.counter("engine_events_total").inc(5, event="hits")
        b.gauge("store_log_bytes").set(10.0)
    assert a_p.merged(b_p) == a_j.merged(b_j)
    m = a_p.merged(b_p)
    assert m["engine_events_total{event=hits}"] == 7.0
    assert m["store_log_bytes"] == 4096.0


def test_replicas_give_equal_deterministic_aggregates():
    """The gate of the telemetry port: the same contributions resolved
    on a replica of each package give equal deterministic aggregates
    (engine counters, cache events)."""
    rng = np.random.default_rng(3)
    trees = [{"w": rng.standard_normal((8, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
             for _ in range(3)]
    rp, rj = Replica("x", device="cpu"), JReplica("x")
    for t in trees:
        rp.contribute(convert.from_numpy_tree(t, "cpu"))
        rj.contribute(t)
    for _ in range(2):                     # a miss, then a cache hit
        rp.resolve(MergeSpec("weight_average"))
        rj.resolve(JSpec("weight_average"))
    got = rp.metrics(deterministic_only=True)
    assert got and got == rj.metrics(deterministic_only=True)


def test_null_registry_and_set_enabled():
    assert P.enabled()
    assert isinstance(P.default_registry(), P.MetricsRegistry)
    tracer = P.Tracer(clock=iter(range(10)).__next__)
    prev_tracer = P.set_tracer(tracer)
    prev = P.set_enabled(False)
    try:
        assert prev is True and not P.enabled()
        reg = P.default_registry()
        assert reg is P.NULL_REGISTRY and isinstance(reg, P.NullRegistry)
        reg.counter("anything").inc(5, event="x")
        reg.histogram("h").observe(1.0)
        assert reg.snapshot() == reg.aggregate() == reg.merged() == {}
        assert reg.counter("c").value() == 0.0 and reg.metrics() == []
        assert P.current_tracer() is P.NULL_TRACER
        with P.span("engine.plan") as sp:
            assert sp.span is None
        with P.layer1_timer() as t:
            pass
        assert t.ms is None                # no clock read at all
        P.observe_layer1(1.0)              # lands in the null registry
    finally:
        P.set_enabled(prev)
        P.set_tracer(prev_tracer)
    assert tracer.spans == []
    P.set_tracer(tracer)
    try:
        assert P.current_tracer() is tracer
        with P.span("engine.plan", leaves=3):
            pass
    finally:
        P.set_tracer(prev_tracer)
    assert [s.name for s in tracer.spans] == ["engine.plan"]
    reg = P.MetricsRegistry()
    with P.layer1_timer(reg) as t:
        pass
    assert t.ms is not None
    assert reg.histogram("resolve_layer1_overhead_ms").count() == 1


def test_render_table_and_report_rows_equal():
    snap = _ops(P).snapshot()
    assert snap == _ops(J).snapshot()
    assert P.render_table(snap, "t") == J.render_table(snap, "t")
    assert P.render_table({}) == J.render_table({})
    for prefix in ("", "resolve_", "store_"):
        assert P.report_rows(snap, prefix) == J.report_rows(snap, prefix)


def _traced(obs):
    tr = obs.Tracer(clock=iter(range(100)).__next__, node="a", seed=7)
    with tr.span("resolve", strategy="slerp") as sp:
        with tr.span("plan"):
            pass
        sp.set(leaves=4)
    try:
        with tr.span("execute"):
            raise RuntimeError
    except RuntimeError:
        pass
    return tr


def test_to_events_and_write_jsonl_byte_equal(tmp_path):
    ev_p = P.to_events(tracer=_traced(P), registry=_ops(P),
                       meta={"run": 1})
    ev_j = J.to_events(tracer=_traced(J), registry=_ops(J),
                       meta={"run": 1})
    assert ev_p == ev_j
    assert P.write_jsonl(str(tmp_path / "p.jsonl"), ev_p) == \
        J.write_jsonl(str(tmp_path / "j.jsonl"), ev_j) == len(ev_p)
    assert (tmp_path / "p.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    assert P.to_events() == J.to_events() == []


@pytest.mark.parametrize("verbosity", [-1, 0, 1])
def test_event_log_equal(verbosity, tmp_path):
    outs = []
    for obs in (P, J):
        buf = io.StringIO()
        reg = obs.MetricsRegistry()
        log = obs.EventLog(verbosity, reg, stream=buf)
        log.emit("merge_done", "merged 3 contributions", n=3)
        log.emit("serve_done", "served", tokens=32)
        log.dump(str(tmp_path / f"{obs.__name__}.jsonl"))
        outs.append((buf.getvalue(), log.events, reg.snapshot(),
                     (tmp_path / f"{obs.__name__}.jsonl").read_bytes()))
    assert outs[0] == outs[1]


def test_event_log_from_args():
    class A:
        quiet, verbose = False, True
    assert P.EventLog.from_args(A()).verbosity == 1
    A.quiet = True
    assert P.EventLog.from_args(A()).verbosity == -1


def test_wire_phase_equal_for_every_message_type():
    assert P.WIRE_PHASES == J.WIRE_PHASES
    for cls in list(W.MESSAGE_TYPES.values()) + [str]:
        name = cls.__name__
        assert P.wire_phase(name) == J.wire_phase(name), name
    from repro_torch.net import wire as PW
    msg = PW.SyncDone("a", 1, PW.VersionVector())
    assert P.wire_phase(msg) == "close"
    assert P.wire_phase("NoSuchMsg") == "control"


def test_replica_metrics_and_trace_to(tmp_path):
    """`metrics()` merges the replica's and an injected cache's
    registries; `trace_to` writes a meta line, the process tracer's
    spans and one line per metric, in the reference's shape."""
    from repro_torch.core.engine import EngineCache
    rng = np.random.default_rng(4)
    trees = [{"w": rng.standard_normal((4, 4)).astype(np.float32)}
             for _ in range(2)]
    rep = Replica("tr", device="cpu", cache=EngineCache())
    for t in trees:
        rep.contribute(convert.from_numpy_tree(t, "cpu"))
    rep.obs.counter("engine_events_total").inc(event="mine")
    tracer = P.Tracer(clock=iter(range(1000)).__next__)
    prev = P.set_tracer(tracer)
    try:
        rep.resolve(MergeSpec("weight_average"))
        n = rep.trace_to(str(tmp_path / "t.jsonl"))
    finally:
        P.set_tracer(prev)
    m = rep.metrics()
    assert m["engine_events_total{event=mine}"] == 1.0
    assert any(k.startswith("engine_events_total{event=misses")
               for k in m)                 # from the injected cache
    lines = [json.loads(x) for x in
             (tmp_path / "t.jsonl").read_text().splitlines()]
    assert len(lines) == n == 1 + len(tracer.spans) + len(m)
    assert lines[0] == {"kind": "meta", "node": "tr"}
    assert [x["kind"] for x in lines[1:1 + len(tracer.spans)]] == \
        ["span"] * len(tracer.spans)
    assert {x["name"]: x["value"] for x in lines
            if x["kind"] == "metric"} == m
    rep.trace_to(str(tmp_path / "u.jsonl"))   # tracing off: no spans
    kinds = [json.loads(x)["kind"] for x in
             (tmp_path / "u.jsonl").read_text().splitlines()]
    assert "span" not in kinds
