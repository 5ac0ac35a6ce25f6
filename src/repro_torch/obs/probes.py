"""CRDT-specific probes (`repro.obs.probes`): Layer-1 overhead,
convergence, wire phases.

  * `layer1_timer` / `observe_layer1` feed `resolve_layer1_overhead_ms`.
    Layer-1 work is the CRDT-side slice of a resolve: canonical
    ordering, Merkle root, seed derivation — everything *except* the
    strategy math. The paper claims this stays under 0.5 ms.
  * `ConvergenceProbe` watches a fleet's Merkle roots:
    `probe_root_divergence` is (#distinct roots − 1), so 0 means the
    fleet agrees; `probe_replica_diverged{node=...}` flags stragglers;
    `probe_convergence_seconds` times each divergence episode on the
    clock the caller gives (a round counter under simulation, so the
    number is a property of the schedule, not the host).
  * `wire_phase` maps a wire message type to its anti-entropy session
    phase (digest exchange -> manifest/plan -> chunk transfer -> close),
    the label on `sync_wire_bytes_total` / `sync_wire_frames_total`.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from .metrics import default_registry, enabled, MetricsRegistry

__all__ = ["wire_phase", "WIRE_PHASES", "observe_layer1", "layer1_timer",
           "ConvergenceProbe"]


# Anti-entropy session phases, in protocol order.
WIRE_PHASES: Tuple[str, ...] = ("gossip", "digest", "plan", "transfer",
                                "close", "control")

_PHASE_BY_TYPE: Dict[str, str] = {
    # full-state / delta gossip payloads
    "StateMsg": "gossip", "DeltaMsg": "gossip",
    # digest exchange: root comparison + bucket walk
    "SyncReq": "digest", "BucketsMsg": "digest",
    "BucketItemsMsg": "digest",
    "HaveReq": "digest", "HaveMap": "digest",
    # transfer planning: what exists, where, in which chunks
    "BlobManifest": "plan",
    # bulk payload movement
    "BlobReq": "transfer", "BlobResp": "transfer",
    "ChunkReq": "transfer", "ChunkData": "transfer",
    # session close + out-of-band control
    "SyncDone": "close", "ResolveSpecMsg": "control",
}


def wire_phase(msg_or_name: Any) -> str:
    """Session phase for a wire message (instance or class name)."""
    name = msg_or_name if isinstance(msg_or_name, str) \
        else type(msg_or_name).__name__
    return _PHASE_BY_TYPE.get(name, "control")


# ---------------------------------------------------------------------------
# Layer-1 overhead
# ---------------------------------------------------------------------------


def observe_layer1(ms: float,
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Record one Layer-1 overhead measurement (milliseconds)."""
    reg = registry if registry is not None else default_registry()
    reg.histogram("resolve_layer1_overhead_ms").observe(ms)


class layer1_timer:
    """`with layer1_timer(registry): <order+root+seed>` — times the
    block on the wall-monotonic clock and feeds the overhead histogram
    of `registry` (the process default without one). When obs is
    disabled and no registry is given, `__enter__` skips the clock read
    entirely."""

    __slots__ = ("_registry", "_t0", "ms")

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry
        self._t0: Optional[float] = None
        self.ms: Optional[float] = None

    def __enter__(self) -> "layer1_timer":
        if self._registry is not None or enabled():
            # detcheck: allow[DET001] telemetry-only; feeds obs only
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._t0 is None or exc_type is not None:
            return
        # detcheck: allow[DET001] telemetry-only; feeds obs only
        self.ms = (time.perf_counter() - self._t0) * 1e3
        observe_layer1(self.ms, self._registry)


class ConvergenceProbe:
    """Tracks Merkle-root agreement across a set of replicas.

    Feed it `observe({node_id: root_hex})` whenever fleet state may
    have changed (e.g. once per gossip round). It maintains the
    divergence gauges and, across a divergence episode, one interval on
    the supplied clock (required: the port reads no clock of its own
    here):

    >>> reg = MetricsRegistry()
    >>> clk = iter(range(100))
    >>> p = ConvergenceProbe(registry=reg, clock=clk.__next__)
    >>> p.observe({"a": "r1", "b": "r1"})   # agree: no episode
    True
    >>> p.observe({"a": "r1", "b": "r2"})   # diverge at t=1
    False
    >>> reg.gauge("probe_root_divergence").value()
    1.0
    >>> p.observe({"a": "r2", "b": "r2"})   # re-agree at t=2
    True
    >>> reg.histogram("probe_convergence_seconds").count()
    1
    >>> p.episodes
    [(1, 2)]
    """

    __slots__ = ("registry", "clock", "_diverged_at", "episodes")

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 clock: Callable[[], float]):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.clock = clock
        self._diverged_at: Optional[float] = None
        self.episodes: list = []        # closed (t_diverge, t_converge)

    def observe(self, roots: Dict[str, str]) -> bool:
        """Record one fleet observation; returns True if converged."""
        reg = self.registry
        distinct = set(roots.values())
        reg.gauge("probe_root_divergence").set(max(0, len(distinct) - 1))
        if len(distinct) <= 1:
            plurality = next(iter(distinct), None)
        else:
            counts: Dict[str, int] = {}
            for r in roots.values():
                counts[r] = counts.get(r, 0) + 1
            # deterministic tie-break: count desc, then root hex
            plurality = min(counts, key=lambda r: (-counts[r], r))
        for node, root in sorted(roots.items()):
            reg.gauge("probe_replica_diverged").set(
                0.0 if root == plurality else 1.0, node=node)
        converged = len(distinct) <= 1
        now = self.clock()
        if not converged and self._diverged_at is None:
            self._diverged_at = now
        elif converged and self._diverged_at is not None:
            dt = now - self._diverged_at
            reg.histogram("probe_convergence_seconds").observe(dt)
            self.episodes.append((self._diverged_at, now))
            self._diverged_at = None
        return converged

    @property
    def diverged(self) -> bool:
        return self._diverged_at is not None
