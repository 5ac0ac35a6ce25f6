"""Layer-1 overhead probe (the part of `repro.obs.probes` the resolve
path records through).

`layer1_timer` feeds `resolve_layer1_overhead_ms`. Layer-1 work is the
CRDT-side slice of a resolve: canonical ordering, Merkle root, seed
derivation — everything *except* the strategy math. The paper claims
this stays under 0.5 ms.
"""
from __future__ import annotations

import time
from typing import Optional

from .metrics import MetricsRegistry

__all__ = ["layer1_timer"]


class layer1_timer:
    """`with layer1_timer(registry): <order+root+seed>` — times the
    block on the wall-monotonic clock and feeds the registry's overhead
    histogram."""

    __slots__ = ("_registry", "_t0", "ms")

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry
        self._t0: Optional[float] = None
        self.ms: Optional[float] = None

    def __enter__(self) -> "layer1_timer":
        # detcheck: allow[DET001] telemetry-only; feeds obs only
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        # detcheck: allow[DET001] telemetry-only; feeds obs only
        self.ms = (time.perf_counter() - self._t0) * 1e3
        self._registry.histogram("resolve_layer1_overhead_ms").observe(
            self.ms)
