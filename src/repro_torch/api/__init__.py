"""repro_torch.api — the typed public surface of the port: `MergeSpec`
(what to resolve) and `Replica` (a replica's lifecycle). Attribute
access is lazy, so low-level modules can import `api.spec` without the
facade."""
from typing import Any

__all__ = ["MergeSpec", "Replica", "SpecError", "EngineCache"]


def __getattr__(name: str) -> Any:
    if name in ("MergeSpec", "SpecError"):
        from repro_torch.api import spec
        return getattr(spec, name)
    if name == "Replica":
        from repro_torch.api.replica import Replica
        return Replica
    if name == "EngineCache":
        from repro_torch.core.engine import EngineCache
        return EngineCache
    raise AttributeError(
        f"module 'repro_torch.api' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)

# detcheck tier manifest (docs/ANALYSIS.md):
# spec encoding/digests feed cache keys and gossip
DETCHECK_TIER = "deterministic"
