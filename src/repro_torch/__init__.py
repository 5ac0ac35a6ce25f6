"""repro_torch — the PyTorch/CUDA port of `repro`, for one NVIDIA H100.

The same two-layer architecture: an OR-Set CRDT over content-addressed
contributions (Layer 1), and deterministic strategy execution through
a planner/executor engine (Layer 2), whose fused batches run on
hand-written CUDA kernels. It imports nothing of `repro` and no JAX;
ids, Merkle roots, seeds, spec encodings and sub-roots are byte-equal
to the reference's, so replicas of the two packages name the same
things the same way.

The public surface is `repro_torch.api` (re-exported here). Entry points
run on CUDA unless the caller passes `device="cpu"`.
"""
from typing import Any

__all__ = ["MergeSpec", "Replica", "SpecError", "EngineCache"]

__version__ = "0.1.0"


def __getattr__(name: str) -> Any:
    if name in __all__:
        from repro_torch import api
        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__ + ["__version__"])

# detcheck tier manifest (docs/ANALYSIS.md):
# SEC surface by default; packages opt out explicitly
DETCHECK_TIER = "deterministic"
