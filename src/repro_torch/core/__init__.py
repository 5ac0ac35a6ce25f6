"""Layer 1 (OR-Set state, hashing, Merkle roots) and Layer 2 (engine,
resolve) of the port."""
from repro_torch.core.dotted_vv import DottedVersionVector  # noqa: F401

# detcheck tier manifest (docs/ANALYSIS.md):
# Layer-1/2 resolve math must be replica-pure
DETCHECK_TIER = "deterministic"
