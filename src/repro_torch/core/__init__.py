"""Layer 1 (OR-Set state, hashing, Merkle roots) and Layer 2 (engine,
resolve) of the port."""

# detcheck tier manifest (docs/ANALYSIS.md):
# Layer-1/2 resolve math must be replica-pure
DETCHECK_TIER = "deterministic"
