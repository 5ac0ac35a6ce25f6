from repro_torch.sharding.policy import (  # noqa: F401
    AXIS_MAP, resolve_leaf_spec)

# detcheck tier manifest (docs/ANALYSIS.md):
# logical-axis resolution over a mesh's shape; not merge math
DETCHECK_TIER = "environment"
