import repro_torch.strategies.catalog  # noqa: F401,E402  (fills REGISTRY)
from repro_torch.strategies.base import (  # noqa: F401
    get_strategy, list_strategies, REGISTRY, Strategy)

# detcheck tier manifest (docs/ANALYSIS.md):
# strategy output is a pure fn of ordered contribs + seed
DETCHECK_TIER = "deterministic"
