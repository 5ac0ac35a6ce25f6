from repro_torch.optim.adamw import (  # noqa: F401
    adamw_update, init_opt_state, lr_schedule)

# detcheck tier manifest (docs/ANALYSIS.md):
# pure update math; nothing here may draw entropy
DETCHECK_TIER = "deterministic"
