from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_checkpoint, restore_checkpoint, restore_crdt_state, save_checkpoint,
    save_checkpoint_async, save_crdt_state)

# detcheck tier manifest (docs/ANALYSIS.md):
# filesystem I/O paths and mtimes
DETCHECK_TIER = "environment"
