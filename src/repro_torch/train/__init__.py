from repro_torch.train.serve import (  # noqa: F401
    greedy_decode, make_decode_step, make_prefill)

# detcheck tier manifest (docs/ANALYSIS.md):
# serving loops drive the model from the host; not on the resolve path
DETCHECK_TIER = "environment"
