from repro_torch.train.serve import (  # noqa: F401
    greedy_decode, make_decode_step, make_prefill)
from repro_torch.train.step import (  # noqa: F401
    init_train_state, make_train_step, train_state_shapes)

# detcheck tier manifest (docs/ANALYSIS.md):
# training and serving loops drive the model from the host; they time
# themselves and pick run seeds; not on the resolve path
DETCHECK_TIER = "environment"
