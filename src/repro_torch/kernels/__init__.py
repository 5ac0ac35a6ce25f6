"""Hand-written CUDA kernels for the merge engine's flat-batch routes
and the model's attention, each with its plain PyTorch version beside
it (the CPU path and the oracle), and a launch count on each wrapper.

  B1 `nary_accum.nary_accum`   linear family        csrc/nary_accum.cu
  B3 `histogram.block_amax`    histogram-trim TIES  csrc/histogram.cu
  B4 `histogram.block_hist`    histogram-trim TIES  csrc/histogram.cu
  B5 `histogram.ties_block`    histogram-trim TIES  csrc/histogram.cu
  B2 `quant.quant_nary`        int8 linear family   csrc/quant.cu
  B6 `dare.dare_block`         counter-RNG DARE     csrc/dare.cu
  B7 `ties.ties_leaf`          quantile-trim TIES   csrc/ties.cu
  B8 `slerp.slerp_reduce`      two-pass SLERP       csrc/slerp.cu
     `slerp.slerp_combine`
  B9 `flash_attention.flash_attention`  attention of the model's prefill
                               and decode, and the training forward
                               (with its log-sum-exp) csrc/flash_attention.cu
     `flash_attention.flash_attention_backward`  its gradient (dQ, dK,
                               dV), training's backward

The per-leaf entry points over contribution pytrees, as the reference's
`repro.kernels` exports them: `weighted_merge`, `weight_average_merge`,
`task_arithmetic_merge`, `ties_merge`, `slerp_merge`, `dare_merge`; and
`flash_attention`, which the dense model's serving path calls.
"""
from typing import Dict

from repro_torch.kernels import dare as _dare
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import histogram as _histogram
from repro_torch.kernels import nary_accum as _nary_accum
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import slerp as _slerp
from repro_torch.kernels import ties as _ties
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.ops import (  # noqa: F401
    dare_merge, slerp_merge, task_arithmetic_merge, ties_merge,
    weight_average_merge, weighted_merge)

WRAPPERS = {"nary_accum": _nary_accum.nary_accum,
            "block_amax": _histogram.block_amax,
            "block_hist": _histogram.block_hist,
            "ties_block": _histogram.ties_block,
            "quant_nary": _quant.quant_nary,
            "dare_block": _dare.dare_block,
            "ties_leaf": _ties.ties_leaf,
            "slerp_reduce": _slerp.slerp_reduce,
            "slerp_combine": _slerp.slerp_combine,
            "flash_attention": _flash.flash_attention,
            "flash_attention_backward": _flash.flash_attention_backward}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


# detcheck tier manifest (docs/ANALYSIS.md):
# kernel outputs feed merged bytes; launch order never changes them
DETCHECK_TIER = "deterministic"
