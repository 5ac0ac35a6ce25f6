"""The training step's share of the chip's bf16 peak: the useful flops
of a step (6 x non-embedding parameters x tokens, plus attention's
causal products once forward and twice backward; an SSD's products are
not counted) over the traced steps' mean time (issue to synchronize)
at 989 TFLOP/s."""
from portbench import peaks


def read(view):
    t = view.trace
    if t is None:
        return None
    steps = t.spans_named("step")
    if not steps:
        return None
    mean_s = sum(s.t1 - s.t0 for s in steps) / 1e9 / len(steps)
    return 100.0 * view.facts["step_flops"] / (mean_s
                                              * peaks.BF16_FLOPS_PER_S)
