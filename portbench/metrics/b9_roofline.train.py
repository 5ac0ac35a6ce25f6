"""B9's share of its roofline in training: the operation bounds of its
forward launches and of its gradient's calls (visible causal pairs at
989 TFLOP/s bf16) over the traced device time of both. Every launch of
a training step has the microbatch's shape; silent without B9."""
from portbench import peaks

FORWARD = ("flash_kernel",)
BACKWARD = ("bwd_dkdv", "bwd_dq", "bwd_dot")


def read(view):
    t = view.trace
    shape = view.facts.get("b9_shape")
    if t is None or shape is None:
        return None
    fwd = [o for o in t.ops if any(k in o.name for k in FORWARD)
           and "decode" not in o.name]
    bwd = [o for o in t.ops if any(k in o.name for k in BACKWARD)]
    calls = len([o for o in bwd if "bwd_dkdv" in o.name])
    if not fwd and not bwd:
        return None
    bound_ms = len(fwd) * peaks.flops_ms(peaks.b9_forward_flops(*shape)) \
        + calls * peaks.flops_ms(peaks.b9_backward_flops(*shape))
    return 100.0 * bound_ms / (sum(o.ns for o in fwd + bwd) / 1e6)
