"""Device milliseconds a training step in kernels whose names mark them
elementwise or reductions (the frozen patterns below), over the traced
steps."""

PATTERNS = ("elementwise", "reduce_kernel", "Reduce", "softmax", "SoftMax",
            "CatArray", "index", "scatter", "gather", "fill", "copy")


def read(view):
    t = view.trace
    if t is None or not t.ops:
        return None
    steps = t.spans_named("step")
    if not steps:
        return None
    ops = [o for o in t.ops if any(p in o.name for p in PATTERNS)]
    return sum(o.ns for o in ops) / 1e6 / len(steps)
