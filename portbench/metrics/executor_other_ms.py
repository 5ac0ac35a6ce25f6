"""The executor's device milliseconds a resolve outside the merge
kernels B1 and B3-B5: stacking, casts, the exact path's leaves, the
output's leaves; over the traced resolves."""

MERGE_KERNELS = ("nary_accum_kernel", "block_amax_kernel",
                 "block_hist_kernel", "ties_block_kernel")


def read(view):
    t = view.trace
    if t is None or not t.ops or not t.spans_named("resolve"):
        return None
    ops = t.ops_in("resolve")
    other = [o for o in ops if not any(k in o.name for k in MERGE_KERNELS)]
    return t.busy_ns(other) / 1e6 / len(t.spans_named("resolve"))
