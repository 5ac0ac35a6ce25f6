"""B1 and B3-B5's share of their roofline: the byte bounds of the calls
the engine made into them (each input and output once, at 3.35 TB/s),
over their traced device time. Silent when the calls recorded and the
kernels traced do not pair up."""
from portbench import peaks

BYTES = {"ties_batch": peaks.ties_hist_bytes,
         "nary_batch": peaks.nary_accum_bytes}
KERNELS = {"ties_batch": ("block_amax_kernel", "block_hist_kernel",
                          "ties_block_kernel"),
           "nary_batch": ("nary_accum_kernel",)}


def read(view):
    t = view.trace
    if t is None:
        return None
    bound_ms = time_ms = 0.0
    for kind, calls in t.calls.items():
        ops = [o for o in t.ops
               if any(k in o.name for k in KERNELS[kind])]
        if len(ops) != len(calls) * len(KERNELS[kind]):
            return None
        bound_ms += sum(peaks.bytes_ms(BYTES[kind](c["k"], c["n"],
                                                   c["itemsize"]))
                        for c in calls)
        time_ms += sum(o.ns for o in ops) / 1e6
    if not time_ms:
        return None
    return 100.0 * bound_ms / time_ms
