"""The resolve's share of the chip's roofline: the least time of one
resolve (the k contributions and the base read once, the merged tree
written once, at 3.35 TB/s) over the traced resolves' mean time, from
issue to synchronize."""


def read(view):
    t = view.trace
    if t is None:
        return None
    spans = t.spans_named("resolve")
    if not spans:
        return None
    mean_ms = sum(s.t1 - s.t0 for s in spans) / 1e6 / len(spans)
    return 100.0 * view.facts["least_resolve_ms"] / mean_ms
