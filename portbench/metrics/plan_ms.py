"""The planner's milliseconds a resolve: the program's `engine.plan`
spans over the traced resolves."""


def read(view):
    t = view.trace
    if t is None:
        return None
    spans = t.spans_named("engine.plan")
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / 1e6 / len(
        t.spans_named("resolve"))
