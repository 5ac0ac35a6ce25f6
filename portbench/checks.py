"""The numbers that decide `correct`: how far what the timed path
produced lies from the plain reference, each held to a limit of its own
(the cell's `limits/<cell>.json`)."""
from __future__ import annotations

import statistics
from typing import Dict, Sequence


def rel_gap(a: Sequence[float], b: Sequence[float]) -> float:
    """The widest |a_i - b_i| / |b_i| over the steps."""
    if len(a) != len(b):
        return float("inf")
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Sequence[str] = ()) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; `keep` limits the leaves (all by
    default)."""
    keys = list(keep) or sorted(ref)
    if set(prog) != set(ref):
        return float("inf")
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def elem_gap(prog: Dict, ref: Dict, keep: Sequence[str]) -> float:
    """The worst leaf's |prog - ref| / |ref| over the leaf's sampled
    elements ({key: 1-D tensor}, the same indices on both sides): it sees
    the direction of a change, which a norm does not."""
    if set(prog) != set(ref):
        return float("inf")
    worst = 0.0
    for k in keep:
        d, r = prog[k].double(), ref[k].double()
        if d.shape != r.shape:
            return float("inf")
        worst = max(worst, float((d - r).norm() / r.norm()))
    return worst


def moving_leaves(grad1: Dict[str, float], share: float = 1e-3):
    """Leaves whose first reference gradient is not nought to rounding:
    at least `share` of the median leaf's."""
    med = statistics.median(grad1.values())
    return [k for k in sorted(grad1) if grad1[k] >= share * med]


def training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The five numbers of a training cell."""
    moving = moving_leaves(ref["grad1"])
    return {
        "loss_gap": rel_gap(prog["loss"], ref["loss"]),
        "grad_norm_gap": rel_gap(prog["grad_norm"], ref["grad_norm"]),
        "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
        "update_gap": leaf_gap(prog["change"], ref["change"], moving),
        "update_elem_gap": elem_gap(prog["change_sample"],
                                    ref["change_sample"], moving),
    }


def with_limits(values: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, tuple]:
    """{name: (value, limit)} for every number the cell's limits name; a
    number they leave out is not compared (PERF.md says why) and goes to
    standard error as a reading, and a limit on a number not computed is
    a fault of the cell's files."""
    import sys
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"limits for numbers not computed: {sorted(missing)}")
    for k in sorted(set(values) - set(limits)):
        print(f"reading {k}: {values[k]!r} (not compared)", file=sys.stderr)
    return {k: (float(values[k]), float(limits[k])) for k in sorted(limits)}
