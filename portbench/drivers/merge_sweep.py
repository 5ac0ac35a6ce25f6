"""A closed loop of Layer-2 resolves over one replica's fine-tunes: a
team choosing how to merge its fine-tunes tries one merge spec after
another.

Set-up makes a base and k contributions (base + scale x delta_j) from
the seed, contributes them to one `Replica` (Layer 1: content ids, the
OR-Set, the Merkle root), registers the base, and warms every route
with one request of each mix entry (the first plan digests each
contribution's leaves). The window issues the mix's requests one after
another in rounds of one request a mix entry, each a new `MergeSpec`,
through `core.engine.merge` over the
visible payloads in canonical order with the replica's registered base
and its digests, the seed from the Merkle root, the kernels on and the
cache off (every spec is new: a cache could only miss). Each request is
timed from its issue to `torch.cuda.synchronize()`; its output is then
sampled at columns drawn from the seed (each leaf's first and last
columns and blocks between) and dropped. The window closes at
the end of the round in which `seconds` have passed, so every window
holds the same mix; `resolve_ms` is the window over the resolves
completed in it, `resolve_ms_p95` the 95th percentile
of every resolve in the window.

Once the window has closed, the plain reference works out the content
ids, the canonical order, the Merkle root and its seed by itself and
recomputes every request's sampled columns; the numbers compared are
the largest share, over every request and leaf, of sampled values more
than one bf16 value away from the reference's, and whether the roots
differ.

Traffic keys: contributions, dtype, delta_scale, mix (entries of
strategy, fixed cfg and uniform `draw` ranges), sample_blocks,
sample_width, trace_requests and trace_after.
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

import torch

from portbench import checks, common, gen, peaks
from portbench.devtrace import Probe, Spans, stretch, Trace
from portbench.reference import layout as L
from portbench.reference import merge as refmerge


def _batch_call(kind: str):
    """Describe a flat-batch kernel call (leaves of k rows each)."""
    def describe(leaves, *rest, **kw):
        rows = leaves[0]
        return {"kind": kind, "k": len(rows),
                "n": sum(int(r[0].numel()) for r in leaves),
                "itemsize": int(rows[0].element_size())}
    return describe


PROBES = {
    "ties_batch": ("repro_torch.kernels.ops", "ties_batch_merge"),
    "nary_batch": ("repro_torch.kernels.ops", "nary_flat_merge"),
}


def p95(xs: List[float]) -> float:
    return statistics.quantiles(xs, n=20, method="inclusive")[-1] \
        if len(xs) > 1 else xs[0]


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    config, traffic = cell.config, cell.traffic
    lay = L.layout(config)
    common.check_layout(Model(common.port_config(config)), lay)
    k = traffic["contributions"]
    if traffic["dtype"] != "bfloat16":
        raise ValueError("the comparison counts bf16 values: the mix's "
                         "dtype must be bfloat16")
    dtype = torch.bfloat16
    spans = Spans()
    stamp = common.Stamps(t_start)
    if device.type == "cuda":
        build.build_all()
    stamp("imports and kernels")
    base, contribs = gen.merge_inputs(lay, seed, k, traffic["delta_scale"],
                                      dtype, device)
    base_tree = L.nest(base)
    rep = Replica("portbench", device=device)
    common.sync(device)
    stamp("inputs")
    t0 = time.perf_counter()
    for c in contribs:
        rep.contribute(L.nest(c))
    contribute_s = time.perf_counter() - t0
    stamp("contribute")
    ref = rep.register_base(base_tree)
    root = rep.merkle_root()
    mseed = seed_from_root(root)
    order = canonical_order(rep.state)
    ordered = [rep.state.store[i] for i in order]
    digests = rep.base_digests(ref)
    stamp("register base")

    def resolve(req: Dict):
        spec = MergeSpec(req["strategy"], req["cfg"], base_ref=ref)
        return engine.merge(ordered, spec=spec, contrib_ids=order,
                            base=base_tree, base_digests=digests,
                            seed=mseed, kernels=True, use_cache=False,
                            cache=rep.cache)

    g = torch.Generator().manual_seed(gen.sub_seed(seed, "columns"))
    cols = {leaf.path: refmerge.sample_columns(
        leaf.numel, traffic["sample_blocks"], traffic["sample_width"], g)
        .to(device) for leaf in lay}

    def sample(out) -> Dict:
        return {leaf.path: L.at(out, leaf.path).reshape(-1)[cols[leaf.path]]
                for leaf in lay}

    for entry in traffic["mix"]:      # every route, once, at mid-range
        cfg = dict(entry.get("cfg", {}))
        cfg.update({n: (lo + hi) / 2 for n, (lo, hi)
                    in entry.get("draw", {}).items()})
        out = resolve({"strategy": entry["strategy"], "cfg": cfg})
        del out
        common.sync(device)
        stamp(f"first {entry['strategy']}")
    stamp.report()
    setup_s = time.perf_counter() - t_start

    requests = gen.merge_requests(seed, traffic["mix"])
    done: List[Dict] = []
    lat: List[float] = []
    traces: List[Trace] = []
    probes = {name: Probe(mod, attr, _batch_call(name))
              for name, (mod, attr) in PROBES.items()}
    t0 = time.perf_counter()
    traced = not trace

    def one(req: Dict) -> float:
        with spans.span("resolve"):
            a = time.perf_counter()
            with spans.span("engine.merge"):
                out = resolve(req)
            with spans.span("sync"):
                common.sync(device)
            b = time.perf_counter()
        with spans.span("sample"):
            done.append({"req": req, "out": sample(out)})
        return b - a

    while True:
        if not traced and len(lat) % len(traffic["mix"]) == 0 \
                and time.perf_counter() - t0 \
                >= traffic["trace_after"] * seconds:
            traced = True
            with stretch(spans, probes, traces, device):
                for _ in range(traffic["trace_requests"]):
                    with spans.span("draw"):
                        req = next(requests)
                    lat.append(one(req))
        else:
            lat.append(one(next(requests)))
        end = time.perf_counter()
        if end - t0 >= seconds and len(lat) % len(traffic["mix"]) == 0:
            break
    window_s = end - t0
    peak = common.memory_peak(device)
    for name in sorted({d["req"]["strategy"] for d in done}):
        ms = sorted(1e3 * x for x, d in zip(lat, done)
                    if d["req"]["strategy"] == name)
        print(f"latency {name}: {len(ms)} resolves, min {ms[0]:.1f} "
              f"median {statistics.median(ms):.1f} max {ms[-1]:.1f} ms",
              file=sys.stderr)
    del rep, ordered
    engine.clear_meta_memo()
    common.free()

    t_ref = time.perf_counter()
    values = _check(lay, base, contribs, cols, done, root)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s over "
          f"{len(done)} resolves", file=sys.stderr)
    n_params = sum(leaf.numel for leaf in lay)
    itemsize = torch.empty((), dtype=dtype).element_size()
    facts = {
        "contribute_bytes": k * n_params * itemsize,
        "contribute_s": contribute_s,
        "resolves": len(lat),
        "least_resolve_ms": peaks.bytes_ms(
            peaks.resolve_least_bytes(k, n_params, itemsize)),
    }
    return {
        "setup_s": setup_s,
        "e2e": {"resolve_ms": window_s * 1e3 / len(lat),
                "resolve_ms_p95": p95(lat) * 1e3},
        "attempted": len(lat), "failed": 0,
        "checks": checks.with_limits(values, cell.limits),
        "memory_peak_bytes": peak,
        "view": common.View(cell, traces[0] if traces else None, facts),
    }


def _check(lay, base, contribs, cols, done, root) -> Dict[str, float]:
    """The reference's ids, root and order, then every request's sampled
    columns against the program's."""
    trees = [{leaf.key: c[leaf.path] for leaf in lay} for c in contribs]
    ids = [refmerge.tree_id(t) for t in trees]
    ref_root = refmerge.merkle_root(ids)
    ordered = [contribs[i] for i in sorted(range(len(ids)),
                                           key=lambda i: ids[i])]
    stats = {}
    if any(d["req"]["strategy"] == "ties" for d in done):
        for leaf in lay:
            stats[leaf.path] = refmerge.hist_stats(
                [c[leaf.path] for c in ordered], base[leaf.path])
    worst, where = 0.0, ""
    for d in done:
        req = d["req"]
        for leaf in lay:
            idx = cols[leaf.path]
            xs = refmerge.gather([c[leaf.path] for c in ordered], idx)
            b = base[leaf.path].reshape(-1)[idx]
            if req["strategy"] == "ties":
                amax, counts = stats[leaf.path]
                thr = refmerge.thresholds(amax, counts, leaf.numel,
                                          req["cfg"]["trim"])
                want = refmerge.ties_columns(xs, b, thr)
            else:
                want = refmerge.task_arithmetic_columns(xs, b,
                                                        req["cfg"]["lam"])
            steps = refmerge.bf16_steps(d["out"][leaf.path],
                                        want.to(torch.bfloat16))
            share = float((steps > 1).float().mean())
            if share > worst:
                worst = share
                where = f"{req['strategy']} {req['cfg']} {leaf.key}"
    print(f"diff_share at its widest: {where}", file=sys.stderr)
    return {"diff_share": worst, "root_mismatch": float(ref_root != root)}
