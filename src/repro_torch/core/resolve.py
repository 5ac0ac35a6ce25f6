"""Layer 2 — deterministic strategy execution (`repro.core.resolve`).

resolve(S, σ) = σ(sort_hash(Visible(S)), seed(MerkleRoot(S)))

Determinism (paper Def. 6): canonical ordering by content hash, a seed
derived from the Merkle root, and pure strategies. `resolve_spec`
funnels a resolve through the planner/executor engine; `reference_apply`
is the whole-tree definition the engine is held to.

Ported: the plain, trust-gated (`trust_threshold`: the visible set is
gated by the converged trust evidence and the seed derives from the
Merkle root of the gated ids) and hierarchical (`group_size`: groups of
the canonical order resolve first, a second pass merges their outputs
with seed + 1) paths, for every strategy, over dense and sparse
contributions (each leaf merged over its covering subset; an uncovered
leaf inherits the base; `sparse_reference_apply` is the engine-free
definition); whole-model strategies probe their cache entry before
touching a payload. Also `IncrementalMean` (O(p) running weight
average) and the deprecated `resolve(state, name, **cfg)` shim, which
the gossip nodes' string form calls.

Fetch-on-resolve: under a sharded blob store (`net.store`) a replica's
store holds only the payloads placed on it, so a resolve takes a
`fetch` hook that pulls the missing visible payloads on demand —
determinism is unaffected because payloads are content-addressed. The
hook is leaf-granular: a plan whose every leaf task hits the cache
(planner metadata is memoized by content id, `engine.memoized_meta`)
completes without fetching any payload, and payloads are pulled only
when some leaf has to recompute.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.api.spec import coerce_spec, MergeSpec, SpecError
from repro_torch.core import engine
from repro_torch.core.engine import EngineCache
from repro_torch.core.hashing import pytree_digest
from repro_torch.core.merkle import merkle_root
from repro_torch.core.state import CRDTMergeState
from repro_torch.obs import layer1_timer, span
from repro_torch.strategies import get_strategy
from repro_torch.strategies.base import pairwise_fold

FetchHook = Callable[[Tuple[str, ...]], Dict[str, Any]]

def seed_from_root(root: bytes) -> int:
    """Strategy RNG seed derived from the Merkle root (paper Def. 6).

    >>> seed_from_root(b"\\x00" * 32)
    0
    >>> seed_from_root(b"\\xff" * 32) == 0x7FFFFFFFFFFFFFFF
    True
    """
    return int.from_bytes(root[:8], "big") & 0x7FFFFFFFFFFFFFFF


def canonical_order(state: CRDTMergeState) -> List[str]:
    return sorted(state.visible())


def _warn_shim(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


def _fetch_into(store: Dict[str, Any], absent: List[str],
                fetch: Optional[FetchHook]) -> Dict[str, Any]:
    """Pull `absent` payloads through the fetch hook into a copied store.
    Raises KeyError without a hook: silently merging a subset would be a
    wrong answer with no signal."""
    if fetch is None:
        raise KeyError(f"store lacks payloads for {list(absent)}; "
                       "sync blobs first or pass a fetch hook")
    store = dict(store)
    with span("engine.fetch", n=len(absent)):
        store.update(fetch(tuple(absent)))
    still = [i for i in absent if i not in store]
    if still:
        raise KeyError(f"fetch hook could not obtain {still}")
    return store


Coverages = Optional[Dict[str, Optional[Tuple[str, ...]]]]


def _merge_ids(store: Dict[str, Any], ids: List[str], spec: MergeSpec,
               seed: int, *, base: Any, fetch: Optional[FetchHook],
               cache: Optional[EngineCache], use_cache: bool,
               base_digest: Optional[bytes] = None,
               coverages: Coverages = None) -> Tuple[Any, Dict[str, Any]]:
    """Merge the ordered id list through the planner/executor engine.
    Returns (merged, store) — the store may have grown by fetched
    payloads, which grouped resolves reuse.

    A whole-model strategy probes its cache entry first, keyed from the
    eids alone (a sparse payload's content hash and the base determine
    its densified form), so a warm resolve touches — and fetches — no
    payload. `coverages` maps sparse element ids to their leaf coverage
    descriptors; ids absent from it (or mapped to None) are dense."""
    covs = None
    if coverages and any(coverages.get(i) is not None for i in ids):
        covs = [coverages.get(i) for i in ids]
    if get_strategy(spec.strategy).whole_model:
        key = None
        if use_cache:
            key = engine.model_key(None, [bytes.fromhex(i) for i in ids],
                                   base=base, seed=seed, spec=spec,
                                   base_digest=base_digest)
            hit = engine.cache_lookup(key, cache)
            if hit is not None:
                return hit, store
        absent = [i for i in ids if i not in store]
        if absent:
            store = _fetch_into(store, absent, fetch)
        out = engine.merge([store[i] for i in ids], contrib_ids=tuple(ids),
                           base=base, seed=seed, use_cache=use_cache,
                           spec=spec, cache=cache, key=key, coverages=covs)
        return out, store
    # plan from resident payloads + memoized digests
    metas = {}
    unknown = []
    for i in ids:
        if i in store:
            metas[i] = engine.contrib_meta(store[i], eid=i)
        else:
            m = engine.memoized_meta(i)
            if m is None:
                unknown.append(i)
            else:
                metas[i] = m
    if unknown:
        # never-seen contributions must be pulled just to plan. With the
        # cache on, pull ONLY those: the other absent payloads may turn
        # out not to be needed at all. With it off, every absent payload
        # is needed — one hook round trip for both pulls.
        need = unknown if use_cache else [i for i in ids if i not in store]
        store = _fetch_into(store, need, fetch)
        for i in unknown:
            metas[i] = engine.contrib_meta(store[i], eid=i)
    plan = engine.plan_merge([metas[i] for i in ids], base=base, seed=seed,
                             spec=spec, coverages=covs)
    absent = [i for i in ids if i not in store]
    if absent:
        if use_cache:
            # leaf-granular and fold-aware: pull only the payloads some
            # cache-missed task consumes — an all-cached plan pulls none
            needed = engine.plan_needed_ids(plan, cache)
            pull = [ids[j] for j in needed if ids[j] not in store]
        else:
            pull = absent
        if pull:
            store = _fetch_into(store, pull, fetch)
    out = engine.execute_plan(plan, [store.get(i) for i in ids], base=base,
                              use_cache=use_cache, cache=cache)
    return out, store


def _grouped_resolve(store: Dict[str, Any], ids: List[str],
                     spec: MergeSpec, seed: int, *, base: Any,
                     fetch: Optional[FetchHook],
                     cache: Optional[EngineCache], use_cache: bool,
                     base_digest: Optional[bytes] = None,
                     coverages: Coverages = None) -> Any:
    """Two-level resolve (paper §7.2 L3 mitigation 2): sub-groups of
    `spec.group_size` over the canonical order resolve first; a second
    pass merges the sub-group outputs with seed + 1. Both passes run
    through the engine, and missing payloads fetch leaf-granularly per
    group. Sub-group outputs are dense whatever their inputs' coverage,
    so the second pass never sees sparsity."""
    firsts = []
    for i in range(0, len(ids), spec.group_size):
        out, store = _merge_ids(store, ids[i:i + spec.group_size], spec,
                                seed, base=base, fetch=fetch, cache=cache,
                                use_cache=use_cache,
                                base_digest=base_digest,
                                coverages=coverages)
        firsts.append(out)
    return engine.merge(firsts, base=base, seed=seed + 1,
                        use_cache=use_cache, spec=spec, cache=cache)


def resolve_spec(state: CRDTMergeState, spec: MergeSpec, *,
                 base: Any = None, trust: Any = None,
                 fetch: Optional[FetchHook] = None,
                 cache: Optional[EngineCache] = None,
                 use_cache: bool = True, verify_base: bool = True) -> Any:
    """Compute the merged model the spec describes, over the state's
    converged visible set, on the exact path (the reference runs its
    Replica's resolve without `pallas=True` too).

    `trust` is a `core.trust.TrustState`; a spec with `trust_threshold`
    gates the visible set by it (evidence is a CRDT, so honest replicas
    gate alike) and seeds from the Merkle root of the gated ids.

    `fetch` is the sharded-store hook: called with the visible eids
    whose payloads are needed and locally absent, it returns them (a
    `net.SyncNode` pulls them over the network). Payloads are needed
    only for leaf tasks that miss the cache: a warm re-resolve on a
    replica that has shed its blobs fetches nothing. Without a hook, a
    needed but missing payload raises KeyError."""
    if not isinstance(spec, MergeSpec):
        raise TypeError(f"resolve_spec() requires a MergeSpec, got "
                        f"{type(spec).__name__}")
    base_digest = None
    if spec.base_ref is not None:
        if base is None:
            raise KeyError(
                f"spec pins base_ref {spec.base_ref[:16]}… but no base "
                "payload was supplied; pass base= (or resolve through a "
                "Replica that registered it)")
        if verify_base:
            got = pytree_digest(base).hex()
            if got != spec.base_ref:
                raise SpecError(
                    f"base payload digest {got[:16]}… does not match "
                    f"the spec's base_ref {spec.base_ref[:16]}…")
        # verified, or registered under its digest: the key needs no
        # second hash of the base
        base_digest = bytes.fromhex(spec.base_ref)
    # Layer-1 slice of the resolve — visibility gate, canonical order,
    # Merkle root, seed — recorded in the resolving cache's registry
    with layer1_timer(engine._cache_or_default(cache).obs):
        if spec.trust_threshold is not None:
            from repro_torch.core.trust import gated_visible, TrustState
            t = trust if trust is not None else TrustState()
            ids = sorted(gated_visible(state, t, spec.trust_threshold))
            if not ids:
                raise ValueError("all contributions gated out")
            root = merkle_root([bytes.fromhex(i) for i in ids])
        else:
            ids = canonical_order(state)
            if not ids:
                raise ValueError(
                    "resolve() requires a non-empty visible set")
            root = state.merkle_root()
        seed = seed_from_root(root)
        coverages = state.coverage()
    if spec.group_size is not None:
        return _grouped_resolve(state.store, ids, spec, seed, base=base,
                                fetch=fetch, cache=cache,
                                use_cache=use_cache,
                                base_digest=base_digest,
                                coverages=coverages)
    out, _ = _merge_ids(state.store, ids, spec, seed, base=base,
                        fetch=fetch, cache=cache, use_cache=use_cache,
                        base_digest=base_digest, coverages=coverages)
    return out


def resolve(state: CRDTMergeState, spec: Any, base: Any = None, *,
            reduction: Optional[str] = None, use_cache: bool = True,
            fetch: Optional[FetchHook] = None,
            cache: Optional[EngineCache] = None, trust: Any = None,
            **cfg) -> Any:
    """Resolve the state. `spec` is a `MergeSpec`.

    The historical form `resolve(state, "ties", trim=0.3)` still works
    but is DEPRECATED: it wraps the unvalidated kwargs in a lenient
    MergeSpec and delegates, emitting DeprecationWarning."""
    if isinstance(spec, MergeSpec):
        return resolve_spec(state, coerce_spec(spec, cfg,
                                               reduction=reduction),
                            base=base, trust=trust, fetch=fetch,
                            cache=cache, use_cache=use_cache)
    _warn_shim("resolve(state, strategy_name, **cfg)",
               "resolve(state, MergeSpec(strategy, cfg)) or "
               "Replica.resolve(spec)")
    lenient = coerce_spec(spec, cfg, reduction=reduction, lenient=True)
    return resolve_spec(state, lenient, base=base, trust=trust,
                        fetch=fetch, cache=cache, use_cache=use_cache)


def hierarchical_resolve(states: List[CRDTMergeState], spec: MergeSpec,
                         group_size: int = 8, base: Any = None, *,
                         fetch: Optional[FetchHook] = None,
                         cache: Optional[EngineCache] = None,
                         use_cache: bool = True) -> Any:
    """Two-level resolve over the join of `states` (paper §7.2 L3
    mitigation 2): `resolve_spec` with the spec's `group_size`, or
    `group_size` where the spec sets none. The reference's deprecated
    string form (a strategy name and kwargs) is not ported."""
    if not states:
        raise ValueError("hierarchical_resolve() requires >= 1 state")
    if not isinstance(spec, MergeSpec):
        raise TypeError(f"hierarchical_resolve() requires a MergeSpec, "
                        f"got {type(spec).__name__}")
    if spec.group_size is None:
        spec = spec.replace(group_size=group_size)
    merged = states[0]
    for s in states[1:]:
        merged = merged.merge(s)
    return resolve_spec(merged, spec, base=base, fetch=fetch, cache=cache,
                        use_cache=use_cache)


def reference_apply(strategy_name: str, contribs: List[Any], *, base=None,
                    seed: int = 0, reduction: str = "fold", **cfg) -> Any:
    """Direct (non-CRDT) strategy application over an ORDERED list: the
    whole-tree definition the engine is verified against. A binary-only
    strategy over k > 2 contributions folds pairwise: in sequence
    (`reduction="fold"`) or as a balanced tree (`"tree"`)."""
    strat = get_strategy(strategy_name)
    if strat.binary_only and len(contribs) > 2:
        return pairwise_fold(contribs, lambda x, y, sd: strat(
            [x, y], base=base, seed=sd, **cfg), seed, reduction)
    return strat(contribs, base=base, seed=seed, **cfg)


def sparse_reference_apply(strategy_name: str, contribs: List[Any],
                           coverages: List[Optional[Tuple[str, ...]]], *,
                           base: Any, seed: int = 0,
                           reduction: str = "fold", **cfg) -> Any:
    """Reference semantics for mixed dense/sparse contribution lists,
    built ONLY from the whole-tree path: each model leaf is merged over
    exactly its covering contribution subset, at its global flatten
    index; zero-coverage leaves inherit the base. For each distinct
    covering subset, its contributions are densified (base fill) and
    `reference_apply` runs over the whole model; the leaves whose subset
    it is are kept — an engine-free definition the sparse engine path is
    held to bitwise."""
    strat = get_strategy(strategy_name)
    if strat.whole_model:
        dense = engine.densify_contributions(contribs, coverages, base)
        return reference_apply(strategy_name, dense, base=base, seed=seed,
                               reduction=reduction, **cfg)
    flat, treedef = pytree.flatten_with_path(base)
    paths = [pytree.keystr(p) for p, _ in flat]
    subset_of = {p: tuple(j for j, cov in enumerate(coverages)
                          if cov is None or p in cov) for p in paths}
    out: List[Any] = [None] * len(paths)
    for subset in sorted(set(subset_of.values())):
        if not subset:
            for i, p in enumerate(paths):
                if subset_of[p] == subset:
                    out[i] = flat[i][1]
            continue
        dense = engine.densify_contributions(
            [contribs[j] for j in subset],
            [coverages[j] for j in subset], base)
        ref = pytree.leaves(reference_apply(
            strategy_name, dense, base=base, seed=seed,
            reduction=reduction, **cfg))
        for i, p in enumerate(paths):
            if subset_of[p] == subset:
                out[i] = ref[i]
    return treedef.unflatten(out)


# ---------------------------------------------------------------------------
# Incremental resolve (paper §7.2 L3 mitigation 3)
# ---------------------------------------------------------------------------


class IncrementalMean:
    """O(p)-per-contribution running weight average.

    Matches weight_average over the same visible set because fp32 running
    sums are order-dependent only through accumulation order — so
    `sync()` re-folds in canonical order whenever out-of-order
    contributions arrive, and drops ids the state has since retracted.
    Fast path: appends.
    """

    def __init__(self):
        self._sum = None
        self._ids: List[str] = []

    def add(self, element_id: str, contribution) -> None:
        if self._sum is None:
            self._sum = pytree.tree_map(
                lambda x: x.to(torch.float32), contribution)
        else:
            self._sum = pytree.tree_map(
                lambda a, x: a + x.to(torch.float32), self._sum,
                contribution)
        self._ids.append(element_id)

    def sync(self, state: CRDTMergeState) -> bool:
        """Re-fold from the state's canonical visible set: retracted ids
        are dropped, missed ones folded in, and accumulation order
        restored to canonical. Returns True if a re-fold was needed.
        Raises KeyError if a visible element's payload is absent from
        the store (resolve would fail there too)."""
        ids = canonical_order(state)
        absent = [eid for eid in ids if eid not in state.store]
        if absent:
            raise KeyError(f"store lacks payloads for {absent}; "
                           "fetch missing blobs before sync()")
        if ids == self._ids:
            return False
        self._sum = None
        self._ids = []
        for eid in ids:
            self.add(eid, state.store[eid])
        return True

    def value(self):
        k = len(self._ids)
        if k == 0:
            raise ValueError("IncrementalMean has no contributions")
        return pytree.tree_map(lambda s: s / k, self._sum)

    def count(self) -> int:
        return len(self._ids)
