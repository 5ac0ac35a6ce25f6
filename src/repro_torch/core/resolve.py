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
with seed + 1) paths, for every strategy; whole-model strategies probe
their cache entry before touching a payload. Sparse contributions
(ROADMAP A4) and fetch-on-resolve over a sharded store (A6) raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.api.spec import MergeSpec, SpecError
from repro_torch.core import engine
from repro_torch.core.engine import EngineCache
from repro_torch.core.hashing import pytree_digest
from repro_torch.core.merkle import merkle_root
from repro_torch.core.state import CRDTMergeState
from repro_torch.obs import layer1_timer
from repro_torch.strategies import get_strategy
from repro_torch.strategies.base import pairwise_fold


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


def _absent(store: Dict[str, Any], ids: List[str]) -> None:
    absent = [i for i in ids if i not in store]
    if absent:
        raise KeyError(f"store lacks payloads for {absent}; fetch-on-"
                       "resolve waits for ROADMAP A6")


def _merge_ids(store: Dict[str, Any], ids: List[str], spec: MergeSpec,
               seed: int, *, base: Any, cache: Optional[EngineCache],
               use_cache: bool, base_digest: Optional[bytes] = None) -> Any:
    """Merge the ordered id list through the planner/executor engine. A
    whole-model strategy probes its cache entry first, keyed from the
    eids alone, so a warm resolve touches no payload."""
    if get_strategy(spec.strategy).whole_model:
        key = None
        if use_cache:
            key = engine.model_key(None, [bytes.fromhex(i) for i in ids],
                                   base=base, seed=seed, spec=spec,
                                   base_digest=base_digest)
            hit = engine.cache_lookup(key, cache)
            if hit is not None:
                return hit
        _absent(store, ids)
        return engine.merge([store[i] for i in ids], contrib_ids=tuple(ids),
                            base=base, seed=seed, use_cache=use_cache,
                            spec=spec, cache=cache, key=key)
    _absent(store, ids)
    metas = [engine.contrib_meta(store[i], eid=i) for i in ids]
    plan = engine.plan_merge(metas, base=base, seed=seed, spec=spec)
    return engine.execute_plan(plan, [store[i] for i in ids], base=base,
                               use_cache=use_cache, cache=cache)


def _grouped_resolve(store: Dict[str, Any], ids: List[str],
                     spec: MergeSpec, seed: int, *, base: Any,
                     cache: Optional[EngineCache], use_cache: bool,
                     base_digest: Optional[bytes] = None) -> Any:
    """Two-level resolve (paper §7.2 L3 mitigation 2): sub-groups of
    `spec.group_size` over the canonical order resolve first; a second
    pass merges the sub-group outputs with seed + 1. Both passes run
    through the engine."""
    firsts = [_merge_ids(store, ids[i:i + spec.group_size], spec, seed,
                         base=base, cache=cache, use_cache=use_cache,
                         base_digest=base_digest)
              for i in range(0, len(ids), spec.group_size)]
    return engine.merge(firsts, base=base, seed=seed + 1,
                        use_cache=use_cache, spec=spec, cache=cache)


def resolve_spec(state: CRDTMergeState, spec: MergeSpec, *,
                 base: Any = None, trust: Any = None,
                 cache: Optional[EngineCache] = None,
                 use_cache: bool = True, verify_base: bool = True) -> Any:
    """Compute the merged model the spec describes, over the state's
    converged visible set, on the exact path (the reference runs its
    Replica's resolve without `pallas=True` too).

    `trust` is a `core.trust.TrustState`; a spec with `trust_threshold`
    gates the visible set by it (evidence is a CRDT, so honest replicas
    gate alike) and seeds from the Merkle root of the gated ids."""
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
        if any(c is not None for c in state.coverage().values()):
            raise NotImplementedError(
                "sparse contributions are not ported yet (ROADMAP A4)")
    if spec.group_size is not None:
        return _grouped_resolve(state.store, ids, spec, seed, base=base,
                                cache=cache, use_cache=use_cache,
                                base_digest=base_digest)
    return _merge_ids(state.store, ids, spec, seed, base=base, cache=cache,
                      use_cache=use_cache, base_digest=base_digest)


def hierarchical_resolve(states: List[CRDTMergeState], spec: MergeSpec,
                         group_size: int = 8, base: Any = None, *,
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
    return resolve_spec(merged, spec, base=base, cache=cache,
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
