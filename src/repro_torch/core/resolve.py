"""Layer 2 — deterministic strategy execution (`repro.core.resolve`).

resolve(S, σ) = σ(sort_hash(Visible(S)), seed(MerkleRoot(S)))

Determinism (paper Def. 6): canonical ordering by content hash, a seed
derived from the Merkle root, and pure strategies. `resolve_spec`
funnels a resolve through the planner/executor engine; `reference_apply`
is the whole-tree definition the engine is held to.

Ported: the plain path. Trust-gated specs (`trust_threshold`, ROADMAP
A1), hierarchical specs (`group_size`, A4), sparse contributions (A4)
and fetch-on-resolve over a sharded store (A6) raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.api.spec import MergeSpec, SpecError
from repro_torch.core import engine
from repro_torch.core.engine import EngineCache
from repro_torch.core.hashing import pytree_digest
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


def _merge_ids(store: Dict[str, Any], ids: List[str], spec: MergeSpec,
               seed: int, *, base: Any, cache: Optional[EngineCache],
               use_cache: bool) -> Any:
    """Merge the ordered id list through the planner/executor engine."""
    absent = [i for i in ids if i not in store]
    if absent:
        raise KeyError(f"store lacks payloads for {absent}; fetch-on-"
                       "resolve waits for ROADMAP A6")
    metas = [engine.contrib_meta(store[i], eid=i) for i in ids]
    plan = engine.plan_merge(metas, base=base, seed=seed, spec=spec)
    return engine.execute_plan(plan, [store[i] for i in ids], base=base,
                               use_cache=use_cache, cache=cache)


def resolve_spec(state: CRDTMergeState, spec: MergeSpec, *,
                 base: Any = None, cache: Optional[EngineCache] = None,
                 use_cache: bool = True, verify_base: bool = True) -> Any:
    """Compute the merged model the spec describes, over the state's
    converged visible set, on the exact path (the reference runs its
    Replica's resolve without `pallas=True` too)."""
    if not isinstance(spec, MergeSpec):
        raise TypeError(f"resolve_spec() requires a MergeSpec, got "
                        f"{type(spec).__name__}")
    if spec.trust_threshold is not None:
        raise NotImplementedError(
            "trust-gated resolve waits for ROADMAP A1 (core/trust.py)")
    if spec.group_size is not None:
        raise NotImplementedError(
            "hierarchical resolve (group_size) waits for ROADMAP A4")
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
    # Layer-1 slice of the resolve — canonical order, Merkle root, seed,
    # recorded in the resolving cache's registry (the Replica's own)
    with layer1_timer(engine._cache_or_default(cache).obs):
        ids = canonical_order(state)
        if not ids:
            raise ValueError("resolve() requires a non-empty visible set")
        seed = seed_from_root(state.merkle_root())
        if any(c is not None for c in state.coverage().values()):
            raise NotImplementedError(
                "sparse contributions are not ported yet (ROADMAP A4)")
    return _merge_ids(state.store, ids, spec, seed, base=base, cache=cache,
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
