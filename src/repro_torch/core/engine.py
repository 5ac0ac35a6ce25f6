"""Planner/executor merge engine (`repro.core.engine`, in PyTorch).

Execution splits into:

  * a **planner** that walks the canonical contribution set and emits one
    `LeafTask` per model tensor, keyed by a per-tensor **sub-root** — the
    hash of that leaf's ordered contribution digests plus everything else
    that shapes the output (strategy, cfg, base leaf). Sub-roots are
    byte-equal to the reference's, so both packages name the same leaf
    merge with the same key;
  * an **executor** that runs the plan leaf by leaf with bounded live
    memory, fusing same-dtype elementwise leaves into one [k, N]
    dispatch; with `kernels=True` the fused batches go through the CUDA
    kernels of `repro_torch.kernels` (the reference's `pallas=True`);
  * a byte-budgeted **per-leaf cache** keyed by sub-root, per
    `EngineCache` (each `Replica` owns one).

Sub-root of leaf i of a k-way merge described by a `MergeSpec`:

    sub_root_i = SHA-256( domain || spec.cache_fragment() ||
                          base_i || k || d_1,i || ... || d_k,i )

with d_j,i the `tensor_digest` of contribution j's leaf i in canonical
order and base_i the base leaf's digest (a fixed marker without base).
For strategies that consume a PRNG key (the DARE family) the seed and
the leaf index enter too.

Strategies that declare a `LeafFold` resume from the longest cached
prefix when a leaf's ordered subset grew append-only, bit-equal to the
full recompute by the LeafFold contract.

Quantized contributions (`CompressedTree`, int8 + fp32 scale per leaf)
are planned in place: digests describe the dequantized tensors, and
int8 slices are priced at one byte per element. The exact path
densifies a slice where it reads it (`engine_events_total{event=
dequant_leaves}`); with `kernels=True` a linear-family group whose
every slice is int8 merges through `quant_nary` without densifying.

Whole-model strategies (population search, SVD) are not planned per
leaf: `merge` runs them as one whole-model dispatch with one cache entry
keyed by `model_key` (the reference's key, byte for byte), and stacks
one leaf at a time through the strategy's leaf function, freeing each
stack before the next (the reference stacks the whole model at once:
the same bytes, k models' memory less).

Sparse contributions
--------------------
A contribution may cover only some of the model's leaves (its
`leaf_paths` coverage descriptor, from `CRDTMergeState.coverage()`).
The planner maps its leaves onto the model by path and keys each leaf
task on that leaf's ordered covering subset, so a leaf a new sparse
contribution does not touch keeps its sub-root and stays a cache hit:
re-resolve costs O(changed leaves). The sub-roots are the reference's,
byte for byte. A leaf covered by no contribution inherits the base leaf
(the rule is folded into `spec.cache_fragment()`). One plan then holds
tasks of different k_i; the executor fuses only tasks with the same
ordered contributor subset, so every batch, and every kernel launch
(`kernels=True`), has one k. Whole-model strategies densify sparse
payloads with the base's leaves first (`densify_contributions`).
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from repro_torch import pytree
from repro_torch.api.spec import coerce_spec, MergeSpec
from repro_torch.core.compression import (
    compressed_tree_to_structure, CompressedLeaf, CompressedTree,
    dequantize_leaf)
from repro_torch.core.hashing import pytree_digest, tensor_digests
from repro_torch.dtypes import BY_NAME
from repro_torch.obs import CounterView, MetricsRegistry, span
from repro_torch.strategies import get_strategy
from repro_torch.strategies.base import pairwise_fold, run_fold, \
    Strategy

_DOMAIN_LEAF = b"repro/engine/leaf-subroot/v2"
_DOMAIN_MODEL = b"repro/engine/model-subroot/v2"
_NO_BASE = b"\x00" * 32          # base=None marker (zeros_like base)


def _is_qleaf(x: Any) -> bool:
    return isinstance(x, CompressedLeaf)


def _dense_leaf(x: Any, *, obs: Optional[MetricsRegistry]) -> Any:
    """Densify one payload slice if (and only if) it arrived quantized,
    with `decompress_tree`'s op, so the exact path stays byte-identical
    to densify-then-merge. Counted (`engine_events_total{event=
    dequant_leaves}`): the int8 kernel route never calls this."""
    if not _is_qleaf(x):
        return x
    if obs is not None:
        obs.counter("engine_events_total").inc(event="dequant_leaves")
    return dequantize_leaf(x)


def _as_spec(spec: Optional[MergeSpec], strategy_name: Optional[str],
             reduction: Optional[str], cfg: Dict[str, Any]) -> MergeSpec:
    """An explicit MergeSpec, or a lenient one built from a strategy
    name + kwargs. A stray reduction=/cfg argument NEXT TO a spec
    raises."""
    if spec is None and strategy_name is None:
        raise TypeError("either a MergeSpec or a strategy name is "
                        "required")
    if spec is not None and strategy_name is not None \
            and strategy_name != spec.strategy:
        raise TypeError(f"conflicting strategies: positional "
                        f"{strategy_name!r} vs spec {spec.strategy!r}")
    return coerce_spec(spec if spec is not None else strategy_name,
                       cfg, reduction=reduction, lenient=True)


# ---------------------------------------------------------------------------
# Per-contribution leaf metadata (digest memo)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContribMeta:
    """One contribution as the planner sees it: tree structure plus
    per-leaf content digests, memoized by element id (content-addressed:
    an eid fully determines the payload bytes)."""
    treedef: Any
    digests: Tuple[bytes, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    paths: Tuple[str, ...] = ()
    # per-leaf bytes per element as the payload holds it: 1 for an int8
    # `CompressedLeaf`, else the dtype's itemsize (batch pricing)
    itemsizes: Tuple[int, ...] = ()
    # per-leaf int8 dequantization scale of an int8 `CompressedLeaf`
    # (None for a dense leaf); None when no leaf is int8
    scales: Optional[Tuple[Optional[float], ...]] = None

    @property
    def leaf_count(self) -> int:
        return len(self.digests)

    def scale_of(self, local: int) -> Optional[float]:
        return self.scales[local] if self.scales is not None else None


_META_MEMO: "OrderedDict[str, ContribMeta]" = OrderedDict()
_META_MEMO_LIMIT = 1024


def contrib_meta(contribution: Any, *, eid: Optional[str] = None
                 ) -> ContribMeta:
    """Flatten + digest one contribution; memoized by content id.

    A `CompressedTree` is planned in place: its leaves are the int8
    payloads, digests are taken on transient dequantizations of a few
    leaves at a time (`tensor_digests`' `prepare`; never the densified
    model), and each int8 leaf is priced at one byte per element."""
    if eid is not None and eid in _META_MEMO:
        _META_MEMO.move_to_end(eid)
        return _META_MEMO[eid]
    if isinstance(contribution, CompressedTree):
        contribution = compressed_tree_to_structure(contribution)
    flat, treedef = pytree.flatten_with_path(contribution)
    leaves = [leaf for _, leaf in flat]
    for leaf in leaves:
        if not isinstance(leaf, (torch.Tensor, CompressedLeaf)):
            raise TypeError(
                f"leaf of type {type(leaf).__name__}: the port merges "
                "torch.Tensor and CompressedLeaf leaves only")
    meta = ContribMeta(
        treedef=treedef,
        # int8 payloads digested on their transient dequantizations
        digests=tuple(tensor_digests(leaves, prepare=_digest_leaf)
                      if any(_is_qleaf(leaf) for leaf in leaves)
                      else tensor_digests(leaves)),
        shapes=tuple(tuple(leaf.shape) for leaf in leaves),
        dtypes=tuple(leaf.dtype for leaf in leaves),
        paths=tuple(pytree.keystr(p) for p, _ in flat),
        itemsizes=tuple(1 if _is_qleaf(leaf) else leaf.dtype.itemsize
                        for leaf in leaves),
        scales=_scales([float(leaf.scale) if _is_qleaf(leaf) else None
                        for leaf in leaves]),
    )
    if eid is not None:
        _memoize(eid, meta)
    return meta


def _digest_leaf(leaf: Any) -> torch.Tensor:
    """The tensor a leaf's digest is taken on: an int8 payload's transient
    dequantization, or the leaf itself."""
    return _dense_leaf(leaf, obs=None)


def _scales(scales: Sequence[Optional[float]]
            ) -> Optional[Tuple[Optional[float], ...]]:
    return tuple(scales) if any(s is not None for s in scales) else None


def _memoize(eid: str, meta: ContribMeta) -> None:
    _META_MEMO[eid] = meta
    while len(_META_MEMO) > _META_MEMO_LIMIT:
        _META_MEMO.popitem(last=False)


def _as_dtype(d: Any) -> torch.dtype:
    """A dtype named as the wire names it ("float32", "bfloat16", ...),
    or a torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    try:
        return BY_NAME[str(d)]
    except KeyError:
        raise TypeError(f"unsupported leaf dtype {d!r}") from None


def note_meta(eid: str, paths: Sequence[str], digests: Sequence[bytes],
              shapes: Sequence[Tuple[int, ...]],
              dtypes: Sequence[Any],
              scales: Optional[Sequence[Optional[float]]] = None
              ) -> ContribMeta:
    """Memoize planner metadata announced over the wire (SparseManifest
    leaf refs) WITHOUT the payload being resident: the planner can then
    key per-leaf subsets — and fully cached or fold-resumable plans can
    execute — before (or without) fetching a single chunk. treedef stays
    None: such metas are mapped onto the model by path.

    A leaf announced with a `scale` arrives as an int8 `CompressedLeaf`
    and is priced at one byte per element, as `contrib_meta` prices a
    resident one."""
    dts = tuple(_as_dtype(d) for d in dtypes)
    if scales is None:
        scales = (None,) * len(dts)
    meta = ContribMeta(
        treedef=None,
        digests=tuple(digests),
        shapes=tuple(tuple(s) for s in shapes),
        dtypes=dts,
        paths=tuple(paths),
        itemsizes=tuple(1 if s is not None else d.itemsize
                        for d, s in zip(dts, scales)),
        scales=_scales([None if s is None else float(s) for s in scales]),
    )
    _memoize(eid, meta)
    return meta


def memoized_meta(eid: str) -> Optional[ContribMeta]:
    """Planner metadata for a content id seen before, else None. Lets
    resolve() plan (and fully cached plans complete) without fetching
    the payload at all."""
    meta = _META_MEMO.get(eid)
    if meta is not None:
        _META_MEMO.move_to_end(eid)
    return meta


def clear_meta_memo() -> None:
    _META_MEMO.clear()


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafTask:
    index: int                    # global flatten index
    path: str                     # keystr
    sub_root: bytes               # per-tensor content address of output
    shape: Tuple[int, ...]
    dtype: torch.dtype
    stacked_nbytes: int           # k * leaf nbytes: live bytes to execute
    contributors: Tuple[int, ...] = ()
    digests: Tuple[bytes, ...] = ()
    base_frag: bytes = b""
    # per contributor, its int8 dequantization scale (None for a dense
    # payload); None when no contributor is int8
    scales: Optional[Tuple[Optional[float], ...]] = None

    @property
    def k(self) -> int:
        return len(self.contributors)

    @property
    def quantized(self) -> bool:
        """Every contributor arrives as an int8 payload."""
        return self.scales is not None and \
            all(s is not None for s in self.scales)


@dataclass(frozen=True)
class MergePlan:
    strategy: str
    reduction: str
    seed: int
    k: int
    cfg: Tuple[Tuple[str, Any], ...]      # sorted (name, value) pairs
    treedef: Any
    tasks: Tuple[LeafTask, ...]
    spec: Optional[MergeSpec] = None
    frag: bytes = b""                     # spec fragment (prefix probing)
    # per-contribution coverage (None entry = dense); None = all dense
    coverages: Optional[Tuple[Optional[Tuple[str, ...]], ...]] = None
    # model leaf indices covered by NO contribution: inherit-base
    base_only: Tuple[int, ...] = ()

    def cfg_dict(self) -> Dict[str, Any]:
        return dict(self.cfg)


def _leaf_subroot(frag: bytes, base_frag: bytes,
                  digests: Sequence[bytes], needs_key: bool,
                  seed: int, index: int) -> bytes:
    """Sub-root over ONE leaf's ordered contribution digests (the
    reference's derivation, byte for byte). A sparse plan passes only
    the leaf's covering subset, so the key equals that of a dense merge
    over exactly that subset."""
    h = hashlib.sha256(_DOMAIN_LEAF)
    h.update(frag)
    h.update(base_frag)
    h.update(len(digests).to_bytes(4, "big"))
    for d in digests:
        h.update(d)
    if needs_key:
        h.update(str(seed).encode())
        h.update(index.to_bytes(4, "big"))
    return h.digest()


def plan_merge(metas: Sequence[ContribMeta],
               strategy_name: Optional[str] = None, *,
               base: Any = None, seed: int = 0,
               reduction: Optional[str] = None,
               spec: Optional[MergeSpec] = None,
               coverages: Optional[Sequence[Optional[Tuple[str, ...]]]]
               = None, base_digests: Optional[Sequence[bytes]] = None,
               **cfg) -> MergePlan:
    """Emit a per-leaf merge plan from contribution metadata (canonical
    order). Payloads are not needed to plan — only their digests.
    `base_digests`: the base's leaf digests in flatten order where the
    caller holds them (a replica's registered base), sparing a hash of
    the whole base on every plan.

    `coverages` (parallel to `metas`) marks sparse contributions: the
    keystr leaf paths a contribution carries, or None for dense. Each
    leaf task is keyed on the contributions covering that leaf; a leaf
    covered by none inherits the base leaf (requires base=). The model
    structure comes from the first dense contribution, or from the base
    when every contribution is sparse."""
    if not metas:
        raise ValueError("plan_merge() requires at least one contribution")
    spec = _as_spec(spec, strategy_name, reduction, cfg)
    strat = get_strategy(spec.strategy)
    if strat.whole_model:
        raise ValueError(
            f"strategy {spec.strategy!r} is whole-model; use merge()")
    k = len(metas)
    if coverages is None:
        coverages = (None,) * k
    if len(coverages) != k:
        raise ValueError("coverages must parallel metas")
    # dense metas carrying their own treedef define the model structure;
    # a manifest-derived meta (treedef None) maps onto it by path
    dense = [j for j, cov in enumerate(coverages)
             if cov is None and metas[j].treedef is not None]
    with span("engine.plan", strategy=spec.strategy, k=k,
              leaves=(metas[dense[0]].leaf_count if dense else 0)):
        frag = spec.cache_fragment(
            with_reduction=(strat.binary_only and k > 2))
        if dense:
            first = metas[dense[0]]
            for j in dense[1:]:
                m = metas[j]
                if m.treedef != first.treedef or m.shapes != first.shapes \
                        or m.dtypes != first.dtypes:
                    raise ValueError(
                        "contributions disagree on tree structure")
            treedef = first.treedef
            shapes, dtypes = first.shapes, first.dtypes
        else:
            if base is None:
                raise ValueError(
                    "every contribution is sparse and no base was given; "
                    "the model structure must come from a dense "
                    "contribution or the base model")
            bflat, treedef = pytree.flatten(base)
            shapes = tuple(tuple(b.shape) for b in bflat)
            dtypes = tuple(b.dtype for b in bflat)
        paths = pytree.leaf_paths(treedef)
        n_leaves = len(paths)
        path_index = {p: i for i, p in enumerate(paths)}
        # per leaf: (contribution position, its leaf digest, its bytes
        # per element, its int8 scale) for every contribution covering
        # the leaf
        cover: List[List[Tuple[int, bytes, int, Optional[float]]]] = [
            [] for _ in range(n_leaves)]
        for j, (m, cov) in enumerate(zip(metas, coverages)):
            if cov is None and m.treedef is not None:
                for i in range(n_leaves):
                    cover[i].append((j, m.digests[i], m.itemsizes[i],
                                     m.scale_of(i)))
                continue
            if cov is not None and set(m.paths) != set(cov):
                raise ValueError(
                    f"contribution {j}: coverage descriptor does not "
                    "match its leaf paths")
            for local, p in enumerate(m.paths):
                i = path_index.get(p)
                if i is None:
                    raise ValueError(
                        f"contribution {j} covers leaf {p!r} which the "
                        "model structure does not have")
                if m.shapes[local] != shapes[i] \
                        or m.dtypes[local] != dtypes[i]:
                    raise ValueError(
                        f"contribution {j}: leaf {p!r} shape/dtype "
                        "disagrees with the model structure")
                cover[i].append((j, m.digests[local], m.itemsizes[local],
                                 m.scale_of(local)))
        if base is None:
            base_frags: Sequence[bytes] = [_NO_BASE] * n_leaves
        elif base_digests is not None:
            if len(base_digests) != n_leaves:
                raise ValueError(f"{len(base_digests)} base digests for "
                                 f"{n_leaves} leaves")
            base_frags = base_digests
        else:
            base_frags = tensor_digests(treedef.flatten_up_to(base))
        tasks = []
        base_only = []
        for i, path in enumerate(paths):
            if not cover[i]:
                # absent-leaf semantics: inherit-base (the spec fragment
                # encodes this choice). Only an all-sparse plan has such
                # leaves, and it took its structure from the base.
                base_only.append(i)
                continue
            digs = tuple(c[1] for c in cover[i])
            # int8 contributors stack at wire width: the merge-on-arrival
            # kernel never densifies them
            stacked = math.prod(shapes[i]) * sum(c[2] for c in cover[i])
            tasks.append(LeafTask(
                index=i, path=path,
                sub_root=_leaf_subroot(frag, base_frags[i], digs,
                                       strat.needs_key, seed, i),
                shape=shapes[i], dtype=dtypes[i],
                stacked_nbytes=stacked,
                contributors=tuple(c[0] for c in cover[i]),
                digests=digs, base_frag=base_frags[i],
                scales=_scales([c[3] for c in cover[i]])))
    any_sparse = any(c is not None for c in coverages)
    return MergePlan(strategy=spec.strategy, reduction=spec.reduction,
                     seed=seed, k=k, cfg=spec.cfg, treedef=treedef,
                     tasks=tuple(tasks), spec=spec, frag=frag,
                     coverages=tuple(coverages) if any_sparse else None,
                     base_only=tuple(base_only))


def plan_for(contribs: Sequence[Any],
             strategy_name: Optional[str] = None, *,
             contrib_ids: Optional[Sequence[str]] = None,
             base: Any = None, seed: int = 0,
             reduction: Optional[str] = None,
             spec: Optional[MergeSpec] = None,
             coverages: Optional[Sequence[Optional[Tuple[str, ...]]]]
             = None, base_digests: Optional[Sequence[bytes]] = None,
             **cfg) -> MergePlan:
    """Convenience planner over resident payloads (ids memoize digests)."""
    ids: Sequence[Optional[str]] = contrib_ids or [None] * len(contribs)
    metas = [contrib_meta(c, eid=e) for c, e in zip(contribs, ids)]
    return plan_merge(metas, strategy_name, base=base, seed=seed,
                      reduction=reduction, spec=spec, coverages=coverages,
                      base_digests=base_digests, **cfg)


# ---------------------------------------------------------------------------
# Byte-budgeted sub-root cache
# ---------------------------------------------------------------------------

_DEFAULT_ENTRY_LIMIT = 65536
_DEFAULT_BYTE_LIMIT = 256 * 2 ** 20


class CacheInfo(NamedTuple):
    entries: int
    bytes: int
    entry_limit: int
    byte_limit: int
    hits: int
    misses: int


class EngineCache:
    """One replica's merge-output cache + executor counters.

    sub_root -> (value, nbytes, aux); aux is an incremental strategy's
    float32 fold accumulator. LRU eviction under both an entry count
    and a resident-byte budget. Counters live on a per-cache registry
    (`self.obs`); `self.stats` is a Counter-shaped view over
    `engine_events_total{event=...}`."""

    __slots__ = ("_data", "_bytes", "entry_limit", "byte_limit", "obs",
                 "stats", "peak_stacked")

    def __init__(self, entries: int = _DEFAULT_ENTRY_LIMIT, *,
                 bytes: int = _DEFAULT_BYTE_LIMIT,  # noqa: A002
                 obs: Optional[MetricsRegistry] = None):
        self._data: "OrderedDict[bytes, Tuple[Any, int, Any]]" = \
            OrderedDict()
        self._bytes = 0
        self.entry_limit = entries
        self.byte_limit = bytes
        self.obs = obs if obs is not None else MetricsRegistry()
        self.stats = CounterView(self.obs, "engine_events_total")
        self.peak_stacked = 0

    def set_limit(self, entries: Optional[int] = None, *,
                  bytes: Optional[int] = None) -> None:  # noqa: A002
        """Bound the cache; evicts LRU-first immediately."""
        if entries is not None:
            if entries < 1:
                raise ValueError("cache entry limit must be >= 1")
            self.entry_limit = entries
        if bytes is not None:
            if bytes < 0:
                raise ValueError("cache byte limit must be >= 0")
            self.byte_limit = bytes
        self._evict()

    def info(self) -> CacheInfo:
        return CacheInfo(len(self._data), self._bytes, self.entry_limit,
                         self.byte_limit, self.stats["hits"],
                         self.stats["misses"])

    def clear(self) -> None:
        self._data.clear()
        self._bytes = 0
        self.obs.gauge("engine_cache_resident_bytes").set(0)

    def _evict(self) -> None:
        evicted = 0
        while self._data and (len(self._data) > self.entry_limit
                              or self._bytes > self.byte_limit):
            _, (_, nbytes, _) = self._data.popitem(last=False)
            self._bytes -= nbytes
            evicted += 1
        if evicted:
            self.stats["evictions"] += evicted
            self.obs.gauge("engine_cache_resident_bytes").set(self._bytes)

    def get(self, key: bytes) -> Optional[Any]:
        if key in self._data:
            self._data.move_to_end(key)
            return self._data[key][0]
        return None

    def put(self, key: bytes, value: Any, nbytes: int,
            aux: Any = None) -> None:
        if key in self._data:
            self._bytes -= self._data[key][1]
        self._data[key] = (value, nbytes, aux)
        self._data.move_to_end(key)
        self._bytes += nbytes
        self.obs.gauge("engine_cache_resident_bytes").set(self._bytes)
        self._evict()

    def aux(self, key: bytes) -> Optional[Any]:
        """The fold accumulator cached alongside a value (no recency
        bump, no counting — a resumption probe)."""
        ent = self._data.get(key)
        return ent[2] if ent is not None else None

    def __contains__(self, key: bytes) -> bool:
        return key in self._data

    def lookup(self, key: bytes) -> Optional[Any]:
        """Fetch-free probe: the cached value (counting a hit) or None
        (counting nothing: the caller computes through a path that
        records the miss itself)."""
        val = self.get(key)
        if val is not None:
            self.stats["hits"] += 1
        return val

    def split(self, plan: "MergePlan") -> Tuple[List["LeafTask"],
                                                List["LeafTask"]]:
        """(hits, misses): membership only, no recency bump, no
        counters."""
        hits = [t for t in plan.tasks if t.sub_root in self._data]
        misses = [t for t in plan.tasks if t.sub_root not in self._data]
        return hits, misses

    def exec_stats(self) -> Dict[str, int]:
        """Executor counters since the last reset: `leaf_tasks`,
        `dispatches`, `batched_leaves`, cache `hits` / `misses`, and
        `peak_stacked_bytes`, the largest set of stacked contribution
        slices live at once."""
        out = dict(self.stats)
        out["peak_stacked_bytes"] = self.peak_stacked
        return out

    def reset_exec_stats(self) -> None:
        self.stats.clear()
        self.peak_stacked = 0
        self.obs.gauge("engine_peak_stacked_bytes").set(0)

    def note_stacked(self, nbytes: int) -> None:
        self.peak_stacked = max(self.peak_stacked, nbytes)
        self.obs.gauge("engine_peak_stacked_bytes").set_max(nbytes)


_DEFAULT_CACHE = EngineCache()


def _cache_or_default(cache: Optional[EngineCache]) -> EngineCache:
    return cache if cache is not None else _DEFAULT_CACHE


def default_cache() -> EngineCache:
    """The process-wide cache the module-level helpers (and every call
    that does not pass `cache=`) operate on."""
    return _DEFAULT_CACHE


# Module-level helpers over the default cache, as the reference keeps
# them for single-replica processes and the test and bench harnesses
# (a `Replica` holds its own `EngineCache`).


def set_cache_limit(entries: Optional[int] = None, *,
                    bytes: Optional[int] = None) -> None:  # noqa: A002
    """Bound the default merge-output cache (`EngineCache.set_limit`)."""
    _DEFAULT_CACHE.set_limit(entries, bytes=bytes)


def cache_info() -> CacheInfo:
    """Occupancy, limits and counters of the default cache."""
    return _DEFAULT_CACHE.info()


def reset_cache_limits() -> None:
    """Restore the default cache's entry and byte limits."""
    _DEFAULT_CACHE.set_limit(_DEFAULT_ENTRY_LIMIT,
                             bytes=_DEFAULT_BYTE_LIMIT)


def cached(key: bytes, cache: Optional[EngineCache] = None) -> bool:
    return key in _cache_or_default(cache)


def cache_lookup(key: bytes,
                 cache: Optional[EngineCache] = None) -> Optional[Any]:
    """Fetch-free probe of a whole-model key (`EngineCache.lookup`)."""
    return _cache_or_default(cache).lookup(key)


def plan_cached_split(plan: "MergePlan",
                      cache: Optional[EngineCache] = None
                      ) -> Tuple[List["LeafTask"], List["LeafTask"]]:
    return _cache_or_default(cache).split(plan)


def exec_stats(cache: Optional[EngineCache] = None) -> Dict[str, int]:
    return _cache_or_default(cache).exec_stats()


def reset_exec_stats(cache: Optional[EngineCache] = None) -> None:
    _cache_or_default(cache).reset_exec_stats()


def clear_cache() -> None:
    """Drop the default cache's merge outputs AND the planner digest
    memo."""
    _DEFAULT_CACHE.clear()
    _META_MEMO.clear()


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def execute_plan(plan: MergePlan, contribs: Optional[Sequence[Any]], *,
                 base: Any = None, use_cache: bool = True,
                 max_batch_bytes: Optional[int] = None,
                 kernels: bool = False,
                 cache: Optional[EngineCache] = None) -> Any:
    """Run a merge plan and return the merged pytree.

    `contribs` is the canonical-order payload list; it may be None when
    every task is cached. Live stacked memory is bounded by the batch
    byte cap (default: the largest single leaf's stack).

    `kernels=True` is the reference's `pallas=True`: fused batches of the
    linear family go through the `nary_accum` kernel (integer leaves
    too, truncated back into their dtype as the reference does), or
    `quant_nary` when every slice is int8; histogram-trim TIES through
    `block_amax` / `block_hist` / `ties_block`; DARE through
    `dare_block` when `kernel_env.dare_kernel_rng` is set (CUDA for CUDA
    tensors, their plain versions for CPU tensors). Those outputs
    accumulate in fp32 and are held to a tolerance, not to the exact
    path's bytes, so they are NEVER written to the sub-root cache.
    Single-leaf groups take the exact path.
    """
    cache = _cache_or_default(cache)
    strat = get_strategy(plan.strategy)
    outputs: List[Optional[Any]] = \
        [None] * (len(plan.tasks) + len(plan.base_only))
    cache.obs.gauge("engine_plan_leaves").set(len(plan.tasks))
    cache.obs.gauge("engine_sparse_leaves_skipped").set(
        sum(1 for t in plan.tasks if t.k < plan.k) + len(plan.base_only))
    base_leaves = (plan.treedef.flatten_up_to(base)
                   if base is not None else None)
    if plan.base_only and base_leaves is None:
        raise ValueError("plan has inherit-base leaves but no base was "
                         "supplied to execute_plan()")
    for i in plan.base_only:
        outputs[i] = base_leaves[i]          # inherit-base

    misses: List[LeafTask] = []
    resumes: List[Tuple[LeafTask, int, Any]] = []
    for t in plan.tasks:
        hit = cache.get(t.sub_root) if use_cache else None
        if hit is not None:
            outputs[t.index] = hit
            cache.stats["hits"] += 1
        else:
            if use_cache:
                cache.stats["misses"] += 1
                rp = _fold_resume_point(strat, plan, t, cache)
                if rp is not None:
                    resumes.append((t, rp[0], rp[1]))
                    continue
            misses.append(t)
    with span("engine.execute", strategy=plan.strategy, k=plan.k,
              leaves=len(plan.tasks),
              misses=len(misses) + len(resumes)):
        if misses or resumes:
            if contribs is None:
                raise KeyError(
                    f"{len(misses) + len(resumes)} leaf tasks miss the "
                    "cache but no payloads were supplied")
            if len(contribs) != plan.k:
                raise ValueError(f"plan expects {plan.k} contributions, "
                                 f"got {len(contribs)}")
            flat = _flatten_contribs(plan, contribs)

            def leaf_raw(j: int, t: LeafTask):
                f = flat[j]
                return f[t.index] if isinstance(f, list) else f[t.path]

            def leaf_of(j: int, t: LeafTask):
                # the exact path densifies int8 slices where it reads
                # them (counted); the int8 kernel route reads leaf_raw
                return _dense_leaf(leaf_raw(j, t), obs=cache.obs)

            cfg = plan.cfg_dict()
            for t, m, aux in resumes:
                # the leaf's ordered subset grew append-only past a
                # cached prefix: fold only the new tail
                new = [leaf_of(j, t) for j in t.contributors[m:]]
                b = _base_leaf(base_leaves, t.index, new[0])
                cache.note_stacked(t.stacked_nbytes)
                kw = dict(strat.defaults)
                kw.update(cfg)
                val, acc = run_fold(strat.fold, new, b, acc=aux, k=t.k,
                                    **kw)
                outputs[t.index] = val
                cache.stats["leaf_tasks"] += 1
                cache.stats["dispatches"] += 1
                cache.stats["fold_resumes"] += 1
                cache.obs.counter("resolve_fold_updates_total").inc(
                    t.k - m)
                cache.put(t.sub_root, val,
                          int(val.nbytes) + int(acc.nbytes), aux=acc)
            if misses:
                if max_batch_bytes is None:
                    max_batch_bytes = max(t.stacked_nbytes
                                          for t in plan.tasks)
                kernel_fuse = kernels and \
                    _kernel_route(strat, cfg) is not None
                for group in _dispatch_groups(strat, misses,
                                              max_batch_bytes,
                                              fuse=kernel_fuse):
                    approximate = False
                    if len(group) == 1:
                        o, a = _execute_leaf(strat, plan, group[0],
                                             leaf_of, base_leaves, cache)
                        out, auxs = [o], [a]
                    else:
                        out, auxs, approximate = _execute_batch(
                            strat, plan, group, leaf_of, base_leaves,
                            cache, kernels=kernels, leaf_raw=leaf_raw)
                        cache.stats["batched_leaves"] += len(group)
                    cache.stats["dispatches"] += 1
                    cache.stats["leaf_tasks"] += len(group)
                    for t, o, a in zip(group, out, auxs):
                        outputs[t.index] = o
                        if use_cache and not approximate:
                            nb = int(o.nbytes) + (int(a.nbytes)
                                                  if a is not None else 0)
                            cache.put(t.sub_root, o, nb, aux=a)
    return plan.treedef.unflatten(outputs)


def _flatten_contribs(plan: MergePlan, contribs: Sequence[Any]
                      ) -> List[Any]:
    """Per-contribution leaf accessors: a flatten-order list for a dense
    contribution, a path-keyed dict for a sparse one, None for a payload
    the executor was told it will not need. A `CompressedTree` flattens
    to its `CompressedLeaf` payloads, densified where they are read."""
    covs = plan.coverages or (None,) * plan.k
    out: List[Any] = []
    for c, cov in zip(contribs, covs):
        if isinstance(c, CompressedTree):
            c = compressed_tree_to_structure(c)
        if c is None:
            out.append(None)
        elif cov is None:
            out.append(plan.treedef.flatten_up_to(c))
        else:
            out.append({pytree.keystr(p): leaf for p, leaf in
                        pytree.flatten_with_path(c)[0]})
    return out


def plan_needed_ids(plan: MergePlan, cache: Optional[EngineCache] = None,
                    *, use_cache: bool = True) -> Tuple[int, ...]:
    """Contribution positions whose payloads execution will need under
    the current cache state: contributors of cache-missed tasks, minus
    the already-folded prefix of fold-resumable tasks (O(changed))."""
    cache = _cache_or_default(cache)
    strat = get_strategy(plan.strategy)
    needed: set = set()
    for t in plan.tasks:
        if use_cache and t.sub_root in cache:
            continue
        rp = _fold_resume_point(strat, plan, t, cache) if use_cache \
            else None
        lo = rp[0] if rp is not None else 0
        needed.update(t.contributors[lo:])
    return tuple(sorted(needed))


def _fold_resume_point(strat: Strategy, plan: MergePlan, task: LeafTask,
                       cache: EngineCache) -> Optional[Tuple[int, Any]]:
    """Longest cached proper prefix of a missed fold-capable task:
    (m, accumulator), or None. Probes longest-first."""
    fold = strat.fold
    if fold is None or task.k < 2 or task.k < fold.min_k:
        return None
    for m in range(task.k - 1, fold.min_k - 1, -1):
        key = _leaf_subroot(plan.frag, task.base_frag,
                            task.digests[:m], strat.needs_key,
                            plan.seed, task.index)
        aux = cache.aux(key)
        if aux is not None:
            return m, aux
    return None


def _dispatch_groups(strat: Strategy, misses: List[LeafTask],
                     max_batch_bytes: int, *,
                     fuse: bool = False) -> List[List[LeafTask]]:
    """Partition missed tasks into dispatches. Elementwise strategies
    (and, with `fuse`, strategies with a kernel flat-batch route) fuse
    same-dtype leaves up to the batch byte cap, largest first;
    everything else runs one leaf per dispatch."""
    if not (strat.batchable or fuse):
        return [[t] for t in misses]
    groups: List[List[LeafTask]] = []
    # under sparse contributions only leaves with the SAME ordered
    # contributor subset fuse: a [k_i, N] batch has one k_i
    by_dtype: Dict[Any, List[LeafTask]] = {}
    for t in misses:
        by_dtype.setdefault((t.dtype, t.contributors), []).append(t)
    for tasks in by_dtype.values():
        tasks = sorted(tasks, key=lambda t: (-t.stacked_nbytes, t.index))
        cur: List[LeafTask] = []
        cur_bytes = 0
        for t in tasks:
            if cur and cur_bytes + t.stacked_nbytes > max_batch_bytes:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(t)
            cur_bytes += t.stacked_nbytes
        if cur:
            groups.append(cur)
    return groups


def _base_leaf(base_leaves, idx: int, like) -> Any:
    if base_leaves is None:
        return torch.zeros_like(like)
    return base_leaves[idx]


def _execute_leaf(strat: Strategy, plan: MergePlan, task: LeafTask,
                  leaf_of, base_leaves, cache: EngineCache
                  ) -> Tuple[Any, Any]:
    """One leaf over its ordered contributors: a binary-only strategy at
    k > 2 folds pairwise (`MergeSpec.reduction`: "tree" or in sequence),
    with the reference's per-step seeds; incremental strategies run
    their fold (keeping the accumulator for resumption); everything else
    runs the leaf function on the [k, ...] stack."""
    slices = [leaf_of(j, task) for j in task.contributors]
    cache.note_stacked(task.stacked_nbytes)
    cfg = plan.cfg_dict()
    if strat.binary_only and len(slices) > 2:
        return pairwise_fold(slices, lambda x, y, sd: strat.apply_leaf(
            torch.stack([x, y]), _base_leaf(base_leaves, task.index, x),
            leaf_index=task.index, seed=sd, **cfg), plan.seed,
            plan.reduction), None
    b = _base_leaf(base_leaves, task.index, slices[0])
    if strat.fold is not None and len(slices) >= strat.fold.min_k:
        kw = dict(strat.defaults)
        kw.update(cfg)
        return run_fold(strat.fold, slices, b, **kw)
    return strat.apply_leaf(torch.stack(slices), b, leaf_index=task.index,
                            seed=plan.seed, **cfg), None


def _kernel_route(strat: Strategy, cfg: Dict[str, Any]) -> Optional[str]:
    """The kernel flat-batch route beyond the elementwise nary one, or
    None: "ties_hist" for TIES with the histogram trim (its sort-free
    threshold keeps per-leaf statistics through batching); "dare" for
    DARE when `kernel_env.dare_kernel_rng` is set (opt-in: the kernel's
    counter-hash sampler is not the catalog's threefry, so replicas
    agree only when all of them opt in)."""
    from repro_torch.kernels.config import kernel_env
    if strat.name == "ties" and \
            str(cfg.get("trim_method", "quantile")) == "histogram":
        return "ties_hist"
    if strat.name == "dare" and kernel_env.dare_kernel_rng:
        return "dare"
    return None


def _base_row(base_leaves, t: LeafTask) -> Optional[torch.Tensor]:
    """The leaf's base as a row, None without a base: the flat batch
    widens it to fp32 in place and leaves a missing base zero."""
    if base_leaves is None:
        return None
    return base_leaves[t.index].reshape(-1)


def _kernel_batch(strat: Strategy, plan: MergePlan, group: List[LeafTask],
                  leaf_raw, base_leaves, cache: EngineCache
                  ) -> Optional[Tuple[List[Any], List[Any], bool]]:
    """Kernel-frontier dispatch for a group of same-dtype float leaves,
    keeping per-leaf tile boundaries so per-leaf statistics survive
    batching. Routes, in the reference's order: histogram-trim TIES
    (three launches); counter-RNG DARE (opt-in; leaf i's seed is
    `plan.seed + i`, low 32 bits); int8 merge-on-arrival for
    linear-family groups whose every slice arrived quantized, which
    never densifies a slice. None when no route applies; else (outs,
    auxs, True): fp32-accumulated tolerance outputs, never cached."""
    from repro_torch.kernels import ops as kops
    cfg = plan.cfg_dict()
    if not group[0].dtype.is_floating_point:
        return None
    route = _kernel_route(strat, cfg)

    def dense_rows(t: LeafTask):
        return [_dense_leaf(leaf_raw(j, t), obs=cache.obs).reshape(-1)
                for j in t.contributors]

    if route in ("ties_hist", "dare"):
        rows = [dense_rows(t) for t in group]
        bases = [_base_row(base_leaves, t) for t in group]
        cache.note_stacked(2 * sum(int(x.nbytes) for r in rows for x in r))
        if route == "ties_hist":
            flats = kops.ties_batch_merge(rows, bases,
                                          float(cfg.get("trim", 0.2)))
        else:
            flats = kops.dare_batch_merge(
                rows, bases, [plan.seed + t.index for t in group],
                float(cfg.get("p", 0.5)))
        kernel = route
    else:
        form = _nary_weights(strat.name, group[0].k, cfg)
        if form is None:
            return None
        raw = [[leaf_raw(j, t) for j in t.contributors] for t in group]
        if not all(_is_qleaf(x) for slices in raw for x in slices):
            return None
        weights, uses_base = form
        bases = [_base_row(base_leaves if uses_base else None, t)
                 for t in group]
        cache.note_stacked(2 * sum(t.stacked_nbytes for t in group))
        flats = kops.quant_batch_merge(
            [[x.q.reshape(-1) for x in slices] for slices in raw],
            [torch.stack([x.scale for x in slices]) for slices in raw],
            bases, weights)
        kernel = "quant_nary"
        cache.obs.counter("engine_quant_leaves_merged_total").inc(len(group))
    cache.stats["pallas_dispatches"] += 1
    cache.obs.counter("kernel_dispatch_total").inc(kernel=kernel)
    outs = [f.reshape(t.shape).to(t.dtype) for f, t in zip(flats, group)]
    return outs, [None] * len(group), True


def _nary_weights(name: str, k: int, cfg: Dict[str, Any]
                  ) -> Optional[Tuple[List[float], bool]]:
    """(weights, uses_base) for strategies of the nary_accum form
    out = base + sum_i w_i (x_i - base); None if not of that form."""
    if name == "weight_average":
        return [1.0 / k] * k, False
    if name == "linear":
        t = float(cfg.get("t", 0.5))
        if k == 2:
            return [1.0 - t, t], False
        return [1.0 / k] * k, False
    if name == "task_arithmetic":
        return [float(cfg.get("lam", 1.0))] * k, True
    if name == "negative_merge":
        return [-float(cfg.get("lam", 0.5)) / k] * k, True
    return None


def _nary_pallas_batch(strat: Strategy, group: List[LeafTask], leaf_of,
                       base_leaves, cfg: Dict[str, Any],
                       cache: EngineCache) -> Optional[List[Any]]:
    """The linear family's fused `nary_accum` dispatch over a group
    (the reference's `_nary_pallas_batch`); None when the strategy has
    no nary weight form. bf16 rows stream in bf16 and widen in the
    kernel, as the reference's `preserve_dtype`."""
    ki = group[0].k
    form = _nary_weights(strat.name, ki, cfg)
    if form is None:
        return None
    weights, uses_base = form
    from repro_torch.kernels import ops as kops
    rows = [[leaf_of(j, t).reshape(-1) for j in t.contributors]
            for t in group]
    bases = [_base_row(base_leaves if uses_base else None, t)
             for t in group]
    cache.note_stacked(2 * sum(t.stacked_nbytes for t in group))
    flats = kops.nary_flat_merge(rows, bases, weights)
    cache.stats["pallas_dispatches"] += 1
    cache.obs.counter("kernel_dispatch_total").inc(kernel="nary_accum")
    return [f.reshape(t.shape).to(t.dtype) for f, t in zip(flats, group)]


def _execute_batch(strat: Strategy, plan: MergePlan, group: List[LeafTask],
                   leaf_of, base_leaves, cache: EngineCache, *,
                   kernels: bool, leaf_raw
                   ) -> Tuple[List[Any], List[Any], bool]:
    """Fused dispatch over same-dtype, same-contributor leaves: flatten
    each leaf's k slices, concatenate along the element axis, apply the
    leaf function ONCE on [k, N], slice the outputs back — byte-equal to
    leaf-at-a-time execution for elementwise strategies. Returns
    (outputs, auxs, approximate); approximate=True means a kernel route
    produced the outputs and the caller must not cache them.

    With `kernels`, as in the reference: float groups try the kernel
    frontier (`_kernel_batch`, reading raw int8 slices through
    `leaf_raw`); then every linear-family group, integer ones included,
    takes `nary_accum`, whose fp32 output is cast back into the leaf
    dtype (truncating toward zero for integers, as `astype` does)."""
    contributors = group[0].contributors
    ki = len(contributors)
    cfg = plan.cfg_dict()
    if kernels:
        routed = _kernel_batch(strat, plan, group, leaf_raw, base_leaves,
                               cache)
        if routed is not None:
            return routed
        outs = _nary_pallas_batch(strat, group, leaf_of, base_leaves, cfg,
                                  cache)
        if outs is not None:
            return outs, [None] * len(group), True
    stacked = torch.cat(
        [torch.stack([leaf_of(j, t).reshape(-1) for j in contributors])
         for t in group], dim=1)
    # the per-leaf stacks and the concatenated copy are both live while
    # cat runs: account 2x
    cache.note_stacked(2 * int(stacked.nbytes))
    if base_leaves is None:
        b = torch.zeros(stacked.shape[1:], dtype=stacked.dtype,
                        device=stacked.device)
    else:
        b = torch.cat([base_leaves[t.index].reshape(-1) for t in group])
    acc = None
    if strat.fold is not None and ki >= strat.fold.min_k:
        kw = dict(strat.defaults)
        kw.update(cfg)
        merged, acc = run_fold(strat.fold, stacked, b, **kw)
    else:
        merged = strat.apply_leaf(stacked, b, leaf_index=group[0].index,
                                  seed=plan.seed, **cfg)
    outs: List[Any] = []
    auxs: List[Any] = []
    off = 0
    for t in group:
        n = math.prod(t.shape)
        outs.append(merged[off:off + n].reshape(t.shape))
        auxs.append(acc[off:off + n].reshape(t.shape)
                    if acc is not None else None)
        off += n
    return outs, auxs, False


# ---------------------------------------------------------------------------
# Whole-model route
# ---------------------------------------------------------------------------


def model_key(strategy_name: Optional[str],
              contrib_digests: Sequence[bytes], *,
              base: Any = None, seed: int = 0,
              reduction: Optional[str] = None,
              spec: Optional[MergeSpec] = None,
              base_digest: Optional[bytes] = None, **cfg) -> bytes:
    """The whole-model cache key, byte-equal to the reference's:
    SHA-256(domain || spec fragment || base digest || k || digests [||
    seed]). `base_digest` is the base's `pytree_digest` where the caller
    already holds it (a registered base's ref), saving a hash of the
    whole base."""
    spec = _as_spec(spec, strategy_name, reduction, cfg)
    strat = get_strategy(spec.strategy)
    h = hashlib.sha256(_DOMAIN_MODEL)
    k = len(contrib_digests)
    h.update(spec.cache_fragment(
        with_reduction=(strat.binary_only and k > 2)))
    if base_digest is None:
        base_digest = pytree_digest(base) if base is not None else _NO_BASE
    h.update(base_digest)
    h.update(k.to_bytes(4, "big"))
    for d in contrib_digests:
        h.update(d)
    if strat.needs_key:
        h.update(str(seed).encode())
    return h.digest()


def _is_hex(s: str) -> bool:
    try:
        bytes.fromhex(s)
        return len(s) % 2 == 0 and len(s) > 0
    except ValueError:
        return False


def _eid_digests(contribs: Sequence[Any],
                 contrib_ids: Optional[Sequence[str]]) -> List[bytes]:
    if contrib_ids is not None:
        return [bytes.fromhex(e) if _is_hex(e) else e.encode()
                for e in contrib_ids]
    return [pytree_digest(c) for c in contribs]


def _whole_model(strat: Strategy, contribs: Sequence[Any], spec: MergeSpec,
                 *, base: Any, seed: int) -> Any:
    """`reference_apply`'s whole-tree result, one leaf at a time: each
    leaf's [k, ...] stack through `apply_leaf` at its global flatten
    index (the key `leafwise` derives), freed before the next."""
    flat = [pytree.flatten(c) for c in contribs]
    treedef = flat[0][1]
    for _, td in flat[1:]:
        if td != treedef:
            raise ValueError("contributions disagree on tree structure")
    base_leaves = treedef.flatten_up_to(base) if base is not None else None
    cfg = spec.cfg_dict()
    outs = []
    for i in range(len(flat[0][0])):
        stacked = torch.stack([leaves[i] for leaves, _ in flat])
        b = _base_leaf(base_leaves, i, stacked[0])
        outs.append(strat.apply_leaf(stacked, b, leaf_index=i, seed=seed,
                                     **cfg))
        del stacked
    return treedef.unflatten(outs)


def densify_contributions(contribs: Sequence[Any],
                          coverages: Sequence[Optional[Tuple[str, ...]]],
                          base: Any) -> List[Any]:
    """Dense view of a mixed dense/sparse contribution list: each sparse
    contribution's absent leaves are the base's own tensors
    (inherit-base). Whole-model strategies consume this."""
    out: List[Any] = []
    bflat = btd = None
    for c, cov in zip(contribs, coverages):
        if cov is None:
            out.append(c)
            continue
        if base is None:
            raise ValueError(
                "a sparse contribution requires a base model here: its "
                "absent leaves inherit the base (whole-model strategies "
                "operate on densified contributions)")
        if bflat is None:
            bflat, btd = pytree.flatten_with_path(base)
        have = {pytree.keystr(p): leaf
                for p, leaf in pytree.flatten_with_path(c)[0]}
        out.append(btd.unflatten([have.get(pytree.keystr(p), leaf)
                                  for p, leaf in bflat]))
    return out


def merge(contribs: Sequence[Any], strategy_name: Optional[str] = None, *,
          contrib_ids: Optional[Sequence[str]] = None, base: Any = None,
          seed: int = 0, reduction: Optional[str] = None,
          use_cache: bool = True,
          max_batch_bytes: Optional[int] = None, kernels: bool = False,
          spec: Optional[MergeSpec] = None,
          cache: Optional[EngineCache] = None,
          key: Optional[bytes] = None,
          coverages: Optional[Sequence[Optional[Tuple[str, ...]]]] = None,
          base_digests: Optional[Sequence[bytes]] = None,
          **cfg) -> Any:
    """Merge an ORDERED contribution list through the engine.

    Byte-identical to `core.resolve.reference_apply` on the same inputs
    (`sparse_reference_apply` with `coverages`). `kernels=True` is the
    reference's `pallas=True` (see execute_plan). Takes a MergeSpec
    (`spec=`) or a strategy name + kwargs. `coverages` marks sparse
    contributions and `base_digests` passes the base's leaf digests (see
    plan_merge). A whole-model strategy densifies
    them first and is one dispatch (`whole_model_dispatches`) with one
    cache entry under `model_key`; `key` passes a key the caller has
    already made (resolve's cache probe), and without the cache no key
    is made.
    """
    if not contribs:
        raise ValueError("merge() requires at least one contribution")
    spec = _as_spec(spec, strategy_name, reduction, cfg)
    cache = _cache_or_default(cache)
    strat = get_strategy(spec.strategy)
    if strat.whole_model:
        cache.stats["whole_model_dispatches"] += 1
        if coverages is not None and any(c is not None
                                         for c in coverages):
            contribs = densify_contributions(contribs, coverages, base)
        if use_cache:
            if key is None:
                key = model_key(None, _eid_digests(contribs, contrib_ids),
                                base=base, seed=seed, spec=spec)
            hit = cache.get(key)
            if hit is not None:
                cache.stats["hits"] += 1
                return hit
            cache.stats["misses"] += 1
        with span("engine.whole_model", strategy=spec.strategy,
                  k=len(contribs)):
            out = _whole_model(strat, contribs, spec, base=base, seed=seed)
        if use_cache:
            cache.put(key, out, sum(int(x.nbytes)
                                    for x in pytree.leaves(out)))
        return out
    cache.stats["planned_merges"] += 1
    plan = plan_for(contribs, contrib_ids=contrib_ids,
                    base=base, seed=seed, spec=spec, coverages=coverages,
                    base_digests=base_digests)
    return execute_plan(plan, contribs, base=base, use_cache=use_cache,
                        max_batch_bytes=max_batch_bytes, kernels=kernels,
                        cache=cache)
