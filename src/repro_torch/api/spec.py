"""MergeSpec — one typed, canonically-hashable description of a resolve
(`repro.api.spec`, ported byte for byte: the encoding, digest and cache
fragment of a spec are equal in both packages).

The paper's Layer-2 guarantee (Def. 6) is that the merged model is a
pure function of the contribution set and *what to resolve*: strategy,
per-strategy configuration, base reference, reduction, and (for the
Byzantine extension) the trust threshold. Historically that second
argument was smeared across free-function kwargs — unvalidated
``**cfg`` strings that strategies silently ignored when misspelled.
``MergeSpec`` reifies it:

  * **validated** — every catalog strategy declares a cfg schema
    (:attr:`repro_torch.strategies.base.Strategy.cfg_schema`), so an unknown
    or ill-typed knob raises at spec *construction*, with a
    did-you-mean, instead of being dropped at merge time;
  * **canonical** — ``spec.encode()`` is a deterministic byte encoding
    (cfg sorted by name, schema defaults filled in), so two replicas
    that mean the same resolve produce the same bytes regardless of
    construction order or whether defaults were spelled out;
  * **hashable** — ``spec.digest()`` (SHA-256 of the encoding) feeds
    the merge engine's sub-root cache keys: same spec ⇒ same keys ⇒
    warm cache hits across every entry point;
  * **wire-serializable** — ``encode()``/``decode()`` round-trip, so
    nodes can gossip *what to resolve*, not just contributions.

>>> s1 = MergeSpec("ties", {"trim": 0.3})
>>> s2 = MergeSpec("ties", {"trim": 0.3, "trim_method": "quantile"})
>>> s1.digest() == s2.digest()        # defaults are canonicalized in
True
>>> MergeSpec.decode(s1.encode()) == s1
True
>>> MergeSpec("ties", {"tirm": 0.2})       # doctest: +IGNORE_EXCEPTION_DETAIL
Traceback (most recent call last):
    ...
SpecError: unknown cfg key 'tirm' for strategy 'ties'; did you mean 'trim'?
"""
from __future__ import annotations

import difflib
import hashlib
import struct
from dataclasses import dataclass, InitVar
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.strategies import get_strategy

__all__ = ["MergeSpec", "SpecError", "coerce_spec"]

_MAGIC = b"MS1"                 # spec-encoding version tag
_REDUCTIONS = ("fold", "tree")

# cfg value tags (canonical TLV encoding)
_V_NONE = 0x00
_V_BOOL = 0x01
_V_INT = 0x02
_V_FLOAT = 0x03
_V_STR = 0x04
_V_BYTES = 0x05
_V_DIGEST = 0x06                # content hash of a non-scalar value;
#                                 hashable/cacheable but NOT decodable

# v2: the fragment names the absent-leaf semantics (a leaf covered by
# no contribution inherits the base — paper Remark 16 reference
# semantics). Folding the choice into every sub-root/model key means a
# future alternative semantics (e.g. absent = zeros) can never alias a
# cache entry computed under this one.
_FRAG_DOMAIN = b"repro/api/spec-frag/v2|absent-leaf:inherit-base"


class SpecError(TypeError):
    """Invalid MergeSpec: unknown/ill-typed cfg, bad field value."""


def coerce_spec(spec: Any, cfg: Optional[Mapping[str, Any]] = None, *,
                reduction: Optional[str] = None,
                lenient: bool = False) -> "MergeSpec":
    """Normalize the dual-form resolve surfaces: pass a MergeSpec
    through (rejecting stray cfg/reduction arguments — they belong
    inside the spec), or build one from a strategy name. `lenient`
    skips schema validation for the deprecated **cfg shims."""
    if isinstance(spec, MergeSpec):
        if cfg or reduction is not None:
            extras = sorted(cfg or ()) + \
                (["reduction"] if reduction is not None else [])
            raise TypeError("cfg kwargs belong inside the MergeSpec, "
                            f"not the call ({extras})")
        return spec
    if not isinstance(spec, str):
        raise TypeError("expected a MergeSpec or a strategy name, got "
                        f"{type(spec).__name__}")
    build = MergeSpec.lenient if lenient else MergeSpec
    return build(spec, cfg, reduction=reduction or "fold")


def _p_str(buf: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    buf += struct.pack(">I", len(b))
    buf += b


def _p_bytes(buf: bytearray, b: bytes) -> None:
    buf += struct.pack(">I", len(b))
    buf += b


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise SpecError("truncated MergeSpec encoding")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def str_(self) -> str:
        return self.take(self.u32()).decode("utf-8")

    def bytes_(self) -> bytes:
        return self.take(self.u32())


def _enc_cfg_value(buf: bytearray, v: Any) -> None:
    if v is None:
        buf.append(_V_NONE)
    elif isinstance(v, bool):                  # before int (bool is int)
        buf.append(_V_BOOL)
        buf.append(1 if v else 0)
    elif isinstance(v, int):
        buf.append(_V_INT)
        _p_str(buf, str(v))                    # arbitrary precision
    elif isinstance(v, float):
        buf.append(_V_FLOAT)
        buf += struct.pack(">d", v)
    elif isinstance(v, str):
        buf.append(_V_STR)
        _p_str(buf, v)
    elif isinstance(v, bytes):
        buf.append(_V_BYTES)
        _p_bytes(buf, v)
    else:
        # arrays / pytrees: content-hash so large knobs key the cache
        # exactly — such a spec digests and caches fine but cannot be
        # wire-decoded
        from repro_torch.core.hashing import pytree_digest
        buf.append(_V_DIGEST)
        _p_bytes(buf, pytree_digest(v))


def _dec_cfg_value(r: _Reader) -> Any:
    tag = r.u8()
    if tag == _V_NONE:
        return None
    if tag == _V_BOOL:
        return bool(r.u8())
    if tag == _V_INT:
        return int(r.str_())
    if tag == _V_FLOAT:
        return struct.unpack(">d", r.take(8))[0]
    if tag == _V_STR:
        return r.str_()
    if tag == _V_BYTES:
        return r.bytes_()
    if tag == _V_DIGEST:
        raise SpecError("MergeSpec cfg carries a content-hashed (array) "
                        "value; such specs are not wire-decodable")
    raise SpecError(f"unknown MergeSpec cfg value tag 0x{tag:02x}")


def _type_ok(value: Any, typ: type) -> bool:
    if typ is float:
        # ints promote to float knobs; bools never do (bool ⊂ int trap)
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)
    if typ is int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, typ)


def _validate_cfg(strategy: str, cfg: Dict[str, Any]) -> None:
    schema = get_strategy(strategy).cfg_schema
    if schema is None:
        if cfg:
            raise SpecError(
                f"strategy {strategy!r} declares no cfg schema; cfg "
                f"{sorted(cfg)} cannot be validated — use "
                "MergeSpec.lenient() or declare a schema")
        return
    for key, value in cfg.items():
        if key not in schema:
            hint = difflib.get_close_matches(key, schema, n=1,
                                             cutoff=0.6)
            did = f"; did you mean {hint[0]!r}?" if hint else ""
            declared = ", ".join(sorted(schema)) or "<none>"
            raise SpecError(
                f"unknown cfg key {key!r} for strategy {strategy!r}"
                f"{did} (declared: {declared})")
        typ, _default = schema[key]
        if not _type_ok(value, typ):
            raise SpecError(
                f"cfg {key!r} for strategy {strategy!r} expects "
                f"{typ.__name__}, got {type(value).__name__} "
                f"({value!r})")


def _normalize_cfg(strategy: str, cfg: Dict[str, Any]
                   ) -> Tuple[Tuple[str, Any], ...]:
    """Sorted (name, value) pairs with declared defaults filled in, so
    MergeSpec("ties") and MergeSpec("ties", {"trim": 0.2}) digest — and
    therefore cache — identically."""
    schema = get_strategy(strategy).cfg_schema
    full = dict(cfg)
    for key, (typ, default) in (schema or {}).items():
        if key not in full:
            full[key] = default
        elif typ is float and isinstance(full[key], int) \
                and not isinstance(full[key], bool):
            full[key] = float(full[key])       # canonical: 1 ≡ 1.0
    return tuple(sorted(full.items()))


@dataclass(frozen=True, eq=False)
class MergeSpec:
    """What to resolve: strategy + typed cfg + base reference +
    reduction (+ trust threshold, + hierarchical group size).

    ``cfg`` is normalized at construction to a sorted tuple of
    (name, value) pairs with the strategy's declared defaults filled
    in. ``base_ref`` is the hex content digest of the base pytree (the
    payload itself travels out of band — content-addressed, so the ref
    pins it exactly). ``trust_threshold`` gates the visible set at the
    Layer-2 boundary; ``group_size`` requests a two-level
    (hierarchical) resolve.
    """

    strategy: str
    cfg: Any = None
    reduction: str = "fold"
    base_ref: Optional[str] = None
    trust_threshold: Optional[float] = None
    group_size: Optional[int] = None
    validate: InitVar[bool] = True

    def __post_init__(self, validate: bool) -> None:
        get_strategy(self.strategy)            # KeyError: unknown name
        if self.reduction not in _REDUCTIONS:
            raise SpecError(f"reduction must be one of {_REDUCTIONS}, "
                            f"got {self.reduction!r}")
        if self.base_ref is not None and not isinstance(self.base_ref,
                                                        str):
            raise SpecError("base_ref must be a hex digest string")
        if self.trust_threshold is not None and not (
                0.0 <= float(self.trust_threshold) <= 1.0):
            raise SpecError("trust_threshold must be in [0, 1]")
        if self.group_size is not None and (
                not isinstance(self.group_size, int)
                or self.group_size < 1):
            raise SpecError("group_size must be a positive int")
        cfg = self.cfg
        if cfg is None:
            cfg = {}
        elif isinstance(cfg, tuple):
            cfg = dict(cfg)
        elif isinstance(cfg, Mapping):
            cfg = dict(cfg)
        else:
            raise SpecError("cfg must be a mapping of knob name to "
                            f"value, got {type(cfg).__name__}")
        if validate:
            _validate_cfg(self.strategy, cfg)
        object.__setattr__(self, "cfg",
                           _normalize_cfg(self.strategy, cfg))
        # remembered so replace() preserves the validation mode: a
        # lenient (shim-produced) spec must stay constructible when an
        # unrelated field is swapped
        object.__setattr__(self, "_lenient", not validate)

    # ------------------------------------------------------ construction

    @classmethod
    def lenient(cls, strategy: str,
                cfg: Optional[Mapping[str, Any]] = None, *,
                reduction: str = "fold", base_ref: Optional[str] = None,
                trust_threshold: Optional[float] = None,
                group_size: Optional[int] = None) -> "MergeSpec":
        """Build a spec WITHOUT schema validation (defaults are still
        canonicalized in). This is what the legacy ``**cfg`` shims use:
        their kwargs were never validated, and rejecting them now would
        change behaviour under deprecation. New code should construct
        MergeSpec directly and get validation."""
        return cls(strategy, cfg, reduction, base_ref, trust_threshold,
                   group_size, validate=False)

    def replace(self, **changes: Any) -> "MergeSpec":
        """A copy with fields swapped. Validation mode is preserved: a
        strict spec revalidates its cfg, a lenient (shim-produced) one
        stays lenient — swapping group_size must not suddenly reject
        cfg the original constructor accepted."""
        fields = dict(strategy=self.strategy, cfg=dict(self.cfg),
                      reduction=self.reduction, base_ref=self.base_ref,
                      trust_threshold=self.trust_threshold,
                      group_size=self.group_size)
        fields.update(changes)
        return MergeSpec(**fields, validate=not self._lenient)

    # ------------------------------------------------------------- views

    def cfg_dict(self) -> Dict[str, Any]:
        return dict(self.cfg)

    # -------------------------------------------------- canonical bytes

    def encode(self) -> bytes:
        """Canonical byte encoding (the wire form; also what digest()
        hashes). Deterministic: cfg sorted, defaults normalized in."""
        buf = bytearray(_MAGIC)
        _p_str(buf, self.strategy)
        _p_str(buf, self.reduction)
        if self.base_ref is None:
            buf.append(0)
        else:
            buf.append(1)
            _p_str(buf, self.base_ref)
        if self.trust_threshold is None:
            buf.append(0)
        else:
            buf.append(1)
            buf += struct.pack(">d", float(self.trust_threshold))
        if self.group_size is None:
            buf.append(0)
        else:
            buf.append(1)
            buf += struct.pack(">I", self.group_size)
        buf += struct.pack(">I", len(self.cfg))
        for key, value in self.cfg:
            _p_str(buf, key)
            _enc_cfg_value(buf, value)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "MergeSpec":
        """Inverse of encode() (strict validation applies — a gossiped
        spec with cfg its strategy never declared is rejected)."""
        r = _Reader(data)
        if r.take(len(_MAGIC)) != _MAGIC:
            raise SpecError("not a MergeSpec encoding (bad magic)")
        strategy = r.str_()
        reduction = r.str_()
        base_ref = r.str_() if r.u8() else None
        threshold = struct.unpack(">d", r.take(8))[0] if r.u8() else None
        group = struct.unpack(">I", r.take(4))[0] if r.u8() else None
        cfg = {}
        for _ in range(r.u32()):
            key = r.str_()
            cfg[key] = _dec_cfg_value(r)
        if r.pos != len(data):
            raise SpecError(f"{len(data) - r.pos} trailing MergeSpec "
                            "bytes")
        return cls(strategy, cfg, reduction, base_ref, threshold, group)

    def wire_decodable(self) -> bool:
        """True when every cfg value is a scalar — i.e. decode(encode())
        reconstructs the spec. Array-valued (lenient) cfg is encoded as
        a content hash: it digests and caches exactly, but a peer could
        never reconstruct the array, so such specs must not be gossiped
        (the wire codec refuses them at encode time)."""
        return all(v is None or isinstance(v, (bool, int, float, str,
                                               bytes))
                   for _, v in self.cfg)

    def digest(self) -> bytes:
        """SHA-256 of the canonical encoding — the engine cache-key
        seed: equal specs produce equal sub-root keys, so a resolve
        described by the same spec is a warm hit no matter which entry
        point (facade or legacy shim) asked for it."""
        return hashlib.sha256(self.encode()).digest()

    def cache_fragment(self, with_reduction: bool = True) -> bytes:
        """The slice of the spec that shapes merge *arithmetic* —
        strategy + cfg (+ reduction where it matters: binary-only folds
        at k > 2). Excludes base_ref / trust_threshold / group_size:
        those select *inputs* (which already enter the sub-root via the
        contribution digests and base-leaf digest), so including them
        would only forfeit cache hits."""
        buf = bytearray(_FRAG_DOMAIN)
        _p_str(buf, self.strategy)
        _p_str(buf, self.reduction if with_reduction else "-")
        buf += struct.pack(">I", len(self.cfg))
        for key, value in self.cfg:
            _p_str(buf, key)
            _enc_cfg_value(buf, value)
        return hashlib.sha256(bytes(buf)).digest()

    # ---------------------------------------------------------- equality

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, MergeSpec):
            return NotImplemented
        # by canonical bytes: array-valued cfg compares by content hash
        # (tuple equality on raw arrays would raise)
        return self.encode() == other.encode()

    def __hash__(self) -> int:
        return hash(self.digest())

    def __repr__(self) -> str:
        parts = [repr(self.strategy)]
        if self.cfg:
            parts.append(f"cfg={dict(self.cfg)!r}")
        if self.reduction != "fold":
            parts.append(f"reduction={self.reduction!r}")
        if self.base_ref is not None:
            parts.append(f"base_ref={self.base_ref[:12]!r}…")
        if self.trust_threshold is not None:
            parts.append(f"trust_threshold={self.trust_threshold}")
        if self.group_size is not None:
            parts.append(f"group_size={self.group_size}")
        return f"MergeSpec({', '.join(parts)})"
