"""Sharded content-addressed blob store: placement + multi-source fetch
(`repro.net.store`).

Layer-1 metadata (the OR-Set of add entries and tombstones) is fully
replicated — convergence depends on it — but contribution *payloads* are
content-addressed by eid and need not live everywhere. This module
supplies the placement policy and the bookkeeping records that turn
`repro_torch.net` from "every node stores every blob" into a
partial-replication system:

  * `rendezvous_holders` / `Placement` — highest-random-weight (HRW)
    hashing over the eid digest assigns each blob to `r` storage nodes
    deterministically, with minimal reshuffling when membership changes
    (only blobs placed on a departed node move). Plain Python, the
    reference's code: both packages place every eid on the same nodes.
  * `chunk_bitmap` / `bitmap_indices` — the compact per-chunk holding
    encoding carried by the HaveMap wire frame.
  * `BlobSource` — one peer's claim over a blob, recorded by the
    multi-source chunk scheduler in `net.antientropy`.
  * `payload_nbytes` — the resident size of one store payload, summed
    from tensor metadata (`numel() * element_size()`): no byte leaves
    the device to size a payload. An int8 payload (`CompressedTree`)
    counts its `q` and `scale` bytes, where the reference's flatten
    treats the tree as one opaque leaf and reads 8 bytes.

>>> p = Placement(["n0", "n1", "n2", "n3"], r=2)
>>> holders = p.holders("ab" * 32)
>>> len(holders)
2
>>> holders == Placement(["n3", "n2", "n1", "n0"], r=2).holders("ab" * 32)
True
>>> chunk_bitmap([0, 2, 8], 9)
b'\\x05\\x01'
>>> bitmap_indices(b"\\x05\\x01", 9)
(0, 2, 8)
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch import pytree
from repro_torch.core.compression import CompressedLeaf, CompressedTree


def rendezvous_holders(eid: str, nodes: Sequence[str],
                       r: int) -> Tuple[str, ...]:
    """The `r` nodes responsible for `eid` under HRW hashing.

    Each node scores SHA-256(node "|" eid); the r highest win. Removing
    a node only reassigns the blobs it held; adding one only claims
    blobs it now out-scores everyone for.

    >>> rendezvous_holders("00" * 32, ["a", "b", "c"], 5)
    ('a', 'c', 'b')
    """
    if r < 1:
        raise ValueError("replication factor must be >= 1")
    scored = sorted(
        ((hashlib.sha256(f"{n}|{eid}".encode()).digest(), n) for n in nodes),
        reverse=True)
    return tuple(n for _score, n in scored[:r])


class Placement:
    """Deterministic blob -> holder-set assignment over a fixed node set.

    Immutable by convention: membership changes build a new Placement.
    Holder lookups are memoized — anti-entropy asks for the same eids
    every session.
    """

    __slots__ = ("nodes", "r", "_cache")

    def __init__(self, nodes: Iterable[str], r: int):
        self.nodes: Tuple[str, ...] = tuple(sorted(set(nodes)))
        if not self.nodes:
            raise ValueError("placement needs at least one node")
        if not 1 <= r <= len(self.nodes):
            raise ValueError(f"need 1 <= r <= {len(self.nodes)}, got {r}")
        self.r = r
        self._cache: Dict[str, Tuple[str, ...]] = {}

    def holders(self, eid: str) -> Tuple[str, ...]:
        out = self._cache.get(eid)
        if out is None:
            out = rendezvous_holders(eid, self.nodes, self.r)
            if len(self._cache) >= 65536:    # bound the memo under churn
                self._cache.clear()
            self._cache[eid] = out
        return out

    def is_holder(self, node_id: str, eid: str) -> bool:
        return node_id in self.holders(eid)

    def without(self, node_id: str) -> "Placement":
        """Placement after `node_id` leaves (same r, capped to survivors).

        >>> Placement(["a", "b", "c"], r=2).without("b").nodes
        ('a', 'c')
        """
        rest = [n for n in self.nodes if n != node_id]
        return Placement(rest, min(self.r, len(rest)))

    def __repr__(self) -> str:
        return f"Placement(n={len(self.nodes)}, r={self.r})"


def _tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaf_nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return _tensor_nbytes(x)
    if isinstance(x, CompressedLeaf):
        return _tensor_nbytes(x.q) + _tensor_nbytes(x.scale)
    if isinstance(x, CompressedTree):
        return sum(_leaf_nbytes(leaf) for leaf in x.leaves)
    return 0


def payload_nbytes(payload: Any) -> int:
    """Resident size of one store payload: the sum of its tensors' bytes
    (an int8 leaf's `q` and `scale`). The sizing key for budgeted
    shedding (`SyncNode.shed_blobs`) — drop order is largest-first.
    Read from tensor metadata only.

    >>> payload_nbytes({"a": torch.zeros(4), "b": {"c": torch.zeros(
    ...     (2, 3), dtype=torch.float16)}})
    28
    """
    return sum(_leaf_nbytes(x) for x in pytree.leaves(payload))


# ---------------------------------------------------------------------------
# HaveMap chunk bitmaps
# ---------------------------------------------------------------------------


def chunk_bitmap(indices: Iterable[int], n_chunks: int) -> bytes:
    """Pack held chunk indices into the HaveMap bitmap (LSB-first).

    >>> chunk_bitmap([], 3)
    b'\\x00'
    >>> chunk_bitmap([0, 1, 2], 3)
    b'\\x07'
    """
    if n_chunks < 1:
        raise ValueError("n_chunks must be >= 1")
    bits = bytearray((n_chunks + 7) // 8)
    for i in indices:
        if not 0 <= i < n_chunks:
            raise ValueError(f"chunk index {i} out of range [0, {n_chunks})")
        bits[i // 8] |= 1 << (i % 8)
    return bytes(bits)


def bitmap_indices(bitmap: bytes, n_chunks: int) -> Tuple[int, ...]:
    """Unpack a HaveMap bitmap into sorted held chunk indices.

    >>> bitmap_indices(chunk_bitmap([5, 1], 8), 8)
    (1, 5)
    """
    return tuple(i for i in range(min(n_chunks, len(bitmap) * 8))
                 if bitmap[i // 8] >> (i % 8) & 1)


# ---------------------------------------------------------------------------
# Multi-source scheduler records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlobSource:
    """One peer's advertised holding of one blob.

    `sid` is the session id the requester addresses ChunkReq frames
    under. `indices is None` means the peer holds the complete blob; a
    frozenset restricts which chunks it can serve (a partial holder
    advertising via HaveMap bitmap). `gen` is the requester's session
    generation at recording time: a source not re-confirmed since the
    latest begin_sync is dropped with the rest of that session's
    request state.
    """
    sid: int
    indices: Optional[FrozenSet[int]] = None
    gen: int = 0

    def can_serve(self, index: int) -> bool:
        return self.indices is None or index in self.indices
