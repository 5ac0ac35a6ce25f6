"""Merkle hash tree over the canonically-ordered visible set (paper §4.2;
a copy of `repro.core.merkle`, which imports no JAX).

Leaves are contribution content hashes sorted ascending; interior nodes
hash child pairs (odd nodes promote). The root provides O(log n)
convergence verification, delta-sync divergence detection, and the
deterministic seed for Layer 2 (paper Def. 6).

Anti-entropy (the reference's repro.net.antientropy) additionally
needs *subtree* digests so two replicas can localise a divergence
without shipping the whole leaf set: `bucket_digests` partitions the
hash space by leaf prefix into 2^bits fixed ranges and digests each
range, and `subtree_digest` exposes interior nodes of the pairwise
tree. Prefix buckets (Cassandra-style hash-range trees) are what the
sync protocol exchanges: both sides derive identical bucket boundaries
from the bit width alone, so a single digest-vector round trip
localises every differing range.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

_EMPTY = hashlib.sha256(b"crdt-merge/empty").digest()


def _h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + a + b).digest()


def merkle_levels(leaves: Sequence[bytes]) -> List[List[bytes]]:
    """All tree levels, bottom-up. Level 0 = sorted leaf hashes."""
    if not leaves:
        return [[_EMPTY]]
    level = sorted(leaves)
    levels = [list(level)]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_h(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        levels.append(list(level))
    return levels


def merkle_root(leaves: Sequence[bytes]) -> bytes:
    return merkle_levels(leaves)[-1][0]


def merkle_proof(leaves: Sequence[bytes],
                 leaf: bytes) -> List[Tuple[str, bytes]]:
    """Audit path [(side, sibling_hash)] from leaf to root."""
    levels = merkle_levels(leaves)
    idx = levels[0].index(leaf)
    proof = []
    for level in levels[:-1]:
        sib = idx ^ 1
        if sib < len(level):
            proof.append(("L" if sib < idx else "R", level[sib]))
        idx //= 2
    return proof


def verify_proof(leaf: bytes, proof: List[Tuple[str, bytes]],
                 root: bytes) -> bool:
    h = leaf
    for side, sib in proof:
        h = _h(sib, h) if side == "L" else _h(h, sib)
    return h == root


def subtree_digest(levels: List[List[bytes]], level: int, index: int) -> bytes:
    """Interior node digest: root of the subtree at (level, index).

    Level 0 is the sorted leaves; the top level holds the root. Raises
    IndexError outside the tree, so callers can probe shape-agnostically.
    """
    return levels[level][index]


# ---------------------------------------------------------------------------
# Prefix-partitioned bucket digests (anti-entropy hash-range trees)
# ---------------------------------------------------------------------------


def prefix_bucket(leaf: bytes, bits: int) -> int:
    """Range index of a leaf: its first `bits` bits (0 <= bits <= 16)."""
    if not 0 <= bits <= 16:
        raise ValueError(f"bits must be in [0, 16], got {bits}")
    if bits == 0:
        return 0
    word = int.from_bytes(leaf[:2].ljust(2, b"\x00"), "big")
    return word >> (16 - bits)


def bucket_digests(leaves: Sequence[bytes], bits: int) -> Dict[int, bytes]:
    """SHA-256 digest per non-empty prefix bucket (sparse map).

    Both replicas compute this over their own leaf sets with the same
    `bits`; equal buckets have equal digests, so the symmetric difference
    of the leaf sets is confined to buckets whose digests differ (or that
    exist on only one side).
    """
    buckets: Dict[int, List[bytes]] = {}
    for leaf in leaves:
        buckets.setdefault(prefix_bucket(leaf, bits), []).append(leaf)
    out: Dict[int, bytes] = {}
    for idx, group in buckets.items():
        h = hashlib.sha256(b"\x02" + bits.to_bytes(1, "big"))
        for leaf in sorted(group):
            h.update(leaf)
        out[idx] = h.digest()
    return out


def pick_bucket_bits(n_leaves: int, target_bucket_size: int = 4,
                     max_bits: int = 10) -> int:
    """Bit width giving ~target_bucket_size leaves per non-empty bucket."""
    bits = 0
    while (n_leaves >> bits) > target_bucket_size and bits < max_bits:
        bits += 1
    return bits


def diff_buckets(mine: Dict[int, bytes],
                 theirs: Dict[int, bytes]) -> List[int]:
    """Bucket indices whose contents may differ between two replicas."""
    return sorted(idx for idx in set(mine) | set(theirs)
                  if mine.get(idx) != theirs.get(idx))
