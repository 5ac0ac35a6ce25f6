"""Content hashing for model contributions (`repro.core.hashing`).

Two tiers:
  * `tensor_digest` / `pytree_digest`: SHA-256 over canonical bytes:
    numpy dtype name | shape as a Python tuple | row-major data, with
    the leaves of a pytree combined in sorted `keystr` order. These are
    the paper's canonical identifiers (Assumption 11), so the port
    reproduces the reference's bytes exactly: a torch replica and a JAX
    replica name the same contribution with the same element id. A CUDA
    tensor is copied to the host in slices of at most 256 MiB as it is
    hashed, and a tree's (or a list's) leaves are hashed on up to
    _HASH_THREADS threads (`tensor_digests`): hashlib and the copies
    release the GIL, and each digest is a pure function of its leaf's
    bytes, so the digests are the same, in the same order, at a fraction
    of one thread's time (host SHA-256 sets the pace of hashing a model).
    The slices land in page-locked staging buffers, reused across
    calls, one a hashing thread: on an H100 host a pageable copy of a
    6.44 GB leaf took 3.1 s and a page-locked one 0.2 s, beside 5.3 s of
    SHA-256.
  * `fingerprint2x32`: an order-independent integer fingerprint, each
    element contributing `word * mix(global_index)` under wrap-around
    uint32 arithmetic, so partial sums over any split add up to the
    whole. It runs on the tensor's device. torch has no uint32
    arithmetic on the CPU, so the words are int64 in [0, 2^32) and
    every product is split into 16-bit halves, which keeps it exact
    without a signed overflow.
"""
from __future__ import annotations

import hashlib
import os
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import pytree
from repro_torch.dtypes import dtype_name

_MIX_A = 2654435761        # Knuth multiplicative
_MIX_B = 0x9E3779B9
_MIX_C = 0x85EBCA6B
_MIX_D = 0xC2B2AE35
_M32 = 0xFFFFFFFF
# elements summed at once: 2^30 terms below 2^32 stay below 2^62
_SUM_CHUNK = 1 << 30
# bytes of a device tensor copied to the host at a time while hashing
_SLICE_BYTES = 1 << 28
# threads hashing a list of leaves; leaves below _THREAD_MIN_BYTES in all
# are hashed on the caller's thread. Leaves given a `prepare` (an int8
# payload's dequantization: a Qwen3-MoE expert leaf at 11 layers is 4.4 GB
# in bf16, with fp32 temporaries twice that) are hashed on at most
# _PREPARED_THREADS, which bounds the transient device copies in flight
_HASH_THREADS = max(1, min(4, os.cpu_count() or 1))
_PREPARED_THREADS = min(2, _HASH_THREADS)
_THREAD_MIN_BYTES = 1 << 26
# page-locked host buffers of _SLICE_BYTES that CUDA slices are copied
# into, made on first need and kept: one for each digest in flight
_STAGING: "queue.SimpleQueue[torch.Tensor]" = queue.SimpleQueue()


def _staging() -> torch.Tensor:
    try:
        return _STAGING.get_nowait()
    except queue.Empty:
        return torch.empty((_SLICE_BYTES,), dtype=torch.uint8,
                           pin_memory=True)


def tensor_digest(t: torch.Tensor) -> bytes:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor leaf, got "
                        f"{type(t).__name__}")
    h = hashlib.sha256()
    h.update(dtype_name(t.dtype).encode())
    h.update(b"|")
    h.update(str(tuple(t.shape)).encode())
    h.update(b"|")
    # the row-major bytes (bf16 through an int16 view: the same bits)
    x = t.detach()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    x = x.contiguous().reshape(-1)
    if x.device.type == "cpu":
        h.update(x.numpy())
        return h.digest()
    raw = x.view(torch.uint8)                 # the same bytes, in order
    buf = _staging()
    try:
        for s in range(0, raw.numel(), _SLICE_BYTES):
            n = min(_SLICE_BYTES, raw.numel() - s)
            buf[:n].copy_(raw[s:s + n])       # returns once it landed
            h.update(buf[:n].numpy())
    finally:
        _STAGING.put(buf)
    return h.digest()


def tensor_digests(leaves: Sequence[Any],
                   prepare: Optional[Callable[[Any], torch.Tensor]] = None
                   ) -> List[bytes]:
    """`tensor_digest` of each leaf, in order, on up to _HASH_THREADS
    threads. With `prepare`, the digest of `prepare(leaf)`, made on the
    hashing thread and dropped after it, on up to _PREPARED_THREADS."""
    leaves = list(leaves)
    if prepare is None:
        digest, threads = tensor_digest, _HASH_THREADS
        if sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor)) < _THREAD_MIN_BYTES:
            threads = 1
    else:
        def digest(leaf):
            return tensor_digest(prepare(leaf))
        threads = _PREPARED_THREADS
    if len(leaves) < 2 or threads < 2:
        return [digest(t) for t in leaves]
    with ThreadPoolExecutor(min(threads, len(leaves))) as pool:
        return list(pool.map(digest, leaves))


def pytree_digest(tree) -> bytes:
    """SHA-256 of a parameter pytree: leaves hashed, combined in path
    order."""
    return pytree_digest_and_leaves(tree)[0]


def pytree_digest_and_leaves(tree) -> Tuple[bytes, List[bytes]]:
    """(`pytree_digest(tree)`, each leaf's `tensor_digest` in flatten
    order) from one pass over the leaves: a registered base keeps the
    second for the planner, which keys every leaf task on its base
    leaf's digest."""
    flat, _ = pytree.flatten_with_path(tree)
    digests = tensor_digests([leaf for _, leaf in flat])
    h = hashlib.sha256()
    for key, d in sorted(((pytree.keystr(p), d)
                          for (p, _), d in zip(flat, digests)),
                         key=lambda kv: kv[0]):
        h.update(key.encode())
        h.update(d)
    return h.digest(), digests


def leaf_paths_of(tree) -> Tuple[str, ...]:
    """Canonical sorted `keystr` paths of a pytree's leaves — the leaf
    coverage descriptor of a (possibly partial) contribution."""
    flat, _ = pytree.flatten_with_path(tree)
    return tuple(sorted(pytree.keystr(p) for p, _ in flat))


# ---------------------------------------------------------------------------
# Order-independent fingerprint
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a, b in [0, 2^32), through b's 16-bit
    halves: each partial product stays below 2^48."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _words_u32(x: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 words of a leaf, as int64: fp32 bits; bf16
    bits widened; int32 / uint32 values mod 2^32; anything else cast to
    fp32 first."""
    x = x.reshape(-1)
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64) & _M32
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if x.dtype in (torch.int32, torch.uint32):
        return x.to(torch.int64) & _M32
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & _M32


def _sum32(t: torch.Tensor) -> int:
    total = 0
    for s in range(0, t.numel(), _SUM_CHUNK):
        total += int(t[s:s + _SUM_CHUNK].sum())
    return total & _M32


def fingerprint2x32(x: torch.Tensor) -> torch.Tensor:
    """uint32[2]; exact, associative-commutative accumulation, bitwise
    equal to the reference's."""
    w = _words_u32(x)
    i = torch.arange(w.numel(), dtype=torch.int64, device=w.device)
    k1 = ((_mul32(i, _MIX_A) + _MIX_B) & _M32) ^ (i >> 7)
    k2 = ((_mul32(i, _MIX_C) + _MIX_D) ^ (i << 3)) & _M32
    lane1 = _sum32(_mul32(w, k1))
    lane2 = _sum32(_mul32(w ^ k2, _MIX_A))
    return torch.tensor([lane1, lane2], dtype=torch.uint32)


def tree_fingerprint(tree) -> torch.Tensor:
    """uint32[2] fingerprint of a whole pytree: leaves in sorted path
    order, leaf idx weighted by (idx * 0x9E3779B9 + 1) mod 2^32. The
    reference builds that weight as `jnp.uint32(...)` of the unreduced
    integer, which raises OverflowError from the third leaf on; the
    port reduces it mod 2^32, and equals the reference bitwise for
    trees of one and two leaves."""
    flat, _ = pytree.flatten_with_path(tree)
    acc = [0, 0]
    for idx, (_, leaf) in enumerate(
            sorted(flat, key=lambda kv: pytree.keystr(kv[0]))):
        fp = fingerprint2x32(leaf).tolist()
        rot = (idx * 0x9E3779B9 + 1) & _M32
        acc = [(a + f * rot) & _M32 for a, f in zip(acc, fp)]
    return torch.tensor(acc, dtype=torch.uint32)
