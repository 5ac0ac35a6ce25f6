"""The plain reference of a Layer-2 resolve: the canonical order of the
contributions (by content hash), the Merkle root and the seed derived
from it, and the two strategies of the merge sweep, TIES with the
512-bucket histogram trim and task arithmetic, in plain PyTorch.

Imports nothing of the program. The content hash is the paper's
canonical identifier (Assumption 11): SHA-256 over "dtype|shape|bytes"
per leaf, the leaves' digests combined in sorted path order; the Merkle
tree pairs sorted ids with SHA-256(0x01 || a || b) and carries an odd
one up; the seed is the root's first 8 bytes, big-endian, 63 bits.

TIES (Yadav et al. 2023) with the histogram trim, per leaf and
contribution j: tau_j = x_j - base in fp32; amax_j = max |tau_j| + 1e-12;
bucket(a) = clip(int(a / amax_j * 512), 0, 511); the threshold is the
first bucket whose cumulative share of the leaf reaches `trim`, times
amax_j / 512; entries under it are trimmed to 0; the sign of the sum
over j is elected; the merged value is base + the mean of the agreeing
non-zero entries. Task arithmetic: base + lam * sum_j tau_j. Both sum
over j in canonical order, in fp32, and round once to the leaves' dtype.

The bucket counts of a leaf do not depend on `trim`, so they are taken
once, over whole leaves in column blocks, and serve every request.
"""
from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import torch

BINS = 512
_BLOCK = 1 << 26           # columns a block (bounds the fp32 temporaries)
_HASH_SLICE = 1 << 28      # bytes copied to the host at a time

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16"}


# ------------------------------------------------------------ identity

def leaf_digest(t: torch.Tensor) -> bytes:
    h = hashlib.sha256()
    h.update(_DTYPE_NAMES[t.dtype].encode())
    h.update(b"|")
    h.update(str(tuple(t.shape)).encode())
    h.update(b"|")
    x = t.detach()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    buf = torch.empty(min(_HASH_SLICE, raw.numel()), dtype=torch.uint8,
                      pin_memory=raw.is_cuda)
    for s in range(0, raw.numel(), _HASH_SLICE):
        n = min(_HASH_SLICE, raw.numel() - s)
        buf[:n].copy_(raw[s:s + n])
        h.update(buf[:n].numpy())
    return h.digest()


def tree_id(tree: Dict[str, torch.Tensor], threads: int = 4) -> str:
    """Hex content id of a tree given as {keystr path: tensor}."""
    keys = sorted(tree)
    with ThreadPoolExecutor(threads) as pool:
        digests = list(pool.map(lambda k: leaf_digest(tree[k]), keys))
    h = hashlib.sha256()
    for key, d in zip(keys, digests):
        h.update(key.encode())
        h.update(d)
    return h.hexdigest()


def merkle_root(ids: Sequence[str]) -> bytes:
    level = sorted(bytes.fromhex(i) for i in ids)
    if not level:
        return hashlib.sha256(b"crdt-merge/empty").digest()
    while len(level) > 1:
        nxt = [hashlib.sha256(b"\x01" + level[i] + level[i + 1]).digest()
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def seed_of(root: bytes) -> int:
    return int.from_bytes(root[:8], "big") & 0x7FFFFFFFFFFFFFFF


# ------------------------------------------------------------ TIES

def hist_stats(rows: Sequence[torch.Tensor], base: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(amax [k] fp32 with the 1e-12, counts [k, BINS] int64) of one
    leaf: rows are the k contributions' leaves, base the base's."""
    b = base.reshape(-1)
    n = b.numel()
    k = len(rows)
    amax = torch.zeros(k, dtype=torch.float32, device=b.device)
    for j, x in enumerate(rows):
        x = x.reshape(-1)
        for c in range(0, n, _BLOCK):
            a = (x[c:c + _BLOCK].float() - b[c:c + _BLOCK].float()).abs_()
            amax[j] = torch.maximum(amax[j], a.max())
    amax = amax + torch.tensor(1e-12, dtype=torch.float32, device=b.device)
    counts = torch.zeros((k, BINS), dtype=torch.int64, device=b.device)
    for j, x in enumerate(rows):
        x = x.reshape(-1)
        for c in range(0, n, _BLOCK):
            a = (x[c:c + _BLOCK].float() - b[c:c + _BLOCK].float()).abs_()
            idx = (a / amax[j] * float(BINS)).to(torch.int32) \
                .clamp_(0, BINS - 1)
            counts[j] += torch.bincount(idx.reshape(-1).long(),
                                        minlength=BINS)
    return amax, counts


def thresholds(amax: torch.Tensor, counts: torch.Tensor, n: int,
               trim: float) -> torch.Tensor:
    """[k] fp32 trim thresholds of one leaf for `trim`."""
    f32 = dict(dtype=torch.float32, device=amax.device)
    cdf = counts.cumsum(dim=1).to(torch.float32) / torch.tensor(float(n),
                                                                **f32)
    bucket = (cdf >= torch.tensor(trim, **f32)).to(torch.uint8).argmax(1)
    return (bucket.to(torch.float32) / torch.tensor(float(BINS), **f32)) \
        * amax


def ties_columns(xs: torch.Tensor, base: torch.Tensor,
                 thr: torch.Tensor, acc_dtype=torch.float32
                 ) -> torch.Tensor:
    """TIES over some columns: xs [k, m], base [m], thr [k] -> [m] in
    `acc_dtype` (fp32; the control passes lower precisions)."""
    b = base.to(acc_dtype)
    tr = []
    s = torch.zeros_like(b)
    for j in range(xs.shape[0]):
        t = xs[j].to(acc_dtype) - b
        t = t * (t.abs() >= thr[j].to(acc_dtype)).to(acc_dtype)
        tr.append(t)
        s = s + t
    elected = torch.sign(s)
    cnt = torch.zeros_like(b)
    acc = torch.zeros_like(b)
    for t in tr:
        agree = ((torch.sign(t) == elected) & (t != 0)).to(acc_dtype)
        cnt = cnt + agree
        acc = acc + t * agree
    return b + acc / torch.clamp_min(cnt, 1.0)


def task_arithmetic_columns(xs: torch.Tensor, base: torch.Tensor,
                            lam: float, acc_dtype=torch.float32
                            ) -> torch.Tensor:
    b = base.to(acc_dtype)
    acc = torch.zeros_like(b)
    for j in range(xs.shape[0]):
        acc = acc + (xs[j].to(acc_dtype) - b)
    return b + torch.tensor(lam, dtype=acc_dtype, device=b.device) * acc


# ------------------------------------------------------------ comparison

def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many representable bf16 values lie between a and b (both
    bf16), as int64; NaN on either side reads 2**40."""
    def ordered(x):
        i = x.view(torch.int16).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    d = (ordered(a) - ordered(b)).abs()
    nan = torch.isnan(a.float()) | torch.isnan(b.float())
    return torch.where(nan, torch.full_like(d, 2 ** 40), d)


def sample_columns(n: int, blocks: int, width: int,
                   g: torch.Generator) -> torch.Tensor:
    """Flat indices of a leaf of n elements to compare: its first and
    last `width` columns and `blocks` seeded blocks of `width`."""
    width = min(width, n)
    starts = [0, n - width]
    if n > width and blocks:
        starts += torch.randint(0, n - width + 1, (blocks,), generator=g)\
            .tolist()
    idx = torch.cat([torch.arange(s, s + width) for s in starts])
    return torch.unique(idx)


def gather(rows: List[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """[k, m] of the rows at flat indices idx."""
    return torch.stack([r.reshape(-1)[idx] for r in rows])
