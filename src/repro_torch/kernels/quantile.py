"""Exact `jnp.quantile` (linear method) without sorting: the one quantile
path of the port, for B7's trim thresholds (`quantile_threshold`) and
for the catalog's strategies (`quantile_rows`: ties, model_breadcrumbs,
emr).

JAX computes the index q * (n - 1) in the weights' type, fp32 unless the
data is float64, so above 2^24 elements the index rounds
(`quantile_weights`), and XLA's CPU code contracts the interpolation
into one FMA (`quantile_interp`). The lower order statistic comes from
an exact radix select over order-preserving int32 keys of the fp32 bit
patterns (`_select`): three digit passes, each an integer histogram of
the next digit among the values that share the digits found so far, one
column chunk at a time, so no row is sorted and no temporary larger than
a chunk is made (a sort of one 805M-element row with its int64 indices
needs about 10 GB); the upper one is in the same group of equal values
or is the least value above it, one more pass. bf16 and fp16 values widen to fp32 exactly. float64
rows (the reference under x64, small audits) are sorted. A row holding a
NaN has a NaN quantile.
"""
from __future__ import annotations

import bisect
import struct
from fractions import Fraction
from typing import Callable, Iterable

import numpy as np
import torch

# columns per chunk of a select pass (bounds its temporaries)
CHUNK = 1 << 24
# (shift, width) of the radix select's digits over a 32-bit key
_DIGITS = ((21, 11), (10, 11), (0, 10))

Chunks = Callable[[], Iterable[torch.Tensor]]


def weak_float(dtype: torch.dtype):
    """numpy type of a weakly typed JAX float made from a Python number
    (`jnp.quantile`'s q, `jnp.sqrt(float(k))`): fp32, or float64 under
    x64, which float64 data stands for here."""
    return np.float64 if dtype == torch.float64 else np.float32


def quantile_weights(n: int, q: float, dtype: torch.dtype = torch.float32):
    """`jnp.quantile`'s linear interpolation over n sorted values of
    `dtype`: (lo, hi, lw, hw), the result being `srt[lo] * lw + srt[hi] *
    hw`. The index q * (fp(n) - 1) is computed in the weights' type,
    fp32 unless the data is float64, as JAX does, so above 2^24 elements
    it rounds; lw and hw are numpy scalars of that type."""
    f = weak_float(dtype)
    qq = f(q) * (f(n) - f(1))
    low, high = np.floor(qq), np.ceil(qq)
    hw = f(qq - low)
    lw = f(f(1) - hw)
    return int(np.clip(low, 0, n - 1)), int(np.clip(high, 0, n - 1)), lw, hw


def _round_to(x: Fraction, f):
    """The exact value x rounded to nearest-even in numpy float type f."""
    if f is np.float64:
        return f(float(x))                # int / int: correctly rounded
    r = f(float(x))                       # may round twice: fix below
    cands = [np.nextafter(r, f(-np.inf)), r, np.nextafter(r, f(np.inf))]
    cands = [c for c in cands if np.isfinite(c)]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                      int(np.asarray(c).view(np.uint32))
                                      & 1))


def quantile_interp(v_lo: float, v_hi: float, lw, hw) -> float:
    """`v_lo * lw + v_hi * hw` in the weights' type as XLA's CPU code
    computes `jnp.quantile`'s interpolation: contracted into
    fma(v_hi, hw, round(v_lo * lw)) (probed: 2000 of 2000 random cases;
    separate roundings matched 1630). Exact rational arithmetic on the
    host, then one rounding (signed zeros as IEEE adds them)."""
    f = type(lw)
    p = f(f(v_lo) * lw)
    hi = f(v_hi)
    if not (np.isfinite(hi) and np.isfinite(p)):
        with np.errstate(invalid="ignore", over="ignore"):
            return float(f(hi * hw + p))
    exact = Fraction(float(hi)) * Fraction(float(hw)) + Fraction(float(p))
    if exact == 0:      # IEEE: -0 only as the sum of two negative zeros
        return -0.0 if (np.signbit(p) and hi * hw == 0
                        and np.signbit(hi) != np.signbit(hw)) else 0.0
    return float(_round_to(exact, f))


def _keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order as the fp32 values do, -0 equal to +0 as
    JAX's sort holds them: the magnitude bits, negated for negative
    values."""
    bits = x.view(torch.int32)
    sgn = bits >> 31
    return ((bits & 0x7FFFFFFF) ^ sgn) - sgn


def _value(key: int) -> float:
    bits = key if key >= 0 else -key | (1 << 31)
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _select(chunks: Chunks, rank: int):
    """(key, rank within its group of equal keys, the group's size) of
    the rank-th smallest (0-based) of the fp32 values that `chunks()`
    yields, exact; None if one of them is NaN. The digits are those of
    key + 2^31, which is non-negative; `chunks` is called once per digit
    pass."""
    prefix = 0
    for level, (shift, width) in enumerate(_DIGITS):
        top = shift + width
        counts, nans = None, []
        for x in chunks():
            key = _keys(x)
            if level:
                key = key[(key >> top) == prefix - (1 << (31 - top))]
                digit = (key >> shift) & ((1 << width) - 1)
            else:
                nans.append(torch.isnan(x).any())
                digit = (key >> shift) + (1 << (31 - shift))
            c = torch.bincount(digit, minlength=1 << width)
            counts = c if counts is None else counts + c
        if nans and bool(torch.stack(nans).any()):      # one host sync
            return None
        cum = counts.cumsum(0).tolist()
        digit = bisect.bisect_right(cum, rank)
        below = cum[digit - 1] if digit else 0
        rank -= below
        group = cum[digit] - below
        prefix = (prefix << width) | digit
    return prefix - (1 << 31), rank, group


def _zero_at(chunks: Chunks, rank: int) -> float:
    """The rank-th zero (0-based) in index order, with its sign: JAX's
    sort is stable and holds -0 equal to +0."""
    for x in chunks():
        z = (x == 0).nonzero()
        if rank < z.shape[0]:
            return float(x[z[rank, 0]])
        rank -= z.shape[0]
    raise ValueError("fewer zeros than the rank")


def select_quantile(chunks: Chunks, n: int, q: float,
                    dtype: torch.dtype = torch.float32) -> float:
    """`jnp.quantile` of the n fp32 values that `chunks()` yields, whose
    data type was `dtype` (fp32, bf16 or fp16): NaN if one is NaN. The
    upper order statistic is the lower one's group, or else the least
    value above it (one pass)."""
    lo, hi, lw, hw = quantile_weights(n, q, dtype)
    sel = _select(chunks, lo)
    if sel is None:
        return float("nan")
    key, r_lo, group = sel
    v_lo = v_hi = _value(key)
    r_hi = r_lo + (hi - lo)
    if r_hi >= group:
        v_hi = float(torch.stack([torch.where(x > v_lo, x, float("inf"))
                                  .amin() for x in chunks()]).amin())
        r_hi = 0
    if v_lo == 0.0:
        v_lo = _zero_at(chunks, r_lo)
    if v_hi == 0.0:
        v_hi = _zero_at(chunks, r_hi)
    return quantile_interp(v_lo, v_hi, lw, hw)


def quantile_rows(a: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(a, q, axis=1, keepdims=True)` of a [k, n] tensor, in
    its dtype: one select per row (a sort for float64)."""
    k, n = a.shape
    f = weak_float(a.dtype)
    if a.dtype == torch.float64:
        a = torch.where(torch.isnan(a).any(dim=1, keepdim=True),
                        torch.full_like(a, float("nan")), a)
        srt = torch.sort(a, dim=1, stable=True).values
        lo, hi, lw, hw = quantile_weights(n, q, a.dtype)
        vals = [quantile_interp(x, y, lw, hw) for x, y in
                zip(srt[:, lo].tolist(), srt[:, hi].tolist())]
    else:
        vals = [select_quantile(
            lambda i=i: (a[i, c:c + CHUNK].to(torch.float32)
                         for c in range(0, n, CHUNK)), n, q, a.dtype)
            for i in range(k)]
    wdt = torch.float64 if f is np.float64 else torch.float32
    return torch.tensor(vals, dtype=wdt, device=a.device).to(
        a.dtype).reshape(-1, 1)


def quantile_threshold(row: torch.Tensor, base: torch.Tensor,
                       q: float) -> torch.Tensor:
    """B7's trim threshold, `jnp.quantile(|f32(row) - f32(base)|, q)`
    (`ops.py:200-204` of the reference), as a 0-dim fp32 tensor on the
    row's device; |row - base| is made one chunk at a time. `row` and
    `base` are 1-D tensors of one length."""
    n = row.shape[0]

    def chunks():
        for c in range(0, n, CHUNK):
            yield (row[c:c + CHUNK].to(torch.float32)
                   - base[c:c + CHUNK].to(torch.float32)).abs_()
    return torch.tensor(select_quantile(chunks, n, q), dtype=torch.float32,
                        device=row.device)
