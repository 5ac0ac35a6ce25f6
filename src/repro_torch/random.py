"""`jax.random` as JAX 0.9 runs it by default, bit for bit, in PyTorch.

The reference's stochastic strategies (`dare`, `dare_ties`, `della`,
`evolutionary_merge`) draw from `jax.random` under
`fold_in(PRNGKey(seed & 0x7FFFFFFF), leaf_index)`. Replicas of the two
packages agree on such a merge only if the port draws the same bits, so
this module reproduces JAX's default generator: threefry2x32 (20
rounds), `jax_threefry_partitionable = True`.

  * `PRNGKey(s)` is the pair (s >> 32, s & 0xFFFFFFFF).
  * `fold_in(key, d)` is threefry2x32(key, (0, d)).
  * random bits: element i of a draw (flat row-major index) hashes the
    counter pair (i >> 32, i & 0xFFFFFFFF) to (b1, b2); 32-bit draws are
    b1 ^ b2, 16- and 8-bit draws its low bits, 64-bit draws b1 << 32 | b2.
  * `uniform` fills the mantissa of a float in [1, 2) with the draw's top
    bits and subtracts 1; a dtype of fewer than 8 mantissa bits (bf16)
    draws 8 bits. `bernoulli(key, p, shape)` is `uniform(key, shape,
    dtype(p)) < p`.

Because element i depends on the key and i alone, a draw can be made in
slices of the flat index (`start`, `count`) and stay bit-equal to the
whole draw: the exact DARE path draws one contribution at a time, in
chunks, so a [4, 805M] stack never needs its 64-bit counters at once.

Keys are pairs of Python ints. Counters and bits are int64 tensors
holding uint32 values (torch lacks most uint32 kernels on the CPU), on
the device the caller names.

`split(key, num)` is JAX 0.9's partitionable split: key i is the
threefry hash of the counter pair (0, i), which is `fold_in(key, i)`.
`uniform(..., minval, maxval)` maps the [0, 1) draw as JAX does,
`max(minval, u * (maxval - minval) + minval)`, with the multiply-add
contracted into one FMA for fp32 and float64 (XLA's CPU code does so)
and rounded op by op for bf16. `normal` is `sqrt(2) * erf_inv(uniform(
nextafter(-1, 0), 1))` with XLA's `erf_inv`, `log1p` and fp32 `log` as
its CPU code runs them: the same polynomials, the same op order, the
same FMAs (read off the compiled kernels). torch rounds each op in the
tensor's dtype; the FMAs are emulated exactly (`fma`), the square root
is numpy's (correctly rounded; torch's CPU one is not always) and
float64 `log` is the C library's, which XLA's CPU code calls. A normal
draw is therefore computed on the host and moved to the device the
caller names; the strategies draw a few dozen values.
"""
from __future__ import annotations

import math
import struct
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

Key = Tuple[int, int]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# flat indices per slice of a chunked draw (bounds its int64 temporaries)
CHUNK = 1 << 24

# dtype -> (bits of the float, mantissa bits, signed view of that width)
_FLOATS = {
    torch.float64: (64, 52, torch.int64),
    torch.float32: (32, 23, torch.int32),
    torch.float16: (16, 10, torch.int16),
    torch.bfloat16: (16, 7, torch.int16),
}


def _rotl(v, r: int):
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """The threefry2x32 hash of the counter pair (x0, x1) under `key`:
    Python ints or int64 tensors holding uint32 values."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 (jax.random's name)
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2^64."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    return (seed >> 32) & M32, seed & M32


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    if not 0 <= data <= M32:
        raise ValueError(f"fold_in data must be a uint32, got {data}")
    return threefry2x32(key, 0, data)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """`jax.random.split(key, num)`: key i is threefry2x32(key, (0, i))."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def _counter_bits(key: Key, start: int, count: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b1, b2) for flat indices [start, start + count), int64."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    return threefry2x32(key, i >> 32, i & M32)


def _uniform_flat(key: Key, start: int, count: int, dtype: torch.dtype,
                  device) -> torch.Tensor:
    nbits, nmant, view = _FLOATS[dtype]
    b1, b2 = _counter_bits(key, start, count, device)
    if nbits == 64:
        # (b1 << 32 | b2) >> 12, a logical shift, without leaving int64
        fbits = (b1 << 20) | (b2 >> 12)
    else:
        rng_bits = 8 if nmant < 8 else nbits
        fbits = ((b1 ^ b2) & ((1 << rng_bits) - 1)) >> (rng_bits - nmant)
    one = torch.tensor(1.0, dtype=dtype).view(view).item()   # > 0
    floats = (fbits | one).to(view).view(dtype)
    return floats - torch.tensor(1.0, dtype=dtype, device=device)


def uniform(key: Key, shape: Sequence[int],
            dtype: torch.dtype = torch.float32, *, device,
            start: int = 0, count: Optional[int] = None,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`: the whole
    draw in `shape`, or the flat slice [start, start + count) of it as a
    1-D tensor, on `device` (which the caller must name)."""
    if dtype not in _FLOATS:
        raise TypeError(f"uniform draws float64/32/16 or bf16, got {dtype}")
    n = math.prod(shape)
    if count is None and start == 0:
        out = torch.empty(n, dtype=dtype, device=device)
        for s in range(0, n, CHUNK):
            c = min(CHUNK, n - s)
            out[s:s + c] = _ranged(_uniform_flat(key, s, c, dtype, device),
                                   minval, maxval)
        return out.reshape(tuple(shape))
    count = n - start if count is None else count
    if start < 0 or count < 0 or start + count > n:
        raise ValueError(f"slice [{start}, {start + count}) outside a "
                         f"draw of {n}")
    return _ranged(_uniform_flat(key, start, count, dtype, device),
                   minval, maxval)


def _ranged(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """`max(minval, u * (maxval - minval) + minval)` in u's dtype, as XLA's
    CPU code computes it: the bounds and their difference rounded to the
    dtype, the multiply-add one FMA in fp32 and float64, each op rounded
    to bf16 / fp16 in the narrow types. [0, 1) is returned as drawn
    (u * 1 + 0 is u)."""
    if minval == 0.0 and maxval == 1.0:
        return u
    lo = torch.tensor(minval, dtype=u.dtype, device=u.device)
    span = torch.tensor(maxval, dtype=u.dtype, device=u.device) - lo
    if u.dtype == torch.float32:
        y = _fma32(u, span, lo)
    elif u.dtype == torch.float64:
        y = _fma64(u, span, lo)
    else:
        y = u * span + lo       # torch rounds each op to u's dtype
    return torch.maximum(lo, y)


# ------------------------------------------------------------ exact ops ---
# XLA's CPU code contracts a multiply whose only use is an add into one
# FMA. torch runs each op as a kernel of its own, correctly rounded in
# the tensor's dtype (bf16 and fp16 through fp32, rounded once), so only
# the FMA needs help: exact in float64 for fp32 (a * b is exact there and
# a sum rounded to odd rounds correctly to fp32), and Boldo and
# Melquiond's emulation for float64.


def _hex(h: str) -> float:
    """A float64 from its IEEE bits in hex (XLA's IR prints constants so)."""
    return struct.unpack(">d", bytes.fromhex(h))[0]


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _to_odd(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """s rounded to odd: where s is inexact (err != 0) and its last bit is
    even, the neighbour towards the exact value."""
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """fma(a, b, c) of fp32 tensors, rounded once."""
    p = a.double() * b.double()
    s, err = _two_sum(p, c.double().expand_as(p))
    return _to_odd(s, err).float()


_SPLIT = 134217729.0            # 2^27 + 1, Veltkamp's splitter


def _split64(x):
    t = _SPLIT * x
    hi = t - (t - x)
    return hi, x - hi


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """fma(a, b, c) of float64 tensors, rounded once: the product split
    exactly into ph + pl (Dekker), c + ph into sh + sl, then sh +
    round_to_odd(sl + pl)."""
    ph = a * b
    ah, al = _split64(a)
    bh, bl = _split64(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl
    sh, sl = _two_sum(c.expand_as(ph), ph)
    v, err = _two_sum(sl, pl)
    return sh + _to_odd(v, err)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a host tensor (numpy's, the
    hardware instruction; torch's CPU sqrt is off by an ulp at times)."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of fp32 or float64 tensors, rounded once, on any
    device."""
    return _fma64(a, b, c) if a.dtype == torch.float64 else _fma32(a, b, c)


def _k(v: float, like: torch.Tensor) -> torch.Tensor:
    """The constant v in like's dtype, broadcast to its shape."""
    return torch.full_like(like, v)


# log1p's small-argument rational (Cephes), as XLA's elemental emitter
# lists it: P and Q from the leading coefficient down
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = 0.41421356237309504880      # sqrt(2) - 1

# XLA's CPU fp32 log (Cephes logf): the mantissa polynomial's constants
# and ln 2 in two parts
_LOGF_C = [_hex(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000")]
_LOGF_Q1 = _hex("BF2BD01060000000")
_LOGF_Q2 = _hex("3FE6300000000000")
_SQRTHF = _hex("3FE6A09E60000000")


def _log32(y: torch.Tensor) -> torch.Tensor:
    """XLA's CPU fp32 `log` of an fp32 tensor: frexp, the sqrt(1/2) fold,
    three interleaved FMA chains over x and x^3, then e * q1, x - x^2/2
    and e * q2, as its compiled kernel runs them."""
    yc = torch.where(y > 2.0 ** -126, y, _k(2.0 ** -126, y))
    bits = yc.view(torch.int32)
    e1 = ((bits >> 23) - 127).to(torch.float32) + _k(1.0, y)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = mant < _SQRTHF
    x = (mant - _k(1.0, y)) + torch.where(low, mant, _k(0.0, y))
    e = torch.where(low, e1 - _k(1.0, y), e1)
    z = x * x
    x3 = z * x
    c = [_k(v, y) for v in _LOGF_C]
    a = _fma32(_fma32(x, c[0], c[1]), x, c[6])
    b = _fma32(_fma32(x, c[2], c[3]), x, c[7])
    d = _fma32(_fma32(x, c[4], c[5]), x, c[8])
    poly = _fma32(_fma32(_fma32(x3, a, b), x3, d), x3, e * _k(_LOGF_Q1, y))
    out = _fma32(e, _k(_LOGF_Q2, y),
                 _fma32(_k(-0.5, y), z, x) + poly)
    out = torch.where(y <= 0, _k(math.nan, y), out)
    out = torch.where(y == 0, _k(-math.inf, y), out)
    return torch.where(y == math.inf, y, out)


def _log1p(m: torch.Tensor) -> torch.Tensor:
    """XLA's CPU `log1p` of an fp32 or float64 tensor: for |m| < sqrt(2) -
    1, m + fma(-0.5, m^2, (m * m^2) * P(m) / Q(m)), P and Q by FMA Horner
    steps from 0 * m plus their leading coefficient; else log(1 + m),
    fp32 by `_log32` and float64 by the C library (on the host)."""
    z = m * m
    zero = m * _k(0.0, m)
    den = zero + _k(_LOG1P_Q[0], m)
    for q in _LOG1P_Q[1:]:
        den = fma(den, m, _k(q, m))
    num = zero + _k(_LOG1P_P[0], m)
    for p in _LOG1P_P[1:]:
        num = fma(num, m, _k(p, m))
    small = m + fma(_k(-0.5, m), z, (m * z) * (num / den))
    y = m + _k(1.0, m)
    if m.dtype == torch.float64:
        large = torch.tensor([math.log(v) if v > 0 else
                              (-math.inf if v == 0 else math.nan)
                              for v in y.reshape(-1).tolist()],
                             dtype=torch.float64).reshape(y.shape)
    else:
        large = _log32(y)
    return torch.where(m.abs() < _k(_LOG1P_SMALL, m), small, large)


# erf_inv's polynomials (Giles), leading coefficient first, as XLA's
# compiled kernels hold them: fp32 in two branches split at w = 5,
# float64 in three split at w = 6.25 and w = 16
_ERFINV32 = (
    ("3E5E2CB100000000", "3E970966C0000000", "BECD8E6AE0000000",
     "BED26B5820000000", "3F2CA65B60000000", "BF548A8100000000",
     "BF711C9DE0000000", "3FCF91EC60000000", "3FF805C5E0000000"),
    ("BF2A3E1360000000", "3F1A76AD60000000", "3F561B8E40000000",
     "BF6E17BCE0000000", "3F77824F60000000", "BF7F38BAE0000000",
     "3F8354AFC0000000", "3FF006DB60000000", "4006A9EFC0000000"))
_ERFINV64 = (
    ("BBB135D2E746E627", "BC08DDF93324D327", "3C37B83EEF0B7C9F",
     "3C69BA72CD589B91", "BCA33689090A6B96", "3C782E11898132E0",
     "3CFDE4ACFD9E26BA", "BD26D33EED66C487", "BD36F2167040D8E2",
     "3D872A22C2D77E20", "BDAC8859C4E5C0AF", "BDCDC583D118A561",
     "3E120F47CCF46B3C", "BE31A9E38DC84D60", "BE5F36CD6D3D46A9",
     "3E9C6B4F5D03B787", "BEB6E8A5434AE8A2", "BEED1D1F7B8736F6",
     "3F2879C2A212F024", "BF4845769484FCA8", "BF78B6C33114F909",
     "3FCEBD80D9B13E28", "3FFA755E7C99AE86"),
    ("3E23040F87DBD932", "3E785CBE52878635", "BE92777453DD3955",
     "3E5395ABCD554C6C", "3EB936388A3790AD", "BED0D5DB812B5083",
     "3EC8860CD5D652F6", "3EEA29A0CACDFB23", "BF08CEF1F80281F2",
     "3F11E684D0B9188A", "3EF932CD54C8A222", "BF37448A89EF8AA3",
     "3F4F3CC55AD40C25", "BF5BA924132F38B1", "3F6468EECA533CF8",
     "BF6EBADABB891BBD", "3F75FFCFE5B76AFC", "3FF0158A6D641D39",
     "4008ABCC380D5A48"),
    ("BDBDCEC3A7785389", "BDF18FEEC0E38727", "3E19E6BF2DDA45E3",
     "BE30468FB24E2F5F", "3E405AC6A8FBA182", "BE50102E495FB9C0",
     "3E5F4C20E1334AF8", "BE722D220FDF9C3E", "3E8EBC8BB824CB54",
     "BEB0A8D40EA372CC", "3ED2FBD29D093D2B", "BEF4A3497E1E0FAC",
     "3F13EBF4EB00938F", "BF2C2F36A8FC5D53", "BF222EA5DF04047C",
     "3FF02A30D1FBA0DC", "4013664DDD1AD7FB"))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """`jax.lax.erf_inv` of an fp32 or float64 host tensor, bit for
    bit: w = -log1p(-x * x), then Horner FMA steps p = fma(W, p, c) over
    the branch's coefficients, W = w - 2.5 or sqrt(w) - 3 (fp32; float64:
    w - 3.125, sqrt(w) - 3.25 or sqrt(w) - 5), and x * p, +-inf at +-1."""
    L = _log1p(x * -x)
    if x.dtype == torch.float64:
        lo, mid, hi = ([_hex(h) for h in t] for t in _ERFINV64)
        b1 = L > -6.25
        b2 = L > -16.0
        sq = _sqrt(-L)
        w = torch.where(b1, _k(-3.125, L) - L,
                        sq - torch.where(b2, _k(3.25, L), _k(5.0, L)))

        def coef(i):
            c = _k(lo[i], L)
            if i < len(mid):
                c = torch.where(b1, c, _k(mid[i], L))
            if i < len(hi):
                c = torch.where(b2, c, _k(hi[i], L))
            return c
        p = coef(0)
        for i in range(1, len(hi)):
            p = _fma64(w, p, coef(i))
        for i in range(len(hi), len(mid)):
            p = torch.where(b2, _fma64(w, p, coef(i)), p)
        for i in range(len(mid), len(lo)):
            p = torch.where(b1, _fma64(w, p, coef(i)), p)
    else:
        lo, hi = ([_hex(h) for h in t] for t in _ERFINV32)
        b1 = L > -5.0
        w = torch.where(b1, _k(-2.5, L) - L, _sqrt(-L) + _k(-3.0, L))
        p = torch.where(b1, _k(lo[0], L), _k(hi[0], L))
        for i in range(1, len(lo)):
            p = _fma32(w, p, torch.where(b1, _k(lo[i], L), _k(hi[i], L)))
    return x * torch.where(x.abs() == 1.0, _k(math.inf, p), p)


def normal(key: Key, shape: Sequence[int],
           dtype: torch.dtype = torch.float32, *, device) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)`, bit for bit: sqrt(2) *
    erf_inv(uniform(key, shape, dtype, nextafter(-1, 0), 1)), bf16 through
    an fp32 erf_inv rounded to bf16. Computed on the host (float64 `log`
    is the C library's there, as in XLA's CPU code), then moved to
    `device`."""
    if dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"normal draws float64/32 or bf16, got {dtype}")
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, dtype, device="cpu", minval=lo, maxval=1.0)
    if dtype == torch.bfloat16:
        e = erf_inv(u.float()).to(torch.bfloat16)
    else:
        e = erf_inv(u)
    return (e * _k(math.sqrt(2.0), e)).to(device)


def p_dtype(like: torch.dtype) -> torch.dtype:
    """The dtype a Python-float `p` takes in `bernoulli`: JAX draws in
    `p`'s dtype, float64 under `jax.enable_x64` and float32 otherwise.
    The port has no x64 switch, so it reads the data instead: float64
    for float64 data (which exists in JAX only under x64), else float32.
    (JAX under x64 with float32 data would draw 64-bit uniforms; the
    port draws 32-bit ones there.)"""
    return torch.float64 if like == torch.float64 else torch.float32


def bernoulli(key: Key, p: Union[float, torch.Tensor],
              shape: Sequence[int], *, device,
              dtype: torch.dtype = torch.float32, start: int = 0,
              count: Optional[int] = None) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` with `p` of dtype `dtype`
    (see `p_dtype`): `uniform(key, shape, dtype) < p`, bool. Sliced as
    `uniform`."""
    u = uniform(key, shape, dtype, start=start, count=count, device=device)
    return u < torch.as_tensor(p, dtype=dtype, device=u.device)
