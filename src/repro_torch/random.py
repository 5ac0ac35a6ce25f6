"""`jax.random` as JAX 0.9 runs it by default, bit for bit, in PyTorch.

The reference's stochastic strategies (`dare`, `dare_ties`, `della`)
draw their masks from `jax.random` under `fold_in(PRNGKey(seed & 0x7FFFFFFF),
leaf_index)`. Replicas of the two packages agree on a merged DARE model
only if the port draws the same bits, so this module reproduces JAX's
default generator: threefry2x32 (20 rounds), `jax_threefry_partitionable
= True`.

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
the device the caller names. `split` and `normal` are not ported: no
ported strategy calls them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

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
            start: int = 0, count: Optional[int] = None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype)` on [0, 1): the whole draw
    in `shape`, or the flat slice [start, start + count) of it as a
    1-D tensor, on `device` (which the caller must name)."""
    if dtype not in _FLOATS:
        raise TypeError(f"uniform draws float64/32/16 or bf16, got {dtype}")
    n = math.prod(shape)
    if count is None and start == 0:
        out = torch.empty(n, dtype=dtype, device=device)
        for s in range(0, n, CHUNK):
            c = min(CHUNK, n - s)
            out[s:s + c] = _uniform_flat(key, s, c, dtype, device)
        return out.reshape(tuple(shape))
    count = n - start if count is None else count
    if start < 0 or count < 0 or start + count > n:
        raise ValueError(f"slice [{start}, {start + count}) outside a "
                         f"draw of {n}")
    return _uniform_flat(key, start, count, dtype, device)


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
