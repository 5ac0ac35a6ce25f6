"""The port's threefry (`repro_torch.random`) and counter hash
(`kernels.common.hash_uniform`) against JAX.

Every check here is bitwise: keys, uniform draws and Bernoulli masks
equal `jax.random`'s (JAX 0.9 defaults: threefry2x32, partitionable) in
fp32, bf16 (the 8-bit draw path), fp16, and float64 under
`jax.enable_x64(True)` (the 64-bit draw path); a draw made in slices of
the flat index equals the whole draw; `hash_uniform` equals the
reference's near the uint32 wrap.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.common import hash_uniform as jhash  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.kernels.common import hash_uniform  # noqa: E402

torch.set_num_threads(1)

SEEDS = [0, 1, 12345, 0x7FFFFFFF]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
SHAPES = [(1,), (7,), (3, 1001), (4, 2, 33)]


def _key(seed, data):
    """The reference's strategy key and the port's."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    return np.asarray(jk), prng.fold_in(prng.PRNGKey(seed), data)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in(seed):
    assert tuple(np.asarray(jax.random.PRNGKey(seed)).tolist()) == \
        prng.PRNGKey(seed)
    for data in (0, 1, 5, 2 ** 31, 2 ** 32 - 1):
        jk, tk = _key(seed, data)
        assert tuple(jk.tolist()) == tk


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_bitwise(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    jk, tk = _key(77, 3)
    want = np.asarray(jax.random.uniform(jk, shape, dtype=jdt))
    got = prng.uniform(tk, shape, tdt, device="cpu")
    assert tuple(got.shape) == shape
    assert np.array_equal(got.to(torch.float32).numpy(),
                          want.astype(np.float32))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.7])
def test_bernoulli_bitwise_fp32(p):
    jk, tk = _key(9, 11)
    want = np.asarray(jax.random.bernoulli(jk, p, (5, 333)))
    got = prng.bernoulli(tk, p, (5, 333), device="cpu").numpy()
    assert np.array_equal(got, want)


def test_float64_draws_under_x64_bitwise():
    with jax.enable_x64(True):
        jk, tk = _key(99, 4)
        want = np.asarray(jax.random.uniform(jk, (6, 77),
                                             dtype=jnp.float64))
        got = prng.uniform(tk, (6, 77), torch.float64,
                           device="cpu").numpy()
        assert np.array_equal(got, want)
        # a Python-float p is float64 under x64: the 64-bit path
        want_b = np.asarray(jax.random.bernoulli(jk, 0.3, (6, 77)))
        got_b = prng.bernoulli(tk, 0.3, (6, 77), device="cpu",
                               dtype=prng.p_dtype(torch.float64)).numpy()
        assert np.array_equal(got_b, want_b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_sliced_draw_equals_whole_draw(dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}[dtype]
    _, tk = _key(3, 2)
    shape = (3, 5000)
    whole = prng.uniform(tk, shape, tdt, device="cpu").reshape(-1)
    parts = [prng.uniform(tk, shape, tdt, device="cpu", start=s, count=c)
             for s, c in ((0, 1), (1, 4999), (5000, 2048), (7048, 7952))]
    assert torch.equal(torch.cat(parts), whole)


def test_chunked_whole_draw_equals_jax(monkeypatch):
    """`uniform` fills a large draw in CHUNK-sized slices; with a tiny
    CHUNK the result is still JAX's."""
    monkeypatch.setattr(prng, "CHUNK", 1000)
    jk, tk = _key(5, 1)
    want = np.asarray(jax.random.uniform(jk, (4, 2500)))
    got = prng.uniform(tk, (4, 2500), device="cpu").numpy()
    assert np.array_equal(got, want)


def test_key_and_slice_validation():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.fold_in((0, 0), 2 ** 32)
    with pytest.raises(ValueError):
        prng.uniform((0, 0), (10,), device="cpu", start=5, count=6)
    with pytest.raises(TypeError):
        prng.uniform((0, 0), (10,), torch.int32, device="cpu")


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 3, 2 ** 32 - 1])
def test_hash_uniform_bitwise_near_the_wrap(seed):
    idx = np.concatenate([np.arange(0, 300),
                          np.arange(2 ** 31 - 150, 2 ** 31 + 150),
                          np.arange(2 ** 32 - 300, 2 ** 32)]).astype(np.uint32)
    want = np.asarray(jhash(jnp.asarray(idx), np.uint32(seed)))
    got = hash_uniform(torch.from_numpy(idx.astype(np.int64)), seed)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
