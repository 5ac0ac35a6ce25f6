"""The port's KV cache at its edges against the JAX reference, on the
CPU, and the decode split of B9 (`decode_splits`).

  prefill(max_len < prompt)  the cache is never shorter than the prompt,
                             as the reference's `_pad_seq` leaves it
  decode past the cache      the reference clamps the slot and overwrites
                             the last key; the port raises ValueError
                             (ROADMAP C, departures on record)
  decode_splits              pinned at the serving shape; the chunks
                             cover [0, kend) once and in order

Inputs are made from a seed with numpy and handed to both packages.
Each assertion says whether it is bitwise or within a tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DECODE_ROWS, DECODE_TARGET_BLOCKS, DECODE_TILE, decode_splits)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.serve import (  # noqa: E402
    greedy_decode, make_decode_step, make_prefill)

torch.set_num_threads(1)

ARCH = "phi3-mini-3.8b"
# the port against the reference in fp32, as tests/test_torch_serve.py
# states it: (logits atol, cache atol); the CPU read 1.2e-7 and 2.5e-7
F32_LIMITS = (1e-6, 1e-6)


def _configs(cd: str = "float32"):
    return (smoke_config(ARCH).replace(n_kv_heads=2, compute_dtype=cd),
            jsmoke(ARCH).replace(n_kv_heads=2, compute_dtype=cd))


def _params(cfg, seed: int):
    """fp32 numpy weights in the dense layout: norms near 1, embeddings
    of order 0.4, projections 0.02."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, pdef in schema_leaves(Model(cfg).schema()):
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if pdef.init == "ones":
            a = 1 + 0.1 * rng.standard_normal(pdef.shape)
        else:
            scale = 0.4 if keys[0] == "embed" else 0.02
            a = scale * rng.standard_normal(pdef.shape)
        node[keys[-1]] = a.astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, out),
            convert.from_numpy_tree(out, "cpu"))


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ------------------------------------------------------------------- C1


@pytest.mark.parametrize("max_len", [None, 4, 11])
def test_prefill_short_max_len_matches_reference(max_len):
    """prefill(max_len below the 12-token prompt, or none) gives a
    12-slot cache in both packages (shapes equal); every cache leaf
    within F32_LIMITS of the reference's (fp32 compute: the two
    projections round differently, 2.5e-7 on the CPU), and bitwise equal
    to the port's own prefill at max_len = 12."""
    cfg, jcfg = _configs()
    jp, tp = _params(cfg, 11)
    toks = _tokens(cfg, 2, 12)
    _, jc = JModel(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)},
                                 max_len=max_len)
    tl, tc = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                max_len=max_len)
    _, exact = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                  max_len=12)
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), pytree.leaves(tc)
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]
    assert tleaves[0].shape[2] == 12
    for t, a, e in zip(tleaves, jleaves, pytree.leaves(exact)):
        np.testing.assert_allclose(_f32(t), _f32(a), rtol=0,
                                   atol=F32_LIMITS[1])
        assert torch.equal(t, e)


def test_prefill_short_max_len_bf16_within_serving_tolerance():
    """bf16 compute, max_len 5 below a 9-token prompt: the same cache
    shapes as the reference, values within the serving tests' bf16
    cache limit (2e-2: one bf16 ulp of keys near 1, as
    tests/test_torch_serve.py states it)."""
    cfg, jcfg = _configs("bfloat16")
    jp, tp = _params(cfg, 12)
    toks = _tokens(cfg, 2, 9, seed=1)
    _, jc = JModel(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)},
                                 max_len=5)
    _, tc = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                               max_len=5)
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), pytree.leaves(tc)
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]
    for t, a in zip(tleaves, jleaves):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(t), _f32(a), rtol=0, atol=2e-2)


# ------------------------------------------------------------------- C2


def test_decode_past_the_cache_reference_clamps_port_raises():
    """At pos = max_len the reference clamps its slot to max_len - 1 and
    overwrites the last key (bitwise: every other slot is unchanged);
    the port raises ValueError and writes nothing (bitwise: its cache is
    unchanged). At pos = max_len - 1 both decode, logits within
    F32_LIMITS."""
    cfg, jcfg = _configs()
    jp, tp = _params(cfg, 13)
    toks = _tokens(cfg, 2, 10, seed=2)
    jm, tm = JModel(jcfg), Model(cfg)
    max_len = 8
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :7])},
                       max_len=max_len)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :7])},
                       max_len=max_len)
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, 7:8]),
                            jnp.asarray(7, jnp.int32))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, 7:8]), 7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32_LIMITS[0])

    k_before = np.asarray(jax.tree_util.tree_leaves(jc)[0])
    _, jc2 = jm.decode_step(jp, jc, jnp.asarray(toks[:, 8:9]),
                            jnp.asarray(max_len, jnp.int32))
    k_after = np.asarray(jax.tree_util.tree_leaves(jc2)[0])
    assert k_after.shape == k_before.shape
    assert np.array_equal(k_after[:, :, :max_len - 1],
                          k_before[:, :, :max_len - 1])
    assert not np.array_equal(k_after[:, :, max_len - 1],
                              k_before[:, :, max_len - 1])

    before = [t.clone() for t in pytree.leaves(tc)]
    with pytest.raises(ValueError, match="does not fit"):
        tm.decode_step(tp, tc, torch.from_numpy(toks[:, 8:9]), max_len)
    assert all(torch.equal(a, b) for a, b in zip(before, pytree.leaves(tc)))


def test_make_prefill_then_decode_raises_at_once():
    """`make_prefill` passes no max_len (as the reference's), so its
    cache holds the prompt alone: the first `make_decode_step` call
    raises ValueError where it used to drop the new key and value.
    `greedy_decode`, which pre-sizes the cache, still decodes."""
    cfg, _ = _configs()
    _, tp = _params(cfg, 14)
    toks = torch.from_numpy(_tokens(cfg, 2, 6, seed=3))
    model = Model(cfg)
    logits, caches = make_prefill(model)(tp, {"tokens": toks})
    assert pytree.leaves(caches)[0].shape[2] == 6
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        make_decode_step(model)(tp, caches, tok, 6)
    assert greedy_decode(model, tp, {"tokens": toks}, 3).shape == (2, 3)


def test_decode_step_raises_on_a_negative_position():
    cfg, _ = _configs()
    _, tp = _params(cfg, 15)
    toks = torch.from_numpy(_tokens(cfg, 1, 4, seed=4))
    _, caches = Model(cfg).prefill(tp, {"tokens": toks}, max_len=8)
    with pytest.raises(ValueError, match="does not fit"):
        Model(cfg).decode_step(tp, caches, toks[:, :1], -1)


# -------------------------------------------------------- decode_splits


def _chunks(b, hk, kend, d):
    n, chunk = decode_splits(b, hk, kend, d)
    return n, chunk, [(c * chunk, min((c + 1) * chunk, kend))
                      for c in range(n)]


def test_decode_splits_pinned_at_the_serving_shape():
    """Bitwise (integers): Phi-3-mini's decode step, batch 4, 32 KV
    heads of 96, 4064 keys visible: 2 chunks of 2048 keys (64 tiles of
    32), 256 blocks; at batch 1, 8 chunks of 512 keys."""
    assert decode_splits(4, 32, 4064, 96) == (2, 2048)
    assert decode_splits(4, 32, 4096, 96) == (2, 2048)
    assert decode_splits(1, 32, 4064, 96) == (8, 512)
    assert 2048 % DECODE_TILE == 0
    assert DECODE_ROWS == 16


@pytest.mark.parametrize("b,hk,d", [(4, 32, 96), (2, 2, 96), (1, 1, 128),
                                    (2, 2, 64), (3, 4, 16), (8, 8, 32)])
def test_decode_splits_cover_every_prefix_once_in_order(b, hk, d):
    """Integers, exact: for every kend in [0, 4096] the chunks cover
    [0, kend) exactly once and in order, none is empty (kend > 0), every
    chunk but one-chunk calls holds whole tiles, and the count never
    exceeds what the target asks for."""
    for kend in range(0, 4097):
        n, chunk, spans = _chunks(b, hk, kend, d)
        assert n >= 1 and chunk >= 1
        assert spans[0][0] == 0 and spans[-1][1] == max(kend, 0)
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 == b0
        if kend > 0:
            assert all(e > s for s, e in spans)
        if n > 1:
            assert chunk % DECODE_TILE == 0
            assert n <= -(-DECODE_TARGET_BLOCKS // (b * hk))


@pytest.mark.parametrize("kend,want", [
    (0, (1, 1)), (1, (1, 1)), (255, (1, 255)), (256, (2, 128)),
    (257, (2, 160)), (2048 * 2 - 1, (2, 2048)), (2048 * 2, (2, 2048)),
    (2048 * 2 + 1, (2, 2080)), (4064, (2, 2048))])
def test_decode_splits_edges(kend, want):
    """Integers, exact, at b 4, 32 KV heads, D 96: no keys and one key
    take one chunk; one chunk up to two minimum chunks (128 keys of 96
    each) less one; then chunks of whole 32-key tiles on either side of
    a chunk boundary, which a full 4096-slot cache sits on."""
    assert decode_splits(4, 32, kend, 96) == want
