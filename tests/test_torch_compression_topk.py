"""Top-k sparsification of task-vector deltas on the port
(`repro_torch.core.compression.topk_sparsify` / `topk_reconstruct`)
against the reference's, on the CPU: indices int32, values fp32 and the
leaf sizes bitwise, ties broken by the lower index, the reconstruction
bitwise, and the int32 index limit refused rather than wrapped.
Inputs are made from a seed with numpy and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402

torch.set_num_threads(1)


def _tree(rng):
    """A base and a fine-tune: a matrix, a vector and a scalar-sized
    leaf; bf16 leaves go through jnp's rounding on both sides."""
    base = {"w": rng.standard_normal((37, 23)),
            "b": {"v": rng.standard_normal((101,)),
                  "s": rng.standard_normal((1,))}}
    ft = {"w": base["w"] + 0.1 * rng.standard_normal((37, 23)),
          "b": {"v": base["b"]["v"] + 0.1 * rng.standard_normal((101,)),
                "s": base["b"]["s"] + 0.5}}
    return ft, base


def _pair(tree, dtype):
    """(the reference's jnp leaves, the port's torch leaves) with the
    same bits."""
    def jleaf(a):
        return jnp.asarray(np.asarray(a, np.float32), dtype)

    jt = {"w": jleaf(tree["w"]), "b": {k: jleaf(v) for k, v in
                                        tree["b"].items()}}
    tt = pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
        .to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
        jt)
    return jt, tt


def _check_sparse(want, got):
    wl = [want["b"]["s"], want["b"]["v"], want["w"]]
    gl = [got["b"]["s"], got["b"]["v"], got["w"]]
    for (wi, wv, wn), (gi, gv, gn) in zip(wl, gl):
        assert gi.dtype == torch.int32 and gv.dtype == torch.float32
        assert gn == wn and isinstance(gn, int)
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(gv.numpy().view(np.int32),
                              np.asarray(wv, np.float32).view(np.int32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k_frac", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("seed", range(3))
def test_topk_sparsify_and_reconstruct_bitwise(dtype, k_frac, seed):
    """Bitwise: indices (int32, ascending), values (fp32) and sizes of
    every leaf equal the reference's, from k_frac 0 (one entry a leaf)
    to 1 (every entry); `topk_reconstruct` gives the reference's fp32
    leaves bit for bit."""
    ft, base = _tree(np.random.default_rng(seed))
    (jft, tft), (jb, tb) = _pair(ft, dtype), _pair(base, dtype)
    want = JC.topk_sparsify(jft, jb, k_frac)
    got = TC.topk_sparsify(tft, tb, k_frac)
    _check_sparse(want, got)
    jr = JC.topk_reconstruct(want, jb)
    tr = TC.topk_reconstruct(got, tb)
    for a, b in zip(pytree.leaves(tr), [jr["b"]["s"], jr["b"]["v"],
                                        jr["w"]]):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert np.array_equal(a.numpy().view(np.int32),
                              np.asarray(b).view(np.int32))


@pytest.mark.parametrize("k_frac", [0.1, 0.25, 0.5])
def test_topk_ties_by_index(k_frac):
    """Bitwise, ties: entries of equal |tau| (both signs, and zeros) are
    taken lower index first, the reference's order; the cut falls inside
    a run of ties."""
    rng = np.random.default_rng(9)
    vals = np.array([0.5, -0.5, 0.25, 0.0, -0.25, 0.5, 0.125, -0.0],
                    np.float32)
    tau = rng.choice(vals, size=(64,)).astype(np.float32)
    base = rng.standard_normal((64,)).astype(np.float32).round(2)
    ft = (base + tau).astype(np.float32)
    jt, jb = {"x": jnp.asarray(ft)}, {"x": jnp.asarray(base)}
    tt, tb = {"x": torch.from_numpy(ft)}, {"x": torch.from_numpy(base)}
    (wi, wv, wn), (gi, gv, gn) = JC.topk_sparsify(jt, jb, k_frac)["x"], \
        TC.topk_sparsify(tt, tb, k_frac)["x"]
    assert np.array_equal(gi.numpy(), np.asarray(wi)) and gn == wn
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    mag = np.abs(ft - base)
    kept = set(gi.tolist())
    cut = mag[gi.numpy()].min()
    # every entry above the cut is kept; at the cut, the lowest indices
    tied = [i for i in range(64) if mag[i] == cut]
    assert all(i in kept for i in range(64) if mag[i] > cut)
    took = [i for i in tied if i in kept]
    assert took == tied[:len(took)]


def test_topk_refuses_leaves_past_int32():
    """Exact: a leaf of 2^31 elements raises `ValueError` (the
    reference's `astype(np.int32)` would wrap its indices); meta tensors,
    so nothing is allocated."""
    x = torch.empty((2 ** 31,), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="int32"):
        TC.topk_sparsify({"e": x}, {"e": x})
    small = torch.empty((2 ** 31 - 1,), dtype=torch.bfloat16,
                        device="meta")
    assert TC._INT32_MAX == small.numel()
