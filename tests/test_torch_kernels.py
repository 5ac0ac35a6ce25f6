"""The port's kernels: each plain PyTorch version against the reference's
Pallas function (interpret mode on the CPU, as the reference's own tests
run it), over fp32 and bf16 stacks, leaf lengths around the 2048-column
tile edge, and k in {1, 4, 16} (`ties_block` also at 5, 8, 9 and 17,
the edges of its CUDA instances: exact k up to 8, 4 columns a thread
from 9, any k above 16).

  nary_accum   within 1e-6 (fp32) of `nary_accum_pallas`: XLA's k-sum
               order inside the tile is not pinned (it contracts into FMA);
               the port sums in index order.
  block_amax   bitwise (max is exact in any order).
  block_hist   exact integer counts.
  ties_block   bitwise for k <= 4, where XLA sums the tile's k rows in
               index order as the port does; above, XLA may reassociate
               the sum, so within 1e-6 (observed 6e-7 on values of ~1 at
               k = 16).
  ties_batch   `ops.ties_batch_merge` bitwise against `ref.ties_hist_ref`
               per leaf; trim thresholds bitwise against the reference's
               `hist_threshold_ref`; against the reference's flat batch
               as ties_block.

bf16 stacks reach the port as bf16 (its kernels widen in registers) and
the reference as their exact fp32 widening (its `pad_stacked` copy).
The CUDA kernels themselves run only on a GPU: `tests/test_torch_cuda.py`,
which imports neither JAX nor `repro`, holds them against these plain
versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import histogram as jh  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.config import kernel_env as jkernel_env  # noqa: E402
from repro.kernels.nary_accum import nary_accum_pallas  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build, histogram, ops, ref  # noqa: E402
from repro_torch.kernels.common import padded_len  # noqa: E402
from repro_torch.kernels import nary_accum as nary  # noqa: E402

torch.set_num_threads(1)

BLOCK, BINS = 2048, 512
LENGTHS = {"1": [1], "2047": [2047], "2048+2049": [2048, 2049],
           "leaves": [1, 2047, 2048, 2049, 700]}
KS = [1, 4, 16]
TIES_KS = KS + [5, 8, 9, 17]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jkernel_env.reset()


def _batch(k, lengths, dtype, seed=0):
    """(port stacked [k, Np] in `dtype`, port base [Np] fp32, the same
    widened to fp32 numpy for the reference, leaf_id, valid)."""
    leaf_id, valid, npad = histogram.batch_layout(lengths, BLOCK)
    rng = np.random.default_rng(seed)
    x = np.zeros((k, npad), np.float32)
    base = np.zeros(npad, np.float32)
    off = 0
    for n in lengths:
        x[:, off:off + n] = rng.standard_normal((k, n))
        base[off:off + n] = rng.standard_normal(n) * 0.5
        off += padded_len(n, BLOCK)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    return tx, torch.from_numpy(base), x, base, leaf_id, valid


def _assert_ties_equal(got, want, k):
    """Bitwise where XLA's k-sum runs in index order (k <= 4), else
    within 1e-6 (see the module docstring)."""
    if k <= 4:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _amax_meta(bmax, leaf_id, nleaves):
    lid = torch.tensor(leaf_id)
    per = torch.stack([bmax[lid == j].amax(dim=0) for j in range(nleaves)])
    return (per + 1e-12)[lid].contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_nary_accum_plain_vs_pallas(lengths, k, dtype):
    tx, tb, x, b, _, _ = _batch(k, LENGTHS[lengths], dtype)
    w = np.random.default_rng(1).standard_normal(k).astype(np.float32)
    got = nary.nary_accum(tx, tb, torch.from_numpy(w)).numpy()
    xs = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" \
        else jnp.asarray(x)
    want = np.asarray(nary_accum_pallas(
        xs, jnp.asarray(b)[None, :], jnp.asarray(w)[:, None], block=BLOCK,
        interpret=True))[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_block_amax_plain_vs_pallas(lengths, k, dtype):
    tx, tb, x, b, _, _ = _batch(k, LENGTHS[lengths], dtype)
    got = histogram.block_amax(tx, tb, BLOCK).numpy()
    want = np.asarray(jh.block_amax_pallas(
        jnp.asarray(x), jnp.asarray(b)[None, :], block=BLOCK,
        interpret=True))
    assert np.array_equal(got, want)


def test_block_amax_propagates_nan():
    tx, tb, x, b, _, _ = _batch(4, [5000], "float32")
    tx[2, 4097] = float("nan")
    got = histogram.block_amax(tx, tb, BLOCK)
    assert torch.isnan(got[2, 2]) and not torch.isnan(got[1, 2])
    assert int(torch.isnan(got).sum()) == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_block_hist_plain_vs_pallas(lengths, k, dtype):
    ls = LENGTHS[lengths]
    tx, tb, x, b, leaf_id, valid = _batch(k, ls, dtype)
    amax = _amax_meta(histogram.block_amax(tx, tb, BLOCK), leaf_id, len(ls))
    got = histogram.block_hist(tx, tb, amax,
                               torch.tensor(valid, dtype=torch.int32),
                               BINS, BLOCK).numpy()
    want = np.asarray(jh.block_hist_pallas(
        jnp.asarray(x), jnp.asarray(b)[None, :], jnp.asarray(amax.numpy()),
        jnp.asarray(valid, jnp.int32).reshape(-1, 1), bins=BINS,
        block=BLOCK, interpret=True))
    assert np.array_equal(got, want.astype(np.int64))
    assert got.sum() == k * sum(ls)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", TIES_KS)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_ties_block_plain_vs_pallas(lengths, k, dtype):
    tx, tb, x, b, leaf_id, _ = _batch(k, LENGTHS[lengths], dtype)
    rng = np.random.default_rng(2)
    thr = (rng.random((len(leaf_id), k)) * 1.5).astype(np.float32)
    got = histogram.ties_block(tx, tb, torch.from_numpy(thr), BLOCK).numpy()
    want = np.asarray(jh.ties_block_pallas(
        jnp.asarray(x), jnp.asarray(b)[None, :], jnp.asarray(thr),
        block=BLOCK, interpret=True))[0]
    _assert_ties_equal(got, want, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
def test_ties_batch_merge_vs_per_leaf_oracle(k, dtype):
    """The flat batch equals each leaf's own eager oracle bitwise, its
    thresholds equal the reference's bitwise, and its output equals the
    reference's flat batch bitwise."""
    lengths = LENGTHS["leaves"]
    rng = np.random.default_rng(3)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rows = [torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(tdt) for n in lengths]
    bases = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for n in lengths]
    outs = ops.ties_batch_merge(rows, bases, 0.3, block=BLOCK)
    jouts = jops.ties_batch_merge(
        [jnp.asarray(r.to(torch.float32).numpy()) for r in rows],
        [jnp.asarray(b.numpy()) for b in bases], 0.3, block=BLOCK,
        interpret=True)
    for r, b, o, jo in zip(rows, bases, outs, jouts):
        assert torch.equal(o, ref.ties_hist_ref(r, b, 0.3))
        _assert_ties_equal(o.numpy(), np.asarray(jo), k)
        thr = ref.hist_threshold_ref(r, b, 0.3).numpy()
        jthr = np.asarray(jref.hist_threshold_ref(
            jnp.asarray(r.to(torch.float32).numpy()),
            jnp.asarray(b.numpy()), 0.3))
        assert np.array_equal(thr, jthr)


def test_nary_flat_merge_is_per_leaf_nary():
    rng = np.random.default_rng(4)
    lengths = LENGTHS["leaves"]
    rows = [torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
            for n in lengths]
    bases = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for n in lengths]
    outs = ops.nary_flat_merge(rows, bases, [0.2, 0.3, 0.5], block=BLOCK)
    w = torch.tensor([0.2, 0.3, 0.5])
    for r, b, o in zip(rows, bases, outs):
        assert torch.equal(o, ref.nary_accum_ref(r, b, w))


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launch_counts()
    tx, tb, _, _, leaf_id, valid = _batch(4, [3000], "bfloat16")
    amax = _amax_meta(histogram.block_amax(tx, tb, BLOCK), leaf_id, 1)
    histogram.block_hist(tx, tb, amax, torch.tensor(valid,
                                                    dtype=torch.int32),
                         BINS, BLOCK)
    histogram.ties_block(tx, tb, amax * 0.5, BLOCK)
    nary.nary_accum(tx, tb, torch.full((4,), 0.25))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_no_device_route_falls_back_silently():
    """Operands off the CPU never run the plain version: a device with
    no kernel, or operands split across devices, raise."""
    meta = torch.empty((4, 2048), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        nary.nary_accum(meta, torch.empty(2048, device="meta"),
                        torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        build.on_host(torch.zeros(2), meta)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        histogram.block_amax(torch.zeros((2, 2048), dtype=torch.float16),
                             torch.zeros(2048), BLOCK)
