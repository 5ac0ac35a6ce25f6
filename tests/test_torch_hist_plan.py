"""B3 (`block_amax`) and B4 (`block_hist`) of the port: B4's launch plan
pinned, and the plain versions against the reference's Pallas functions
(interpret mode on the CPU) on the inputs the CUDA kernels' warp-per-
tile design is sized for:

  hist_plan    (warps per block, contributions per pass, shared bytes)
               at k in {1, 4, 5, 16, 17} and bins in {512, 100, 4096}
               and at the largest histogram a block holds; a ValueError
               past it
  concentrated one element per leaf and contribution set to 1000 x the
               typical |x - base|, so almost every count falls in the
               first few of the bins (real fine-tune deltas are heavy-
               tailed): block_amax bitwise, block_hist exact counts
  bins = 100   block_hist exact counts on the Gaussian batch

bf16 stacks reach the port as bf16 and the reference as their exact fp32
widening. The CUDA kernels are held against these plain versions on a
GPU by `tests/test_torch_cuda.py`, on the same inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import histogram as jh  # noqa: E402
from repro_torch.kernels import histogram  # noqa: E402
from repro_torch.kernels.common import padded_len  # noqa: E402

torch.set_num_threads(1)

BLOCK = 2048
LENGTHS = [1, 2047, 2048, 2049, 700]
KS = [1, 4, 5, 16, 17]
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("k, bins, plan", [
    (1, 512, (4, 1, 8192)),
    (4, 512, (4, 4, 32768)),        # the main path
    (5, 512, (4, 5, 40960)),
    (16, 512, (4, 8, 65536)),       # two passes over x
    (17, 512, (4, 8, 65536)),       # three, the last of one row
    (4, 100, (4, 4, 6400)),
    (17, 100, (4, 17, 27200)),
    (4, 4096, (4, 1, 65536)),
    (16, 4096, (4, 1, 65536)),      # one contribution a pass
    (4, 58112, (1, 1, 232448)),     # one histogram fills a block
])
def test_hist_plan_is_pinned(k, bins, plan):
    assert histogram.hist_plan(k, bins) == plan
    warps, group, smem = plan
    assert smem == warps * group * bins * 4 <= histogram.SMEM_PER_BLOCK


@pytest.mark.parametrize("k, bins", [(1, 58113), (4, 1 << 20), (4, 0),
                                     (0, 512)])
def test_hist_plan_refuses_what_no_block_holds(k, bins):
    with pytest.raises(ValueError, match="no B4 launch"):
        histogram.hist_plan(k, bins)


def _batch(k, dtype, concentrated, seed=0):
    """(port stacked [k, Np], port base [Np] fp32, the reference's fp32
    copies, leaf_id, valid) over LENGTHS; `concentrated` sets one element
    per leaf and contribution to 1000 x the typical |x - base|."""
    leaf_id, valid, npad = histogram.batch_layout(LENGTHS, BLOCK)
    rng = np.random.default_rng(seed)
    x = np.zeros((k, npad), np.float32)
    base = np.zeros(npad, np.float32)
    off = 0
    for n in LENGTHS:
        x[:, off:off + n] = rng.standard_normal((k, n))
        base[off:off + n] = rng.standard_normal(n) * 0.5
        off += padded_len(n, BLOCK)
    if concentrated:
        real = np.concatenate([np.arange(n) + o for n, o in zip(
            LENGTHS, np.cumsum([0] + [padded_len(n, BLOCK)
                                      for n in LENGTHS[:-1]]))])
        typical = float(np.median(np.abs(x[:, real] - base[real])))
        off = 0
        for n in LENGTHS:
            for i in range(k):
                c = off + int(rng.integers(n))
                x[i, c] = base[c] + 1000.0 * typical * rng.choice([-1, 1])
            off += padded_len(n, BLOCK)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    return tx, torch.from_numpy(base), x, base, leaf_id, valid


def _amax_meta(bmax, leaf_id):
    lid = torch.tensor(leaf_id)
    per = torch.stack([bmax[lid == j].amax(dim=0)
                       for j in range(len(LENGTHS))])
    return (per + 1e-12)[lid].contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
def test_block_amax_plain_vs_pallas_concentrated(k, dtype):
    tx, tb, x, b, _, _ = _batch(k, dtype, concentrated=True)
    got = histogram.block_amax(tx, tb, BLOCK).numpy()
    want = np.asarray(jh.block_amax_pallas(
        jnp.asarray(x), jnp.asarray(b)[None, :], block=BLOCK,
        interpret=True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("bins, concentrated", [(512, True), (100, True),
                                                (100, False)])
def test_block_hist_plain_vs_pallas(bins, concentrated, k, dtype):
    tx, tb, x, b, leaf_id, valid = _batch(k, dtype, concentrated)
    amax = _amax_meta(histogram.block_amax(tx, tb, BLOCK), leaf_id)
    got = histogram.block_hist(tx, tb, amax,
                               torch.tensor(valid, dtype=torch.int32),
                               bins, BLOCK).numpy()
    want = np.asarray(jh.block_hist_pallas(
        jnp.asarray(x), jnp.asarray(b)[None, :], jnp.asarray(amax.numpy()),
        jnp.asarray(valid, jnp.int32).reshape(-1, 1), bins=bins,
        block=BLOCK, interpret=True))
    assert np.array_equal(got, want.astype(np.int64))
    assert got.sum() == k * sum(LENGTHS)
    if concentrated:
        # the input the design must hold: nearly every count in bins 0-3
        per = got.reshape(len(leaf_id), k, bins).sum(axis=(0, 1))
        assert per[:4].sum() >= 0.99 * per.sum()


def test_cpu_tensors_take_any_block():
    """The 16-byte rule binds only the CUDA kernels: the plain versions
    take a block that is not a multiple of 8."""
    rng = np.random.default_rng(5)
    tx = torch.from_numpy(rng.standard_normal((3, 3000)).astype(np.float32))
    tb = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    bmax = histogram.block_amax(tx, tb, 1500)
    assert torch.equal(bmax, histogram.block_amax_plain(tx, tb, 1500))
    counts = histogram.block_hist(tx, tb, bmax + 1e-12,
                                  torch.full((2,), 1500, dtype=torch.int32),
                                  64, 1500)
    assert int(counts.sum()) == 3 * 3000
