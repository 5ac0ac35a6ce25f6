"""The port's CUDA kernels (all eight kernel functions, B1-B8) on a
GPU, against their plain PyTorch versions, bitwise; skipped without
CUDA (the kernels have no CPU mode).

This file imports neither JAX nor `repro`, so it runs on a GPU machine
without them: `python -m pytest --noconftest -q -m cuda
tests/test_torch_cuda.py` (the shared `tests/conftest.py` imports JAX).

  B1, B3-B5    nary_accum, block_amax, block_hist, ties_block: fp32 and
               bf16, k in {1, 4, 16}, leaves around the tile edge; a NaN
               stays in its tile
  quant_nary   B2, k in {1, 3, 4, 16}, leaves around the tile edge
  dare_block   B6, fp32 and bf16, seeds near the uint32 wrap
  ties_leaf    B7, k in {1, 2, 4} (and 16), fp32 and bf16, a ragged leaf
  slerp        B8 reduce and combine, fp32 and bf16, u == v included
  engine       the int8 and DARE kernel routes on CUDA tensors equal
               the same merges on CPU tensors (plain versions), and
               the exact DARE path's threefry draws agree across the
               two devices
  per-leaf     `repro_torch.kernels`' six entry points on the card equal
               the same calls on the CPU: bitwise, except slerp_merge,
               whose trig scalars go through the two devices' own
               arccos and sin: those within 4 fp32 ulps, and each leaf
               bitwise equal to the CPU's combine with the card's
               scalars
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels, pytree  # noqa: E402
from repro_torch.core import compression, engine  # noqa: E402
from repro_torch.kernels import dare, histogram, quant, slerp  # noqa: E402
from repro_torch.kernels import nary_accum as nary  # noqa: E402
from repro_torch.kernels import ties  # noqa: E402
from repro_torch.kernels.common import padded_len  # noqa: E402
from repro_torch.kernels.config import kernel_env  # noqa: E402
from repro_torch.kernels.histogram import batch_layout  # noqa: E402

BLOCK = 2048
BINS = 512
LENGTHS = [1, 2047, 2048, 2049, 700]
SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 32 - 1, 123456789]


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    yield
    kernel_env.dare_kernel_rng = False


def _rows(rng, k, dtype=np.float32):
    leaf_id, _, npad = batch_layout(LENGTHS, BLOCK)
    x = np.zeros((k, npad), dtype)
    base = np.zeros(npad, np.float32)
    off = 0
    for n in LENGTHS:
        x[:, off:off + n] = rng.standard_normal((k, n)) if dtype != np.int8 \
            else rng.integers(-127, 128, (k, n))
        base[off:off + n] = rng.standard_normal(n) * 0.5
        off += padded_len(n, BLOCK)
    return leaf_id, torch.from_numpy(x), torch.from_numpy(base)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4, 16])
def test_cuda_quant_nary_equals_plain(k):
    rng = np.random.default_rng(k)
    leaf_id, q, base = _rows(rng, k, np.int8)
    scales = torch.from_numpy((rng.random((len(LENGTHS), k)) * 0.02
                               + 1e-3).astype(np.float32))
    smeta = scales[torch.tensor(leaf_id)].contiguous()
    w = torch.from_numpy(rng.standard_normal(k).astype(np.float32))
    args = [t.cuda() for t in (q, base, smeta, w)]
    before = quant.quant_nary.launches
    got = quant.quant_nary(*args, BLOCK)
    assert quant.quant_nary.launches == before + 1
    assert torch.equal(got, quant.quant_nary_plain(*args, BLOCK))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dare_block_equals_plain(dtype, k):
    rng = np.random.default_rng(k)
    _, x, base = _rows(rng, k)
    x = x.to(getattr(torch, dtype))
    meta = torch.cat([dare.leaf_meta(s, padded_len(n, BLOCK), BLOCK,
                                     device="cpu")
                      for s, n in zip(SEEDS, LENGTHS)])
    args = [t.cuda() for t in (x, base, meta)]
    before = dare.dare_block.launches
    got = dare.dare_block(*args, 0.3, BLOCK)
    assert dare.dare_block.launches == before + 1
    assert torch.equal(got, dare.dare_block_plain(*args, 0.3, BLOCK))


def _tree(seed, k=4):
    """k bf16 contributions over a small mixed-shape tree (CPU)."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    return [{"emb": leaf(37, 8), "blk": {"w": leaf(8, 16), "b": leaf(16)},
             "norm": leaf(5)} for _ in range(k)]


def _on(tree, device):
    return pytree.tree_map(lambda t: t.to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["int8", "dare"])
def test_cuda_engine_route_equals_cpu(route):
    """The same merge on CUDA tensors (kernels) and on CPU tensors
    (plain versions): bitwise, including the exact-path leaves."""
    cs = _tree(0)
    if route == "int8":
        kw = dict(strategy_name="weight_average")
        cpu_in = [compression.compress_tree(c) for c in cs]
        dev_in = [compression.compress_tree(_on(c, "cuda")) for c in cs]
        kind = "quant_nary"
    else:
        kernel_env.dare_kernel_rng = True
        kw = dict(strategy_name="dare", seed=2 ** 62 + 11, p=0.4)
        cpu_in, dev_in = cs, [_on(c, "cuda") for c in cs]
        kind = "dare"
    cache = engine.EngineCache()
    got = engine.merge(dev_in, kernels=True, use_cache=False,
                       max_batch_bytes=600, cache=cache, **kw)
    assert cache.obs.counter("kernel_dispatch_total").value(kernel=kind) > 0
    want = engine.merge(cpu_in, kernels=True, use_cache=False,
                        max_batch_bytes=600, **kw)
    for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
        assert g.is_cuda and torch.equal(g.cpu(), w)


# ------------------------------------------------------------ B1, B3-B5


def _amax_meta(bmax, leaf_id, nleaves):
    lid = torch.tensor(leaf_id, device=bmax.device)
    per = torch.stack([bmax[lid == j].amax(dim=0) for j in range(nleaves)])
    return (per + 1e-12)[lid].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_equal_plain_versions(dtype, k):
    """B1, B3, B4 and B5 bitwise equal to their plain versions."""
    leaf_id, x, base = _rows(np.random.default_rng(k), k)
    tx, tb = x.to(getattr(torch, dtype)).cuda(), base.cuda()
    _, valid, _ = batch_layout(LENGTHS, BLOCK)
    w = torch.linspace(-1, 1, k, device="cuda")
    assert torch.equal(nary.nary_accum(tx, tb, w),
                       nary.nary_accum_plain(tx, tb, w))
    bmax = histogram.block_amax(tx, tb, BLOCK)
    assert torch.equal(bmax, histogram.block_amax_plain(tx, tb, BLOCK))
    amax = _amax_meta(bmax, leaf_id, len(LENGTHS))
    vld = torch.tensor(valid, dtype=torch.int32, device="cuda")
    assert torch.equal(
        histogram.block_hist(tx, tb, amax, vld, BINS, BLOCK),
        histogram.block_hist_plain(tx, tb, amax, vld, BINS, BLOCK))
    thr = (amax * 0.4).contiguous()
    assert torch.equal(histogram.ties_block(tx, tb, thr, BLOCK),
                       histogram.ties_block_plain(tx, tb, thr, BLOCK))


@pytest.mark.cuda
def test_cuda_block_amax_keeps_a_nan_in_its_tile():
    x = torch.zeros((4, 5000 // BLOCK * BLOCK + BLOCK), device="cuda")
    x[2, 4097] = float("nan")
    got = histogram.block_amax(x, torch.zeros(x.shape[1], device="cuda"),
                               BLOCK).cpu()
    assert torch.isnan(got[2, 2]) and int(torch.isnan(got).sum()) == 1


# ------------------------------------------------------------ B7, B8


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ties_leaf_equals_plain(dtype, k):
    """One ragged leaf of 5000 columns, zero-padded to 6144 as the
    per-leaf API pads it; thresholds around |tau|'s median."""
    rng = np.random.default_rng(k)
    n, npad = 5000, padded_len(5000, BLOCK)
    x = np.zeros((k, npad), np.float32)
    x[:, :n] = rng.standard_normal((k, n))
    base = np.zeros(npad, np.float32)
    base[:n] = rng.standard_normal(n) * 0.5
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
    tb = torch.from_numpy(base).cuda()
    thr = torch.from_numpy((rng.random(k) * 1.2).astype(np.float32)).cuda()
    before = ties.ties_leaf.launches
    got = ties.ties_leaf(tx, tb, thr, BLOCK)
    assert ties.ties_leaf.launches == before + 1
    assert torch.equal(got, ties.ties_leaf_plain(tx, tb, thr, BLOCK))
    assert torch.equal(got.cpu(), ties.ties_tile(
        tx.cpu(), tb.cpu(), thr.cpu().reshape(-1, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_slerp_equals_plain(dtype, same):
    """Both passes bitwise; u == v takes the `so < 1e-6` branch, where
    the scalars are (1 - t, t) times nu / nu."""
    rng = np.random.default_rng(8)
    n = 5 * BLOCK
    u = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        getattr(torch, dtype)).cuda()
    v = u.clone() if same else torch.from_numpy(rng.standard_normal(
        n).astype(np.float32)).to(getattr(torch, dtype)).cuda()
    before = (slerp.slerp_reduce.launches, slerp.slerp_combine.launches)
    part = slerp.slerp_reduce(u, v, BLOCK)
    assert torch.equal(part, slerp.slerp_reduce_plain(u, v, BLOCK))
    c = slerp.slerp_scalars(part, 0.3)
    out = slerp.slerp_combine(u, v, c, BLOCK)
    assert torch.equal(out, slerp.slerp_combine_plain(u, v, c, BLOCK))
    assert (slerp.slerp_reduce.launches,
            slerp.slerp_combine.launches) == (before[0] + 1, before[1] + 1)
    if same:
        np.testing.assert_allclose(out.cpu().numpy(),
                                   u.float().cpu().numpy(), rtol=4e-7,
                                   atol=0)


# ------------------------------------------------------------ per-leaf API


def _perleaf_tree(rng, dtype):
    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    # "tiles": a tile multiple, which the per-leaf API hands over unpadded
    return {"emb": leaf(37, 8), "blk": {"w": leaf(300, 20), "b": leaf(16)},
            "big": leaf(3, 2100), "tiles": leaf(3, 2048)}


def _perleaf_call(name, cs, base):
    if name == "weighted":
        return kernels.weighted_merge(cs, [0.1, 0.2, 0.3, 0.4], base)
    if name == "weight_average":
        return kernels.weight_average_merge(cs)
    if name == "task_arithmetic":
        return kernels.task_arithmetic_merge(cs, base, lam=0.7)
    if name == "ties_hist":
        return kernels.ties_merge(cs, base, 0.3)
    if name == "ties_quantile":
        return kernels.ties_merge(cs, base, 0.3, trim_method="quantile")
    if name == "slerp":
        return kernels.slerp_merge(cs[0], cs[1], t=0.35)
    return kernels.dare_merge(cs, base, seed=2 ** 40 + 3, p=0.4)


PERLEAF_KERNELS = {"weighted": "nary_accum", "weight_average": "nary_accum",
                   "task_arithmetic": "nary_accum", "ties_hist": "ties_block",
                   "ties_quantile": "ties_leaf", "slerp": "slerp_combine",
                   "dare": "dare_block"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PERLEAF_KERNELS))
def test_cuda_perleaf_api_equals_cpu(name, dtype):
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    cs = [_perleaf_tree(rng, dt) for _ in range(4)]
    base = _perleaf_tree(rng, dt)
    want = _perleaf_call(name, cs, base)
    kernels.reset_launch_counts()
    got = _perleaf_call(name, [_on(c, "cuda") for c in cs],
                        _on(base, "cuda"))
    assert kernels.launch_counts()[PERLEAF_KERNELS[name]] > 0
    for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        if name != "slerp":
            assert torch.equal(g.cpu(), w)
    if name == "slerp":
        for g, u, v in zip(pytree.leaves(got), pytree.leaves(cs[0]),
                           pytree.leaves(cs[1])):
            _check_slerp_leaf(g, u, v, 0.35)


def _slerp_scalars(u, v, t):
    """(zero-padded rows [2, Np], scalars c [2]) of one leaf, as
    `slerp_merge` computes them on the leaf's device."""
    n = u.numel()
    uv = torch.zeros((2, padded_len(n, BLOCK)), dtype=u.dtype,
                     device=u.device)
    uv[0, :n] = u.reshape(-1)
    uv[1, :n] = v.reshape(-1)
    return uv, slerp.slerp_scalars(slerp.slerp_reduce(uv[0], uv[1], BLOCK),
                                   t)


def _check_slerp_leaf(got, u, v, t):
    """The card's trig scalars within 4 fp32 ulps of the CPU's (the two
    devices' own arccos and sin), and the card's leaf bitwise equal to
    the CPU's combine with the card's scalars."""
    uv, c_cpu = _slerp_scalars(u, v, t)
    c_card = _slerp_scalars(u.cuda(), v.cuda(), t)[1].cpu()
    ulp = torch.from_numpy(np.abs(np.spacing(c_cpu.numpy())))
    assert bool(((c_card - c_cpu).abs() <= 4 * ulp).all()), (c_card, c_cpu)
    want = slerp.slerp_combine_plain(uv[0], uv[1], c_card, BLOCK)
    assert torch.equal(got.cpu(), want[:u.numel()].reshape(u.shape).to(
        u.dtype))
