"""The port's slice-2 CUDA kernels on a GPU, against their plain
PyTorch versions, bitwise; skipped without CUDA (the kernels have no
CPU mode).

This file imports neither JAX nor `repro`, so it runs on a GPU machine
without them: `python -m pytest --noconftest -q -m cuda
tests/test_torch_cuda.py` (the shared `tests/conftest.py` imports JAX).

  quant_nary   B2, k in {1, 3, 4, 16}, leaves around the tile edge
  dare_block   B6, fp32 and bf16, seeds near the uint32 wrap
  engine       the int8 and DARE kernel routes on CUDA tensors equal
               the same merges on CPU tensors (plain versions), and
               the exact DARE path's threefry draws agree across the
               two devices
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import pytree  # noqa: E402
from repro_torch.core import compression, engine  # noqa: E402
from repro_torch.kernels import dare, quant  # noqa: E402
from repro_torch.kernels.common import padded_len  # noqa: E402
from repro_torch.kernels.config import kernel_env  # noqa: E402
from repro_torch.kernels.histogram import batch_layout  # noqa: E402

BLOCK = 2048
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
