"""The port's CUDA kernels on a GPU, against their plain PyTorch
versions: B1-B8 bitwise, B9 within a tolerance; skipped without CUDA
(the kernels have no CPU mode).

This file imports neither JAX nor `repro`, so it runs on a GPU machine
without them: `python -m pytest --noconftest -q -m cuda
tests/test_torch_cuda.py` (the shared `tests/conftest.py` imports JAX).

  B1, B3-B5    nary_accum, block_amax, block_hist, ties_block: fp32 and
               bf16, k in {1, 4, 16}, leaves around the tile edge; a NaN
               stays in its tile
  B5           k in {1, 2, 3, 4, 5, 7, 8, 9, 12, 16, 17, 40} (every
               instance and every boundary between them), blocks of
               2048, 1000 and 4104, a tile of NaN, +-0, ties, |tau| at
               its threshold and +-inf, bit for bit; a stack 2 bytes
               into its buffer, or a block not a multiple of 8, raises
  B3, B4       k in {1, 4, 5, 16, 17}, bins in {512, 100, 4096, 30}, a
               Gaussian and a concentrated input (nearly every count in
               the first bins), tiles of 1 valid column and an all-zero
               tile, blocks of 1000 and 4104 columns, k = 40; B4's plan in
               the CUDA source equals `hist_plan`; a stack 2 bytes into
               its buffer, or a block not a multiple of 8, raises
  quant_nary   B2, k in {1, 3, 4, 16}, leaves around the tile edge, with
               and without a base row; batches whose element offsets
               pass 2^31 (a row past 2^31, and a third row starting
               past it), bitwise over the whole output (skipped, and
               saying so, on a card with less than 24 GB free)
  MoE          Qwen3-MoE's smoke block on the card: `moe_gather` and
               `moe_einsum` give the same bytes on two calls, the
               dispatch integers (positions, keep, the [G, E, C] table,
               used slots) equal the CPU's, and the outputs the CPU's
               within a tolerance; the smoke model's greedy decode on
               the card gives the CPU's tokens in fp32; its loss and
               gradients under the train step's deterministic mode
               equal the CPU's within the CPU tests' limits, and two
               train steps repeat bitwise on the card
  MLA          DeepSeek-V2's smoke model (`q_lora_rank` 24) on the card:
               prefill logits and latent caches, greedy decode (no B9
               launch), the bf16 decode repeated bitwise, the loss and
               its gradients, each against the CPU
  VLM, MLA     the VLM's (gates set) and DeepSeek-V2's smoke train steps
  training     with fp32 and with bf16 parameters (`parambf16`): two
               steps on the card repeat bitwise and land near the CPU's
  hashing      `tensor_digest` of CUDA leaves (through the page-locked
               staging buffers, on the hashing threads) equals the
               CPU's
  dare_block   B6, fp32 and bf16, seeds near the uint32 wrap
  ties_leaf    B7, k in {1, 2, 4} (and 16), fp32 and bf16, a ragged leaf
  slerp        B8 reduce and combine, fp32 and bf16, u == v included
  engine       the int8 and DARE kernel routes on CUDA tensors equal
               the same merges on CPU tensors (plain versions), and
               the exact DARE path's threefry draws agree across the
               two devices; a sparse plan whose fused groups have
               k = 1, 4 and 5 through B1 and B3-B5 equals the CPU's
  per-leaf     `repro_torch.kernels`' six entry points on the card equal
               the same calls on the CPU: bitwise, except slerp_merge,
               whose trig scalars go through the two devices' own
               arccos and sin: those within 4 fp32 ulps, and each leaf
               bitwise equal to the CPU's combine with the card's
               scalars
  B9 gradient  the LSE forward and the three backward kernels against
               their plain versions (MHA, GQA, MQA, every head dim, fp32
               and bf16, ragged tiles, one row, non-causal, Minitron-8B's
               32:8 GQA at D = 128, MiniCPM-2B's 36 heads; q x8 in bf16;
               gemma2's softcap 50 and 2 and windows 1, 5 and 64, one row
               included, and its 32:16 heads at D = 128; the VLM's 8:1
               at D = 128, causal and non-causal over ragged Sq and Sk
               as its training runs them), bitwise
               repeatable, and q x8 in fp32 against a float64 oracle
               (ROADMAP C4), reached once each through autograd; rows
               that see one key (one row, a window of 1) give dq and dk
               of exactly 0 over several seeds, as the reference's
               autodiff (ROADMAP C5); two smoke train steps on the card
               (minitron, and gemma2 with its window and softcap
               binding) repeat bitwise and match the CPU's
  B9           flash_attention against its plain version within a
               tolerance (the two sum and exponentiate differently):
               GQA, MQA, ragged Sq and Sk, every D in HEAD_DIMS, a
               multi-tile and a chunked prefill, decode (Sq = 1 at a
               q_offset, at position 0, on either side of a key-chunk
               boundary, over a full 4096-slot cache, GQA 4:1),
               non-causal with ragged Sk, cache slices read through
               their strides, fp32 and bf16; two launches give equal
               bits, also with calls of another shape between them (the
               decode tickets reset); the smoke model's greedy decode on
               the card gives the CPU's tokens in fp32
  B9 gemma2    softcap and sliding window in the three designs, every
               head dim, windows of 1, 7, 64, 100 and 4096, q_offset 0
               and past it; key tiles below the window never read (NaN
               there leaves the output's bits); decode over a 4096-slot
               ring at and after the wrap; gemma2's smoke model (window
               5, softcap 2) greedy-decodes the CPU's tokens on the card
  whole-model  `random.split` / `normal` on the card equal the CPU's
               (bitwise), the medians on the card equal the CPU's
               (bitwise: ties, +-0, NaN), the five whole-model
               strategies on the card within `WHOLE_TOL` of the CPU's
               (the SVD runs in cuSOLVER there, in LAPACK here), and two
               runs of each SVD strategy on the card give equal bytes
  wire/journal `decode_blob` and `msg_to_state` (kept int8 and
               decompressed on arrival) onto the card equal the CPU
               decode bitwise, and CUDA tensors encode to the CPU's
               bytes; a `Replica(path=)` reopened on the card (a
               `DurableStore` recovered there) resolves weight_average
               with the kernels (B2) byte-identical to an in-memory
               replica, at Phi-3-mini's width and 2 layers; C3: int8
               payloads on the CPU contributed to a replica on the card
               land there and resolve to the CPU replica's bytes
  sync         a two-node anti-entropy session over
               `PersistentLoopbackTransport(device="cuda")` lands every
               payload on the card, bitwise the CPU session's; int8
               payloads kept quantized on arrival merge through B2
               byte-identical to the CPU's plain merge; a
               `SimGossipNetwork(device="cuda")` epidemic delivers the
               CPU run's frames at the same virtual times and reaches
               its roots
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
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention, flash_attention_plain)
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
    # no base row: a zero base, read by neither
    args[1] = None
    got = quant.quant_nary(*args, BLOCK)
    assert torch.equal(got, quant.quant_nary_plain(*args, BLOCK))
    assert torch.equal(got, quant.quant_nary(
        args[0], torch.zeros_like(base.cuda()), *args[2:], BLOCK))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1, 2 ** 31 + 2 ** 20),
                                 (3, 2 ** 30 + 2 ** 20)])
@pytest.mark.parametrize("with_base", [False, True])
def test_cuda_quant_nary_past_2_31(k, n, with_base):
    """B2 over element offsets past 2^31: one row of 2^31 + 2^20
    columns, and three rows of 2^30 + 2^20 (the third starts past
    2^31), bitwise equal to the plain version over the whole output.
    Needs about 24 GB of the card: skipped, saying so, with less free."""
    need = 24 * 2 ** 30
    if torch.cuda.mem_get_info()[0] < need:
        pytest.skip(f"needs {need / 2 ** 30:.0f} GiB free on the card")
    g = torch.Generator(device="cuda").manual_seed(k)
    q = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    smeta = (torch.rand((n // BLOCK, k), generator=g, device="cuda")
             * 1e-3 + 1e-5)
    w = torch.rand((k,), generator=g, device="cuda")
    base = torch.randn((n,), generator=g, device="cuda") \
        if with_base else None
    got = quant.quant_nary(q, base, smeta, w, BLOCK)
    want = quant.quant_nary_plain(q, base, smeta, w, BLOCK)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got[-BLOCK:]).all())


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


def _mixed_k(dtype):
    """Six sparse contributions over a base (CPU): four cover d1, d2,
    s1, s2, a fifth s1, s2, a sixth u1, u2; `big` is covered by none.
    So the plan fuses a k = 4 group, a k = 5 group and a k = 1 group."""
    rng = np.random.default_rng(9)

    def leaf(n):
        return torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dtype)

    sizes = {"big": 5000, "d1": 2047, "d2": 2049, "s1": 700, "s2": 2048,
             "u1": 1, "u2": 3000}
    base = {k: leaf(n) for k, n in sizes.items()}
    covers = [("d1", "d2", "s1", "s2")] * 4 + [("s1", "s2"), ("u1", "u2")]
    contribs = [{k: base[k] + 0.1 * leaf(sizes[k]) for k in c}
                for c in covers]
    covs = [tuple(sorted(f"['{k}']" for k in c)) for c in covers]
    return contribs, covs, base


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["weight_average", "task_arithmetic",
                                  "ties"])
def test_cuda_mixed_k_plan_equals_cpu(name, dtype):
    """B1 (linear family) and B3-B5 (histogram TIES) over one plan whose
    groups have k = 1, 4 and 5: the merge on CUDA tensors equals the
    same merge on CPU tensors (plain versions), bitwise, with one
    dispatch per group."""
    contribs, covs, base = _mixed_k(dtype)
    cfg = {"trim_method": "histogram"} if name == "ties" else {}
    kind = "ties_hist" if name == "ties" else "nary_accum"
    outs = []
    for dev in ("cuda", "cpu"):
        cache = engine.EngineCache()
        kernels.reset_launch_counts()
        outs.append(engine.merge(
            [_on(c, dev) for c in contribs], name, base=_on(base, dev),
            coverages=covs, kernels=True, use_cache=False,
            max_batch_bytes=1 << 20, cache=cache, **cfg))
        assert cache.obs.counter("kernel_dispatch_total").value(
            kernel=kind) == 3
        assert cache.obs.gauge("engine_sparse_leaves_skipped").value() == 7
        counts = kernels.launch_counts()
        launched = ("nary_accum",) if kind == "nary_accum" else \
            ("block_amax", "block_hist", "ties_block")
        assert all(counts[k] == (3 if dev == "cuda" else 0)
                   for k in launched), counts
    for g, w in zip(pytree.leaves(outs[0]), pytree.leaves(outs[1])):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    assert torch.equal(outs[1]["big"], base["big"])


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


def _hist_batch(k, dtype, block, concentrated, seed=0):
    """(leaf_id, valid, stacked, base) on the card over LENGTHS at
    `block`: Gaussian rows, the tile from column `block` zeroed in x and
    base (an all-zero tile), and with `concentrated` one element per leaf
    and contribution set to 1000 x the typical |x - base|, so nearly
    every count falls in the first few bins."""
    leaf_id, valid, npad = batch_layout(LENGTHS, block)
    starts = np.cumsum([0] + [padded_len(n, block) for n in LENGTHS])
    rng = np.random.default_rng(seed)
    x = np.zeros((k, npad), np.float32)
    base = np.zeros(npad, np.float32)
    for n, off in zip(LENGTHS, starts):
        x[:, off:off + n] = rng.standard_normal((k, n))
        base[off:off + n] = rng.standard_normal(n) * 0.5
    if concentrated:
        real = np.concatenate([np.arange(n) + off
                               for n, off in zip(LENGTHS, starts)])
        typical = float(np.median(np.abs(x[:, real] - base[real])))
        for n, off in zip(LENGTHS, starts):
            for i in range(k):
                c = off + int(rng.integers(n))
                x[i, c] = base[c] + 1000.0 * typical * rng.choice([-1, 1])
    x[:, block:2 * block] = 0.0
    base[block:2 * block] = 0.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
    return leaf_id, valid, tx, torch.from_numpy(base).cuda()


def _hist_equal_plain(k, dtype, block, bins, concentrated):
    leaf_id, valid, tx, tb = _hist_batch(k, dtype, block, concentrated)
    before = (histogram.block_amax.launches, histogram.block_hist.launches)
    bmax = histogram.block_amax(tx, tb, block)
    assert torch.equal(bmax, histogram.block_amax_plain(tx, tb, block))
    amax = _amax_meta(bmax, leaf_id, len(LENGTHS))
    vld = torch.tensor(valid, dtype=torch.int32, device="cuda")
    got = histogram.block_hist(tx, tb, amax, vld, bins, block)
    assert torch.equal(
        got, histogram.block_hist_plain(tx, tb, amax, vld, bins, block))
    assert (histogram.block_amax.launches, histogram.block_hist.launches) \
        == (before[0] + 1, before[1] + 1)
    assert int(got.sum()) == k * sum(LENGTHS)
    tiles = got.reshape(len(leaf_id), k, bins)
    # the zero tile: every valid column in bin 0
    assert int(tiles[1, :, 0].sum()) == int(tiles[1].sum()) == k * valid[1]
    return tiles


@pytest.mark.cuda
@pytest.mark.parametrize("concentrated", [False, True])
@pytest.mark.parametrize("bins", [512, 100, 4096, 30])
@pytest.mark.parametrize("k", [1, 4, 5, 16, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_block_amax_hist_equal_plain(dtype, k, bins, concentrated):
    """B3 bitwise and B4's exact counts against the plain versions over
    the tile edge (tiles of 1 valid column, an all-zero tile), with the
    contributions taken in groups where their histograms outgrow a
    warp's share (16 x 4096 bins: one a pass), with 16-byte and 4-byte
    count moves (bins 30), and on the concentrated input."""
    counts = _hist_equal_plain(k, dtype, BLOCK, bins, concentrated)
    if concentrated and bins <= 512:
        per = counts.sum(dim=(0, 1))
        assert int(per[:4].sum()) >= 0.99 * int(per.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("bins", [512, 4096])
@pytest.mark.parametrize("k", [4, 17, 40])
@pytest.mark.parametrize("block", [1000, 4104])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_block_amax_hist_other_blocks(dtype, block, k, bins):
    """Tiles narrower than a warp's 1024-column segment (1000: lanes past
    the edge idle) and wider (4104: five segments, the last one vector
    wide; at 4096 bins the base is read again for each contribution);
    k = 40 takes B3's rows in two groups of 32 and B4's in five of 8."""
    _hist_equal_plain(k, dtype, block, bins, concentrated=False)


@pytest.mark.cuda
def test_cuda_hist_plan_matches_the_kernels():
    """The launch plan the CUDA source computes is `hist_plan`'s."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.function("block_hist_plan")
    plan = (ctypes.c_int * 3)()
    for k in (1, 2, 4, 5, 8, 9, 16, 17, 64):
        for bins in (1, 30, 100, 512, 4096, 8192, 58112):
            assert fn(k, bins, ctypes.addressof(plan)) == 0
            assert tuple(plan) == histogram.hist_plan(k, bins)
    assert fn(4, 58113, ctypes.addressof(plan)) != 0
    assert fn(0, 512, ctypes.addressof(plan)) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_block_amax_hist_refuse_unaligned(dtype):
    """16-byte loads: a stack 2 bytes into its buffer and a block that
    is not a multiple of 8 raise, and nothing launches."""
    k, np_ = 4, 6000
    buf = torch.zeros(k * np_ + 1, dtype=getattr(torch, dtype),
                      device="cuda")
    off = buf[1:].view(k, np_)
    ok = torch.zeros((k, np_), dtype=getattr(torch, dtype), device="cuda")
    base = torch.zeros(np_, device="cuda")
    before = (histogram.block_amax.launches, histogram.block_hist.launches)
    for x, block in ((off, 2000), (ok, 1500)):
        nb = np_ // block
        with pytest.raises(ValueError, match="16-byte|multiple of 8"):
            histogram.block_amax(x, base, block)
        with pytest.raises(ValueError, match="16-byte|multiple of 8"):
            histogram.block_hist(
                x, base, torch.ones((nb, k), device="cuda"),
                torch.full((nb,), block, dtype=torch.int32, device="cuda"),
                BINS, block)
    assert (histogram.block_amax.launches,
            histogram.block_hist.launches) == before


def _ties_batch(k, dtype, block, seed=0):
    """(stacked, base, thr_meta) on the card over LENGTHS at `block`:
    Gaussian rows, per-tile thresholds around |tau|'s median, and tile 1
    (from column `block`; its thresholds all 0.5) holding the values
    whose arithmetic is delicate: a NaN in one row, tau = +0 and -0 in
    every row, |tau| exactly equal to the threshold, a k-sum of exactly
    0 (k >= 2), and +-inf."""
    leaf_id, _, npad = batch_layout(LENGTHS, block)
    starts = np.cumsum([0] + [padded_len(n, block) for n in LENGTHS])
    rng = np.random.default_rng(seed)
    x = np.zeros((k, npad), np.float32)
    base = np.zeros(npad, np.float32)
    for n, off in zip(LENGTHS, starts):
        x[:, off:off + n] = rng.standard_normal((k, n))
        base[off:off + n] = rng.standard_normal(n) * 0.5
    thr = (rng.random((len(leaf_id), k)) * 1.2).astype(np.float32)
    c = block
    thr[1] = 0.5
    x[k // 2, c] = np.nan
    base[c + 1] = 0.25
    x[:, c + 1] = 0.25                        # tau = +0
    base[c + 2:c + 5] = 0.0
    x[:, c + 2] = -0.0                        # tau = -0
    # |tau| = 0.5, the threshold: kept; one row in three negative
    x[:, c + 3] = 0.5 * np.where(np.arange(k) % 3 == 1, -1.0, 1.0)
    x[:, c + 4] = 0.0
    if k >= 2:
        x[0, c + 4], x[1, c + 4] = 1.0, -1.0  # a k-sum of exactly 0
        x[0, c + 5], x[1, c + 5] = np.inf, -np.inf
    x[0, c + 6] = np.inf
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
    return tx, torch.from_numpy(base).cuda(), torch.from_numpy(thr).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [2048, 1000, 4104])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 9, 12, 16, 17, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ties_block_equals_plain(dtype, k, block):
    """B5 bit for bit its plain version at every instance and every
    boundary between them (exact k up to 16, 4 columns a thread from 9,
    any k above), over the tile edge, in tiles narrower (1000) and wider
    (4104) than one thread a vector, and on a tile of NaN, +-0, ties,
    |tau| at its threshold and +-inf."""
    tx, tb, thr = _ties_batch(k, dtype, block)
    before = histogram.ties_block.launches
    got = histogram.ties_block(tx, tb, thr, block)
    assert histogram.ties_block.launches == before + 1
    want = histogram.ties_block_plain(tx, tb, thr, block)
    assert torch.equal(_bits(got), _bits(want))
    c = block
    assert bool(torch.isnan(got[c])) and float(got[c + 1]) == float(tb[c + 1])
    # kept at the threshold: the positive rows outnumber the negative
    # ones but at k = 2, a tie
    assert float(got[c + 3]) == (0.0 if k == 2 else 0.5)
    assert float(got[c + 4]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ties_block_refuses_unaligned(dtype):
    """B5's 16-byte loads: a stack 2 bytes into its buffer and a block
    that is not a multiple of 8 raise, and nothing launches."""
    k, np_ = 4, 6000
    buf = torch.zeros(k * np_ + 1, dtype=getattr(torch, dtype),
                      device="cuda")
    off = buf[1:].view(k, np_)
    ok = torch.zeros((k, np_), dtype=getattr(torch, dtype), device="cuda")
    base = torch.zeros(np_, device="cuda")
    before = histogram.ties_block.launches
    for x, block in ((off, 2000), (ok, 1500)):
        thr = torch.ones((np_ // block, k), device="cuda")
        with pytest.raises(ValueError, match="16-byte|multiple of 8"):
            histogram.ties_block(x, base, thr, block)
    assert histogram.ties_block.launches == before


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


# B9 on the card against its plain version on the card. fp32: within
# 1e-5 absolute (outputs of order 1; the two differ in the order of the
# D-long dot products and the key sums, and in exp). bf16: within one
# bf16 ulp of |plain| + 1e-6 (equal fp32 values up to that difference,
# each rounded once to bf16).
FLASH_SPECS = {
    "gqa": (2, 128, 128, 8, 2, 64, True, 0),
    "mqa": (1, 200, 200, 4, 1, 128, True, 0),
    "ragged": (2, 77, 93, 4, 2, 96, True, 0),
    "noncausal_ragged": (2, 37, 100, 4, 2, 96, False, 0),
    "decode": (2, 1, 300, 8, 2, 96, True, 250),
    "decode_short_tile": (3, 5, 70, 4, 4, 64, True, 60),
    # the prefill design: a multi-tile causal prefill whose Sq is not a
    # multiple of 64; a chunked prefill at q_offset > 0; head dims 16, 32
    # (64, 96 and 128 above)
    "prefill_multitile": (2, 200, 200, 4, 2, 96, True, 0),
    "chunked_prefill": (2, 80, 180, 4, 2, 96, True, 100),
    "d16": (2, 70, 70, 4, 2, 16, True, 0),
    "d32": (2, 70, 70, 4, 2, 32, True, 0),
    # the decode design: 640 visible keys make five chunks of 128, so
    # 639 / 640 / 641 sit at a chunk boundary (641: a last chunk of one
    # key); position 0; a full 4096-slot cache; GQA with H / HK = 4 over
    # 24 chunks
    "decode_chunk_minus": (2, 1, 800, 8, 2, 96, True, 638),
    "decode_chunk_at": (2, 1, 800, 8, 2, 96, True, 639),
    "decode_chunk_plus": (2, 1, 800, 8, 2, 96, True, 640),
    "decode_pos0": (2, 1, 64, 8, 2, 96, True, 0),
    "decode_full_cache": (2, 1, 4096, 8, 2, 96, True, 4095),
    "decode_gqa4": (2, 1, 4096, 8, 2, 128, True, 3000),
    # Qwen3-MoE's 32 query heads over 4 KV heads of 128 (H / HK = 8):
    # a ragged prefill, and decode over a 4096-slot cache at position
    # 4063 (the 16-row decode instance with 8 rows live)
    "qwen3_prefill": (2, 300, 300, 32, 4, 128, True, 0),
    "qwen3_decode": (2, 1, 4096, 32, 4, 128, True, 4063),
    # Whisper-tiny's (6 heads of 64) and Llama-3.2-Vision's (64 over 8
    # KV heads of 128) attention, non-causal over a ragged Sk (1500 % 64
    # = 28, 1601 % 64 = 1): the encoder's self-attention, the cross
    # prefill at the chip smoke's 4-token prompt (the decode design) and
    # at 448 queries, a decode step over each cross cache, the VLM's
    # cross prefill (its 4064 queries cut to 300), and Whisper's causal
    # decoder decode over its 228-slot cache
    "whisper_encoder": (2, 1500, 1500, 6, 6, 64, False, 0),
    "whisper_cross_prompt": (2, 4, 1500, 6, 6, 64, False, 0),
    "whisper_cross_448": (2, 448, 1500, 6, 6, 64, False, 0),
    "whisper_cross_decode": (2, 1, 1500, 6, 6, 64, False, 0),
    "whisper_self_decode": (2, 1, 228, 6, 6, 64, True, 150),
    "vlm_cross_prefill": (1, 300, 1601, 64, 8, 128, False, 0),
    "vlm_cross_decode": (2, 1, 1601, 64, 8, 128, False, 0),
}


def _flash_inputs(spec, dtype, seed=0):
    b, sq, sk, h, hk, d, _, _ = spec
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(getattr(torch, dtype))
            for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d))]


def _flash_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        assert float((g - w).abs().max()) <= 1e-5
    else:
        assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 1e-6).all())


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_SPECS))
def test_cuda_flash_attention_equals_plain(case, dtype):
    spec = FLASH_SPECS[case]
    causal, q_offset = spec[6], spec[7]
    q, k, v = (t.cuda() for t in _flash_inputs(spec, dtype))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal,
                                    q_offset=q_offset)
    torch.cuda.synchronize()
    _flash_close(got, want)
    again = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert torch.equal(_bits(got), _bits(again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_tickets_reset_between_calls(dtype):
    """Two split decode calls interleaved with calls of another shape
    (another split and group count) give the same bits each time: every
    call's last block of a group puts its ticket back to 0."""
    from repro_torch.kernels.flash_attention import decode_splits
    a = (2, 1, 4096, 8, 2, 96, True, 4000)
    b = (3, 1, 2000, 4, 4, 64, True, 1500)
    assert decode_splits(2, 2, 4001, 96)[0] > 1
    assert decode_splits(3, 4, 1501, 64)[0] > 1
    ins = {spec: [t.cuda() for t in _flash_inputs(spec, dtype, seed=5)]
           for spec in (a, b)}
    first = {}
    for spec in (a, b, a, b, a):
        got = flash_attention(*ins[spec], q_offset=spec[7])
        torch.cuda.synchronize()
        if spec not in first:
            first[spec] = got
            _flash_close(got, flash_attention_plain(*ins[spec],
                                                    q_offset=spec[7]))
        assert torch.equal(_bits(got), _bits(first[spec]))


# gemma2's softcap and sliding window, in the three
# designs (bf16 prefill on the tensor cores, fp32 prefill on the scalar
# pipes, decode), under the same rule as above (`_flash_close`): every
# head dim in HEAD_DIMS; windows of 1, 7, 64 (a key tile), 100 and 4096
# (>= Sk: never binding); a binding softcap (2.0) and gemma2's (50); at
# q_offset 0 and past it (a chunked prefill, and decode steps whose
# window starts inside a key chunk). (B, Sq, Sk, H, HK, D, q_offset).
FLASH_WINDOWS = (1, 7, 64, 100, 4096)
FLASH_WINDOW_SHAPES = {
    "prefill": (2, 200, 200, 4, 2, None, 0),
    "chunked_prefill": (2, 80, 300, 4, 2, None, 220),
    "decode": (2, 1, 800, 8, 2, None, 700),
    "decode_gqa_rows": (2, 3, 2000, 8, 2, None, 1500),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("shape", sorted(FLASH_WINDOW_SHAPES))
def test_cuda_flash_window_softcap_equals_plain(shape, d, dtype):
    """Each window, with softcap 2.0 at the odd ones and 50 at the
    others: the kernel launches once, lies within the rule of the plain
    version, and a second launch gives the same bits."""
    b, sq, sk, h, hk, _, q_offset = FLASH_WINDOW_SHAPES[shape]
    spec = (b, sq, sk, h, hk, d, True, q_offset)
    q, k, v = (t.cuda() for t in _flash_inputs(spec, dtype, seed=d))
    for i, window in enumerate(FLASH_WINDOWS):
        kw = dict(q_offset=q_offset, window=window,
                  softcap=2.0 if i % 2 else 50.0)
        before = flash_attention.launches
        got = flash_attention(q, k, v, **kw)
        assert flash_attention.launches == before + 1
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        _flash_close(got, want)
        assert torch.equal(_bits(got), _bits(flash_attention(q, k, v, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [64, 1])
def test_cuda_flash_window_skips_tiles_below_it(sq, dtype):
    """Key tiles wholly below every row's window are neither loaded nor
    computed: with K and V there set to NaN the output is bitwise the
    clean input's (a key that was read, even masked, would carry the NaN
    into p . v). One 64-row query tile (the prefill design, both dtypes)
    at q_offset 1000 with a window of 100 sees keys from 901 on, in the
    key tile from 896; a decode step at 1000, keys from 901."""
    q_offset, window = 1000, 100
    spec = (2, sq, q_offset + sq, 4, 2, 64, True, q_offset)
    q, k, v = (t.cuda() for t in _flash_inputs(spec, dtype, seed=9))
    kw = dict(q_offset=q_offset, window=window, softcap=50.0)
    clean = flash_attention(q, k, v, **kw)
    first = 896 if sq > 16 else q_offset - window + 1
    k2, v2 = k.clone(), v.clone()
    k2[:, :first] = float("nan")
    v2[:, :first] = float("nan")
    got = flash_attention(q, k2, v2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(clean))
    _flash_close(clean, flash_attention_plain(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_ring_decode_equals_plain(dtype):
    """Decode over a 4096-slot ring (gemma2's local layers) at and after
    the wrap: B9 at q_offset = min(pos, 4095) without a window (every
    filled slot lies inside it), a 16-head query over 8 KV heads, D =
    128, softcap 50, within the rule, bitwise repeatable."""
    spec = (2, 1, 4096, 16, 8, 128, True, 0)
    q, k, v = (t.cuda() for t in _flash_inputs(spec, dtype, seed=4))
    for pos in (4000, 4095, 4096, 8160):
        kw = dict(q_offset=min(pos, 4095), softcap=50.0)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        _flash_close(got, want)
        assert torch.equal(_bits(got), _bits(flash_attention(q, k, v, **kw)))


@pytest.mark.cuda
def test_cuda_gemma2_smoke_greedy_decode_equals_cpu():
    """gemma2's smoke config with a window of 5 and a softcap of 2.0,
    fp32 compute: greedy_decode of 9 tokens past a 24-token prompt (the
    prefill design, then decode steps over the 5-slot rings, across
    their wraps) launches B9 once per layer per step and gives the CPU's
    tokens."""
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("gemma2-27b").replace(
        compute_dtype="float32", sliding_window=5, attn_softcap=2.0)
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device="cpu")
    batch = make_batch(cfg, ShapeSpec("s", 24, 3, "prefill"))
    want = greedy_decode(model, params, batch, 9)
    before = flash_attention.launches
    got = greedy_decode(model, pytree.tree_map(lambda t: t.cuda(), params),
                        batch, 9)
    assert flash_attention.launches - before == cfg.n_layers * 10
    assert got.is_cuda and torch.equal(got.cpu(), want)


# B9's gradient on the card against its plain version on the card:
# (B, S, H, HK, D) with S not a multiple of the 64-row tiles, MHA, GQA
# and MQA, every head dim it has (BWD_HEAD_DIMS: 16, 64, 96, 128). fp32: |kernel - plain| <= 1e-5 + 1e-4 |plain|
# (both sum in fp32 in other orders; read <= 3e-6 relative on an H100).
# bf16: <= 2^-7 |plain| + 1e-3 max|plain| (equal fp32 values up to
# their summation order, each rounded once to bf16; near-zero entries
# are the small differences of large terms).
# The bf16 design's tiles under stress (FLASH_BWD_OPTS): a non-causal
# call, Minitron-8B's GQA (32 heads over 8 KV heads, D = 128) at S = 257,
# MiniCPM-2B's 36 heads at D = 64; gemma2's softcap (50, and 2, which
# binds on logits of order 1) and sliding window (1: every row one key;
# 5: within a tile; 64: a tile's width, so whole tiles are skipped),
# alone and together, its 32:16 heads at D = 128 over 300 rows; and
# (FLASH_BWD_PEAKED) q scaled x8, so rows have peaked P and large
# cancelling dP - Dd: bf16 under the rule above; fp32 against a float64
# oracle (the fp32 rule's 1e-5 floor is for gradients of order 1, and at
# x8 dk reaches 30: ROADMAP C4).
FLASH_BWD_SPECS = {
    "mha": (2, 130, 4, 4, 64),
    "gqa": (1, 200, 8, 2, 96),
    "mqa": (2, 129, 4, 1, 128),
    "d16": (2, 37, 4, 2, 16),
    "one_tile": (1, 64, 2, 2, 64),
    "one_row": (1, 1, 2, 2, 96),
    "full": (2, 130, 4, 2, 64),
    "minitron_gqa": (1, 257, 32, 8, 128),
    "minicpm_heads": (1, 300, 36, 36, 64),
    "one_row_cap50_win5": (1, 1, 2, 2, 96),
    "cap50": (2, 129, 4, 1, 128),
    "cap2": (2, 130, 4, 4, 64),
    "win1": (2, 130, 4, 2, 64),
    "win5_cap2": (2, 130, 4, 2, 64),
    "win64_cap50": (1, 200, 8, 2, 96),
    "d16_win5_cap50": (2, 37, 4, 2, 16),
    "gemma2_heads": (1, 300, 32, 16, 128),
    "vlm_self_narrow": (2, 321, 16, 2, 128),
}
FLASH_BWD_PEAKED = (2, 200, 4, 2, 96)
FLASH_BWD_OPTS = {"full": {"causal": False},
                  "one_row_cap50_win5": {"softcap": 50.0, "window": 5},
                  "cap50": {"softcap": 50.0}, "cap2": {"softcap": 2.0},
                  "win1": {"window": 1},
                  "win5_cap2": {"window": 5, "softcap": 2.0},
                  "win64_cap50": {"window": 64, "softcap": 50.0},
                  "d16_win5_cap50": {"window": 5, "softcap": 50.0},
                  "gemma2_heads": {"window": 64, "softcap": 50.0,
                                   "scale": 144.0 ** -0.5}}


def _bwd_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        assert bool(((g - w).abs() <= 1e-5 + 1e-4 * w.abs()).all())
    else:
        tol = 2.0 ** -7 * w.abs() + 1e-3 * float(w.abs().max())
        assert bool(((g - w).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_BWD_SPECS))
def test_cuda_flash_backward_equals_plain(case, dtype):
    """The LSE forward equals the served forward bitwise and its LSE the
    plain one within 1e-5; dq, dk, dv within the rule above; two
    launches give the same bits; autograd through `flash_attention`
    launches the LSE forward and the backward once each."""
    _check_flash_backward(FLASH_BWD_SPECS[case], dtype,
                          **FLASH_BWD_OPTS.get(case, {}))


@pytest.mark.cuda
def test_cuda_flash_backward_peaked_bf16():
    """The same checks in bf16 with q scaled x8 (the LSE within 8e-5:
    its fp32 rounding scales with the logits)."""
    _check_flash_backward(FLASH_BWD_PEAKED, "bfloat16", q_mult=8.0)


# ROADMAP C5: shapes whose rows each see one key (causal, q_offset 0):
# one row, and a window of 1 over several tiles
ONE_KEY_ROWS = {"one_row": ((1, 1, 2, 2, 96), {}),
                "win1": ((2, 130, 4, 2, 64), {"window": 1})}


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ONE_KEY_ROWS))
def test_cuda_flash_backward_one_key_rows_exact(case, dtype, softcap):
    """Exact, over 6 seeds: where each row sees one key, dS is 0 in exact
    arithmetic, and the reference's autodiff gives dq = dk = 0 (its
    softmax VJP subtracts sum_k P dP, which is dP when P is 1). The
    kernels give exactly 0 too: their Dd sums dO . O in the order they
    sum dP, and O is that key's V bit for bit, so dP - Dd is 0. So does
    the plain version in bf16 (its float64 sums of bf16 products are
    exact); dv within the rule of `_bwd_close`."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_lse)
    (b, s, h, hk, d), kw = ONE_KEY_ROWS[case]
    kw = dict(kw, softcap=softcap)
    dt = getattr(torch, dtype)
    for seed in range(6):
        g = torch.Generator().manual_seed(seed)
        q, k, v, dout = (torch.randn(shape, generator=g).to(dt).cuda()
                         for shape in ((b, s, h, d), (b, s, hk, d),
                                       (b, s, hk, d), (b, s, h, d)))
        out, lse = flash_attention_lse(q, k, v, **kw)
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, **kw)
        pq, pk, pv = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                                    **kw)
        torch.cuda.synchronize()
        assert int(torch.count_nonzero(dq)) == 0, seed
        assert int(torch.count_nonzero(dk)) == 0, seed
        if dtype == "bfloat16":
            assert int(torch.count_nonzero(pq)) == 0
            assert int(torch.count_nonzero(pk)) == 0
        _bwd_close(dv, pv)
        assert float(dv.abs().max()) > 0


def _attention_f64(q, k, v):
    """Causal GQA attention in float64 torch ops: the oracle."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kk = k.repeat_interleave(g, dim=2)
    vv = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) * d ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(logits.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.cuda
def test_cuda_flash_backward_peaked_fp32():
    """fp32 with q scaled x8 (ROADMAP C4): the kernel's and the plain
    version's dq, dk and dv against a float64 oracle of the same
    function on the card (autograd of `_attention_f64` on the same
    inputs). An fp32 sum over hundreds of keys of gradients of order 30
    leaves errors of its own, so the yardstick is the plain version's:
    for each, max |kernel - oracle| <= 2 max |plain - oracle| + 1e-7 max
    |oracle|. Two launches give the same bits."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_lse)
    b, s, h, hk, d = FLASH_BWD_PEAKED
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(shape, generator=g).cuda() for shape in
               ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    q = q * 8.0
    dout = torch.randn((b, s, h, d), generator=g).cuda()
    out, lse = flash_attention_lse(q, k, v)
    got = flash_attention_backward(q, k, v, out, lse, dout)
    plain = flash_attention_backward_plain(q, k, v, out, lse, dout)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    oracle = torch.autograd.grad(_attention_f64(*leaves), leaves,
                                 dout.double())
    torch.cuda.synchronize()
    for name, x, y, z in zip(("dq", "dk", "dv"), got, plain, oracle):
        err = float((x.double() - z).abs().max())
        ref = float((y.double() - z).abs().max())
        top = float(z.abs().max())
        print(f"C4 {name}: max |kernel - oracle| {err:.3e}, max |plain - "
              f"oracle| {ref:.3e}, max |oracle| {top:.3e}")
        assert err <= 2 * ref + 1e-7 * top, (name, err, ref)
    again = flash_attention_backward(q, k, v, out, lse, dout)
    for x, y in zip(got, again):
        assert torch.equal(_bits(x), _bits(y))


def _check_flash_backward(spec, dtype, causal=True, q_mult=1.0, sk=0,
                          **kw):
    """`kw`: B9's window, softcap and scale; `sk` keys (Sq = Sk unless
    given)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_lse)
    b, s, h, hk, d = spec
    sk = sk or s
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(shape, generator=g).to(dt).cuda() for shape in
               ((b, s, h, d), (b, sk, hk, d), (b, sk, hk, d)))
    q = q * q_mult
    dout = torch.randn((b, s, h, d), generator=g).to(dt).cuda()
    kw = dict(causal=causal, **kw)
    out, lse = flash_attention_lse(q, k, v, **kw)
    assert torch.equal(_bits(out), _bits(flash_attention(q, k, v, **kw)))
    _, lse_plain = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert float((lse - lse_plain).abs().max()) <= 1e-5 * q_mult
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, lse, dout, **kw)
    assert flash_attention_backward.launches == before + 1
    want = flash_attention_backward_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        _bwd_close(x, y)
    again = flash_attention_backward(q, k, v, out, lse, dout, **kw)
    for x, y in zip(got, again):
        assert torch.equal(_bits(x), _bits(y))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention_backward.launches
    grads = torch.autograd.grad(flash_attention(*leaves, **kw), leaves,
                                dout)
    assert flash_attention.launches == f0 + 1
    assert flash_attention_backward.launches == b0 + 1
    for x, y in zip(grads, got):
        assert torch.equal(_bits(x), _bits(y))


# B9's gradient at the enc-dec and VLM shapes, non-causal over a ragged
# Sk: Whisper's encoder self-attention (Sq = Sk = 1500) and its
# cross-attention (Sq = 448, the decoder's context, over 1500 frames);
# the VLM's cross-attention over 1601 patches at H / HK = 8 (200
# queries), and narrow (16 heads over 2, D = 128) with ragged Sq and Sk
# (321 % 64 = 1, 777 % 64 = 9), as the VLM's training runs it at
# 4096 / 1601; rule as above
FLASH_BWD_CROSS = {"whisper_encoder": ((2, 1500, 6, 6, 64), 1500),
                   "whisper_cross": ((2, 448, 6, 6, 64), 1500),
                   "vlm_cross": ((1, 200, 64, 8, 128), 1601),
                   "vlm_cross_narrow": ((2, 321, 16, 2, 128), 777)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CROSS))
def test_cuda_flash_backward_cross_equals_plain(case, dtype):
    """The checks of `test_cuda_flash_backward_equals_plain`, non-causal
    with Sq != Sk (and Whisper's encoder, Sq = Sk = 1500)."""
    spec, sk = FLASH_BWD_CROSS[case]
    _check_flash_backward(spec, dtype, causal=False, sk=sk)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_cuda_encdec_vlm_smoke_greedy_decode_equals_cpu(arch):
    """The enc-dec and VLM smoke configs with fp32 compute (the VLM's
    gates set to 0.5 and -0.7, so its cross sub-layers count):
    greedy_decode on the card launches B9 on every attention call (the
    encoder's layers and each decoder layer's two, or each self and
    cross sub-layer, in the prompt; each decoder attention a step) and
    gives the CPU's tokens."""
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device="cpu")
    if cfg.family == "vlm":
        for j, sl in enumerate(model.layout):
            if sl.mixer == "cross":
                params["blocks"][f"sub{j}"]["gate_attn"].fill_(0.5)
                params["blocks"][f"sub{j}"]["gate_ffn"].fill_(-0.7)
        per_step = cfg.n_layers
        prompt = cfg.n_layers
    else:
        per_step = 2 * cfg.n_layers
        prompt = cfg.n_encoder_layers + 2 * cfg.n_layers
    batch = make_batch(cfg, ShapeSpec("s", 12, 3, "prefill"))
    want = greedy_decode(model, params, batch, 8)
    before = flash_attention.launches
    got = greedy_decode(model, pytree.tree_map(lambda t: t.cuda(), params),
                        batch, 8)
    assert flash_attention.launches - before == prompt + 8 * per_step
    assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_flash_backward_refuses_other_head_dims():
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_lse)
    q, k, v = (torch.randn((1, 40, 2, 32)).cuda() for _ in range(3))
    out, lse = flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="head dim 32"):
        flash_attention_backward(q, k, v, out, lse, torch.ones_like(out))


@pytest.mark.cuda
def test_cuda_train_step_smoke_matches_cpu_and_repeats():
    """Two train steps of the smoke model (fp32 compute, grad_accum 2)
    on the card: bitwise repeatable, and within 1e-3 of each leaf's
    largest magnitude of the same steps on the CPU (plain versions; the
    CPU against JAX reads 5.5e-5 after three such steps, and an entry
    whose gradient is near zero can take Adam's step of +-lr either
    way)."""
    from repro_torch import random as prng
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = smoke_config("minitron-8b").replace(compute_dtype="float32",
                                              n_kv_heads=2)
    toks = [np.random.default_rng(i).integers(0, cfg.vocab_size, (4, 32))
            for i in range(2)]
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        m = Model(cfg)
        state = init_train_state(m, prng.PRNGKey(0), device=device)
        step = make_train_step(m, total_steps=10)
        for t in toks:
            state, _ = step(state, {"tokens": t})
        runs.append([x.cpu() for x in pytree.leaves(state)])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= \
            1e-3 * max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
def test_cuda_gemma2_train_steps_smoke_match_cpu_and_repeat():
    """gemma2's smoke model with a window of 5 and a softcap of 2.0
    (fp32 compute, grad_accum 2, a sequence of 24 past the window): two
    train steps on the card repeat bitwise, launch B9's gradient once a
    layer a microbatch, and land within 1e-3 of each leaf's largest
    magnitude of the same steps on the CPU (plain versions), as the
    minitron test above."""
    from repro_torch import random as prng
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward)
    from repro_torch.models.model import Model
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = smoke_config("gemma2-27b").replace(
        compute_dtype="float32", sliding_window=5, attn_softcap=2.0)
    toks = [np.random.default_rng(i).integers(0, cfg.vocab_size, (4, 24))
            for i in range(2)]
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        m = Model(cfg)
        state = init_train_state(m, prng.PRNGKey(0), device=device)
        step = make_train_step(m, total_steps=10)
        before = flash_attention_backward.launches
        for t in toks:
            state, _ = step(state, {"tokens": t})
        if device == "cuda":
            assert flash_attention_backward.launches - before == \
                2 * cfg.grad_accum * cfg.n_layers
        runs.append([x.cpu() for x in pytree.leaves(state)])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= \
            1e-3 * max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_reads_cache_slices(dtype):
    """Strided reads: q a head slice of a wider projection, k and v one
    layer's slice of a [2, L, B, max_len, HK, D] cache, past the last
    written position; a decode step and a short prefill chunk."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    cache = torch.randn((2, 3, 2, 160, 2, 96), generator=g).to(dt).cuda()
    kc, vc = cache[0, 1], cache[1, 1]          # [B=2, 160, 2, 96] views
    wide = torch.randn((2, 9, 16, 96), generator=g).to(dt).cuda()
    assert not wide[:, :, :8].is_contiguous()
    for q, pos in ((wide[:, :1, :8], 120), (wide[:, :, 8:], 40)):
        got = flash_attention(q, kc, vc, q_offset=pos)
        want = flash_attention_plain(q.contiguous(), kc.contiguous(),
                                        vc.contiguous(), q_offset=pos)
        torch.cuda.synchronize()
        _flash_close(got, want)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses():
    q = torch.zeros((1, 4, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 4, 2, 68), device="cuda")[..., :64]
    with pytest.raises(ValueError, match="strides"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="several devices"):
        flash_attention(q.cpu(), q, q)


@pytest.mark.cuda
def test_cuda_smoke_model_greedy_decode_equals_cpu():
    """Phi-3-mini's smoke config (4 layers, head dim 16) with fp32
    compute: greedy_decode on the card launches B9 once per layer per
    step (and once per layer for the prompt) and gives the CPU's
    tokens."""
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("phi3-mini-3.8b").replace(compute_dtype="float32")
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device="cpu")
    batch = make_batch(cfg, ShapeSpec("s", 24, 3, "prefill"))
    want = greedy_decode(model, params, batch, 8)
    before = flash_attention.launches
    got = greedy_decode(model, pytree.tree_map(lambda t: t.cuda(), params),
                        batch, 8)
    assert flash_attention.launches - before == cfg.n_layers * 9
    assert got.is_cuda and torch.equal(got.cpu(), want)


# ------------------------------------------------------ whole-model ---

from repro_torch import random as prng  # noqa: E402
from repro_torch.core.resolve import reference_apply  # noqa: E402
from repro_torch.kernels.quantile import median_axis0, median_flat  # noqa

WHOLE = ("star", "svd_knot_tying", "adarank", "evolutionary_merge",
         "genetic_merge")
# card against CPU, relative to the output's magnitude: cuSOLVER's gesvd
# against LAPACK (fp32 reconstruction errors ~1e-5 relative on the H100)
WHOLE_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cuda_split_and_normal_equal_cpu(dtype):
    for seed in range(8):
        key = prng.fold_in(prng.PRNGKey(seed), 3)
        assert prng.split(key, 3) == tuple(prng.split(key, 3))
        got = prng.normal(key, (16, 4), dtype, device="cuda")
        want = prng.normal(key, (16, 4), dtype, device="cpu")
        assert got.is_cuda and torch.equal(got.cpu(), want)
        u = prng.uniform(key, (3, 1001), dtype, device="cuda",
                         minval=-0.7, maxval=2.5)
        assert torch.equal(u.cpu(), prng.uniform(
            key, (3, 1001), dtype, device="cpu", minval=-0.7, maxval=2.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_cuda_median_equals_cpu(dtype, k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((k, 5000))
    a[:, :100] = np.round(a[:, :100])
    a[rng.random((k, 5000)) < 0.1] = -0.0
    a[0, 7] = np.nan
    x = torch.tensor(a, dtype=dtype)
    got, want = median_axis0(x.cuda()).cpu(), median_axis0(x)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()].view(torch.uint8),
                       want[~want.isnan()].view(torch.uint8))
    row = x[-1].abs()                 # k = 1: the row with the NaN
    got, want = median_flat(row.cuda()).cpu(), median_flat(row)
    assert torch.equal(got.reshape(1).view(torch.uint8),
                       want.reshape(1).view(torch.uint8))


def _whole_inputs(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape)
    cs = [base + 0.1 * rng.standard_normal(shape) for _ in range(4)]
    return [torch.tensor(c, dtype=dtype) for c in cs], \
        torch.tensor(base, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(37,), (96, 80), (6, 40, 33)], ids=str)
@pytest.mark.parametrize("name", WHOLE)
def test_cuda_whole_model_strategies_near_cpu(name, shape, dtype):
    cs, base = _whole_inputs(dtype, shape, seed=len(shape))
    want = reference_apply(name, cs, base=base, seed=5)
    got = reference_apply(name, [c.cuda() for c in cs], base=base.cuda(),
                          seed=5)
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= WHOLE_TOL[dtype] * scale
    again = reference_apply(name, [c.cuda() for c in cs], base=base.cuda(),
                            seed=5)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))


# ------------------------------------------------------ wire, journal ---

from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.core.hashing import pytree_digest  # noqa: E402
from repro_torch.core.resolve import canonical_order  # noqa: E402
from repro_torch.core.resolve import seed_from_root  # noqa: E402
from repro_torch.core.state import CRDTMergeState  # noqa: E402
from repro_torch.net import wire  # noqa: E402


def _wire_tree(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"f32": torch.randn(3, 5, generator=g),
            "bf16": torch.randn(4, 4, generator=g).bfloat16(),
            "f16": torch.randn(2, 3, 2, generator=g).half(),
            "i8": torch.randint(-127, 128, (7,), generator=g,
                                dtype=torch.int8),
            "i32": torch.randint(-9, 9, (2, 2), generator=g,
                                 dtype=torch.int32),
            "b": torch.randn(5, generator=g) > 0,
            "s": [torch.tensor(2.5), 3, "x", None]}


def _same_tree(a, b) -> None:
    if isinstance(a, compression.CompressedTree):
        a, b = (compression.compressed_tree_to_structure(x) for x in (a, b))
    la, lb = pytree.leaves(a), pytree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, compression.CompressedLeaf):
            assert (x.shape, x.dtype) == (y.shape, y.dtype)
            x, y = (x.q, x.scale), (y.q, y.scale)
        else:
            x, y = (x,), (y,)
        for u, v in zip(x, y):
            if not isinstance(u, torch.Tensor):
                assert u == v
                continue
            assert u.dtype == v.dtype and u.shape == v.shape
            assert torch.equal(u.cpu().reshape(-1).view(torch.uint8),
                               v.cpu().reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_cuda_decode_blob_equals_cpu_decode():
    tree = _wire_tree(0)
    ct = compression.compress_tree({k: tree[k] for k in ("f32", "bf16",
                                                        "f16")})
    for value in (tree, ct):
        blob = wire.encode_blob(value)
        on_cpu = wire.decode_blob(blob, device="cpu")
        on_gpu = wire.decode_blob(blob, device="cuda")
        _same_tree(on_cpu, on_gpu)
        leaves = pytree.leaves(compression.compressed_tree_to_structure(
            on_gpu) if value is ct else on_gpu)
        assert all(x.q.is_cuda and x.scale.is_cuda
                   if isinstance(x, compression.CompressedLeaf)
                   else x.is_cuda for x in leaves
                   if isinstance(x, (torch.Tensor,
                                     compression.CompressedLeaf)))
        assert wire.encode_blob(on_gpu) == blob


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [False, True])
def test_cuda_msg_to_state_equals_cpu(keep):
    ct = compression.compress_tree({"a": torch.randn(64, 33),
                                    "b": [torch.randn(9).bfloat16()]})
    eid = pytree_digest(compression.decompress_tree(ct)).hex()
    s = CRDTMergeState().add(ct, "n", element_id=eid)
    frame = wire.encode_message(wire.state_to_msg(s, "n"))
    got = wire.msg_to_state(wire.decode_message(frame, device="cuda"),
                            keep_quantized=keep, device="cuda")
    want = wire.msg_to_state(wire.decode_message(frame, device="cpu"),
                             keep_quantized=keep, device="cpu")
    assert got.merkle_root() == want.merkle_root() == s.merkle_root()
    assert isinstance(got.store[eid], compression.CompressedTree) == keep
    _same_tree(got.store[eid], want.store[eid])


def _phi3_int8(layers: int, k: int):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    cfg = get_config("phi3-mini-3.8b").replace(n_layers=layers)
    schema = Model(cfg).schema()
    base = init_from_schema(schema, seed=0, device="cuda",
                            dtype=torch.bfloat16)
    cts = []
    for j in range(k):
        delta = init_from_schema(schema, seed=1 + j, device="cuda",
                                 dtype=torch.bfloat16)
        cts.append(compression.compress_tree(pytree.tree_map(
            lambda b, d: b + d * 0.1, base, delta)))
        del delta
    return cts


@pytest.mark.cuda
def test_cuda_durable_replica_resolves_like_memory(tmp_path):
    """Four int8 Phi-3-mini contributions (full width, 2 layers) through
    `Replica(path=)`, closed and reopened on the card: the recovered
    root, visible set and payload bytes equal the in-memory replica's,
    and weight_average with the kernels (B2 on the int8 payloads)
    gives the same bytes."""
    cts = _phi3_int8(2, 4)
    eids = [pytree_digest(compression.decompress_tree(ct)).hex()
            for ct in cts]
    mem = Replica("mem", device="cuda")
    d = str(tmp_path / "rep")
    with Replica("disk", path=d, device="cuda") as rep:
        for ct, e in zip(cts, eids):
            mem.contribute(ct, element_id=e)
            rep.contribute(ct, element_id=e)
    back = Replica("disk", path=d, device="cuda")
    assert back.merkle_root() == mem.merkle_root()
    assert back.visible() == mem.visible() == set(eids)
    for e in eids:
        _same_tree(back.state.store[e], mem.state.store[e])
        assert all(leaf.q.is_cuda for leaf in back.state.store[e].leaves)
    order = canonical_order(mem.state)
    seed = seed_from_root(mem.merkle_root())

    def weight_average(rep):
        return engine.merge([rep.state.store[e] for e in order],
                            spec=MergeSpec("weight_average"),
                            contrib_ids=order, seed=seed, kernels=True,
                            use_cache=False, cache=rep.cache)

    before = quant.quant_nary.launches
    want = weight_average(mem)
    got = weight_average(back)
    assert quant.quant_nary.launches - before >= 2
    _same_tree(got, want)
    back.close()


@pytest.mark.cuda
def test_cuda_c3_int8_payloads_move_to_the_card():
    g = torch.Generator().manual_seed(5)
    cts = [compression.compress_tree({"a": torch.randn(40, 24, generator=g),
                                      "b": torch.randn(24, generator=g)})
           for _ in range(3)]
    eids = [pytree_digest(compression.decompress_tree(ct)).hex()
            for ct in cts]
    gpu, cpu = Replica("g", device="cuda"), Replica("c", device="cpu")
    for ct, e in zip(cts, eids):
        gpu.contribute(ct, element_id=e)
        cpu.contribute(ct, element_id=e)
    assert all(leaf.q.is_cuda and leaf.scale.is_cuda
               for e in eids for leaf in gpu.state.store[e].leaves)
    assert gpu.merkle_root() == cpu.merkle_root()
    with pytest.raises(TypeError, match="element_id"):
        gpu.contribute(cts[0])
    spec = MergeSpec("weight_average")
    _same_tree(gpu.resolve(spec, use_cache=False),
               cpu.resolve(spec, use_cache=False))


# ------------------------------------------------------------------ sync


def _sync_pair(device, transport_cls, *, compress=False, keep=False,
               frame=None):
    from repro_torch.net import pump, SyncNode
    g = torch.Generator().manual_seed(11)
    kw = {} if frame is None else {"max_frame_bytes": frame}
    a = SyncNode("a", device=device, compress_blobs=compress, **kw)
    b = SyncNode("b", device=device, keep_quantized=keep, **kw)
    for _ in range(3):
        a.contribute({"w": torch.randn(300, 40, generator=g),
                      "u": torch.randn(20, 30, generator=g),
                      "v": [torch.randn(40, generator=g).bfloat16(),
                            torch.randn(33, 8, generator=g)]})
    t = transport_cls(device=device)
    try:
        for n in (a, b):
            t.register(n.node_id)
        t.send("b", "a", b.begin_sync("a"))
        pump({"a": a, "b": b}, t, max_steps=20_000)
    finally:
        t.close()
    return a, b


@pytest.mark.cuda
def test_cuda_sync_session_lands_payloads_on_the_card():
    from repro_torch.net import PersistentLoopbackTransport
    ga, gb = _sync_pair("cuda", PersistentLoopbackTransport, frame=4096)
    ca, cb = _sync_pair("cpu", PersistentLoopbackTransport, frame=4096)
    assert ga.root() == gb.root() == ca.root() == cb.root()
    assert set(gb.state.store) == set(cb.state.store) == set(ga.state.store)
    for e in cb.state.store:
        _same_tree(gb.state.store[e], cb.state.store[e])
        assert all(x.is_cuda for x in pytree.leaves(gb.state.store[e]))
    assert dict(gb.stats) == dict(cb.stats)
    assert gb.stats["blobs_assembled"] > 0       # the chunk path ran


@pytest.mark.cuda
def test_cuda_keep_quantized_merges_on_arrival_through_b2():
    from repro_torch.net import InMemoryTransport
    _, gb = _sync_pair("cuda", InMemoryTransport, compress=True, keep=True)
    _, cb = _sync_pair("cpu", InMemoryTransport, compress=True, keep=True)
    order = canonical_order(gb.state)
    for e in order:
        ct = gb.state.store[e]
        assert isinstance(ct, compression.CompressedTree)
        assert all(leaf.q.is_cuda and leaf.scale.is_cuda
                   for leaf in ct.leaves)
    seed = seed_from_root(gb.root())

    def merge(node):
        return engine.merge([node.state.store[e] for e in order],
                            spec=MergeSpec("weight_average"),
                            contrib_ids=order, seed=seed, kernels=True,
                            use_cache=False, cache=engine.EngineCache())

    before = quant.quant_nary.launches
    got = merge(gb)
    assert quant.quant_nary.launches > before
    _same_tree(got, merge(cb))


@pytest.mark.cuda
def test_cuda_sim_epidemic_equals_cpu():
    from repro_torch.net import LinkSpec, SimGossipNetwork, wire

    def run(device):
        g = SimGossipNetwork(8, seed=4, mode="antientropy", device=device,
                             max_frame_bytes=4096,
                             link=LinkSpec(loss=0.1, duplicate=0.1,
                                           reorder=0.2, jitter=0.002))
        log = []
        for k, h in list(g.net.handlers.items()):
            def traced(n, dst, src, msg, h=h):
                log.append((n.clock, src, dst, wire.encode_message(msg)))
                return h(n, dst, src, msg)
            g.net.handlers[k] = traced
        gen = torch.Generator().manual_seed(4)
        pl = [{"w": torch.randn(40, 40, generator=gen)} for _ in range(8)]
        g.contribute_all(lambda i: pl[i])
        rounds = g.run_epidemic(fanout=3, max_rounds=40, require_blobs=True)
        assert g.converged(require_blobs=True)
        assert all(x.state.store[e]["w"].device.type == device
                   for x in g.nodes for e in x.state.store)
        return rounds, g.roots(), log, g.bytes_sent

    assert run("cuda") == run("cpu")


# ---------------------------------------------------------------- MoE


def _moe_case(dtype, cf=0.5):
    import dataclasses
    from repro_torch.configs import smoke_config
    cfg = smoke_config("qwen3-moe-30b-a3b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 40, 64), generator=g)
    p = {"router": 0.5 * torch.randn((64, 4), generator=g),
         "experts": {k: 0.1 * torch.randn(s, generator=g) for k, s in (
             ("w_gate", (4, 64, 64)), ("w_up", (4, 64, 64)),
             ("w_down", (4, 64, 64)))}}
    return cfg, x.to(dtype), p


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_block_repeats_and_equals_cpu(impl, dtype):
    """Qwen3-MoE's smoke block with drops (capacity factor 0.5) on the
    card: two calls give the same bytes; the dispatch integers equal
    the CPU's exactly; the output equals the CPU's within 1e-5 in fp32
    and two bf16 ulps of the largest magnitude in bf16 (the two
    devices' matmuls sum in other orders)."""
    from repro_torch.models import moe as M
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, x, p = _moe_case(dtype)
    fn = M.moe_gather if impl == "gather" else M.moe_einsum
    pc = pytree.tree_map(lambda t: t.cuda(), p)
    y1, a1 = fn(pc, x.cuda(), cfg, dtype)
    y2, a2 = fn(pc, x.cuda(), cfg, dtype)
    assert torch.equal(_bits(y1), _bits(y2)) and torch.equal(a1, a2)
    yc, ac = fn(p, x, cfg, dtype)
    err = float((y1.cpu().float() - yc.float()).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5
    else:
        assert err <= 2 * 2.0 ** -7 * float(yc.float().abs().max())
    assert abs(float(a1) - float(ac)) <= 1e-6
    _, idx, _ = M._router(p, x, cfg.moe)
    c = M._capacity(cfg.moe, x.shape[1])
    want = M._dispatch(idx, cfg.moe.num_experts, c)
    got = M._dispatch(idx.cuda(), cfg.moe.num_experts, c)
    assert int((~want[1]).sum()) > 0          # tokens dropped
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8, torch.float16])
def test_cuda_tensor_digest_equals_cpu(dtype):
    """Bitwise: `tensor_digest` of a CUDA tensor (its slices copied
    through the page-locked staging buffers) equals the digest of the
    same tensor on the CPU, for leaves of 0 and 1 elements, one just
    past a staging slice, a strided view, and 16 leaves on the hashing
    threads at once (`tensor_digests`, each thread its own buffer)."""
    from repro_torch.core import hashing
    g = torch.Generator().manual_seed(4)
    slice_elems = hashing._SLICE_BYTES // torch.empty((), dtype=dtype) \
        .element_size()
    leaves = [(torch.randn((n,), generator=g) * 50).to(dtype)
              for n in (0, 1, slice_elems + 3, 1000)]
    leaves.append((torch.randn((64, 301), generator=g) * 50).to(dtype)
                  [:, ::2])
    for t in leaves:
        assert hashing.tensor_digest(t.cuda()) == hashing.tensor_digest(t)
    many = [(torch.randn((1 << 22,), generator=g) * 50).to(dtype)
            for _ in range(16)]
    assert hashing.tensor_digests([t.cuda() for t in many]) == \
        [hashing.tensor_digest(t) for t in many]


@pytest.mark.cuda
def test_cuda_qwen3_train_step_smoke_deterministic_and_matches_cpu():
    """Qwen3-MoE's smoke model with drops (capacity factor 0.5), the
    router at 50x its init (top-2 gaps far wider than the two devices'
    differences), fp32 compute, remat, grad_accum 2: `Model.loss` and
    its gradients on the card under the train step's deterministic mode
    (the gather dispatch's backward is an accumulating index-put) equal
    the CPU's within the CPU tests' limits against JAX
    (tests/test_torch_moe.py: ce within 1e-6 relative, aux within 1e-6,
    each leaf's gradient within 2e-5 of its largest magnitude); two
    train steps on the card give the same bits twice, and land within
    1e-3 of each leaf's largest magnitude of the CPU's, as the minitron
    and gemma2 tests above."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.step import (_deterministic, init_train_state,
                                        make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("qwen3-moe-30b-a3b").replace(
        compute_dtype="float32", remat="full", grad_accum=2)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device="cpu")
    params["blocks"]["sub0"]["ffn"]["router"].mul_(50.0)
    toks = [np.random.default_rng(i).integers(0, cfg.vocab_size, (4, 32))
            for i in range(2)]
    grads = []
    for device in ("cuda", "cpu"):
        p = pytree.tree_map(
            lambda t: t.to(device, copy=True).requires_grad_(), params)
        with _deterministic(torch.device(device)):
            loss, mets = model.loss(p, {"tokens": toks[0]})
            loss.backward()
        grads.append(([float(loss.detach()), float(mets["ce"].detach()),
                       float(mets["aux"].detach())],
                      [t.grad.cpu() for t in pytree.leaves(p)]))
    (lc, gc), (lh, gh) = grads
    assert abs(lc[0] - lh[0]) <= 1e-6 * abs(lh[0])
    assert abs(lc[1] - lh[1]) <= 1e-6 * abs(lh[1])
    assert abs(lc[2] - lh[2]) <= 1e-6 and lh[2] > 0.5
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max()) <= \
            2e-5 * max(float(b.abs().max()), 1e-30)
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        state = init_train_state(model, params=pytree.tree_map(
            lambda t: t.to(device, copy=True), params), device=device)
        step = make_train_step(model, total_steps=10)
        for t in toks:
            state, _ = step(state, {"tokens": t})
        runs.append([x.cpu() for x in pytree.leaves(state)])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= \
            1e-3 * max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
def test_cuda_qwen3_smoke_greedy_decode_equals_cpu():
    """Qwen3-MoE's smoke config, fp32 compute: greedy_decode of 8 tokens
    past a 24-token prompt on the card launches B9 once per layer per
    step and gives the CPU's tokens."""
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("qwen3-moe-30b-a3b").replace(compute_dtype="float32")
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device="cpu")
    params["blocks"]["sub0"]["ffn"]["router"].mul_(50.0)
    batch = make_batch(cfg, ShapeSpec("s", 24, 3, "prefill"))
    want = greedy_decode(model, params, batch, 8)
    before = flash_attention.launches
    got = greedy_decode(model, pytree.tree_map(lambda t: t.cuda(), params),
                        batch, 8)
    assert flash_attention.launches - before == cfg.n_layers * 9
    assert got.is_cuda and torch.equal(got.cpu(), want)


def _smoke_train_case(arch):
    """(config, CPU params, batch): the VLM's smoke model with its gates
    at 0.5 / -0.7 and 12 patches a row, or DeepSeek-V2's with
    `q_lora_rank` 24, the router at 50x and the latent-attention
    projections at 10x; fp32 compute, remat, grad_accum 2; 4 rows of 64
    tokens (two of DeepSeek's query chunks), two batches."""
    import dataclasses
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    cfg = smoke_config(arch).replace(compute_dtype="float32", remat="full",
                                     grad_accum=2)
    if cfg.mla is not None:
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, q_lora_rank=24))
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device="cpu")
    if cfg.family == "vlm":
        for j, sl in enumerate(model.layout):
            if sl.mixer == "cross":
                params["blocks"][f"sub{j}"]["gate_attn"].fill_(0.5)
                params["blocks"][f"sub{j}"]["gate_ffn"].fill_(-0.7)
    else:
        params["blocks"]["sub0"]["ffn"]["router"].mul_(50.0)
        for attn in (params["first"]["attn"],
                     params["blocks"]["sub0"]["attn"]):
            for w in ("w_q", "w_dq", "w_dkv", "w_uk"):
                attn[w].mul_(10.0)
    return cfg, params, [make_batch(cfg, ShapeSpec("s", 64, 4, "train"),
                                    step=i) for i in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "deepseek-v2-236b"])
def test_cuda_vlm_mla_train_steps_smoke_match_cpu(arch, param_dtype):
    """The VLM's and DeepSeek-V2's smoke train steps (`_smoke_train_case`)
    with fp32 parameters or the dry run's `parambf16` (bf16 parameters,
    gradients and moments; learning rate 5e-3 from the first step, as
    the chip smoke's bf16 runs): two steps on the card repeat bitwise,
    launch B9's gradient once an attention sub-layer a microbatch (the
    VLM's; DeepSeek's MLA launches none), and land near the CPU's: each
    parameter within `near` (fp32 parameters: 1e-3 of its leaf's largest
    magnitude, as the minitron test above; bf16: one bf16 ulp, 2^-8 of
    its magnitude) of the CPU's, but at most 1e-3 of them, which may
    differ by up to 2.5 times the two steps' learning rates plus twice
    `near` (Adam's step is about +-lr by the gradient's sign, so an
    element whose gradient is near zero can move the other way); the
    bf16 moments within 2^-6 of each leaf's largest magnitude (two bf16
    ulps)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward)
    from repro_torch.launch.dryrun import apply_variant
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import lr_schedule
    from repro_torch.train.step import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, batches = _smoke_train_case(arch)
    if param_dtype == "bfloat16":
        cfg = apply_variant(cfg, "parambf16").replace(
            learning_rate=5e-3, warmup_steps=1)
    model = Model(cfg)
    attn = model.n_periods * sum(sl.mixer in ("attn", "cross")
                                 for sl in model.layout)
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        state = init_train_state(model, params=pytree.tree_map(
            lambda t: t.to(device, copy=True), params), device=device)
        step = make_train_step(model, total_steps=10)
        before = flash_attention_backward.launches
        for b in batches:
            state, _ = step(state, b)
        if device == "cuda":
            assert flash_attention_backward.launches - before == \
                2 * cfg.grad_accum * attn
        runs.append({part: [x.cpu().float() for x in
                            pytree.leaves(state[part])]
                     for part in ("params", "m", "v")})
    for part in runs[0]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0][part],
                                                      runs[1][part]))
    for part in ("m", "v"):
        for a, b in zip(runs[0][part], runs[2][part]):
            assert float((a - b).abs().max()) <= \
                2.0 ** -6 * max(float(b.abs().max()), 1e-30)
    lrs = sum(float(lr_schedule(i, cfg, 10)) for i in range(2))
    beyond = total = 0
    for a, b in zip(runs[0]["params"], runs[2]["params"]):
        d = (a - b).abs()
        near = (1e-3 * max(float(b.abs().max()), 1e-30)
                if param_dtype == "float32" else 2.0 ** -8 * b.abs())
        assert bool((d <= 2.5 * lrs + 2 * near).all())
        beyond += int((d > near).sum())
        total += d.numel()
    assert beyond <= 1e-3 * total


@pytest.mark.cuda
def test_cuda_mla_smoke_equals_cpu():
    """DeepSeek-V2's smoke config with `q_lora_rank` 24, fp32 compute,
    the router at 50x its init and the latent-attention projections at
    10x (so neither routing nor attention is flat): the prefill's
    logits and latent caches on the card within 2e-5 of the CPU's, a
    greedy decode of 8 tokens past a 64-token prompt (two query chunks)
    the CPU's tokens with no B9 launch (MLA runs on plain products, as
    the reference's einsums), the same decode in bf16 byte-identical on
    two calls, and `Model.loss` with its gradients under the train
    step's deterministic mode within the CPU tests' limits of the CPU's
    (tests/test_torch_mla.py: 1e-6 relative, each leaf's gradient within
    2e-5 of its largest magnitude)."""
    import dataclasses
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    from repro_torch.train.step import _deterministic
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("deepseek-v2-236b").replace(compute_dtype="float32")
    cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, q_lora_rank=24))
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device="cpu")
    params["blocks"]["sub0"]["ffn"]["router"].mul_(50.0)
    for attn in (params["first"]["attn"], params["blocks"]["sub0"]["attn"]):
        for w in ("w_q", "w_dq", "w_dkv", "w_uk"):
            attn[w].mul_(10.0)
    batch = make_batch(cfg, ShapeSpec("s", 64, 3, "prefill"))
    cuda = pytree.tree_map(lambda t: t.cuda(), params)
    want_l, want_c = model.prefill(params, batch, max_len=72)
    got_l, got_c = model.prefill(cuda, batch, max_len=72)
    assert float((got_l.cpu() - want_l).abs().max()) <= 2e-5
    for a, b in zip(pytree.leaves(got_c), pytree.leaves(want_c)):
        assert float((a.cpu() - b).abs().max()) <= 2e-5
    want = greedy_decode(model, params, batch, 8)
    before = flash_attention.launches
    got = greedy_decode(model, cuda, batch, 8)
    assert flash_attention.launches == before
    assert got.is_cuda and torch.equal(got.cpu(), want)
    b16 = Model(cfg.replace(compute_dtype="bfloat16"))
    wb = pytree.tree_map(lambda t: t.to(torch.bfloat16), cuda)
    runs = [greedy_decode(b16, wb, batch, 8, return_logits=True)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64))
    out = []
    for device in ("cuda", "cpu"):
        p = pytree.tree_map(
            lambda t: t.to(device, copy=True).requires_grad_(), params)
        with _deterministic(torch.device(device)):
            loss, mets = model.loss(p, {"tokens": toks})
            loss.backward()
        out.append((float(loss.detach()), float(mets["aux"].detach()),
                    [t.grad.cpu() for t in pytree.leaves(p)]))
    (lc, ac, gc), (lh, ah, gh) = out
    assert abs(lc - lh) <= 1e-6 * abs(lh) and abs(ac - ah) <= 1e-6
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max()) <= \
            2e-5 * max(float(b.abs().max()), 1e-30)
