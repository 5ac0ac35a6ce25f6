"""The port's kernel knobs (`repro_torch.kernels.config.KernelEnv`)
against the reference's (`repro.kernels.config.KernelEnv`), on the CPU:
both seed themselves from REPRO_KERNEL_BLOCK, REPRO_KERNEL_HIST_BINS and
REPRO_KERNEL_DARE_RNG with the same parsing and raise the same
`ValueError`s; a histogram-TIES merge at a non-default block and bin
count gives the reference's bytes; on CUDA the 8-column rule of B3-B5
names the variable. All exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.api import Replica as JReplica  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.kernels.config import KernelEnv as JKernelEnv  # noqa: E402
from repro.kernels.config import kernel_env as jkernel_env  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.resolve import canonical_order  # noqa: E402
from repro_torch.core.resolve import seed_from_root  # noqa: E402
from repro_torch.kernels import histogram  # noqa: E402
from repro_torch.kernels.config import KernelEnv, block_name  # noqa: E402
from repro_torch.kernels.config import kernel_env  # noqa: E402

torch.set_num_threads(1)

VARS = ("REPRO_KERNEL_BLOCK", "REPRO_KERNEL_HIST_BINS",
        "REPRO_KERNEL_DARE_RNG")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in VARS + ("REPRO_KERNEL_INTERPRET", "REPRO_KERNEL_QUANTIZED"):
        monkeypatch.delenv(name, raising=False)
    yield
    monkeypatch.undo()
    kernel_env.reset()
    jkernel_env.reset()
    jeng.clear_cache()
    engine.clear_cache()


def _knobs(env) -> tuple:
    return env.block, env.hist_bins, env.dare_kernel_rng


@pytest.mark.parametrize("values", [
    {},
    {"REPRO_KERNEL_BLOCK": "1024", "REPRO_KERNEL_HIST_BINS": "256",
     "REPRO_KERNEL_DARE_RNG": "1"},
    {"REPRO_KERNEL_BLOCK": " 4104", "REPRO_KERNEL_DARE_RNG": " Yes "},
    {"REPRO_KERNEL_HIST_BINS": "2", "REPRO_KERNEL_DARE_RNG": "off"},
    {"REPRO_KERNEL_DARE_RNG": "TRUE"}])
def test_both_packages_read_the_same_values(monkeypatch, values):
    """With the variables set (or unset: 2048, 512, off), `reset()` and
    a new `KernelEnv()` read the same block, bins and DARE switch in
    both packages; the port's constructor keywords override them."""
    for name, raw in values.items():
        monkeypatch.setenv(name, raw)
    kernel_env.reset()
    jkernel_env.reset()
    want = _knobs(jkernel_env)
    assert _knobs(kernel_env) == want == _knobs(JKernelEnv())
    assert _knobs(KernelEnv()) == want
    if not values:
        assert want == (2048, 512, False)
    assert _knobs(KernelEnv(block=64, hist_bins=100,
                            dare_kernel_rng=True)) == (64, 100, True)
    assert _knobs(KernelEnv(hist_bins=30))[::2] == want[::2]


@pytest.mark.parametrize("name,raw", [
    ("REPRO_KERNEL_BLOCK", "0"), ("REPRO_KERNEL_BLOCK", "-8"),
    ("REPRO_KERNEL_BLOCK", "2k"), ("REPRO_KERNEL_HIST_BINS", "1"),
    ("REPRO_KERNEL_HIST_BINS", "5.0"), ("REPRO_KERNEL_DARE_RNG", "maybe"),
    ("REPRO_KERNEL_DARE_RNG", "")])
def test_bad_values_raise_as_the_reference(monkeypatch, name, raw):
    """A value the reference refuses raises `ValueError` in the port
    too, with the reference's message."""
    monkeypatch.setenv(name, raw)
    with pytest.raises(ValueError) as want:
        JKernelEnv()
    with pytest.raises(ValueError) as got:
        KernelEnv()
    assert str(got.value) == str(want.value)


def _models():
    """Numpy bf16 base + 3 contributions of mixed leaf lengths (none a
    multiple of 1024, one of 5000 elements)."""
    rng = np.random.default_rng(4)
    shapes = {"a": (50, 100), "b": (3001,), "c": (7, 11, 13)}

    def tree(scale):
        return {k: (rng.standard_normal(s) * scale).astype(
            ml_dtypes.bfloat16) for k, s in shapes.items()}

    base = tree(0.02)
    contribs = [jax.tree_util.tree_map(
        lambda b: (b.astype(np.float32) + 0.002 * rng.standard_normal(
            b.shape)).astype(ml_dtypes.bfloat16), base) for _ in range(3)]
    return base, contribs


def _ties_hist(base, contribs):
    """The histogram-TIES kernel route of each package over the same
    contributions and base: (the reference's leaves, the port's)."""
    cfg = {"trim": 0.2, "trim_method": "histogram"}
    jrep = JReplica("ref")
    for c in contribs:
        jrep.contribute(jax.tree_util.tree_map(jnp.asarray, c))
    jref = jrep.register_base(jax.tree_util.tree_map(jnp.asarray, base))
    jspec = JSpec("ties", cfg, base_ref=jref)
    want = jeng.merge(
        [jrep.state.store[i] for i in sorted(jrep.visible())], spec=jspec,
        base=jrep._bases[jref],
        seed=int.from_bytes(jrep.merkle_root()[:8], "big")
        & 0x7FFFFFFFFFFFFFFF, pallas=True, use_cache=False)
    rep = Replica("port", device="cpu")
    for c in contribs:
        rep.contribute(convert.from_numpy_tree(c, "cpu"))
    ref = rep.register_base(convert.from_numpy_tree(base, "cpu"))
    ids = canonical_order(rep.state)
    got = engine.merge([rep.state.store[i] for i in ids],
                       spec=MergeSpec("ties", cfg, base_ref=ref),
                       contrib_ids=ids, base=rep._bases[ref],
                       seed=seed_from_root(rep.merkle_root()), kernels=True,
                       use_cache=False, cache=rep.cache)
    return ([np.asarray(a) for a in jax.tree_util.tree_leaves(want)],
            [np.asarray(a) for a in
             pytree.leaves(convert.to_numpy_tree(got))])


def test_hist_ties_at_an_environment_block_gives_the_reference_bytes(
        monkeypatch):
    """Bitwise: with REPRO_KERNEL_BLOCK=1024 and
    REPRO_KERNEL_HIST_BINS=256 in both packages, histogram TIES through
    the kernel routes (the port's plain versions, the reference's Pallas
    kernels in interpret mode) gives the reference's bytes, and those
    bytes differ from the default block's (the knobs reach the merge)."""
    base, contribs = _models()
    default = _ties_hist(base, contribs)[0]
    monkeypatch.setenv("REPRO_KERNEL_BLOCK", "1024")
    monkeypatch.setenv("REPRO_KERNEL_HIST_BINS", "256")
    kernel_env.reset()
    jkernel_env.reset()
    want, got = _ties_hist(base, contribs)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
    assert any(not np.array_equal(a.view(np.uint16), b.view(np.uint16))
               for a, b in zip(default, want))


def test_cuda_block_rule_names_the_variable(monkeypatch):
    """B3-B5's 8-column rule, which binds on CUDA tensors: its error
    names REPRO_KERNEL_BLOCK when the block is the one the environment
    set, and the argument otherwise (checked without a card: the check
    runs before any launch)."""
    monkeypatch.setenv("REPRO_KERNEL_BLOCK", "1500")
    kernel_env.reset()
    assert block_name(1500) == "REPRO_KERNEL_BLOCK=1500"
    assert block_name(1504) == "block=1504"
    t = torch.zeros(16)
    with pytest.raises(ValueError, match="REPRO_KERNEL_BLOCK=1500: .*"
                       "multiple of 8"):
        histogram._check_vectors(1500, t)
    with pytest.raises(ValueError, match="block=12: .*multiple of 8"):
        histogram._check_vectors(12, t)
    monkeypatch.delenv("REPRO_KERNEL_BLOCK")
    assert block_name(1500) == "block=1500"
