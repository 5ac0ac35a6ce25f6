"""The whole first slice of the port at `smoke_config("phi3-mini-3.8b")`
widths, against the JAX reference, plus the port's boundaries.

Four bf16 contributions (base + small delta), contributed in three
orders, resolved through the exact path (`Replica.resolve`) and through
the kernel routes (`engine.merge(kernels=True)`, the plain versions on
the CPU), against the reference's `Replica.resolve` and
`engine.merge(pallas=True)`. Exact path: bitwise. Kernel routes:
bitwise except task_arithmetic, which XLA computes with an FMA in the
Pallas tile: within one bf16 ulp.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.api import Replica as JReplica  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.kernels.config import kernel_env as jkernel_env  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.resolve import canonical_order  # noqa: E402
from repro_torch.core.resolve import seed_from_root  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.schema import schema_leaves  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STRATEGIES = {
    "weight_average": ({}, False),
    "linear": ({"t": 0.3}, False),
    "task_arithmetic": ({"lam": 0.8}, True),
    "negative_merge": ({"lam": 0.5}, True),
    "ties": ({"trim": 0.2}, True),
    "ties_hist": ({"trim": 0.2, "trim_method": "histogram"}, True),
}
ORDERS = ([0, 1, 2, 3], [2, 0, 3, 1], [3, 2, 1, 0])


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jkernel_env.reset()
    jeng.clear_cache()
    jeng.reset_exec_stats()
    engine.clear_cache()


def _models():
    """Numpy bf16 base + 4 contributions in the Phi-3-mini smoke layout
    (checked to be the reference's layout too)."""
    from repro.configs import smoke_config as jsmoke
    from repro.models.model import Model as JModel
    cfg = smoke_config("phi3-mini-3.8b")
    leaves = schema_leaves(Model(cfg).schema())
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        JModel(jsmoke("phi3-mini-3.8b")).schema(),
        is_leaf=lambda x: hasattr(x, "init"))
    assert [(p, d.shape) for p, d in leaves] == \
        [(jax.tree_util.keystr(p), d.shape) for p, d in jflat]
    rng = np.random.default_rng(11)

    def tree(fn):
        out = {}
        for path, pdef in leaves:
            node = out
            keys = [k.strip("'") for k in path[1:-1].split("][")]
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = fn(pdef.shape)
        return out

    base = tree(lambda s: (rng.standard_normal(s) * 0.02).astype(
        ml_dtypes.bfloat16))
    contribs = [jax.tree_util.tree_map(
        lambda b: (b.astype(np.float32) + 0.002 * rng.standard_normal(
            b.shape)).astype(ml_dtypes.bfloat16), base) for _ in range(4)]
    return base, contribs


def _np_leaves(tree):
    return [np.asarray(a) for a in pytree.leaves(convert.to_numpy_tree(tree))]


def _assert_close(got, want, bitwise):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if bitwise:
            assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
        else:
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32),
                                       rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("key", sorted(STRATEGIES))
def test_slice_matches_reference(key):
    cfgd, uses_base = STRATEGIES[key]
    name = "ties" if key.startswith("ties") else key
    base, contribs = _models()
    jrep = JReplica("ref")
    for c in contribs:
        jrep.contribute(jax.tree_util.tree_map(jnp.asarray, c))
    jref = jrep.register_base(jax.tree_util.tree_map(jnp.asarray, base))
    jspec = JSpec(name, cfgd, base_ref=jref if uses_base else None)
    want_exact = jax.tree_util.tree_leaves(jrep.resolve(jspec))
    jorder = sorted(jrep.visible())
    want_kern = jax.tree_util.tree_leaves(jeng.merge(
        [jrep.state.store[i] for i in jorder], spec=jspec,
        base=jrep._bases[jref] if uses_base else None,
        seed=int.from_bytes(jrep.merkle_root()[:8], "big")
        & 0x7FFFFFFFFFFFFFFF, pallas=True, use_cache=False))
    for order in ORDERS:
        rep = Replica("port", device="cpu")
        for i in order:
            rep.contribute(convert.from_numpy_tree(contribs[i], "cpu"))
        ref = rep.register_base(convert.from_numpy_tree(base, "cpu"))
        assert rep.merkle_root() == jrep.merkle_root() and ref == jref
        spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
        _assert_close(_np_leaves(rep.resolve(spec)), want_exact, True)
        ids = canonical_order(rep.state)
        kern = engine.merge([rep.state.store[i] for i in ids], spec=spec,
                            contrib_ids=ids,
                            base=rep._bases[ref] if uses_base else None,
                            seed=seed_from_root(rep.merkle_root()),
                            kernels=True, use_cache=False, cache=rep.cache)
        _assert_close(_np_leaves(kern), want_kern,
                      key != "task_arithmetic")
        kind = "ties_hist" if key == "ties_hist" else "nary_accum"
        if key != "ties":
            assert rep.cache.obs.counter("kernel_dispatch_total").value(
                kernel=kind) > 0


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    rel = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files
           if "repro_torch" in f.parts}
    # slice 3's, slice 7's, slice 8's, slice 11's and slice 12's modules
    # are among the files checked
    assert {"kernels/ties.py", "kernels/slerp.py", "kernels/ops.py",
            "kernels/quantile.py", "strategies/catalog.py",
            "core/engine.py", "core/trust.py", "core/properties.py",
            "core/resolve.py", "random.py", "core/delta.py",
            "core/dotted_vv.py", "core/gossip.py", "core/hashing.py",
            "obs/probes.py", "obs/metrics.py", "net/antientropy.py",
            "net/transport.py", "net/store.py", "net/simulator.py",
            "optim/adamw.py", "train/step.py", "train/btm.py",
            "checkpoint/ckpt.py", "launch/train.py", "launch/merge.py",
            "configs/minicpm_2b.py", "configs/minitron_8b.py"} <= rel
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{f.relative_to(ROOT)} imports {mod}"


def test_gpu_tests_import_neither_jax_nor_the_reference():
    """`tests/test_torch_cuda.py` runs on the GPU machine, which has no
    JAX (and so no ml_dtypes)."""
    for mod in _imports(ROOT / "tests" / "test_torch_cuda.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro",
                                         "ml_dtypes"), mod


def test_replica_without_device_needs_cuda():
    if torch.cuda.is_available():
        assert Replica().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Replica()


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
