"""The merge engine's kernel routes on integer leaves, against the JAX
reference.

Under `kernels=True` (the reference's `pallas=True`) every multi-leaf
group of the linear family takes the n-ary accumulate kernel, integer
groups included: the rows widen to fp32 and the fp32 result is cast
back into the leaf dtype, truncating toward zero. With k = 4 the
weight 0.25 and every partial sum are exact in fp32, so truncation
cannot flip between the two packages, and the comparison is bitwise.
The batch cap is raised so both int32 leaves share one group (the
default cap, one leaf's stack, would split them and hide the route);
single-leaf groups take the exact path in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.kernels.config import kernel_env as jkernel_env  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.core import engine  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jkernel_env.reset()
    jeng.clear_cache()
    jeng.reset_exec_stats()
    engine.clear_cache()


def _int_contribs(seed, k=4):
    rng = np.random.default_rng(seed)
    return [{"a": rng.integers(-1000, 1000, 64, dtype=np.int32),
             "b": rng.integers(-1000, 1000, 64, dtype=np.int32)}
            for _ in range(k)]


@pytest.mark.parametrize("cap", [1 << 20, None])
def test_integer_group_matches_reference_bitwise(cap):
    cs = _int_contribs(0)
    want = jeng.merge([jax.tree_util.tree_map(jnp.asarray, c) for c in cs],
                      "weight_average", pallas=True, use_cache=False,
                      max_batch_bytes=cap)
    cache = engine.EngineCache()
    got = engine.merge([convert.from_numpy_tree(c, "cpu") for c in cs],
                       "weight_average", kernels=True, use_cache=False,
                       max_batch_bytes=cap, cache=cache)
    routed = cache.obs.counter("kernel_dispatch_total").value(
        kernel="nary_accum")
    assert routed == (1 if cap else 0)
    for g, w in zip(pytree.leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        # the kernel route casts back into int32; the exact path keeps
        # the fp32 mean, in both packages
        assert g.numpy().dtype == w.dtype == (np.int32 if cap
                                              else np.float32)
        assert g.numpy().tobytes() == w.tobytes()


def test_integer_group_truncates_toward_zero():
    """Means of -1.75 and 1.75 truncate to -1 and 1 (not floor)."""
    rows = [np.array([-1, 1] * 32, np.int32), np.array([-2, 2] * 32,
                                                       np.int32),
            np.array([-2, 2] * 32, np.int32), np.array([-2, 2] * 32,
                                                       np.int32)]
    cs = [{"a": r, "b": r.copy()} for r in rows]
    got = engine.merge([convert.from_numpy_tree(c, "cpu") for c in cs],
                       "weight_average", kernels=True, use_cache=False,
                       max_batch_bytes=1 << 20)
    assert got["a"].dtype == torch.int32
    assert got["a"][:2].tolist() == [-1, 1]
