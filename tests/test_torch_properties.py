"""The port's algebraic audit (`repro_torch.core.properties`), paper
Tables 3 and 4, on the CPU.

- The test tensors are the reference's, bitwise (numpy, seed 42).
- Phase 1 (raw, tolerance 1e-5 as in the reference): the port's (C, A,
  I) pattern equals `TABLE3_EXPECTED` for each of the 26 strategies,
  and `TABLE3_EXPECTED` is the reference's table.
- Phase 2 (through `CRDTMergeState`, bitwise): commutativity,
  associativity, idempotency and 3-replica convergence hold for every
  strategy, 104 of 104, and on the tier-2 production slices at 128^2
  and 512^2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import properties as jprops  # noqa: E402
from repro_torch.core import properties as props  # noqa: E402
from repro_torch.strategies import list_strategies  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tensors():
    return props.controlled_tensors(device="cpu")


def test_tensors_are_the_references():
    with jax.enable_x64(True):
        want = jprops.controlled_tensors(dtype=jnp.float64)
        for a, b in zip(props.controlled_tensors(device="cpu"), want):
            assert a.dtype == torch.float64
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    jb, jouts = jprops.production_slices(None, slice_dim=32)
    tb, touts = props.production_slices(None, slice_dim=32, device="cpu")
    for a, b in zip([tb] + touts, [jb] + jouts):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_table3_is_the_references():
    assert props.TABLE3_EXPECTED == jprops.TABLE3_EXPECTED
    assert sorted(props.TABLE3_EXPECTED) == list_strategies()


@pytest.mark.parametrize("name", sorted(props.TABLE3_EXPECTED))
def test_raw_pattern_matches_table3(name, tensors):
    r = props.audit_raw(name, tensors)
    assert (r.commutative, r.associative, r.idempotent) == \
        props.TABLE3_EXPECTED[name]


@pytest.mark.parametrize("name", sorted(props.TABLE3_EXPECTED))
def test_wrapped_is_crdt(name, tensors):
    r = props.audit_wrapped(name, tensors)
    assert (r.commutative, r.associative, r.idempotent, r.convergent) == \
        (True, True, True, True)


def test_wrapped_104_of_104(tensors):
    res = props.audit_all_wrapped(tensors)
    assert len(res) == 26
    assert sum(r.commutative + r.associative + r.idempotent + r.convergent
               for r in res.values()) == 104


def test_raw_26_of_26(tensors):
    res = props.audit_all_raw(tensors)
    assert {n: (r.commutative, r.associative, r.idempotent)
            for n, r in res.items()} == props.TABLE3_EXPECTED
    assert sum(r.crdt for r in res.values()) == 0


@pytest.mark.parametrize("dim", [128, 512])
def test_tier2_production_slices_wrapped(dim):
    base, outs = props.production_slices(None, slice_dim=dim, device="cpu")
    res = props.audit_all_wrapped(outs, base)
    assert [n for n, r in res.items() if not r.crdt] == []
