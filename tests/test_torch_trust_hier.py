"""Trust-gated and hierarchical resolve of the PyTorch port against the
JAX reference.

Bitwise: trust scores, the gated id set, its Merkle root and seed (host
arithmetic on the same evidence and eids); the gated and hierarchical
resolves against the port's own whole-tree definition (`reference_apply`
over the gated canonical order with the gated seed; groups resolved,
then merged with seed + 1).

The equivalence grid of `tests/test_api.py` (plain, gated and
hierarchical, all 26 strategies x {fold, tree}) against the reference's
`Replica.resolve`, fp32 8x8 contributions: within `TOL` of the output's
magnitude, or bitwise for the strategies in `BITWISE` (their op order is
pinned in both packages).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.api import Replica as JReplica  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.merkle import merkle_root as jmerkle  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro.core.trust import TrustState as JTrust  # noqa: E402
from repro.core.trust import gated_visible as jgated  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.merkle import merkle_root  # noqa: E402
from repro_torch.core.resolve import (  # noqa: E402
    canonical_order, hierarchical_resolve, reference_apply, resolve_spec,
    seed_from_root)
from repro_torch.core.state import CRDTMergeState  # noqa: E402
from repro_torch.core.trust import TrustState, gated_visible  # noqa: E402
from repro_torch.strategies import list_strategies  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-5
# linear-family folds: the same fp32 left fold in both packages
BITWISE = ("weight_average", "linear", "task_arithmetic", "negative_merge")
KINDS = ("equivocation", "divergent_root", "fingerprint_anomaly",
         "statistical_outlier", "other")


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    jeng.clear_cache()
    engine.clear_cache()


def _contribs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((8, 8)).astype(np.float32)
            for _ in range(n)]


def _states(cs):
    s, j = CRDTMergeState(), JState()
    for i, c in enumerate(cs):
        s = s.add(torch.from_numpy(c.copy()), node=f"n{i}")
        j = j.add(jnp.asarray(c), node=f"n{i}")
    assert s.visible() == j.visible()
    return s, j


def _close(name, got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if name in BITWISE:
        assert got.tobytes() == want.tobytes(), name
        return
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * scale, (name, err)


# ------------------------------------------------------------- trust ---


def test_trust_scores_and_gate_match_reference():
    cs = _contribs(6, seed=1)
    s, j = _states(cs)
    ids = sorted(s.visible())
    rng = np.random.default_rng(2)
    t, jt = TrustState(), JTrust()
    for _ in range(12):
        eid = ids[rng.integers(len(ids))]
        kind = KINDS[rng.integers(len(KINDS))]
        rep, sev = f"r{rng.integers(3)}", float(rng.uniform(0.1, 1.0))
        t, jt = t.report(eid, kind, rep, sev), jt.report(eid, kind, rep, sev)
    for eid in ids:
        assert t.score(eid) == jt.score(eid)
    for thr in (0.0, 0.3, 0.5, 0.75, 1.0):
        assert gated_visible(s, t, thr) == jgated(j, jt, thr)
    # evidence is a grow-only CRDT: merge is commutative and idempotent
    a = TrustState().report(ids[0], "equivocation", "x")
    b = TrustState().report(ids[1], "divergent_root", "y")
    assert a.merge(b) == b.merge(a) == a.merge(b).merge(a)


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.9])
def test_gated_ids_root_and_seed_bitwise(thr):
    cs = _contribs(5, seed=3)
    s, j = _states(cs)
    ids = sorted(s.visible())
    t = TrustState().report(ids[1], "divergent_root", "n0") \
        .report(ids[3], "statistical_outlier", "n2", 2.0)
    jt = JTrust().report(ids[1], "divergent_root", "n0") \
        .report(ids[3], "statistical_outlier", "n2", 2.0)
    gated = sorted(gated_visible(s, t, thr))
    assert gated == sorted(jgated(j, jt, thr))
    root = merkle_root([bytes.fromhex(i) for i in gated])
    assert root == jmerkle([bytes.fromhex(i) for i in gated])
    seed = seed_from_root(root)
    # the gated resolve is the whole-tree definition over the gated set
    for name in ("ties", "dare", "genetic_merge", "evolutionary_merge"):
        got = resolve_spec(s, MergeSpec(name, trust_threshold=thr),
                           trust=t, use_cache=False)
        want = reference_apply(name, [s.store[i] for i in gated], seed=seed)
        assert torch.equal(got, want), name


def test_everything_gated_out_raises():
    cs = _contribs(2, seed=4)
    s, _ = _states(cs)
    t = TrustState()
    for eid in s.visible():
        t = t.report(eid, "equivocation", "n0")
    with pytest.raises(ValueError, match="gated out"):
        resolve_spec(s, MergeSpec("weight_average", trust_threshold=0.5),
                     trust=t)


def test_replica_reports_and_merges_evidence():
    a, b = Replica("a", device="cpu"), Replica("b", device="cpu")
    ids = [a.contribute(torch.from_numpy(c)) for c in _contribs(4, seed=5)]
    b.merge(a)
    b.report(ids[0], "equivocation")
    assert a.trust is None
    a.merge(b)                                   # evidence joins too
    assert a.trust == b.trust
    spec = MergeSpec("ties", trust_threshold=0.5)
    assert torch.equal(a.resolve(spec), b.resolve(spec))
    plain = a.resolve(MergeSpec("ties"))
    assert not torch.equal(plain, a.resolve(spec))


# ------------------------------------------------------ hierarchical ---


@pytest.mark.parametrize("group", [1, 2, 3, 9])
def test_hierarchical_is_groups_then_seed_plus_one(group):
    cs = _contribs(7, seed=6)
    s, _ = _states(cs)
    ids = canonical_order(s)
    seed = seed_from_root(s.merkle_root())
    # (slerp would meet a one-contribution group here, which it refuses
    # in both packages)
    for name in ("weight_average", "linear", "dare", "star",
                 "evolutionary_merge"):
        got = resolve_spec(s, MergeSpec(name, group_size=group),
                           use_cache=False)
        firsts = [reference_apply(name, [s.store[i]
                                         for i in ids[g:g + group]],
                                  seed=seed)
                  for g in range(0, len(ids), group)]
        want = reference_apply(name, firsts, seed=seed + 1)
        assert torch.equal(got, want), (name, group)
    states = [CRDTMergeState().add(torch.from_numpy(c), node=f"n{i}")
              for i, c in enumerate(cs)]
    assert torch.equal(
        hierarchical_resolve(states, MergeSpec("ties"), group_size=group),
        resolve_spec(s, MergeSpec("ties", group_size=group)))


# ------------------------------------------- the reference's grid ---


@pytest.mark.parametrize("reduction", ["fold", "tree"])
def test_equivalence_grid_all_strategies(reduction):
    cs = _contribs(4, seed=33)
    s, j = _states(cs)
    rep, jrep = Replica("grid", state=s, device="cpu"), \
        JReplica("grid", state=j)
    for name in list_strategies():
        got = rep.resolve(MergeSpec(name, reduction=reduction),
                          use_cache=False)
        want = jrep.resolve(JSpec(name, reduction=reduction),
                            use_cache=False)
        _close(name, got, want)


@pytest.mark.parametrize("reduction", ["fold", "tree"])
def test_equivalence_grid_trust_gated(reduction):
    cs = _contribs(5, seed=34)
    s, j = _states(cs)
    bad = sorted(s.visible())[1]
    rep = Replica("gated", state=s, device="cpu",
                  trust=TrustState().report(bad, "equivocation", "n0"))
    jrep = JReplica("gated", state=j,
                    trust=JTrust().report(bad, "equivocation", "n0"))
    for name in list_strategies():
        got = rep.resolve(MergeSpec(name, reduction=reduction,
                                    trust_threshold=0.5), use_cache=False)
        want = jrep.resolve(JSpec(name, reduction=reduction,
                                  trust_threshold=0.5), use_cache=False)
        _close(name, got, want)
    assert bad in s.visible()          # gating never mutates the state


@pytest.mark.parametrize("reduction", ["fold", "tree"])
def test_equivalence_grid_hierarchical(reduction):
    cs = _contribs(9, seed=35)
    s, j = _states(cs)
    rep, jrep = Replica("hier", state=s, device="cpu"), \
        JReplica("hier", state=j)
    for name in list_strategies():
        got = rep.resolve(MergeSpec(name, reduction=reduction,
                                    group_size=3), use_cache=False)
        want = jrep.resolve(JSpec(name, reduction=reduction, group_size=3),
                            use_cache=False)
        _close(name, got, want)


def test_hierarchical_resolve_wants_a_spec():
    """The reference's deprecated string form: a strategy name with its
    cfg and `group_size` warns `DeprecationWarning` once and gives the
    MergeSpec form's bytes; no state at all is a `ValueError`."""
    s, _ = _states(_contribs(5, seed=7))
    with pytest.warns(DeprecationWarning,
                      match="hierarchical_resolve") as rec:
        got = hierarchical_resolve([s], "ties", group_size=2, trim=0.3)
    assert len(rec) == 1
    want = hierarchical_resolve([s], MergeSpec("ties", {"trim": 0.3}),
                                group_size=2)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    with pytest.raises(ValueError, match=">= 1 state"):
        hierarchical_resolve([], MergeSpec("ties"))
