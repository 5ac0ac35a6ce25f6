"""The in-process gossip network of the PyTorch port against the JAX
reference: the scenarios of tests/test_gossip.py and
tests/test_dotted_vv_gc.py (the paper's Tier 3) on both packages.

Bitwise: Merkle roots after every round, `run_epidemic`'s round count,
`bytes_sent` and the `gossip_*` counters against the reference's
network under the same seed (both draw `random.Random(seed)` the same
way); merged outputs across the port's nodes (byte-identical), and
against the reference's for the linear family. Other strategies'
outputs within `TOL` of the reference's magnitude (the rule of
tests/test_torch_trust_hier.py). `ConvergenceProbe` gauges, histogram
and episodes equal the reference's over the same root sequence.

The consortium scenario of `chip_smoke.py`'s `[gossip]` phase (eight
nodes, delta gossip, a sparse attention update per node and two dense
fine-tunes, partition, heal) runs here at two layers of Phi-3-mini's
leaf paths on small stand-in tensors named by fixed eids: roots after
each round equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.core.gossip import GossipNetwork as JNet  # noqa: E402
from repro.core.trust import TrustState as JTrust  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs.probes import ConvergenceProbe as JProbe  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.gossip import GossipNetwork  # noqa: E402
from repro_torch.core.resolve import reference_apply  # noqa: E402
from repro_torch.core.trust import TrustState  # noqa: E402
from repro_torch.obs import ConvergenceProbe, MetricsRegistry  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-5
BITWISE = ("weight_average", "linear", "task_arithmetic", "negative_merge")
COUNTERS = ("gossip_sends_total", "gossip_payloads_shipped_total")


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    from repro.core import engine as jeng
    jeng.clear_cache()
    engine.clear_cache()


def _nets(n, seed=0, shape=(8, 8), use_deltas=False, scale=1.0):
    """Port and reference networks seeded alike, one contribution a
    node from the same numpy draws."""
    net = GossipNetwork(n, seed=seed, use_deltas=use_deltas, device="cpu")
    jnet = JNet(n, seed=seed, use_deltas=use_deltas)
    rng = np.random.default_rng(seed)
    for node, jnode in zip(net.nodes, jnet.nodes):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        node.contribute(torch.from_numpy(a))
        jnode.contribute(jnp.asarray(a))
    return net, jnet


def _same_roots(net, jnet):
    assert net.roots() == jnet.roots()
    assert net.converged() == jnet.converged()


def _same_counters(net, jnet):
    assert net.bytes_sent == jnet.bytes_sent
    for name in COUNTERS:
        assert net.obs.counter(name).value() == \
            jnet.obs.counter(name).value(), name
    for proto in ("all_pairs", "epidemic"):
        assert net.obs.counter("gossip_rounds_total").value(
            protocol=proto) == jnet.obs.counter(
            "gossip_rounds_total").value(protocol=proto)


def _identical(outs):
    first = outs[0].numpy().tobytes()
    return all(o.numpy().tobytes() == first for o in outs[1:])


def _close(name, got, want):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, name
    if name in BITWISE:
        assert g.tobytes() == w.tobytes(), name
        return
    err = float(np.max(np.abs(g.astype(np.float64) - w)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(w)))), (name, err)


@pytest.mark.parametrize("ordering_seed", [1, 2, 3, 4, 5])
def test_allpairs_convergence_any_ordering(ordering_seed):
    net, jnet = _nets(8, seed=ordering_seed)
    net.all_pairs_round()
    jnet.all_pairs_round()
    _same_roots(net, jnet)
    _same_counters(net, jnet)
    assert net.converged()
    outs = net.resolve_all("weight_average")
    assert _identical(outs)
    _close("weight_average", outs[0],
           jnet.resolve_all("weight_average")[0])


@pytest.mark.parametrize("name", ["ties", "dare", "slerp", "emr",
                                  "genetic_merge"])
def test_resolve_identical_across_strategies(name):
    net, jnet = _nets(6, seed=11)
    net.all_pairs_round()
    jnet.all_pairs_round()
    _same_roots(net, jnet)
    outs = net.resolve_all(name, use_cache=False)
    assert _identical(outs), name
    _close(name, outs[0], jnet.nodes[0].resolve(JSpec(name),
                                                use_cache=False))


def test_partition_then_heal():
    net, jnet = _nets(10, seed=4)
    for x in (net, jnet):
        x.partition([range(0, 5), range(5, 10)])
        x.all_pairs_round()
    _same_roots(net, jnet)
    assert net.converged() and net.roots()[0] != net.roots()[9]
    assert len(set(net.roots())) == 2
    for x in (net, jnet):
        x.heal()
        x.all_pairs_round()
    _same_roots(net, jnet)
    _same_counters(net, jnet)
    assert net.converged() and len(set(net.roots())) == 1


def test_duplicated_and_stale_delivery():
    net, jnet = _nets(4, seed=5)
    for _ in range(3):
        net.all_pairs_round()
        jnet.all_pairs_round()
    net.nodes[3].receive_state(net.nodes[0].state)
    jnet.nodes[3].receive_state(jnet.nodes[0].state)
    _same_roots(net, jnet)
    assert net.converged()
    assert net.nodes[3].merge_calls == jnet.nodes[3].merge_calls


@pytest.mark.parametrize("n,fanout", [(25, 3), (30, 3), (12, 2)])
def test_epidemic_rounds_and_counters(n, fanout):
    net, jnet = _nets(n, seed=6, use_deltas=(n == 30))
    rounds = net.run_epidemic(fanout=fanout)
    assert rounds == jnet.run_epidemic(fanout=fanout)
    assert net.converged() and rounds <= 10
    _same_roots(net, jnet)
    _same_counters(net, jnet)


def test_delta_gossip_equals_full_state_gossip():
    order = [(i, j) for i in range(9) for j in range(9) if i != j]
    full, jfull = _nets(9, seed=7)
    delt, jdelt = _nets(9, seed=7, use_deltas=True)
    for x in (full, jfull, delt, jdelt):
        x.all_pairs_round(order=order)
    _same_roots(full, jfull)
    _same_roots(delt, jdelt)
    _same_counters(delt, jdelt)
    assert delt.bytes_sent > 0 and full.bytes_sent == 0
    assert full.roots()[0] == delt.roots()[0]
    a = full.nodes[0].resolve(MergeSpec("ties"))
    b = delt.nodes[0].resolve(MergeSpec("ties"))
    assert torch.equal(a, b)


def test_delta_gossip_shares_payloads_across_stores():
    net, _ = _nets(5, seed=8, use_deltas=True)
    net.all_pairs_round()
    for eid, p in net.nodes[0].state.store.items():
        assert all(n.state.store[eid] is p for n in net.nodes[1:])


def test_delta_gossip_converges_bitwise():
    """The reference's compression scenario (its flag acts on transport
    frames only, so in-process delivery ships the payloads either way)."""
    net, jnet = _nets(5, seed=8, use_deltas=True, scale=3.0)
    jnet.compress_payloads = True
    net.all_pairs_round()
    jnet.all_pairs_round()
    _same_roots(net, jnet)
    _same_counters(net, jnet)
    outs = net.resolve_all("weight_average")
    assert _identical(outs)
    _close("weight_average", outs[0],
           jnet.resolve_all("weight_average")[0])


def test_trust_gating_converges_and_filters():
    net, jnet = _nets(5, seed=9, shape=(4, 4))
    net.all_pairs_round()
    jnet.all_pairs_round()
    bad = sorted(net.nodes[0].state.visible())[2]
    t = TrustState().report(bad, "equivocation", "n0").merge(
        TrustState().report(bad, "divergent_root", "n1"))
    jt = JTrust().report(bad, "equivocation", "n0").merge(
        JTrust().report(bad, "divergent_root", "n1"))
    spec = MergeSpec("weight_average", trust_threshold=0.5)
    outs = net.resolve_all(spec, trust=t)
    assert _identical(outs)
    _close("weight_average", outs[0], jnet.resolve_all(
        JSpec("weight_average", trust_threshold=0.5), trust=jt)[0])
    plain = net.nodes[0].resolve(MergeSpec("weight_average"))
    assert not torch.equal(plain, outs[0])


def test_string_resolve_warns_like_the_reference():
    net, jnet = _nets(3, seed=10)
    net.all_pairs_round()
    jnet.all_pairs_round()
    with pytest.warns(DeprecationWarning):
        got = net.nodes[1].resolve("ties", trim=0.3)
    with pytest.warns(DeprecationWarning):
        want = jnet.nodes[1].resolve("ties", trim=0.3)
    assert torch.equal(got, net.nodes[1].resolve(
        MergeSpec("ties", {"trim": 0.3})))
    _close("ties", got, want)


# ------------------------------------------------------ tombstone GC ---


def _nets_with_removal(n=6):
    net, jnet = _nets(n, seed=0, shape=(4, 4))
    for x in (net, jnet):
        x.all_pairs_round()
        victim = sorted(x.nodes[0].state.visible())[0]
        x.nodes[0].retract(victim)
        x.all_pairs_round()
    return net, jnet, victim


def test_gc_prunes_stable_tombstones_preserving_convergence():
    net, jnet, victim = _nets_with_removal()
    before = len(net.nodes[0].state.adds)
    root = net.nodes[0].root()
    assert net.stable_tombstones() == jnet.stable_tombstones()
    assert net.gc_round() == jnet.gc_round() >= 1
    assert len(net.nodes[0].state.adds) < before
    assert all(len(n.state.removes) == 0 for n in net.nodes)
    _same_roots(net, jnet)
    assert net.converged() and net.nodes[0].root() == root
    assert victim not in net.nodes[0].state.visible()
    merged = net.nodes[0].state.merge(net.nodes[1].state)
    assert merged.visible() == net.nodes[0].state.visible()


def test_gc_defers_until_all_nodes_observed():
    net, jnet = _nets(4, seed=1, shape=(4, 4))
    for x in (net, jnet):
        x.all_pairs_round()
        x.nodes[0].retract(sorted(x.nodes[0].state.visible())[0])
        assert x.gc_round() == 0
        assert len(x.nodes[0].state.removes) > 0
        x.all_pairs_round()
    assert net.gc_round() == jnet.gc_round() > 0
    _same_roots(net, jnet)


def test_gc_then_resolve_identical_across_nodes():
    net, jnet, _ = _nets_with_removal()
    net.gc_round()
    jnet.gc_round()
    outs = net.resolve_all("ties", use_cache=False)
    assert _identical(outs)
    _close("ties", outs[0], jnet.resolve_all("ties", use_cache=False)[0])


# ----------------------------------------------------------- A6 paths ---


def test_transport_placement_and_wire_wait_for_a6():
    with pytest.raises(NotImplementedError, match="A6"):
        GossipNetwork(2, transport=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        GossipNetwork(2, placement=object(), device="cpu")
    net = GossipNetwork(2, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        net.nodes[0].receive_wire(object())


def test_network_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        assert GossipNetwork(1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GossipNetwork(1)


# ------------------------------------------------------------ probe ---


def test_convergence_probe_matches_reference():
    net, jnet = _nets(10, seed=3)
    reg, jreg = MetricsRegistry(), JRegistry()
    clk, jclk = iter(range(1000)), iter(range(1000))
    probe = ConvergenceProbe(registry=reg, clock=clk.__next__)
    jprobe = JProbe(registry=jreg, clock=jclk.__next__)

    def observe():
        roots = {n.node_id: n.root().hex() for n in net.nodes}
        assert probe.observe(roots) == jprobe.observe(roots)
        assert reg.gauge("probe_root_divergence").value() == \
            jreg.gauge("probe_root_divergence").value()
        for node in roots:
            assert reg.gauge("probe_replica_diverged").value(node=node) \
                == jreg.gauge("probe_replica_diverged").value(node=node)

    observe()
    net.partition([range(0, 3), range(3, 7), range(7, 10)])
    net.all_pairs_round()
    observe()
    assert reg.gauge("probe_root_divergence").value() == 2.0
    net.heal()
    net.epidemic_round(fanout=2)
    observe()
    net.all_pairs_round()
    observe()
    assert probe.episodes == jprobe.episodes and len(probe.episodes) == 1
    h, jh = (r.histogram("probe_convergence_seconds") for r in (reg, jreg))
    assert (h.count(), h.sum()) == (jh.count(), jh.sum())
    assert not probe.diverged


# ------------------------------------------------------ consortium ---


def _consortium_standins():
    """Phi-3-mini's attention paths at two layers with small stand-in
    tensors: a dense tree (attention, MLP, embedding) and one sparse
    attention update per node, each under a fixed eid."""
    rng = np.random.default_rng(0)
    attn = ("wq", "wk", "wv", "wo")

    def dense():
        return {"blocks": {"sub0": {
            "attn": {w: rng.standard_normal((2, 3, 3)).astype(np.float32)
                     for w in attn},
            "mlp": {"w_up": rng.standard_normal((2, 3, 4)).astype(
                np.float32)}}},
            "embed": rng.standard_normal((5, 3)).astype(np.float32)}

    def sparse():
        return {"blocks": {"sub0": {"attn": {
            w: rng.standard_normal((2, 3, 3)).astype(np.float32)
            for w in attn}}}}

    paths = [f"['blocks']['sub0']['attn']['{w}']" for w in attn]
    dense_trees = [dense() for _ in range(2)]
    sparse_trees = [sparse() for _ in range(8)]
    eid = lambda tag: f"{tag:02x}" * 32  # noqa: E731
    return dense_trees, sparse_trees, paths, eid, dense()


def test_consortium_partition_heal_roots_match_reference():
    dense, sparse, paths, eid, base = _consortium_standins()
    net = GossipNetwork(8, seed=0, use_deltas=True, device="cpu")
    jnet = JNet(8, seed=0, use_deltas=True)
    for i in range(8):
        net.nodes[i].contribute(convert.from_numpy_tree(sparse[i], "cpu"),
                                eid(0x10 + i), leaves=paths)
        jnet.nodes[i].state = jnet.nodes[i].state.add(
            jax.tree_util.tree_map(jnp.asarray, sparse[i]),
            jnet.nodes[i].node_id, element_id=eid(0x10 + i),
            leaf_paths=paths)
    for i in range(2):
        net.nodes[i].contribute(convert.from_numpy_tree(dense[i], "cpu"),
                                eid(0xA0 + i))
        jnet.nodes[i].contribute(jax.tree_util.tree_map(jnp.asarray,
                                                        dense[i]),
                                 eid(0xA0 + i))
    _same_roots(net, jnet)
    for x in (net, jnet):
        x.partition([range(0, 4), range(4, 8)])
        x.all_pairs_round()
    _same_roots(net, jnet)
    _same_counters(net, jnet)
    assert len(set(net.roots())) == 2
    for x in (net, jnet):
        x.heal()
        x.all_pairs_round()
    _same_roots(net, jnet)
    _same_counters(net, jnet)
    assert len(set(net.roots())) == 1
    tb = convert.from_numpy_tree(base, "cpu")
    jb = jax.tree_util.tree_map(jnp.asarray, base)
    for name in ("weight_average", "ties"):
        outs = [n.resolve(MergeSpec(name), tb, use_cache=False)
                for n in net.nodes]
        first = [x.numpy().tobytes() for x in pytree.leaves(outs[0])]
        assert all([x.numpy().tobytes() for x in pytree.leaves(o)] == first
                   for o in outs[1:]), name
        want = jnet.nodes[7].resolve(JSpec(name), jb, use_cache=False)
        for g, w in zip(pytree.leaves(outs[0]),
                        jax.tree_util.tree_leaves(want)):
            _close(name, g, w)
    # the embedding and MLP leaves average the two dense fine-tunes only
    avg = net.nodes[3].resolve(MergeSpec("weight_average"), tb,
                               use_cache=False)
    two = reference_apply("weight_average", [convert.from_numpy_tree(
        d, "cpu") for d in dense], base=tb)
    assert torch.equal(avg["embed"], two["embed"])
    assert torch.equal(avg["blocks"]["sub0"]["mlp"]["w_up"],
                       two["blocks"]["sub0"]["mlp"]["w_up"])
