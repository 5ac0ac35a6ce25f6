"""The port's network simulator (`repro_torch.net.simulator`) against
the reference (`repro.net.simulator`): the scenarios of
tests/test_net_simulator.py, crash and restart with durable storage,
and the scenarios of benchmarks/bench_antientropy.py and
benchmarks/bench_durability.py at their `--quick` sizes, on both
packages from the same numpy inputs (tests/_net_twins.py).

Bitwise: the delivery trace (virtual time, sender, destination, frame
bytes) for one seed under loss, duplication and reordering — both
packages draw `random.Random(seed)` and `random.Random(seed ^ 0x5EED)`
alike, so they drop, duplicate and delay the same frames — rounds to
convergence, Merkle roots, byte totals, the drop and duplicate counts,
and weight_average resolves.
"""
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _net_twins as T  # noqa: E402
from _net_twins import PORT, REF  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    PORT.clear_cache()
    REF.clear_cache()


def _payloads(pkg, n, side=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": pkg.tensor(rng.standard_normal((side, side)).astype(
        np.float32))} for _ in range(n)]


def _sim_result(g, **extra):
    out = {"trace": list(g.net.log), "roots": g.roots(),
           "bytes": g.bytes_sent, "dropped": g.net.msgs_dropped,
           "duplicated": g.net.msgs_duplicated,
           "delivered": g.net.msgs_delivered, "clock": g.net.clock,
           "stats": [T.stats(x) for x in g.nodes], "g": g}
    out.update(extra)
    return out


def _check(p, r, *extra):
    T.same(p, r, "trace", "roots", "bytes", "dropped", "duplicated",
           "delivered", "clock", "stats", *extra)


# ------------------------------------------------------------ event loop


def _sync_done(pkg, sid):
    return pkg.wire.SyncDone("a", sid, pkg.CRDTMergeState().vv)


def _event_loop(pkg):
    seen, times = [], []
    net = pkg.SimNetwork(seed=0)
    net.register("b", lambda n, _d, _s, msg: (seen.append(msg.sid),
                                              times.append(n.clock)))
    net.set_link("a", "b", pkg.LinkSpec(latency=1.0))
    net.send("a", "b", _sync_done(pkg, 1))
    net.set_link("a", "b", pkg.LinkSpec(latency=0.001))
    net.send("a", "b", _sync_done(pkg, 2))
    net.run()
    out = {"order": list(seen), "times": list(times), "clock": net.clock}
    bw = pkg.SimNetwork(seed=0, default_link=pkg.LinkSpec(
        latency=0.0, bandwidth=1000.0))
    bw_times = []
    bw.register("b", lambda n, _d, _s, _m: bw_times.append(n.clock))
    sizes = [bw.send("a", "b", _sync_done(pkg, s)) for s in range(3)]
    inflight = (bw.inflight_bytes, bw.peak_inflight_bytes)
    bw.run()
    out.update(bw_times=bw_times, sizes=sizes, inflight=inflight,
               after=(bw.inflight_bytes, bw.peak_inflight_bytes,
                      bw.max_frame_seen))
    for name, link in (("loss", pkg.LinkSpec(loss=1.0)),
                       ("dup", pkg.LinkSpec(duplicate=1.0))):
        got = []
        n = pkg.SimNetwork(seed=0, default_link=link)
        n.register("b", lambda _n, _d, _s, m: got.append(m.sid))
        n.send("a", "b", _sync_done(pkg, 7))
        n.run()
        out[name] = (got, n.msgs_dropped, n.msgs_delivered,
                     n.msgs_duplicated, n.bytes_sent)
    part, got = pkg.SimNetwork(seed=0), []
    part.register("b", lambda _n, _d, _s, m: got.append(m.sid))
    part.partition([{"a"}, {"b"}])
    part.send("a", "b", _sync_done(pkg, 1))
    part.run()
    part.heal()
    part.send("a", "b", _sync_done(pkg, 2))
    part.run()
    out["partition"] = got
    return out


def test_event_loop_matches_the_reference():
    """Virtual-time order, bandwidth serialisation, in-flight
    accounting, loss, duplication and partitions, equal in both."""
    p, r = T.run(_event_loop)
    assert p == r
    assert p["order"] == [2, 1] and p["clock"] >= 1.0
    t = p["bw_times"]
    assert len(t) == 3
    assert t[1] - t[0] == pytest.approx(t[2] - t[1], rel=0.01)
    assert p["inflight"] == (sum(p["sizes"]), sum(p["sizes"]))
    assert p["after"] == (0, sum(p["sizes"]), max(p["sizes"]))
    assert p["loss"][:3] == ([], 1, 0) and p["loss"][4] > 0
    assert p["dup"][0] == [7, 7]
    assert p["partition"] == [2]


# --------------------------------------------------------- gossip modes


def _modes(pkg, mode, lossy):
    link = pkg.LinkSpec(loss=0.2, duplicate=0.15, reorder=0.3,
                        jitter=0.002) if lossy else None
    n = 10 if lossy else 12
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(n, seed=2 if lossy else 1,
                                               mode=mode, link=link))
    pl = _payloads(pkg, n, seed=2 if lossy else 1)
    g.contribute_all(lambda i: pl[i])
    rounds = g.run_epidemic(fanout=3, max_rounds=60 if lossy else 64,
                            require_blobs=True)
    return _sim_result(g, rounds=rounds,
                       converged=g.converged(require_blobs=True))


@pytest.mark.parametrize("mode", ["state", "delta", "antientropy"])
@pytest.mark.parametrize("lossy", [False, True])
def test_convergence_and_delivery_trace(mode, lossy):
    p, r = T.run(_modes, mode, lossy)
    _check(p, r, "rounds", "converged")
    assert p["converged"]
    if lossy:
        assert p["dropped"] > 0 and p["duplicated"] > 0
    else:
        assert p["rounds"] < 12


def _lossy_resolve(pkg):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(
        8, seed=3, mode="antientropy",
        link=pkg.LinkSpec(loss=0.25, reorder=0.2)))
    pl = _payloads(pkg, 8, seed=3)
    g.contribute_all(lambda i: pl[i])
    g.run_epidemic(fanout=3, max_rounds=60, require_blobs=True)
    outs = g.resolve_all("weight_average")
    return _sim_result(g, outs=[T.nbytes(o["w"]) for o in outs],
                       converged=g.converged(require_blobs=True))


def test_resolve_identical_after_lossy_antientropy():
    p, r = T.run(_lossy_resolve)
    _check(p, r, "outs", "converged")
    assert p["converged"] and len(set(p["outs"])) == 1


def _retraction(pkg):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(6, seed=4,
                                               mode="antientropy"))
    pl = _payloads(pkg, 6, seed=4)
    g.contribute_all(lambda i: pl[i])
    g.run_epidemic(fanout=3)
    victim = sorted(g.nodes[0].state.visible())[0]
    g.nodes[0].retract(victim)
    g.run_epidemic(fanout=3)
    return _sim_result(g, converged=g.converged(), gone=all(
        victim not in x.state.visible() for x in g.nodes))


def test_retraction_propagates_through_simulator():
    p, r = T.run(_retraction)
    _check(p, r, "converged", "gone")
    assert p["converged"] and p["gone"]


def test_determinism_same_seed_same_bytes():
    def once(pkg):
        g = pkg.SimGossipNetwork(8, seed=5, mode="antientropy",
                                 link=pkg.LinkSpec(loss=0.1, duplicate=0.1,
                                                   reorder=0.2))
        pl = _payloads(pkg, 8, seed=5)
        g.contribute_all(lambda i: pl[i])
        rounds = g.run_epidemic(fanout=2, max_rounds=40,
                                require_blobs=True)
        return rounds, g.bytes_sent, g.net.msgs_dropped
    assert once(PORT) == once(PORT) == once(REF)


def _delta_recovers(pkg):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(
        2, seed=11, mode="delta", link=pkg.LinkSpec(loss=0.5)))
    pl = _payloads(pkg, 2, seed=11)
    g.contribute_all(lambda i: pl[i])
    g.run_epidemic(fanout=1, max_rounds=64, require_blobs=True)
    return _sim_result(g, converged=g.converged(require_blobs=True))


def test_delta_mode_recovers_from_dropped_first_contact():
    p, r = T.run(_delta_recovers)
    _check(p, r, "converged")
    assert p["converged"]


def _tombstoned(pkg):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(3, seed=12,
                                               mode="antientropy"))
    pl = _payloads(pkg, 3, seed=12)
    g.contribute_all(lambda i: pl[i])
    g.run_epidemic(fanout=2)
    victim = sorted(g.nodes[0].state.visible())[0]
    g.nodes[0].retract(victim)
    g.run_epidemic(fanout=2)
    for x in g.nodes:
        store = {k: v for k, v in x.state.store.items() if k != victim}
        x.state = pkg.CRDTMergeState(x.state.adds, x.state.removes,
                                     x.state.vv, store)
    rounds = g.run_epidemic(fanout=2, max_rounds=8, require_blobs=True)
    return _sim_result(g, rounds=rounds,
                       converged=g.converged(require_blobs=True),
                       clean=all(victim not in x.missing_blobs()
                                 for x in g.nodes))


def test_tombstoned_element_not_blob_requested_forever():
    p, r = T.run(_tombstoned)
    _check(p, r, "rounds", "converged", "clean")
    assert p["converged"] and p["rounds"] < 8 and p["clean"]


def _cheaper(pkg):
    rng = np.random.default_rng(6)
    distinct = _payloads(pkg, 10, side=16, seed=6)
    pick = rng.integers(0, 10, size=24)
    totals = {}
    for mode in ("state", "antientropy"):
        g = pkg.SimGossipNetwork(24, seed=7, mode=mode)
        g.contribute_all(lambda i: distinct[pick[i]])
        g.run_epidemic(fanout=3, require_blobs=True)
        assert g.converged(require_blobs=True)
        totals[mode] = g.bytes_sent
    return totals


def test_antientropy_cheaper_than_full_state():
    p, r = T.run(_cheaper)
    assert p == r
    assert p["antientropy"] * 2 < p["state"]


def test_probe_and_tracer_on_the_virtual_clock():
    res = {}
    for pkg in (PORT, REF):
        g = pkg.SimGossipNetwork(6, seed=8, mode="antientropy")
        pl = _payloads(pkg, 6, seed=8)
        g.contribute_all(lambda i: pl[i])
        probe = g.make_probe()
        obs = [g.observe_convergence(probe)]
        while not g.converged():
            g.epidemic_round(fanout=2)
            obs.append(g.observe_convergence(probe))
        tracer = g.make_tracer(run="sim")
        h = probe.registry.histogram("probe_convergence_seconds")
        res[pkg.name] = (obs, probe.episodes, tracer.clock(),
                         h.count(), h.sum())
    assert res["port"] == res["ref"]


# ------------------------------------------------ crash / restart storage


def _crash_restart(pkg, tmp):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(4, seed=3,
                                               mode="antientropy"))
    pl = _payloads(pkg, 4, side=6, seed=3)
    g.contribute_all(lambda i: pl[i])
    g.attach_storage(tmp)
    g.run_epidemic(fanout=3, require_blobs=True)

    def blob_bytes():
        c = g.net.obs.counter("net_bytes_total")
        return sum(c.value(type=t) for t in
                   ("BlobResp", "ChunkData", "BlobManifest"))

    pre = g.by_id["node001"].state.merkle_root()
    before = blob_bytes()
    g.crash_node("node001")
    node = g.restart_node("node001")
    exact = node.state.merkle_root() == pre and not node.missing_blobs()
    g.run_epidemic(fanout=3, require_blobs=True)
    warm = blob_bytes() - before
    received = node.stats["blobs_received"]
    g.crash_node("node001")
    shutil.rmtree(os.path.join(tmp, "node001"))
    before = blob_bytes()
    g.restart_node("node001")
    g.run_epidemic(fanout=3, require_blobs=True)
    return _sim_result(g, exact=exact, warm=warm, received=received,
                       cold=blob_bytes() - before,
                       converged=g.converged(require_blobs=True))


def test_crash_restart_with_storage(tmp_path):
    p = _crash_restart(PORT, str(tmp_path / "port"))
    r = _crash_restart(REF, str(tmp_path / "ref"))
    _check(p, r, "exact", "warm", "received", "cold", "converged")
    assert p["exact"] and p["warm"] == 0 and p["received"] == 0
    assert p["cold"] > 0 and p["converged"]
    restarted = p["g"].by_id["node001"]
    for payload in restarted.state.store.values():
        assert payload["w"].device.type == "cpu"


# ---------------------------------------------- the benchmarks' scenarios


def _bench_antientropy(pkg, mode, nodes=20, side=16, distinct=8, fanout=3,
                       seed=7):
    """bench_antientropy.run_mode at its --quick size."""
    rng = np.random.default_rng(seed)
    pool = [{"w": pkg.tensor(rng.standard_normal((side, side)).astype(
        np.float32))} for _ in range(distinct)]
    pick = rng.integers(0, distinct, size=nodes)
    g = pkg.SimGossipNetwork(nodes, seed=seed, mode=mode)
    g.contribute_all(lambda i: pool[pick[i]])
    rounds = g.run_epidemic(fanout=fanout, require_blobs=True)
    assert g.converged(require_blobs=True)
    return {"rounds": rounds, "bytes": g.bytes_sent,
            "msgs": g.net.msgs_sent, "clock": g.net.clock,
            "roots": len(set(g.roots()))}


@pytest.mark.parametrize("mode", ["state", "delta", "antientropy"])
def test_bench_antientropy_quick_byte_totals(mode):
    p, r = T.run(_bench_antientropy, mode)
    assert p == r and p["roots"] == 1


def _bench_durability(pkg, tmp, mib=8.0, seed=7):
    """bench_durability.run at its --quick size (8 MiB over 4 nodes)."""
    g = pkg.SimGossipNetwork(4, seed=seed, mode="antientropy")
    side = int(round((mib / 4 * 2 ** 20 / 4) ** 0.5))
    rng = np.random.default_rng(seed)
    pl = [{"w": pkg.tensor(rng.standard_normal((side, side)).astype(
        np.float32))} for _ in range(4)]
    g.contribute_all(lambda i: pl[i])
    g.attach_storage(tmp)
    g.run_epidemic(fanout=3, require_blobs=True)

    def blob_bytes():
        c = g.net.obs.counter("net_bytes_total")
        return sum(c.value(type=t) for t in
                   ("BlobResp", "ChunkData", "BlobManifest"))

    pre = g.by_id["node001"].state.merkle_root()
    n_blobs = len(g.by_id["node001"].state.store)
    g.crash_node("node001")
    before = blob_bytes()
    t0 = time.perf_counter()
    node = g.restart_node("node001")
    replay_s = time.perf_counter() - t0
    exact = node.state.merkle_root() == pre
    back = len(node.state.store) == n_blobs
    g.run_epidemic(fanout=3, require_blobs=True)
    warm = blob_bytes() - before
    reconverged = g.converged(require_blobs=True)
    g.crash_node("node001")
    shutil.rmtree(os.path.join(tmp, "node001"))
    before = blob_bytes()
    g.restart_node("node001")
    g.run_epidemic(fanout=3, require_blobs=True)
    cold = blob_bytes() - before
    return {"warm": warm, "cold": cold, "exact": exact, "back": back,
            "reconverged": reconverged, "bytes": g.bytes_sent,
            "cold_root": g.by_id["node001"].state.merkle_root() == pre,
            "replay_s": replay_s}


def test_bench_durability_quick_gates(tmp_path):
    p = _bench_durability(PORT, str(tmp_path / "port"))
    r = _bench_durability(REF, str(tmp_path / "ref"))
    for k in ("warm", "cold", "exact", "back", "reconverged", "bytes",
              "cold_root"):
        assert p[k] == r[k], k
    assert p["warm"] == 0 and p["reconverged"]            # warm_zero_bytes
    assert p["exact"] and p["back"]                        # exact_root
    assert p["replay_s"] <= 30.0                           # bounded_replay
    assert p["cold"] > 0 and p["cold_root"]                # cold_refetch


def test_simulator_without_a_device_needs_cuda():
    from repro_torch.net import SimGossipNetwork
    if torch.cuda.is_available():
        assert SimGossipNetwork(1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SimGossipNetwork(1)
