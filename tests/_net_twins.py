"""Twin harness for the sync-stack parity tests (`test_torch_antientropy`,
`test_torch_blobstream`, `test_torch_shardstore`, `test_torch_simulator`):
one namespace per package exposing the same names, so a scenario written
once against `pkg` runs on the port (`PORT`, every tensor on the CPU)
and on the reference (`REF`) from the same numpy draws.

`traced(pkg, transport)` records every frame a transport sends as
(sender, destination, encoded bytes); `traced_sim(pkg, g)` records every
frame a simulator delivers as (virtual time, sender, destination,
encoded bytes). Frames are canonical — encoding a decoded message gives
its bytes back — so the records compare bitwise across the packages.
"""
import importlib
from functools import partial
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

import repro.api as japi
import repro.core.compression as jcomp
import repro.core.delta as jdelta
import repro.core.state as jstate
import repro.net.antientropy as jae
import repro.net.simulator as jsim
import repro.net.store as jstore
import repro.net.transport as jtr
import repro.net.wire as jwire
from repro.core.gossip import GossipNetwork as JGossip
from repro_torch import convert
from repro_torch.api import MergeSpec
from repro_torch.core import compression as tcomp
from repro_torch.core import delta as tdelta
from repro_torch.core import resolve as tresolve
from repro_torch.core import state as tstate
from repro_torch.core.gossip import GossipNetwork
from repro_torch.net import antientropy as tae
from repro_torch.net import simulator as tsim
from repro_torch.net import store as tstore
from repro_torch.net import transport as ttr
from repro_torch.net import wire as twire

# repro.core re-exports a function named `resolve` over its module
jresolve = importlib.import_module("repro.core.resolve")

CPU = "cpu"


def _ns(name, **kw):
    return SimpleNamespace(name=name, **kw)


PORT = _ns(
    "port",
    SyncNode=partial(tae.SyncNode, device=CPU),
    InMemoryTransport=partial(ttr.InMemoryTransport, device=CPU),
    LoopbackSocketTransport=partial(ttr.LoopbackSocketTransport,
                                    device=CPU),
    PersistentLoopbackTransport=partial(ttr.PersistentLoopbackTransport,
                                        device=CPU),
    SimNetwork=partial(tsim.SimNetwork, device=CPU),
    SimGossipNetwork=partial(tsim.SimGossipNetwork, device=CPU),
    GossipNetwork=partial(GossipNetwork, device=CPU),
    LinkSpec=tsim.LinkSpec, pump=ttr.pump, wire=twire,
    Placement=tstore.Placement, CRDTMergeState=tstate.CRDTMergeState,
    apply_delta=tdelta.apply_delta,
    delta_for_entries=tdelta.delta_for_entries,
    compress_tree=tcomp.compress_tree,
    decompress_tree=tcomp.decompress_tree,
    CompressedTree=tcomp.CompressedTree, MergeSpec=MergeSpec,
    resolve_spec=tresolve.resolve_spec, resolve=tresolve.resolve,
    clear_cache=tresolve.engine.clear_cache,
    tensor=lambda a: torch.from_numpy(np.array(a)),
)

REF = _ns(
    "ref",
    SyncNode=jae.SyncNode, InMemoryTransport=jtr.InMemoryTransport,
    LoopbackSocketTransport=jtr.LoopbackSocketTransport,
    PersistentLoopbackTransport=jtr.PersistentLoopbackTransport,
    SimNetwork=jsim.SimNetwork, SimGossipNetwork=jsim.SimGossipNetwork,
    GossipNetwork=JGossip, LinkSpec=jsim.LinkSpec, pump=jtr.pump,
    wire=jwire, Placement=jstore.Placement,
    CRDTMergeState=jstate.CRDTMergeState, apply_delta=jdelta.apply_delta,
    delta_for_entries=jdelta.delta_for_entries,
    compress_tree=jcomp.compress_tree,
    decompress_tree=jcomp.decompress_tree,
    CompressedTree=jcomp.CompressedTree, MergeSpec=japi.MergeSpec,
    resolve_spec=jresolve.resolve_spec, resolve=jresolve.resolve,
    clear_cache=jresolve.clear_cache,
    tensor=jnp.asarray,
)



def payload(pkg, rng, shape=(4, 4)):
    """One {"w": fp32 normal} payload; the same draw on both packages."""
    return {"w": pkg.tensor(rng.standard_normal(shape).astype(np.float32))}


def nbytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return convert._to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def tree_bytes(tree):
    """Row-major bytes of every leaf, either package's tensors."""
    if isinstance(tree, dict):
        return {k: tree_bytes(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [tree_bytes(v) for v in tree]
    return nbytes(tree)


def stats(node) -> dict:
    return {k: node.stats[k] for k in node.stats}


def traced(pkg, transport):
    """Record (src, dst, frame bytes) of every send, in order."""
    log = []
    send = transport.send

    def rec(src, dst, msg):
        log.append((src, dst, pkg.wire.encode_message(msg)))
        return send(src, dst, msg)

    transport.send = rec
    transport.log = log
    return transport


def traced_sim(pkg, g):
    """Record (virtual time, src, dst, frame bytes) of every delivery of
    a SimGossipNetwork or SimNetwork."""
    net = getattr(g, "net", g)
    log = []

    def wrap(handler):
        def h(n, dst, src, msg):
            log.append((n.clock, src, dst, pkg.wire.encode_message(msg)))
            return handler(n, dst, src, msg)
        return h

    for k in list(net.handlers):
        net.handlers[k] = wrap(net.handlers[k])
    register = net.register
    net.register = lambda node_id, handler: register(node_id, wrap(handler))
    net.log = log
    return g


def sync(pkg, a, b, transport=None, max_steps=100_000):
    """One anti-entropy session initiated by `a`, pumped to quiescence."""
    t = transport if transport is not None else traced(
        pkg, pkg.InMemoryTransport())
    t.register(a.node_id)
    t.register(b.node_id)
    t.send(a.node_id, b.node_id, a.begin_sync(b.node_id))
    pkg.pump({a.node_id: a, b.node_id: b}, t, max_steps=max_steps)
    return t


def metadata_only(pkg, state):
    """A state holding `state`'s full metadata but no payloads."""
    return pkg.apply_delta(pkg.CRDTMergeState(), pkg.delta_for_entries(
        state, state.adds, state.removes))


def run(scenario, *args, **kw):
    """The scenario on both packages: (port result, reference result)."""
    return scenario(PORT, *args, **kw), scenario(REF, *args, **kw)


def same(p, r, *keys):
    for k in keys:
        assert p[k] == r[k], k
