"""repro_torch.net — wire codec, transports, sharded store, sync, network
sim (`repro.net`).

Every message crosses a byte boundary through the versioned framed
codec (`wire`, spec in docs/PROTOCOL.md), moves over a pluggable
transport (`transport`: in-memory queues, per-frame loopback TCP, or
persistent per-peer TCP connections), and replicas reconcile via
Merkle-partitioned anti-entropy (`antientropy`) instead of shipping full
states. Large blobs stream as bounded-size manifest / chunk frames,
resumable across sessions and fetched multi-source. `store` partitions
payload residency across nodes by rendezvous hashing (Layer-1 metadata
stays fully replicated); `simulator` is a deterministic discrete-event
network with per-link latency, bandwidth, loss, duplication and
reordering. Frames are the reference's byte for byte, so a port node
and a reference node sync with each other; tensors decode onto the
device the caller names (CUDA unless the caller asks for the CPU).
"""
from repro_torch.net.antientropy import reconcile_root, state_items, SyncNode
from repro_torch.net.simulator import LinkSpec, SimGossipNetwork, SimNetwork
from repro_torch.net.store import (
    bitmap_indices, BlobSource, chunk_bitmap, Placement, rendezvous_holders)
from repro_torch.net.transport import (
    InMemoryTransport, LoopbackSocketTransport, PersistentLoopbackTransport,
    pump, Transport)
from repro_torch.net.wire import (
    decode_blob, decode_frame, decode_message, DEFAULT_MAX_FRAME, encode_blob,
    encode_message, msg_to_delta, msg_to_state, ResolveSpecMsg, state_to_msg,
    WireError)

__all__ = [
    "SyncNode", "reconcile_root", "state_items",
    "LinkSpec", "SimGossipNetwork", "SimNetwork",
    "BlobSource", "Placement", "bitmap_indices", "chunk_bitmap",
    "rendezvous_holders",
    "InMemoryTransport", "LoopbackSocketTransport",
    "PersistentLoopbackTransport", "Transport", "pump",
    "DEFAULT_MAX_FRAME", "ResolveSpecMsg", "WireError", "decode_blob",
    "decode_frame", "decode_message", "encode_blob", "encode_message",
    "msg_to_delta", "msg_to_state", "state_to_msg",
]

# detcheck tier manifest (docs/ANALYSIS.md):
# transports/sync touch sockets and wall clocks by design
DETCHECK_TIER = "environment"
