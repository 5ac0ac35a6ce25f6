"""repro_torch.net — the wire codec (`repro.net.wire`, byte for byte).

Every message crosses a byte boundary through the versioned framed
codec (`wire`, spec in docs/PROTOCOL.md); tensors decode onto the device
the caller names. Large blobs stream as bounded-size manifest / chunk
frames. The transports, the sharded store, `SyncNode` and the network
simulator wait for the sync stack (ROADMAP A6b).
"""
from repro_torch.net.wire import (
    decode_blob, decode_frame, decode_message, DEFAULT_MAX_FRAME, encode_blob,
    encode_message, msg_to_delta, msg_to_state, ResolveSpecMsg, state_to_msg,
    WireError)

__all__ = [
    "DEFAULT_MAX_FRAME", "ResolveSpecMsg", "WireError", "decode_blob",
    "decode_frame", "decode_message", "encode_blob", "encode_message",
    "msg_to_delta", "msg_to_state", "state_to_msg",
]

# detcheck tier manifest (docs/ANALYSIS.md):
# frame bytes are canonical: a pure function of the message value
DETCHECK_TIER = "deterministic"
