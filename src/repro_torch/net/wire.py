"""Versioned binary wire format for CRDT gossip and anti-entropy
(`repro.net.wire`, byte for byte).

`docs/PROTOCOL.md` is the normative specification (frame table, field
layouts, size bounds, chunk streaming). For equal content this module
writes the reference's frames exactly, and each package decodes the
other's (tests/test_torch_wire.py).

Frame layout (all integers big-endian):

    magic   2B  b"RN"
    version 1B  0x01 for frame types v1 peers parse; 0x02 for the
                frames v2 introduced (both accepted on decode)
    type    1B  message type tag (MSG_*)
    length  4B  payload byte count
    payload length bytes
    crc32   4B  zlib.crc32 over the payload

The payload is a canonical encoding of one message dataclass: sets are
written in sorted order, dict keys sorted, so encoding is a pure function
of the message value and `encode_message(decode_message(b)) == b` for any
frame this module produced. Tensors travel as raw row-major
little-endian bytes under numpy's dtype name ("float32", "bfloat16",
"int8", "bool", ...) and a shape; int8 payloads (`core.compression`)
travel as q-bytes + the fp32 scale's 4 bytes and reconstruct bit for bit
on every replica (paper Assumption 10 across the network boundary).

What differs from the reference is where bytes live, never which bytes:

  * Tensors decode onto a device the caller names (`device=`; CUDA
    unless the caller asks for the CPU, resolved at the first tensor a
    frame holds). A tensor's bytes go from the frame to the device in
    one copy (`torch.frombuffer` over the frame, then `.to(device)`);
    dtype names map to torch dtypes here, so bf16 needs no numpy type.
  * Encoding a CUDA tensor copies it to the host once; the encoder
    collects parts and joins them once, and the reader slices a
    `memoryview`, so a multi-GB blob is not copied over and over.
  * A length field is a u32. A tensor of 4 GiB or more, or a frame
    payload that large, raises `WireError` at encode time, where the
    reference would write a frame no peer can read.

Large blobs never travel as one frame: payloads whose canonical encoding
exceeds the per-frame data budget are announced via BlobManifest (chunk
count, sizes, per-chunk SHA-256) and stream as ChunkReq/ChunkData frames
bounded by DEFAULT_MAX_FRAME. Wire v2 adds the discovery frames (HaveReq
/ HaveMap), ResolveSpecMsg and SparseManifest.
"""
from __future__ import annotations

import hashlib
import os
import struct
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.compression import (
    compressed_tree_from_structure, compressed_tree_to_structure,
    CompressedLeaf, CompressedTree, decompress_tree, dequantize_leaf,
    to_device)
from repro_torch.core.delta import Delta
from repro_torch.core.state import AddEntry, CRDTMergeState
from repro_torch.core.version_vector import VersionVector
from repro_torch.dtypes import BY_NAME, dtype_name

MAGIC = b"RN"
VERSION = 2                             # current protocol version
ACCEPTED_VERSIONS = frozenset({1, 2})   # decoded without complaint
# Frames whose type already existed in v1 keep the v1 stamp, so an
# un-upgraded peer still reads everything it can parse; only the
# v2-introduced frames carry the v2 stamp. Decoding is lenient about
# the version/type pairing — the type tag alone selects the decoder.
HEADER = struct.Struct(">2sBBI")        # magic, version, type, payload len
TRAILER = struct.Struct(">I")           # crc32
FRAME_OVERHEAD = HEADER.size + TRAILER.size

# message type tags
MSG_STATE = 0x01
MSG_DELTA = 0x02
MSG_SYNC_REQ = 0x10
MSG_BUCKETS = 0x11
MSG_BUCKET_ITEMS = 0x12
MSG_BLOB_REQ = 0x13
MSG_BLOB_RESP = 0x14
MSG_SYNC_DONE = 0x15
MSG_BLOB_MANIFEST = 0x16
MSG_CHUNK_REQ = 0x17
MSG_CHUNK_DATA = 0x18
MSG_HAVE_REQ = 0x19
MSG_HAVE_MAP = 0x1A
MSG_RESOLVE_SPEC = 0x1B
MSG_SPARSE_MANIFEST = 0x1C

# Streaming transfer sizing. Blobs whose canonical encoding exceeds the
# per-frame data budget travel as BlobManifest + ChunkReq/ChunkData.
# CHUNK_ENVELOPE reserves room for the non-data fields of a ChunkData
# frame (sender, sid, eid, index, length prefixes, frame overhead) so a
# full chunk plus envelope stays <= the configured max frame size.
DEFAULT_MAX_FRAME = 4 * 2 ** 20
CHUNK_ENVELOPE = 256
DIGEST_LEN = 32                         # per-chunk SHA-256

# value (pytree) node tags
_T_DICT = 0x01
_T_LIST = 0x02
_T_TUPLE = 0x03
_T_TENSOR = 0x04
_T_QLEAF = 0x05
_T_CTREE = 0x06
_T_NONE = 0x07
_T_FLOAT = 0x08
_T_INT = 0x09
_T_STR = 0x0A
_T_BOOL = 0x0B

_U32_MAX = 2 ** 32 - 1


class WireError(ValueError):
    """Malformed frame, bad checksum, or unsupported value."""


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StateMsg:
    """Full-state push: complete (A, R, V) metadata plus store payloads."""
    sender: str
    adds: FrozenSet[AddEntry]
    removes: FrozenSet[str]
    vv: VersionVector
    payloads: Dict[str, Any] = field(default_factory=dict)

    type = MSG_STATE


@dataclass(frozen=True)
class DeltaMsg:
    """Delta-state push (vv-filtered or bucket-selected entries)."""
    sender: str
    adds: FrozenSet[AddEntry]
    removes: FrozenSet[str]
    vv: VersionVector
    payloads: Dict[str, Any] = field(default_factory=dict)
    compressed: bool = False

    type = MSG_DELTA


@dataclass(frozen=True)
class SyncReq:
    """Anti-entropy round 1: initiator's reconciliation root + bucketing."""
    sender: str
    sid: int
    root: bytes
    bits: int
    vv: VersionVector

    type = MSG_SYNC_REQ


@dataclass(frozen=True)
class BucketsMsg:
    """Round 2: responder's sparse bucket digest vector (roots differ)."""
    sender: str
    sid: int
    bits: int
    digests: Dict[int, bytes]

    type = MSG_BUCKETS


@dataclass(frozen=True)
class BucketItemsMsg:
    """Rounds 3/4: entries in differing buckets; `want` asks the peer to
    reply with its entries for those bucket indices (empty = no reply).
    Carries the session's bucket bit-width so the receiver needs no
    session bookkeeping to interpret `want`."""
    sender: str
    sid: int
    bits: int
    adds: FrozenSet[AddEntry]
    removes: FrozenSet[str]
    vv: VersionVector
    want: Tuple[int, ...] = ()

    type = MSG_BUCKET_ITEMS


@dataclass(frozen=True)
class BlobReq:
    """Request store payloads the requester's store lacks."""
    sender: str
    sid: int
    eids: Tuple[str, ...]

    type = MSG_BLOB_REQ


@dataclass(frozen=True)
class BlobResp:
    sender: str
    sid: int
    payloads: Dict[str, Any] = field(default_factory=dict)
    compressed: bool = False

    type = MSG_BLOB_RESP


@dataclass(frozen=True)
class SyncDone:
    """Roots matched (or session closed); carries vv for metadata merge."""
    sender: str
    sid: int
    vv: VersionVector

    type = MSG_SYNC_DONE


@dataclass(frozen=True)
class ManifestEntry:
    """Chunking of one blob: the canonical encoding of the payload split
    at `chunk_size` boundaries, with a SHA-256 digest per chunk so every
    chunk is verifiable on its own and partial transfers resume without
    re-shipping verified data."""
    eid: str
    chunk_size: int
    total_size: int
    digests: Tuple[bytes, ...]

    @property
    def n_chunks(self) -> int:
        return len(self.digests)


@dataclass(frozen=True)
class BlobManifest:
    """Announces blobs too large for a single BlobResp frame."""
    sender: str
    sid: int
    entries: Tuple[ManifestEntry, ...]

    type = MSG_BLOB_MANIFEST


@dataclass(frozen=True)
class ChunkReq:
    """Request specific chunks of one blob. `chunk_size` echoes the
    manifest the requester adopted, so any peer holding the blob can
    serve compatible chunks regardless of its own chunking config."""
    sender: str
    sid: int
    eid: str
    chunk_size: int
    indices: Tuple[int, ...]

    type = MSG_CHUNK_REQ


@dataclass(frozen=True)
class ChunkData:
    """One verified-size slice of a blob's canonical encoding."""
    sender: str
    sid: int
    eid: str
    index: int
    data: bytes

    type = MSG_CHUNK_DATA


@dataclass(frozen=True)
class HaveReq:
    """Ask a peer which of `eids` it holds (sharded-store discovery).

    The answer (HaveMap) feeds the multi-source chunk scheduler: a
    requester fans disjoint chunk windows of one blob across every peer
    known to hold it."""
    sender: str
    sid: int
    eids: Tuple[str, ...]

    type = MSG_HAVE_REQ


@dataclass(frozen=True)
class HaveEntry:
    """One blob's holding claim. `n_chunks == 0` means the peer holds
    the complete blob (bitmap empty); otherwise `bitmap` marks which of
    the `n_chunks` manifest chunks the peer has verified so far (bit i =
    byte i//8, bit i%8, LSB first)."""
    eid: str
    n_chunks: int
    bitmap: bytes = b""


@dataclass(frozen=True)
class HaveMap:
    """Compact advertisement of which requested eids/chunks a node holds."""
    sender: str
    sid: int
    entries: Tuple[HaveEntry, ...] = ()

    type = MSG_HAVE_MAP


@dataclass(frozen=True)
class LeafRef:
    """Per-leaf planner metadata of one contribution: canonical keystr
    path, `tensor_digest`, dtype name, shape. A SparseManifest full of
    these lets the receiver plan per-leaf contribution subsets — and
    complete warm or fold-resumable resolves — before (or without)
    fetching a single payload chunk.

    `scale` announces that the leaf's payload travels as symmetric int8
    (`CompressedLeaf`) with this fp32 dequantization scale; zero-point
    is identically 0 by construction (the codec is symmetric), so the
    scale alone fully determines dequantization. The digest still
    describes the DEQUANTIZED tensor — content identity is defined on
    wire-format values — which is what lets a receiver plan (and the
    merge-on-arrival kernel execute) against the int8 bytes without
    ever densifying."""
    path: str
    digest: bytes                  # 32B tensor_digest
    dtype: str
    shape: Tuple[int, ...]
    scale: Optional[float] = None  # int8 dequant scale; None = dense


@dataclass(frozen=True)
class SparseManifestEntry:
    """One contribution's leaf-level announcement: the chunking manifest
    of its canonical blob encoding (so chunk transfer can start from the
    same frame) plus one LeafRef per carried leaf, sorted by path. The
    leaf list IS the coverage descriptor; a dense contribution is the
    trivially-full case (every model leaf listed)."""
    manifest: ManifestEntry
    leaves: Tuple[LeafRef, ...]

    @property
    def eid(self) -> str:
        return self.manifest.eid

    @property
    def coverage(self) -> Tuple[str, ...]:
        return tuple(l.path for l in self.leaves)


@dataclass(frozen=True)
class SparseManifest:
    """Announces contributions at leaf granularity (wire v2): per-leaf
    blob refs feed the planner's digest memo, and
    the embedded chunk manifests register the sender as a chunk source
    — so a receiver fetches only the payloads some cache-missed leaf
    actually needs (O(changed) fetch)."""
    sender: str
    sid: int
    entries: Tuple[SparseManifestEntry, ...]

    type = MSG_SPARSE_MANIFEST


@dataclass(frozen=True)
class ResolveSpecMsg:
    """Gossip *what to resolve*: a `repro_torch.api.MergeSpec` in its
    canonical encoding. Contributions already converge via the OR-Set;
    this frame lets nodes converge on the resolve description too
    (strategy, typed cfg, base ref, reduction, trust threshold) instead
    of relying on out-of-band configuration. The payload is the spec's
    own versioned canonical bytes — the same bytes its digest() (and
    therefore the engine cache key) hashes."""
    sender: str
    sid: int
    spec: Any                  # repro_torch.api.MergeSpec

    type = MSG_RESOLVE_SPEC


Message = Any  # any of the dataclasses above


# ---------------------------------------------------------------------------
# Primitive encoders
# ---------------------------------------------------------------------------


class _Buf:
    """An append-only payload: small fields gather in a bytearray, large
    tensor bytes are kept as parts (no copy) and joined once."""

    __slots__ = ("_parts", "_small", "_n")

    def __init__(self):
        self._parts: List[Any] = []
        self._small = bytearray()
        self._n = 0                     # bytes in _parts

    def __iadd__(self, b) -> "_Buf":
        self._small += b
        return self

    def append(self, byte: int) -> None:
        self._small.append(byte)

    def big(self, mv: memoryview) -> None:
        if self._small:
            self._parts.append(bytes(self._small))
            self._n += len(self._small)
            self._small = bytearray()
        self._parts.append(mv)
        self._n += mv.nbytes

    def __len__(self) -> int:
        return self._n + len(self._small)

    def parts(self) -> List[Any]:
        return self._parts + ([self._small] if self._small else [])

    def crc32(self) -> int:
        crc = 0
        for p in self.parts():
            crc = zlib.crc32(p, crc)
        return crc & 0xFFFFFFFF

    def getvalue(self) -> bytes:
        return b"".join(self.parts())


def _p_u8(buf: _Buf, v: int) -> None:
    buf += struct.pack(">B", v)


def _p_u16(buf: _Buf, v: int) -> None:
    buf += struct.pack(">H", v)


def _p_u32(buf: _Buf, v: int) -> None:
    buf += struct.pack(">I", v)


def _p_u64(buf: _Buf, v: int) -> None:
    buf += struct.pack(">Q", v)


# a bytes field this long is kept as a part of its own (no copy)
_BIG_FIELD = 1 << 16


def _p_bytes(buf: _Buf, b: bytes) -> None:
    mv = memoryview(b).cast("B")
    _p_len(buf, mv.nbytes)
    if mv.nbytes >= _BIG_FIELD:
        buf.big(mv)
    else:
        buf += mv


def _p_len(buf: _Buf, n: int) -> None:
    if n > _U32_MAX:
        raise WireError(f"a {n}-byte field does not fit the u32 length "
                        "prefix (4 GiB)")
    _p_u32(buf, n)


def _p_str(buf: _Buf, s: str) -> None:
    _p_bytes(buf, s.encode("utf-8"))


class _Reader:
    """Cursor over one payload. `take` copies a small field out;
    `view` hands out a zero-copy slice for tensor bytes. The device
    tensors decode onto is resolved at the first tensor."""

    __slots__ = ("buf", "pos", "_device", "_dev")

    def __init__(self, buf, pos: int = 0, device: Any = None):
        mv = memoryview(buf)
        self.buf = mv if mv.format == "B" and mv.ndim == 1 \
            else mv.cast("B")
        self.pos = pos
        self._device = device
        self._dev: Optional[torch.device] = None

    @property
    def device(self) -> torch.device:
        if self._dev is None:
            from repro_torch.api.replica import resolve_device
            self._dev = resolve_device(self._device)
        return self._dev

    def view(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise WireError("truncated payload")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def take(self, n: int) -> bytes:
        return bytes(self.view(n))

    def u8(self) -> int:
        return self.view(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.view(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.view(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.view(8))[0]

    def bytes_(self) -> bytes:
        return self.take(self.u32())

    def str_(self) -> str:
        return str(self.view(self.u32()), "utf-8")


# ---------------------------------------------------------------------------
# Pytree value codec
# ---------------------------------------------------------------------------


# numpy's names of the dtypes a frame may carry, as torch dtypes
_TORCH_DTYPE: Dict[str, torch.dtype] = dict(
    BY_NAME, uint16=torch.uint16, uint32=torch.uint32,
    uint64=torch.uint64)
_NAME_OF = {v: k for k, v in _TORCH_DTYPE.items()}


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPE[name]
    except KeyError:
        raise WireError(f"unsupported tensor dtype {name!r}") from None


def _dtype_str(dtype: torch.dtype) -> str:
    try:
        return _NAME_OF[dtype]
    except KeyError:
        raise WireError(f"unsupported tensor dtype {dtype}") from None


def _host_bytes(t: torch.Tensor) -> memoryview:
    """Row-major bytes of a tensor on any device: one device->host copy
    for a CUDA tensor, none for a contiguous host tensor."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy() if t.numel()
                      else np.empty(0, np.uint8))


def _p_tensor_bytes(buf: _Buf, t: torch.Tensor) -> None:
    mv = _host_bytes(t)
    _p_len(buf, mv.nbytes)
    buf.big(mv)


def _enc_tensor_header(buf: _Buf, dtype: str,
                       shape: Tuple[int, ...]) -> None:
    _p_str(buf, dtype)
    _p_u8(buf, len(shape))
    for d in shape:
        _p_u32(buf, d)


def _dec_tensor_header(r: _Reader) -> Tuple[str, Tuple[int, ...]]:
    dtype = r.str_()
    shape = tuple(r.u32() for _ in range(r.u8()))
    return dtype, shape


def _dec_tensor(r: _Reader, raw: memoryview, dtype: str,
                shape: Tuple[int, ...]) -> torch.Tensor:
    """A tensor on the reader's device from its frame bytes, in one
    copy. The bytes move as uint8 (no alignment needed) and are viewed
    as the dtype on the copy."""
    dt = _torch_dtype(dtype)
    numel = 1
    for d in shape:
        numel *= d
    if raw.nbytes != numel * dt.itemsize:
        raise WireError(f"tensor bytes ({raw.nbytes}) do not match "
                        f"{dtype}{list(shape)}")
    dev = r.device
    if numel == 0:
        return torch.empty(shape, dtype=dt, device=dev)
    with warnings.catch_warnings():
        # a read-only frame is never written through: the tensor below
        # is a copy
        warnings.simplefilter("ignore", UserWarning)
        u8 = torch.frombuffer(raw, dtype=torch.uint8)
    u8 = u8.clone() if dev.type == "cpu" else u8.to(dev)
    return u8.view(dt).reshape(shape)


def encode_value(buf: _Buf, v: Any) -> None:
    """Canonical recursive pytree encoding (dict keys sorted)."""
    if isinstance(v, CompressedTree):
        _p_u8(buf, _T_CTREE)
        encode_value(buf, compressed_tree_to_structure(v))
    elif isinstance(v, CompressedLeaf):
        _p_u8(buf, _T_QLEAF)
        _enc_tensor_header(buf, _dtype_str(v.dtype), tuple(v.shape))
        buf += bytes(_host_bytes(v.scale.to(torch.float32)))
        _p_tensor_bytes(buf, v.q)
    elif isinstance(v, dict):
        _p_u8(buf, _T_DICT)
        _p_u32(buf, len(v))
        for k in sorted(v):
            if not isinstance(k, str):
                raise WireError(f"dict keys must be str, got {type(k)}")
            _p_str(buf, k)
            encode_value(buf, v[k])
    elif isinstance(v, list):
        _p_u8(buf, _T_LIST)
        _p_u32(buf, len(v))
        for x in v:
            encode_value(buf, x)
    elif isinstance(v, tuple):
        _p_u8(buf, _T_TUPLE)
        _p_u32(buf, len(v))
        for x in v:
            encode_value(buf, x)
    elif isinstance(v, bool):               # before int (bool is int)
        _p_u8(buf, _T_BOOL)
        _p_u8(buf, 1 if v else 0)
    elif isinstance(v, int):
        _p_u8(buf, _T_INT)
        buf += struct.pack(">q", v)
    elif isinstance(v, float):
        _p_u8(buf, _T_FLOAT)
        buf += struct.pack(">d", v)
    elif isinstance(v, str):
        _p_u8(buf, _T_STR)
        _p_str(buf, v)
    elif v is None:
        _p_u8(buf, _T_NONE)
    elif isinstance(v, torch.Tensor):
        _p_u8(buf, _T_TENSOR)
        _enc_tensor_header(buf, _dtype_str(v.dtype), tuple(v.shape))
        _p_tensor_bytes(buf, v)
    else:
        raise WireError(f"unsupported payload value: {type(v)}")


def decode_value(r: _Reader) -> Any:
    tag = r.u8()
    if tag == _T_CTREE:
        return compressed_tree_from_structure(decode_value(r))
    if tag == _T_QLEAF:
        dtype, shape = _dec_tensor_header(r)
        scale = _dec_tensor(r, r.view(4), "float32", ())
        q = _dec_tensor(r, r.view(r.u32()), "int8", shape)
        return CompressedLeaf(q, scale, shape, _torch_dtype(dtype))
    if tag == _T_DICT:
        return {r.str_(): decode_value(r) for _ in range(r.u32())}
    if tag == _T_LIST:
        return [decode_value(r) for _ in range(r.u32())]
    if tag == _T_TUPLE:
        return tuple(decode_value(r) for _ in range(r.u32()))
    if tag == _T_TENSOR:
        dtype, shape = _dec_tensor_header(r)
        return _dec_tensor(r, r.view(r.u32()), dtype, shape)
    if tag == _T_BOOL:
        return bool(r.u8())
    if tag == _T_INT:
        return struct.unpack(">q", r.view(8))[0]
    if tag == _T_FLOAT:
        return struct.unpack(">d", r.view(8))[0]
    if tag == _T_STR:
        return r.str_()
    if tag == _T_NONE:
        return None
    raise WireError(f"unknown value tag 0x{tag:02x}")


# ---------------------------------------------------------------------------
# Component codecs
# ---------------------------------------------------------------------------


# High bit of the adds count word marks the 4-string entry form that
# carries leaf coverage descriptors. A set with no sparse entries keeps
# the legacy 3-string encoding byte-for-byte (un-upgraded peers parse
# it); sparse entries append a 4th string — the \x1f-joined coverage
# paths, empty for dense entries riding in the same set.
_SPARSE_ADDS_FLAG = 0x80000000
_COVER_SEP = "\x1f"


def _enc_adds(buf: _Buf, adds: FrozenSet[AddEntry]) -> None:
    entries = sorted(adds)
    if len(entries) >= _SPARSE_ADDS_FLAG:
        raise WireError("too many add entries for one frame")
    sparse = any(e.leaf_paths is not None for e in entries)
    _p_u32(buf, len(entries) | (_SPARSE_ADDS_FLAG if sparse else 0))
    for e in entries:
        _p_str(buf, e.element_id)
        _p_str(buf, e.tag)
        _p_str(buf, e.node)
        if sparse:
            _p_str(buf, _COVER_SEP.join(e.leaf_paths)
                   if e.leaf_paths is not None else "")


def _dec_adds(r: _Reader) -> FrozenSet[AddEntry]:
    word = r.u32()
    n, sparse = word & ~_SPARSE_ADDS_FLAG, bool(word & _SPARSE_ADDS_FLAG)
    out = []
    for _ in range(n):
        eid, tag, node = r.str_(), r.str_(), r.str_()
        cover = None
        if sparse:
            raw = r.str_()
            if raw:
                cover = tuple(raw.split(_COVER_SEP))
        out.append(AddEntry(eid, tag, node, cover))
    return frozenset(out)


def _enc_removes(buf: _Buf, removes: FrozenSet[str]) -> None:
    _p_u32(buf, len(removes))
    for tag in sorted(removes):
        _p_str(buf, tag)


def _dec_removes(r: _Reader) -> FrozenSet[str]:
    return frozenset(r.str_() for _ in range(r.u32()))


def _enc_vv(buf: _Buf, vv: VersionVector) -> None:
    clocks = {k: v for k, v in vv.to_dict().items() if v}
    _p_u32(buf, len(clocks))
    for k in sorted(clocks):
        _p_str(buf, k)
        _p_u64(buf, clocks[k])


def _dec_vv(r: _Reader) -> VersionVector:
    return VersionVector({r.str_(): r.u64() for _ in range(r.u32())})


def _enc_payloads(buf: _Buf, payloads: Dict[str, Any]) -> None:
    _p_u32(buf, len(payloads))
    for eid in sorted(payloads):
        _p_str(buf, eid)
        encode_value(buf, payloads[eid])


def _dec_payloads(r: _Reader) -> Dict[str, Any]:
    return {r.str_(): decode_value(r) for _ in range(r.u32())}


def encode_layer1(adds: FrozenSet[AddEntry], removes: FrozenSet[str],
                  vv: VersionVector) -> bytes:
    """Canonical encoding of a Layer-1 (A, R, V) triple, payload-free:
    the add/remove/version-vector encoders the sync frames use
    (including the sparse `leaf_paths` extension). The durable journal
    (`core.journal`) writes Layer-1 metadata in these bytes, so there
    is exactly one (de)serialization of `CRDTMergeState` metadata."""
    buf = _Buf()
    _enc_adds(buf, adds)
    _enc_removes(buf, removes)
    _enc_vv(buf, vv)
    return buf.getvalue()


def decode_layer1(raw: bytes) -> Tuple[FrozenSet[AddEntry],
                                       FrozenSet[str], VersionVector]:
    """Inverse of `encode_layer1`; raises `WireError` on malformed or
    trailing bytes (a durable record must parse exactly)."""
    r = _Reader(raw)
    adds = _dec_adds(r)
    removes = _dec_removes(r)
    vv = _dec_vv(r)
    if r.pos != len(r.buf):
        raise WireError("trailing bytes after layer-1 payload")
    return adds, removes, vv


# ---------------------------------------------------------------------------
# Message codecs
# ---------------------------------------------------------------------------


def _enc_state(buf: _Buf, m: StateMsg) -> None:
    _p_str(buf, m.sender)
    _enc_adds(buf, m.adds)
    _enc_removes(buf, m.removes)
    _enc_vv(buf, m.vv)
    _enc_payloads(buf, m.payloads)


def _dec_state(r: _Reader) -> StateMsg:
    return StateMsg(r.str_(), _dec_adds(r), _dec_removes(r), _dec_vv(r),
                    _dec_payloads(r))


def _enc_delta(buf: _Buf, m: DeltaMsg) -> None:
    _p_str(buf, m.sender)
    _p_u8(buf, 1 if m.compressed else 0)
    _enc_adds(buf, m.adds)
    _enc_removes(buf, m.removes)
    _enc_vv(buf, m.vv)
    _enc_payloads(buf, m.payloads)


def _dec_delta(r: _Reader) -> DeltaMsg:
    sender = r.str_()
    compressed = bool(r.u8())
    return DeltaMsg(sender, _dec_adds(r), _dec_removes(r), _dec_vv(r),
                    _dec_payloads(r), compressed)


def _enc_sync_req(buf: _Buf, m: SyncReq) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_bytes(buf, m.root)
    _p_u8(buf, m.bits)
    _enc_vv(buf, m.vv)


def _dec_sync_req(r: _Reader) -> SyncReq:
    return SyncReq(r.str_(), r.u64(), r.bytes_(), r.u8(), _dec_vv(r))


def _enc_buckets(buf: _Buf, m: BucketsMsg) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u8(buf, m.bits)
    _p_u32(buf, len(m.digests))
    for idx in sorted(m.digests):
        _p_u16(buf, idx)
        _p_bytes(buf, m.digests[idx])


def _dec_buckets(r: _Reader) -> BucketsMsg:
    sender, sid, bits = r.str_(), r.u64(), r.u8()
    digests = {r.u16(): r.bytes_() for _ in range(r.u32())}
    return BucketsMsg(sender, sid, bits, digests)


def _enc_bucket_items(buf: _Buf, m: BucketItemsMsg) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u8(buf, m.bits)
    _enc_adds(buf, m.adds)
    _enc_removes(buf, m.removes)
    _enc_vv(buf, m.vv)
    _p_u32(buf, len(m.want))
    for idx in sorted(m.want):
        _p_u16(buf, idx)


def _dec_bucket_items(r: _Reader) -> BucketItemsMsg:
    sender, sid, bits = r.str_(), r.u64(), r.u8()
    adds, removes, vv = _dec_adds(r), _dec_removes(r), _dec_vv(r)
    want = tuple(r.u16() for _ in range(r.u32()))
    return BucketItemsMsg(sender, sid, bits, adds, removes, vv, want)


def _enc_blob_req(buf: _Buf, m: BlobReq) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u32(buf, len(m.eids))
    for eid in sorted(m.eids):
        _p_str(buf, eid)


def _dec_blob_req(r: _Reader) -> BlobReq:
    sender, sid = r.str_(), r.u64()
    eids = tuple(r.str_() for _ in range(r.u32()))
    return BlobReq(sender, sid, eids)


def _enc_blob_resp(buf: _Buf, m: BlobResp) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u8(buf, 1 if m.compressed else 0)
    _enc_payloads(buf, m.payloads)


def _dec_blob_resp(r: _Reader) -> BlobResp:
    sender, sid = r.str_(), r.u64()
    compressed = bool(r.u8())
    return BlobResp(sender, sid, _dec_payloads(r), compressed)


def _enc_sync_done(buf: _Buf, m: SyncDone) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _enc_vv(buf, m.vv)


def _dec_sync_done(r: _Reader) -> SyncDone:
    return SyncDone(r.str_(), r.u64(), _dec_vv(r))


def _enc_blob_manifest(buf: _Buf, m: BlobManifest) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u32(buf, len(m.entries))
    for e in sorted(m.entries, key=lambda x: x.eid):
        _p_str(buf, e.eid)
        _p_u64(buf, e.total_size)
        _p_u32(buf, e.chunk_size)
        _p_u32(buf, len(e.digests))
        for d in e.digests:
            if len(d) != DIGEST_LEN:
                raise WireError(f"chunk digest must be {DIGEST_LEN}B")
            buf += d


def _dec_blob_manifest(r: _Reader) -> BlobManifest:
    sender, sid = r.str_(), r.u64()
    entries = []
    for _ in range(r.u32()):
        eid, total, csize = r.str_(), r.u64(), r.u32()
        digests = tuple(r.take(DIGEST_LEN) for _ in range(r.u32()))
        entries.append(ManifestEntry(eid, csize, total, digests))
    return BlobManifest(sender, sid, tuple(entries))


def _enc_chunk_req(buf: _Buf, m: ChunkReq) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_str(buf, m.eid)
    _p_u32(buf, m.chunk_size)
    _p_u32(buf, len(m.indices))
    for i in sorted(m.indices):
        _p_u32(buf, i)


def _dec_chunk_req(r: _Reader) -> ChunkReq:
    sender, sid, eid, csize = r.str_(), r.u64(), r.str_(), r.u32()
    indices = tuple(r.u32() for _ in range(r.u32()))
    return ChunkReq(sender, sid, eid, csize, indices)


def _enc_chunk_data(buf: _Buf, m: ChunkData) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_str(buf, m.eid)
    _p_u32(buf, m.index)
    _p_bytes(buf, m.data)


def _dec_chunk_data(r: _Reader) -> ChunkData:
    return ChunkData(r.str_(), r.u64(), r.str_(), r.u32(), r.bytes_())


def _enc_have_req(buf: _Buf, m: HaveReq) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u32(buf, len(set(m.eids)))
    for eid in sorted(set(m.eids)):
        _p_str(buf, eid)


def _dec_have_req(r: _Reader) -> HaveReq:
    sender, sid = r.str_(), r.u64()
    eids = tuple(r.str_() for _ in range(r.u32()))
    return HaveReq(sender, sid, eids)


def _enc_have_map(buf: _Buf, m: HaveMap) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u32(buf, len(m.entries))
    for e in sorted(m.entries, key=lambda x: x.eid):
        if e.n_chunks == 0 and e.bitmap:
            raise WireError("complete HaveEntry must carry no bitmap")
        if e.n_chunks > 0 and len(e.bitmap) != (e.n_chunks + 7) // 8:
            raise WireError(f"HaveEntry bitmap must be "
                            f"{(e.n_chunks + 7) // 8}B for {e.n_chunks} "
                            f"chunks, got {len(e.bitmap)}B")
        _p_str(buf, e.eid)
        _p_u32(buf, e.n_chunks)
        if e.n_chunks:
            buf += e.bitmap


def _dec_have_map(r: _Reader) -> HaveMap:
    sender, sid = r.str_(), r.u64()
    entries = []
    for _ in range(r.u32()):
        eid, n = r.str_(), r.u32()
        bitmap = r.take((n + 7) // 8) if n else b""
        entries.append(HaveEntry(eid, n, bitmap))
    return HaveMap(sender, sid, tuple(entries))


def _enc_sparse_manifest(buf: _Buf, m: SparseManifest) -> None:
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_u32(buf, len(m.entries))
    for e in sorted(m.entries, key=lambda x: x.eid):
        me = e.manifest
        _p_str(buf, me.eid)
        _p_u64(buf, me.total_size)
        _p_u32(buf, me.chunk_size)
        _p_u32(buf, len(me.digests))
        for d in me.digests:
            if len(d) != DIGEST_LEN:
                raise WireError(f"chunk digest must be {DIGEST_LEN}B")
            buf += d
        _p_u32(buf, len(e.leaves))
        for l in e.leaves:
            if len(l.digest) != DIGEST_LEN:
                raise WireError(f"leaf digest must be {DIGEST_LEN}B")
            _p_str(buf, l.path)
            buf += l.digest
            _enc_tensor_header(buf, l.dtype, tuple(l.shape))
            # quantization trailer: u8 flag, then fp32 scale if set
            if l.scale is None:
                buf.append(0)
            else:
                buf.append(1)
                buf += struct.pack("<f", float(l.scale))


def _dec_sparse_manifest(r: _Reader) -> SparseManifest:
    sender, sid = r.str_(), r.u64()
    entries = []
    for _ in range(r.u32()):
        eid, total, csize = r.str_(), r.u64(), r.u32()
        digests = tuple(r.take(DIGEST_LEN) for _ in range(r.u32()))
        leaves = []
        for _ in range(r.u32()):
            path = r.str_()
            digest = r.take(DIGEST_LEN)
            dtype, shape = _dec_tensor_header(r)
            flag = r.take(1)[0]
            if flag not in (0, 1):
                raise WireError(f"bad leaf-ref scale flag {flag}")
            scale = (struct.unpack("<f", r.take(4))[0] if flag
                     else None)
            leaves.append(LeafRef(path, digest, dtype, shape, scale))
        entries.append(SparseManifestEntry(
            ManifestEntry(eid, csize, total, digests), tuple(leaves)))
    return SparseManifest(sender, sid, tuple(entries))


def _enc_resolve_spec(buf: _Buf, m: ResolveSpecMsg) -> None:
    from repro_torch.api.spec import MergeSpec, SpecError
    if not isinstance(m.spec, MergeSpec):
        raise WireError(f"ResolveSpecMsg.spec must be a MergeSpec, "
                        f"got {type(m.spec).__name__}")
    try:
        raw = m.spec.encode()
        # the strict round trip at ENCODE time: a receiver rejects any
        # spec that fails strict validation, so none is emitted
        MergeSpec.decode(raw)
    except (SpecError, KeyError) as e:
        raise WireError(f"MergeSpec not gossipable (a peer's strict "
                        f"decode would reject it): {e}") from e
    _p_str(buf, m.sender)
    _p_u64(buf, m.sid)
    _p_bytes(buf, raw)


def _dec_resolve_spec(r: _Reader) -> ResolveSpecMsg:
    from repro_torch.api.spec import MergeSpec, SpecError
    sender, sid, raw = r.str_(), r.u64(), r.bytes_()
    try:
        spec = MergeSpec.decode(raw)
    except (SpecError, KeyError, ValueError, struct.error) as e:
        # every parse failure surfaces as WireError, so a hostile frame
        # cannot abort a receiver's delivery drain with a foreign type
        raise WireError(f"bad MergeSpec payload: {e}") from e
    return ResolveSpecMsg(sender, sid, spec)


_ENCODERS = {
    MSG_STATE: _enc_state, MSG_DELTA: _enc_delta,
    MSG_SYNC_REQ: _enc_sync_req, MSG_BUCKETS: _enc_buckets,
    MSG_BUCKET_ITEMS: _enc_bucket_items, MSG_BLOB_REQ: _enc_blob_req,
    MSG_BLOB_RESP: _enc_blob_resp, MSG_SYNC_DONE: _enc_sync_done,
    MSG_BLOB_MANIFEST: _enc_blob_manifest, MSG_CHUNK_REQ: _enc_chunk_req,
    MSG_CHUNK_DATA: _enc_chunk_data, MSG_HAVE_REQ: _enc_have_req,
    MSG_HAVE_MAP: _enc_have_map, MSG_RESOLVE_SPEC: _enc_resolve_spec,
    MSG_SPARSE_MANIFEST: _enc_sparse_manifest,
}
_DECODERS = {
    MSG_STATE: _dec_state, MSG_DELTA: _dec_delta,
    MSG_SYNC_REQ: _dec_sync_req, MSG_BUCKETS: _dec_buckets,
    MSG_BUCKET_ITEMS: _dec_bucket_items, MSG_BLOB_REQ: _dec_blob_req,
    MSG_BLOB_RESP: _dec_blob_resp, MSG_SYNC_DONE: _dec_sync_done,
    MSG_BLOB_MANIFEST: _dec_blob_manifest, MSG_CHUNK_REQ: _dec_chunk_req,
    MSG_CHUNK_DATA: _dec_chunk_data, MSG_HAVE_REQ: _dec_have_req,
    MSG_HAVE_MAP: _dec_have_map, MSG_RESOLVE_SPEC: _dec_resolve_spec,
    MSG_SPARSE_MANIFEST: _dec_sparse_manifest,
}

# Public registry: every frame tag the codec accepts, with its message
# class (the reference's, tag for tag).
MESSAGE_TYPES: Dict[int, type] = {
    MSG_STATE: StateMsg, MSG_DELTA: DeltaMsg, MSG_SYNC_REQ: SyncReq,
    MSG_BUCKETS: BucketsMsg, MSG_BUCKET_ITEMS: BucketItemsMsg,
    MSG_BLOB_REQ: BlobReq, MSG_BLOB_RESP: BlobResp,
    MSG_SYNC_DONE: SyncDone, MSG_BLOB_MANIFEST: BlobManifest,
    MSG_CHUNK_REQ: ChunkReq, MSG_CHUNK_DATA: ChunkData,
    MSG_HAVE_REQ: HaveReq, MSG_HAVE_MAP: HaveMap,
    MSG_RESOLVE_SPEC: ResolveSpecMsg,
    MSG_SPARSE_MANIFEST: SparseManifest,
}


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


_V2_TYPES = frozenset({MSG_HAVE_REQ, MSG_HAVE_MAP, MSG_RESOLVE_SPEC,
                       MSG_SPARSE_MANIFEST})


def frame_version(mtype: int) -> int:
    """The version stamp a frame of `mtype` carries (see HEADER note)."""
    return 2 if mtype in _V2_TYPES else 1


def encode_message(msg: Message) -> bytes:
    """Message dataclass -> framed bytes."""
    mtype = getattr(msg, "type", None)
    enc = _ENCODERS.get(mtype)
    if enc is None:
        raise WireError(f"not a wire message: {type(msg)}")
    payload = _Buf()
    enc(payload, msg)
    if len(payload) > _U32_MAX:
        raise WireError(f"a {len(payload)}-byte payload does not fit one "
                        "frame (4 GiB); stream it in chunks")
    return b"".join([HEADER.pack(MAGIC, frame_version(mtype), mtype,
                                 len(payload)),
                     *payload.parts(), TRAILER.pack(payload.crc32())])


def decode_frame(buf, pos: int = 0, *,
                 device: Any = None) -> Tuple[Message, int]:
    """Decode one frame starting at `pos`; returns (message, next_pos).
    Tensors land on `device` (CUDA unless the caller names another).

    Validates magic, version, length, and checksum; raises WireError on
    any mismatch so corrupted frames are rejected, never half-applied.
    """
    mv = memoryview(buf)
    if len(mv) - pos < HEADER.size:
        raise WireError("truncated header")
    magic, version, mtype, plen = HEADER.unpack_from(mv, pos)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if version not in ACCEPTED_VERSIONS:
        raise WireError(f"unsupported wire version {version}")
    body_start = pos + HEADER.size
    body_end = body_start + plen
    if len(mv) < body_end + TRAILER.size:
        raise WireError("truncated frame")
    payload = mv[body_start:body_end]
    (crc,) = TRAILER.unpack_from(mv, body_end)
    if crc != (zlib.crc32(payload) & 0xFFFFFFFF):
        raise WireError("checksum mismatch")
    dec = _DECODERS.get(mtype)
    if dec is None:
        raise WireError(f"unknown message type 0x{mtype:02x}")
    r = _Reader(payload, device=device)
    msg = dec(r)
    if r.pos != len(payload):
        raise WireError(f"{len(payload) - r.pos} trailing payload bytes")
    return msg, body_end + TRAILER.size


def decode_message(buf, *, device: Any = None) -> Message:
    """Decode exactly one frame occupying the whole buffer."""
    msg, end = decode_frame(buf, device=device)
    if end != len(memoryview(buf)):
        raise WireError(f"{len(buf) - end} trailing bytes after frame")
    return msg


def frame_size(msg: Message) -> int:
    return len(encode_message(msg))


# ---------------------------------------------------------------------------
# Standalone blob (payload value) codec — the unit of chunked transfer
# ---------------------------------------------------------------------------


def encode_blob(value: Any) -> bytes:
    """Canonical bytes of one store payload (chunk digests cover these)."""
    buf = _Buf()
    encode_value(buf, value)
    return buf.getvalue()


def decode_blob(blob, *, device: Any = None) -> Any:
    """One store payload from its canonical bytes; tensors land on
    `device` (CUDA unless the caller names another)."""
    r = _Reader(blob, device=device)
    value = decode_value(r)
    if r.pos != len(r.buf):
        raise WireError(f"{len(r.buf) - r.pos} trailing blob bytes")
    return value


# chunks hashed at once by chunk_digests' threads (hashlib releases the
# GIL over large buffers)
_HASH_THREADS = max(1, min(8, os.cpu_count() or 1))


def chunk_digests(blob, chunk_size: int) -> Tuple[bytes, ...]:
    """Per-chunk SHA-256 over `blob` split at `chunk_size` boundaries.
    The chunks are independent, so a blob of many chunks is hashed on
    several threads; the digests come back in chunk order."""
    if chunk_size <= 0:
        raise WireError("chunk_size must be positive")
    mv = memoryview(blob)
    starts = range(0, len(mv), chunk_size)

    def digest(i: int) -> bytes:
        return hashlib.sha256(mv[i:i + chunk_size]).digest()

    if len(starts) < 2 * _HASH_THREADS:
        return tuple(digest(i) for i in starts)
    with ThreadPoolExecutor(_HASH_THREADS) as pool:
        return tuple(pool.map(digest, starts))


def manifest_entry(eid: str, blob, chunk_size: int) -> ManifestEntry:
    return ManifestEntry(eid, chunk_size, len(memoryview(blob)),
                         chunk_digests(blob, chunk_size))


def leaf_refs(payload: Any) -> Tuple[LeafRef, ...]:
    """Per-leaf planner refs of a payload pytree, sorted by path (the
    canonical coverage order).

    Quantized payloads (`CompressedTree`) produce scale-carrying refs:
    digests are computed on a transient per-leaf dequantization (one
    leaf live at a time — the full tree is never densified), and the
    announced dtype/shape describe the dequantized tensor the
    receiver's planner will key against."""
    from repro_torch.core.hashing import tensor_digest
    if isinstance(payload, CompressedTree):
        payload = compressed_tree_to_structure(payload)
    flat, _ = pytree.flatten_with_path(payload)
    refs = []
    for p, leaf in flat:
        if isinstance(leaf, CompressedLeaf):
            dense = dequantize_leaf(leaf)
            refs.append(LeafRef(pytree.keystr(p), tensor_digest(dense),
                                dtype_name(dense.dtype),
                                tuple(dense.shape), float(leaf.scale)))
        else:
            refs.append(LeafRef(pytree.keystr(p), tensor_digest(leaf),
                                dtype_name(leaf.dtype),
                                tuple(leaf.shape)))
    return tuple(sorted(refs, key=lambda r: r.path))


def sparse_manifest_entry(eid: str, payload: Any, blob,
                          chunk_size: int) -> SparseManifestEntry:
    """Leaf-level announcement of one contribution: chunking manifest of
    its canonical blob encoding + one LeafRef per carried leaf."""
    return SparseManifestEntry(manifest_entry(eid, blob, chunk_size),
                               leaf_refs(payload))


# ---------------------------------------------------------------------------
# State/Delta conversions
# ---------------------------------------------------------------------------


def state_to_msg(state: CRDTMergeState, sender: str) -> StateMsg:
    return StateMsg(sender, state.adds, state.removes, state.vv,
                    dict(state.store))


def msg_to_state(msg: StateMsg, *, keep_quantized: bool = False,
                 device: Any = None) -> CRDTMergeState:
    """The receiver's state, its payloads on `device` (CUDA unless the
    caller names another).

    Compressed blobs decompress on arrival by default: the store then
    holds the dequantized wire-format tensors (content identity,
    Assumption 11). `keep_quantized=True` stores the CompressedTree
    as-is — the merge engine plans and merges directly from the int8
    payloads (merge on arrival), and content identity is unchanged
    because digests are always computed on dequantized values."""
    from repro_torch.api.replica import resolve_device
    dev = resolve_device(device)
    store = {}
    for eid, p in msg.payloads.items():
        p = to_device(p, dev)
        if not keep_quantized and isinstance(p, CompressedTree):
            p = decompress_tree(p)
        store[eid] = p
    return CRDTMergeState(msg.adds, msg.removes, msg.vv, store)


def delta_to_msg(delta: Delta, sender: str) -> DeltaMsg:
    return DeltaMsg(sender, delta.adds, delta.removes, delta.vv,
                    dict(delta.payloads), delta.compressed)


def msg_to_delta(msg: DeltaMsg) -> Delta:
    return Delta(msg.adds, msg.removes, msg.vv, dict(msg.payloads),
                 msg.compressed)
