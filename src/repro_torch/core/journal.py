"""Durable storage tier: crash-safe blob log + Layer-1 write-ahead
journal (`repro.core.journal`, byte for byte).

Three on-disk structures live in one storage directory (the normative
record table is in docs/PROTOCOL.md):

  * `blobs.log`    — append-only content-addressed blob log. One
    `BlobRecord` per store payload: the eid, a SHA-256 over the blob's
    canonical wire encoding (`net.wire.encode_blob`), and the bytes
    themselves. The in-memory index (eid -> file offset) is rebuilt by
    scanning on open, so the log needs no side files.
  * `journal.log`  — the Layer-1 WAL. One `JournalDelta` per
    acknowledged metadata transition: the *new* add entries (including
    sparse `leaf_paths` coverage), the new tombstones, and the merged
    version vector, in the canonical wire encoding
    (`net.wire.encode_layer1`). Replay is a CRDT join, so a duplicated
    or re-applied record is harmless.
  * `snapshot.bin` — periodic compaction: one `Snapshot` record holding
    the full (A, R, V). Written to a temp file, fsynced, atomically
    renamed; the journal is truncated only after the rename lands.
    Recovery = snapshot ⊔ journal replay — correct whichever side of
    the rename/truncate a crash fell on.

Every record rides the same envelope — `length u32 | type u8 | payload
| crc32 u32` — and recovery accepts exactly the longest clean prefix of
each log: the scan stops at the first truncated or checksum-failing
record and truncates the file there, so a torn tail write costs at most
the final, never-acknowledged record. An operation is *acknowledged*
when `DurableStore.record_transition` returns.

For the same op sequence the files are the reference's, byte for byte,
and a directory written by either package is recovered by the other
(tests/test_torch_journal.py). What differs is how bytes move, for
blobs of several GB: a record is written from its parts (no
concatenated copy), its CRC-32 and SHA-256 computed incrementally; a
log is scanned on open in bounded reads, keeping only the payload
prefix a blob record's eid needs; a blob is read back into one buffer
and sliced, not copied; `DurableStore.load` decodes payloads onto the
device it was given (CUDA unless the caller asks for the CPU).

Crash-point injection
---------------------
`CrashPoint.maybe_crash(name)` is threaded through every durability
write path, between every pair of steps whose ordering matters (before
an append, mid-record for torn writes, before fsync, before the
in-memory index/ack, and around the snapshot write/rename/truncate
sequence). Unarmed, every call is a dict lookup that misses; a test
arms one point (`CrashPoint.arm(name)`) and the next hit raises
`SimulatedCrash` with the file system in exactly the state a power cut
at that instant would leave. The points are the reference's, declared
in the same order, and the registry is enumerable
(`CrashPoint.registered()`). The registry is module state: a test that
arms a point disarms it (`CrashPoint.disarm_all()`) when it ends.
"""
from __future__ import annotations

import hashlib
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.state import AddEntry, CRDTMergeState
from repro_torch.core.version_vector import VersionVector
from repro_torch.net.wire import (
    decode_blob, decode_layer1, encode_blob, encode_layer1)
from repro_torch.obs import MetricsRegistry

__all__ = [
    "CrashPoint", "SimulatedCrash", "BlobLog", "StateJournal",
    "DurableStore", "RECORD_TYPES", "REC_BLOB", "REC_DELTA",
    "REC_SNAPSHOT", "JournalError", "scan_records",
]


class JournalError(ValueError):
    """Malformed durable-store record or misused log handle."""


# ---------------------------------------------------------------------------
# Crash-point injection
# ---------------------------------------------------------------------------


class SimulatedCrash(BaseException):
    """Raised by an armed crash point. Derives from BaseException so no
    internal `except Exception` recovery path can accidentally swallow
    the simulated power cut."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point


class CrashPoint:
    """Deterministic crash-injection registry (process-global).

    Points are declared once at module import (`_declare`), so the set
    of crash sites is a static, enumerable property of the code — the
    test suite iterates `registered()` and kills the process state at
    every one. `arm(name, at=k)` makes the k-th subsequent hit of
    `maybe_crash(name)` raise `SimulatedCrash`; unarmed points cost one
    dict lookup.
    """

    _declared: Dict[str, str] = {}
    _armed: Dict[str, int] = {}
    hits: Dict[str, int] = {}

    @classmethod
    def _declare(cls, name: str, help: str) -> str:  # noqa: A002
        cls._declared[name] = help
        return name

    @classmethod
    def registered(cls) -> Tuple[str, ...]:
        return tuple(sorted(cls._declared))

    @classmethod
    def describe(cls, name: str) -> str:
        return cls._declared[name]

    @classmethod
    def arm(cls, name: str, at: int = 1) -> None:
        if name not in cls._declared:
            raise KeyError(f"unknown crash point {name!r}")
        if at < 1:
            raise ValueError("at must be >= 1")
        cls._armed[name] = at

    @classmethod
    def disarm_all(cls) -> None:
        cls._armed.clear()
        cls.hits.clear()

    @classmethod
    def maybe_crash(cls, name: str) -> None:
        if not cls._armed:          # production fast path
            return
        left = cls._armed.get(name)
        if left is None:
            return
        cls.hits[name] = cls.hits.get(name, 0) + 1
        if left <= 1:
            del cls._armed[name]
            raise SimulatedCrash(name)
        cls._armed[name] = left - 1


CP_BLOB_PRE_APPEND = CrashPoint._declare(
    "blob.pre_append", "before any byte of a blob record is written")
CP_BLOB_TORN_WRITE = CrashPoint._declare(
    "blob.torn_write", "half a blob record written and flushed")
CP_BLOB_PRE_SYNC = CrashPoint._declare(
    "blob.pre_sync", "blob record written, before fsync")
CP_BLOB_PRE_INDEX = CrashPoint._declare(
    "blob.pre_index", "blob record durable, before the in-memory index")
CP_JOURNAL_PRE_APPEND = CrashPoint._declare(
    "journal.pre_append", "before any byte of a journal record")
CP_JOURNAL_TORN_WRITE = CrashPoint._declare(
    "journal.torn_write", "half a journal record written and flushed")
CP_JOURNAL_PRE_SYNC = CrashPoint._declare(
    "journal.pre_sync", "journal record written, before fsync")
CP_JOURNAL_PRE_ACK = CrashPoint._declare(
    "journal.pre_ack", "journal record durable, before acknowledgement")
CP_SNAP_PRE_WRITE = CrashPoint._declare(
    "snapshot.pre_write", "before the snapshot temp file is written")
CP_SNAP_PRE_RENAME = CrashPoint._declare(
    "snapshot.pre_rename", "snapshot temp fsynced, before atomic rename")
CP_SNAP_PRE_TRUNCATE = CrashPoint._declare(
    "snapshot.pre_truncate", "snapshot renamed, before journal truncate")
CP_BLOB_PRE_COMPACT_RENAME = CrashPoint._declare(
    "blob.pre_compact_rename",
    "compacted blob log fsynced, before atomic rename")


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


REC_BLOB = 0x01
REC_DELTA = 0x02
REC_SNAPSHOT = 0x03

# The reference's on-disk record table (docs/PROTOCOL.md), tag for tag.
RECORD_TYPES: Dict[int, str] = {
    REC_BLOB: "BlobRecord",
    REC_DELTA: "JournalDelta",
    REC_SNAPSHOT: "Snapshot",
}

_LEN = struct.Struct(">I")          # length of (type + payload)
_CRC = struct.Struct(">I")          # zlib.crc32 over (type + payload)
_ENVELOPE = _LEN.size + _CRC.size   # bytes beyond type + payload


def _parts_of(payload: Any) -> List[Any]:
    """A record payload as a list of bytes-like parts (one bytes-like
    object, or a sequence of them)."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return [payload]
    return list(payload)


def _nbytes(b: Any) -> int:
    return memoryview(b).nbytes


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, row) for row in mat]


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC-32 of A || B from crc(A), crc(B) and len(B) (zlib's
    `crc32_combine`, which Python's zlib does not expose): crc1 is
    carried over len2 zero bytes by squaring the GF(2) operator of one
    zero bit, then crc2 is folded in."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]
    even = _gf2_square(odd)             # two zero bits
    odd = _gf2_square(even)             # four zero bits
    while True:
        even = _gf2_square(odd)         # the first: one zero byte
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def _pack_record(rtype: int, payload: Any,
                 tail_crc: Optional[int] = None) -> List[Any]:
    """The record's bytes as parts: `length | type | payload... | crc`.
    The CRC-32 runs over the parts in turn (no concatenated copy);
    `tail_crc`, the CRC-32 of the last part computed elsewhere, is
    combined in rather than computed again."""
    if rtype not in RECORD_TYPES:
        raise JournalError(f"unknown record type 0x{rtype:02x}")
    parts = _parts_of(payload)
    head = bytes([rtype])
    crc = zlib.crc32(head)
    for p in parts if tail_crc is None else parts[:-1]:
        crc = zlib.crc32(p, crc)
    if tail_crc is not None:
        crc = _crc32_combine(crc, tail_crc, _nbytes(parts[-1]))
    blen = 1 + sum(_nbytes(p) for p in parts)
    return [_LEN.pack(blen) + head, *parts, _CRC.pack(crc & 0xFFFFFFFF)]


def _sha256_and_crc32(data) -> Tuple[bytes, int]:
    """SHA-256 and CRC-32 of the same bytes, on two threads at once
    (hashlib and zlib both release the GIL over large buffers)."""
    with ThreadPoolExecutor(1) as pool:
        sha = pool.submit(lambda: hashlib.sha256(data).digest())
        crc = zlib.crc32(data)
        return sha.result(), crc


def _record_bytes(rtype: int, payload: Any) -> bytes:
    return b"".join(_pack_record(rtype, payload))


def scan_records(raw) -> Tuple[List[Tuple[int, int, bytes]], int]:
    """Parse the longest clean prefix of an append-only log.

    Returns `([(offset, rtype, payload), ...], clean_end)`: every record
    whose length, type, and CRC-32 check out, in file order, plus the
    byte offset where the clean prefix ends. Anything after `clean_end`
    — a torn tail, flipped bytes, a half-written length word — is
    unrecoverable garbage by construction and the caller truncates it.
    """
    mv = memoryview(raw)
    out: List[Tuple[int, int, bytes]] = []
    pos = 0
    n = len(mv)
    while pos + _LEN.size <= n:
        (blen,) = _LEN.unpack_from(mv, pos)
        body_end = pos + _LEN.size + blen
        if blen < 1 or body_end + _CRC.size > n:
            break
        body = mv[pos + _LEN.size:body_end]
        (crc,) = _CRC.unpack_from(mv, body_end)
        if crc != (zlib.crc32(body) & 0xFFFFFFFF):
            break
        if body[0] not in RECORD_TYPES:
            break
        out.append((pos, body[0], bytes(body[1:])))
        pos = body_end + _CRC.size
    return out, pos


# bytes read at once while scanning a log on open
_SCAN_READ = 64 * 2 ** 20


def _scan_file(path: str, keep: Optional[int]
               ) -> Tuple[List[Tuple[int, int, bytes]], int]:
    """`scan_records` over a file, in reads of at most `_SCAN_READ`
    bytes: a record's CRC-32 runs over its body as it streams past.
    Each record keeps its payload's first `keep` bytes (all of it with
    `keep=None`), so a multi-GB blob is never held in memory here."""
    out: List[Tuple[int, int, bytes]] = []
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return out, 0
    with f:
        n = os.fstat(f.fileno()).st_size
        pos = 0
        while pos + _LEN.size <= n:
            f.seek(pos)
            head = f.read(_LEN.size + 1)
            (blen,) = _LEN.unpack_from(head)
            body_end = pos + _LEN.size + blen
            if blen < 1 or body_end + _CRC.size > n:
                break
            rtype = head[_LEN.size]
            want = blen - 1 if keep is None else min(keep, blen - 1)
            crc = zlib.crc32(head[_LEN.size:])
            kept = bytearray()
            left = blen - 1
            while left:
                chunk = f.read(min(left, _SCAN_READ))
                if not chunk:
                    break
                if len(kept) < want:
                    kept += chunk[:want - len(kept)]
                crc = zlib.crc32(chunk, crc)
                left -= len(chunk)
            if left:
                break
            (stored,) = _CRC.unpack(f.read(_CRC.size))
            if stored != (crc & 0xFFFFFFFF) or rtype not in RECORD_TYPES:
                break
            out.append((pos, rtype, bytes(kept)))
            pos = body_end + _CRC.size
    return out, pos


def _fsync_dir(path: str) -> None:
    """Make a rename/creation in `path` durable (best-effort on
    platforms whose directories cannot be fsynced)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _RecordLog:
    """One append-only record file with torn-tail repair on open.

    `crash_tag` prefixes the crash points threaded through `append`
    ("blob" or "journal"). Appends are written in two halves with a
    crash point between them — the torn-write site — and flushed before
    each point so the bytes on disk at crash time are exactly what a
    power cut there would leave. `keep` bounds the payload bytes each
    record found on open keeps in memory (None: all of them).
    """

    def __init__(self, path: str, crash_tag: str, *, sync: bool = True,
                 obs: Optional[MetricsRegistry] = None,
                 keep: Optional[int] = None):
        self.path = path
        self.crash_tag = crash_tag
        self.sync = sync
        self.keep = keep
        self.obs = obs if obs is not None else MetricsRegistry()
        records, clean_end = _scan_file(self.path, keep)
        self._repair(clean_end)
        self.records = records          # scan result from open
        self.size = clean_end
        self._f = open(self.path, "ab")

    def _repair(self, clean_end: int) -> None:
        try:
            actual = os.path.getsize(self.path)
        except OSError:
            actual = 0
        if actual > clean_end:
            self.obs.counter("journal_events_total").inc(
                event=f"{self.crash_tag}_torn_tail")
            with open(self.path, "r+b") as f:
                f.truncate(clean_end)
                f.flush()
                os.fsync(f.fileno())

    def _write(self, parts: List[Any], start: int, stop: int) -> None:
        """Write bytes [start, stop) of the record held as `parts`."""
        pos = 0
        for p in parts:
            mv = memoryview(p).cast("B")
            lo, hi = max(start - pos, 0), min(stop - pos, len(mv))
            if lo < hi:
                self._f.write(mv[lo:hi])
            pos += len(mv)

    def append(self, rtype: int, payload: Any,
               tail_crc: Optional[int] = None) -> int:
        """Append one record (`payload`: bytes, or a sequence of
        bytes-like parts; `tail_crc` as in `_pack_record`); returns its
        starting offset. The record is durable (flushed + fsynced under
        the default policy) when this returns."""
        parts = _pack_record(rtype, payload, tail_crc)
        total = sum(_nbytes(p) for p in parts)
        offset = self.size
        CrashPoint.maybe_crash(f"{self.crash_tag}.pre_append")
        half = total // 2
        self._write(parts, 0, half)
        self._f.flush()
        CrashPoint.maybe_crash(f"{self.crash_tag}.torn_write")
        self._write(parts, half, total)
        self._f.flush()
        CrashPoint.maybe_crash(f"{self.crash_tag}.pre_sync")
        if self.sync:
            os.fsync(self._f.fileno())
            self.obs.counter("journal_events_total").inc(event="fsync")
        self.size += total
        self.obs.counter("journal_events_total").inc(
            event=f"{self.crash_tag}_append")
        return offset

    def read_at(self, offset: int, also: Optional[Callable] = None
                ) -> Tuple[int, memoryview, Any]:
        """Re-read and re-verify one record at `offset` (blob fetch).
        The payload comes back as a view of one buffer read from disk;
        `also(payload)`, when given, runs on a second thread while the
        CRC-32 is checked, and its result comes back third."""
        with open(self.path, "rb") as f:
            f.seek(offset)
            head = f.read(_LEN.size)
            if len(head) < _LEN.size:
                raise JournalError(f"truncated record at {offset}")
            (blen,) = _LEN.unpack_from(head)
            body = bytearray(blen)
            got = f.readinto(body)
            tail = f.read(_CRC.size)
        if got < blen or len(tail) < _CRC.size:
            raise JournalError(f"truncated record at {offset}")
        payload = memoryview(body)[1:]
        with ThreadPoolExecutor(1) as pool:
            side = pool.submit(also, payload) if also is not None else None
            (crc,) = _CRC.unpack_from(tail)
            if crc != (zlib.crc32(body) & 0xFFFFFFFF):
                raise JournalError(f"checksum mismatch at {offset}")
            return body[0], payload, side.result() if side else None

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()


# ---------------------------------------------------------------------------
# Blob log
# ---------------------------------------------------------------------------


_DIGEST_LEN = 32
# payload bytes a blob record keeps from the scan on open: enough for
# its eid (u32 length + the eid's UTF-8 bytes)
_BLOB_SCAN_KEEP = 64 * 1024


class BlobLog:
    """Persistent append-only content-addressed blob log.

    A `BlobRecord` payload is `eid str | sha256 32B | blob bytes` where
    the digest covers the blob bytes (the canonical wire encoding from
    `net.wire.encode_blob`) — every record verifies on its own,
    independent of the eid's provenance. The in-memory index maps eid to
    the record's file offset and is rebuilt by scanning on open; `get`
    re-reads from disk and re-verifies CRC + SHA-256, so a latent disk
    corruption surfaces as an error, never as wrong bytes.

    Content-addressed means idempotent: `put` of an already-indexed eid
    is a no-op, so replayed or re-synced blobs never grow the log.
    """

    def __init__(self, path: str, *, sync: bool = True,
                 obs: Optional[MetricsRegistry] = None):
        self.obs = obs if obs is not None else MetricsRegistry()
        self._log = _RecordLog(path, "blob", sync=sync, obs=self.obs,
                               keep=_BLOB_SCAN_KEEP)
        self._index: Dict[str, int] = {}        # eid -> record offset
        for offset, rtype, payload in self._log.records:
            if rtype != REC_BLOB:
                continue
            self._index[self._parse_eid(payload)] = offset
            self.obs.counter("journal_events_total").inc(
                event="blob_replayed")
        self._log.records = []                  # scan buffers released

    @staticmethod
    def _parse_eid(payload) -> str:
        if len(payload) < 4:
            raise JournalError("short blob record")
        (elen,) = struct.unpack_from(">I", payload)
        if len(payload) < 4 + elen:
            raise JournalError("short blob record")
        return str(payload[4:4 + elen], "utf-8")

    @staticmethod
    def _parse(payload) -> Tuple[str, bytes, memoryview]:
        mv = memoryview(payload)
        eid = BlobLog._parse_eid(mv)
        start = 4 + len(eid.encode())
        need = start + _DIGEST_LEN
        if len(mv) < need:
            raise JournalError("short blob record")
        return eid, bytes(mv[start:need]), mv[need:]

    def put(self, eid: str, blob) -> None:
        """Append one blob; durable (and indexed) on return."""
        if eid in self._index:
            self.obs.counter("journal_events_total").inc(
                event="blob_dedup")
            return
        e = eid.encode()
        sha, crc = _sha256_and_crc32(blob)
        head = struct.pack(">I", len(e)) + e + sha
        offset = self._log.append(REC_BLOB, (head, blob), tail_crc=crc)
        CrashPoint.maybe_crash(CP_BLOB_PRE_INDEX)
        self._index[eid] = offset

    def get(self, eid: str) -> memoryview:
        """Blob bytes for `eid`, CRC- and SHA-256-verified from disk (a
        view of the record read back)."""
        def sha_of_blob(payload):
            # a record too short to parse fails below, after the CRC
            try:
                return hashlib.sha256(self._parse(payload)[2]).digest()
            except JournalError:
                return None

        rtype, payload, digest = self._log.read_at(self._index[eid],
                                                   sha_of_blob)
        if rtype != REC_BLOB:
            raise JournalError(f"offset for {eid[:16]} is not a blob")
        got_eid, sha, blob = self._parse(payload)
        if got_eid != eid:
            raise JournalError(f"blob record eid mismatch for {eid[:16]}")
        if digest != sha:
            raise JournalError(f"blob bytes corrupt for {eid[:16]}")
        return blob

    def eids(self) -> FrozenSet[str]:
        return frozenset(self._index)

    def __contains__(self, eid: str) -> bool:
        return eid in self._index

    def __len__(self) -> int:
        return len(self._index)

    @property
    def size(self) -> int:
        return self._log.size

    def compact(self, live: FrozenSet[str]) -> int:
        """Rewrite the log keeping only `live` eids (atomic: new log is
        written aside, fsynced, renamed over the old). Returns bytes
        reclaimed."""
        drop = [e for e in self._index if e not in live]
        if not drop:
            return 0
        before = self._log.size
        tmp = self.path + ".tmp"
        new_index: Dict[str, int] = {}
        with open(tmp, "wb") as f:
            for eid in sorted(self._index):
                if eid not in live:
                    continue
                rtype, payload, _ = self._log.read_at(self._index[eid])
                new_index[eid] = f.tell()
                for part in _pack_record(rtype, payload):
                    f.write(part)
            f.flush()
            os.fsync(f.fileno())
            new_size = f.tell()
        CrashPoint.maybe_crash(CP_BLOB_PRE_COMPACT_RENAME)
        self._log.close()
        os.replace(tmp, self.path)
        _fsync_dir(os.path.dirname(self.path) or ".")
        self._log = _RecordLog(self.path, "blob", sync=self._log.sync,
                               obs=self.obs, keep=_BLOB_SCAN_KEEP)
        self._log.records = []
        self._index = new_index
        self._log.size = new_size
        self.obs.counter("journal_events_total").inc(event="blob_compact")
        return before - new_size

    @property
    def path(self) -> str:
        return self._log.path

    def flush(self) -> None:
        self._log.flush()

    def close(self) -> None:
        self._log.close()


# ---------------------------------------------------------------------------
# Layer-1 WAL + snapshots
# ---------------------------------------------------------------------------


_EPOCH = struct.Struct(">Q")


def _split_epoch(payload: bytes):
    """(epoch, adds, removes, vv) from an epoch-stamped record payload."""
    if len(payload) < 8:
        raise JournalError("short journal record")
    (epoch,) = _EPOCH.unpack_from(payload)
    adds, removes, vv = decode_layer1(payload[8:])
    return epoch, adds, removes, vv


class StateJournal:
    """Write-ahead log of Layer-1 (A, R, V) transitions with periodic
    compacted snapshots.

    `append_delta` records the *new* entries of one acknowledged
    transition; `load()` = snapshot (if any) joined with every journal
    record of the snapshot's epoch, each a CRDT join, so replay is
    idempotent and insensitive to the crash landing between any two
    steps of `snapshot()`'s write → rename → truncate sequence.

    Every record carries a u64 *snapshot epoch*, bumped at each
    snapshot. Recovery skips deltas older than the snapshot's epoch:
    they are redundant joins for monotone history, but after a
    NON-monotone snapshot (tombstone GC shrank A/R) a crash between the
    snapshot rename and the journal truncate would otherwise replay
    them and resurrect GC'd entries. The epoch stamp makes the stale
    journal suffix inert either way.
    """

    def __init__(self, dirname: str, *, sync: bool = True,
                 obs: Optional[MetricsRegistry] = None):
        self.dirname = dirname
        self.obs = obs if obs is not None else MetricsRegistry()
        self.snap_path = os.path.join(dirname, "snapshot.bin")
        # a leftover temp file is a snapshot that never renamed — dead
        tmp = self.snap_path + ".tmp"
        if os.path.exists(tmp):
            os.unlink(tmp)
        self._log = _RecordLog(os.path.join(dirname, "journal.log"),
                               "journal", sync=sync, obs=self.obs)
        self.records_since_snapshot = len(self._log.records)
        snap = self._read_snapshot()
        self.epoch = snap[0] if snap is not None else 0

    def _read_snapshot(self):
        try:
            with open(self.snap_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        records, _ = scan_records(raw)
        if len(records) != 1 or records[0][1] != REC_SNAPSHOT:
            # an unparseable snapshot can only be pre-durable garbage
            # (the rename is atomic and follows the fsync): ignore it —
            # the journal still holds everything since the last GOOD
            # snapshot, because truncation happens only after a rename
            return None
        epoch, adds, removes, vv = _split_epoch(records[0][2])
        return epoch, adds, removes, vv

    def load(self) -> Tuple[FrozenSet[AddEntry], FrozenSet[str],
                            VersionVector]:
        """Recovered Layer-1 metadata: snapshot ⊔ same-epoch clean
        journal prefix."""
        adds: FrozenSet[AddEntry] = frozenset()
        removes: FrozenSet[str] = frozenset()
        vv = VersionVector()
        snap = self._read_snapshot()
        if snap is not None:
            self.epoch, adds, removes, vv = snap
            self.obs.counter("journal_events_total").inc(
                event="snapshot_loaded")
        for _off, rtype, payload in self._log.records:
            if rtype != REC_DELTA:
                continue
            d_epoch, d_adds, d_removes, d_vv = _split_epoch(payload)
            if d_epoch < self.epoch:    # pre-snapshot leftovers (the
                continue                # truncate never landed): inert
            adds |= d_adds
            removes |= d_removes
            vv = vv.merge(d_vv)
            self.obs.counter("journal_events_total").inc(
                event="delta_replayed")
        self._log.records = []
        return adds, removes, vv

    def append_delta(self, adds: FrozenSet[AddEntry],
                     removes: FrozenSet[str], vv: VersionVector) -> None:
        self._log.append(REC_DELTA, _EPOCH.pack(self.epoch)
                         + encode_layer1(adds, removes, vv))
        self.records_since_snapshot += 1

    def snapshot(self, adds: FrozenSet[AddEntry], removes: FrozenSet[str],
                 vv: VersionVector) -> None:
        """Compact: durable full-state snapshot, then truncate the WAL.

        Sequence (each step durable before the next): write
        snapshot.tmp at epoch+1, fsync, atomic-rename over
        snapshot.bin, fsync the directory, truncate journal.log. A
        crash anywhere leaves a recoverable pair: before the rename the
        old snapshot + full journal still cover everything; after it
        the journal's records are a stale epoch and recovery skips
        them."""
        CrashPoint.maybe_crash(CP_SNAP_PRE_WRITE)
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_record_bytes(REC_SNAPSHOT,
                                  _EPOCH.pack(self.epoch + 1)
                                  + encode_layer1(adds, removes, vv)))
            f.flush()
            os.fsync(f.fileno())
        CrashPoint.maybe_crash(CP_SNAP_PRE_RENAME)
        os.replace(tmp, self.snap_path)
        _fsync_dir(self.dirname)
        self.epoch += 1
        CrashPoint.maybe_crash(CP_SNAP_PRE_TRUNCATE)
        self._log.close()
        with open(self._log.path, "r+b") as f:
            f.truncate(0)
            f.flush()
            os.fsync(f.fileno())
        self._log = _RecordLog(self._log.path, "journal",
                               sync=self._log.sync, obs=self.obs)
        self.records_since_snapshot = 0
        self.obs.counter("journal_events_total").inc(event="snapshot")

    @property
    def size(self) -> int:
        return self._log.size

    def flush(self) -> None:
        self._log.flush()

    def close(self) -> None:
        self._log.close()


# ---------------------------------------------------------------------------
# DurableStore — the replica-facing facade
# ---------------------------------------------------------------------------


class DurableStore:
    """One directory holding a replica's durable state: blob log +
    Layer-1 WAL + snapshot, with write-through transition recording.

    Wiring (see `api.Replica(path=...)`): every state replacement funnels through `record_transition(old,
    new)`, which appends newly resident blobs to the blob log, then
    journals the metadata delta — an operation is acknowledged exactly
    when it returns. `load()` rebuilds the pre-crash state: metadata
    from snapshot + WAL, payloads decoded from the blob log for every
    still-referenced eid — a warm restart re-serves all locally-held
    blobs with zero network bytes.

    Non-monotone transitions (tombstone GC shrinking A/R) cannot be a
    delta record; they force an immediate snapshot. Blob *residency*
    shrink (shedding) is durable at the next compaction — until then a
    restart may recover a superset of payloads; Layer-1 metadata, and
    therefore the Merkle root, is always exact.

    `load()` decodes payloads onto `device`: CUDA unless the caller asks
    for the CPU (resolved at the first tensor it decodes).
    """

    def __init__(self, dirname: str, *, sync: bool = True,
                 compact_every: int = 256,
                 obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        os.makedirs(dirname, exist_ok=True)
        self.dirname = dirname
        self.device = device
        self.compact_every = max(1, compact_every)
        self.obs = obs if obs is not None else MetricsRegistry()
        self.blobs = BlobLog(os.path.join(dirname, "blobs.log"),
                             sync=sync, obs=self.obs)
        self.journal = StateJournal(dirname, sync=sync, obs=self.obs)
        self.closed = False
        self._update_size_gauge()

    def _update_size_gauge(self) -> None:
        self.obs.gauge("store_log_bytes").set(
            float(self.blobs.size + self.journal.size))

    # ------------------------------------------------------------ recovery

    def load(self) -> CRDTMergeState:
        """Replay to the recovered `CRDTMergeState`: Layer-1 metadata
        exactly as last acknowledged, store payloads decoded from the
        blob log for every eid some add entry still references."""
        adds, removes, vv = self.journal.load()
        live = {e.element_id for e in adds}
        store: Dict[str, Any] = {}
        for eid in sorted(self.blobs.eids()):
            if eid in live:
                store[eid] = decode_blob(self.blobs.get(eid),
                                         device=self.device)
        return CRDTMergeState(adds, removes, vv, store)

    # ------------------------------------------------------- write-through

    def record_transition(self, old: CRDTMergeState,
                          new: CRDTMergeState) -> None:
        """Make one state replacement durable; the operation it carries
        is acknowledged when this returns. Blobs land before the
        metadata that references them, so a crash between the two loses
        an unreferenced blob record (harmless), never a dangling one."""
        if self.closed:
            raise JournalError("durable store is closed")
        for eid in new.store:
            if eid not in old.store and eid not in self.blobs:
                self.blobs.put(eid, encode_blob(new.store[eid]))
        monotone = (old.adds <= new.adds and old.removes <= new.removes)
        if not monotone:
            # tombstone GC (or any shrink) is not expressible as a
            # delta record: snapshot the exact new state instead
            self.journal.snapshot(new.adds, new.removes, new.vv)
            self.blobs.compact(frozenset(new.store))
            self._update_size_gauge()
            return
        d_adds = new.adds - old.adds
        d_removes = new.removes - old.removes
        if d_adds or d_removes or new.vv != old.vv:
            self.journal.append_delta(d_adds, d_removes, new.vv)
            CrashPoint.maybe_crash(CP_JOURNAL_PRE_ACK)
        if self.journal.records_since_snapshot >= self.compact_every:
            self.journal.snapshot(new.adds, new.removes, new.vv)
            self.blobs.compact(frozenset(new.store))
        self._update_size_gauge()

    # ----------------------------------------------------------- lifecycle

    def compact(self, state: CRDTMergeState) -> None:
        """Force a snapshot + blob-log compaction against `state`."""
        self.journal.snapshot(state.adds, state.removes, state.vv)
        self.blobs.compact(frozenset(state.store))
        self._update_size_gauge()

    def flush(self) -> None:
        if not self.closed:
            self.blobs.flush()
            self.journal.flush()

    def close(self) -> None:
        if self.closed:
            return
        self.blobs.close()
        self.journal.close()
        self.closed = True

    def __enter__(self) -> "DurableStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"DurableStore({self.dirname!r}, blobs={len(self.blobs)}, "
                f"wal={self.journal.size}B)")
