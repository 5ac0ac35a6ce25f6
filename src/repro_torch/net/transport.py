"""Transports: how framed wire bytes move between nodes
(`repro.net.transport`).

One interface, three implementations:

  * InMemoryTransport — per-node FIFO queues of encoded frames. Every
    message still round-trips through encode_message/decode_frame, so
    tests exercise real serialization while staying deterministic.
  * LoopbackSocketTransport — real TCP sockets on 127.0.0.1, one
    listening socket per registered node; each send opens a connection,
    writes one record, and closes. Exercises the OS byte path (partial
    reads, frame reassembly from a stream).
  * PersistentLoopbackTransport — one TCP connection per (src, dst)
    pair, reused for every frame (the deployment shape: chunked blob
    streams amortize the handshake instead of paying it per frame).
    Writes are non-blocking with a per-connection spool, so large
    frames cannot deadlock a single-threaded pump; `flush()` drains
    spools.

A socket carries records of u16 sender length + sender + one wire
frame, byte for byte the reference's, so a record one package's
transport writes parses in the other's. Every transport decodes frames
onto the device it was built with (`device=`: CUDA unless the caller
names another), so payload tensors in a decoded StateMsg, DeltaMsg or
BlobResp already sit where the receiving node keeps them.

Byte accounting is part of the interface: `bytes_sent`, `msgs_sent`,
`max_frame_seen`, a per-message-type byte breakdown, and the `net_*` /
`sync_wire_*` series of the transport's registry.
"""
from __future__ import annotations

import errno
import socket
import time
from collections import Counter, deque
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

from repro_torch.api.replica import resolve_device
from repro_torch.net.wire import (
    decode_frame, encode_message, FRAME_OVERHEAD, HEADER, Message)
from repro_torch.obs import MetricsRegistry, wire_phase


class Transport:
    """Point-to-point frame delivery between named nodes.

    Each transport owns a registry (`self.obs`, injectable) mirroring
    the accounting fields as labeled series: frames and bytes by message
    type, bytes per directed (src, dst) pair, anti-entropy bytes and
    frames attributed to session phase, and a queue-depth gauge (frames
    sent minus frames delivered).
    """

    def __init__(self, obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        self.device = resolve_device(device)
        self.bytes_sent = 0
        self.msgs_sent = 0
        self.msgs_delivered = 0
        self.max_frame_seen = 0
        self.bytes_by_type: Counter = Counter()
        self.obs = obs if obs is not None else MetricsRegistry()

    # -- interface ---------------------------------------------------------

    def register(self, node_id: str) -> None:
        """Make `node_id` addressable (idempotent)."""
        raise NotImplementedError

    def send(self, src: str, dst: str, msg: Message) -> int:
        """Encode and enqueue one message; returns frame bytes on wire."""
        raise NotImplementedError

    def recv_ready(self, node_id: str) -> List[Tuple[str, Message]]:
        """Drain and decode every frame waiting for `node_id`."""
        raise NotImplementedError

    def pending(self) -> int:
        """Frames sent but not yet received, across all nodes."""
        raise NotImplementedError

    def flush(self) -> None:
        """Push any spooled outgoing bytes toward the wire (no-op for
        transports that deliver synchronously)."""

    def close(self) -> None:
        pass

    # -- shared accounting -------------------------------------------------

    def _account(self, msg: Message, nbytes: int,
                 src: Optional[str] = None,
                 dst: Optional[str] = None) -> None:
        self.bytes_sent += nbytes
        self.msgs_sent += 1
        if nbytes > self.max_frame_seen:
            self.max_frame_seen = nbytes
        mtype = type(msg).__name__
        self.bytes_by_type[mtype] += nbytes
        obs = self.obs
        obs.counter("net_bytes_total").inc(nbytes, type=mtype)
        obs.counter("net_frames_total").inc(type=mtype)
        if src is not None and dst is not None:
            obs.counter("net_peer_bytes_total").inc(nbytes, src=src,
                                                    dst=dst)
        phase = wire_phase(mtype)
        obs.counter("sync_wire_bytes_total").inc(nbytes, phase=phase)
        obs.counter("sync_wire_frames_total").inc(phase=phase)
        obs.gauge("net_queue_depth").set(
            self.msgs_sent - self.msgs_delivered)

    def _account_recv(self, n: int) -> None:
        if n:
            self.msgs_delivered += n
            self.obs.gauge("net_queue_depth").set(
                self.msgs_sent - self.msgs_delivered)


def _head(src: str) -> bytes:
    """A stream record's head: u16 sender length + sender; the frame
    follows."""
    src_b = src.encode("utf-8")
    return len(src_b).to_bytes(2, "big") + src_b


class InMemoryTransport(Transport):
    def __init__(self, obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        super().__init__(obs, device)
        self._queues: Dict[str, Deque[Tuple[str, bytes]]] = {}

    def register(self, node_id: str) -> None:
        self._queues.setdefault(node_id, deque())

    def send(self, src: str, dst: str, msg: Message) -> int:
        frame = encode_message(msg)
        self._queues.setdefault(dst, deque()).append((src, frame))
        self._account(msg, len(frame), src, dst)
        return len(frame)

    def recv_ready(self, node_id: str) -> List[Tuple[str, Message]]:
        q = self._queues.get(node_id)
        out: List[Tuple[str, Message]] = []
        while q:
            src, frame = q.popleft()
            msg, _ = decode_frame(frame, device=self.device)
            out.append((src, msg))
        self._account_recv(len(out))
        return out

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())


def _listener() -> socket.socket:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(128)
    srv.setblocking(False)
    return srv


def _accept(srv: socket.socket) -> Optional[socket.socket]:
    """One pending connection, or None when none waits."""
    try:
        conn, _ = srv.accept()
    except (BlockingIOError, InterruptedError):
        return None
    except OSError as e:  # pragma: no cover - platform-specific
        if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
            return None
        raise
    return conn


class LoopbackSocketTransport(Transport):
    """Frames over real localhost TCP; one short-lived connection per
    send. Receiving reassembles records from the byte stream using the
    length header, so a frame split across TCP segments decodes. For
    small frames: `send` writes a whole record before any receiver
    accepts it, so a frame larger than the kernel's socket buffers
    blocks a single-threaded pump (`PersistentLoopbackTransport`
    spools instead)."""

    def __init__(self, obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        super().__init__(obs, device)
        self._servers: Dict[str, socket.socket] = {}
        self._ports: Dict[str, int] = {}
        self._partial: Dict[str, bytearray] = {}
        self._in_flight = 0

    def register(self, node_id: str) -> None:
        if node_id in self._servers:
            return
        srv = _listener()
        self._servers[node_id] = srv
        self._ports[node_id] = srv.getsockname()[1]
        self._partial[node_id] = bytearray()

    def send(self, src: str, dst: str, msg: Message) -> int:
        if dst not in self._ports:
            raise KeyError(f"unregistered node {dst!r}")
        frame = encode_message(msg)
        with socket.create_connection(("127.0.0.1", self._ports[dst]),
                                      timeout=5.0) as conn:
            conn.sendall(_head(src) + frame)
        self._in_flight += 1
        self._account(msg, len(frame), src, dst)
        return len(frame)

    def recv_ready(self, node_id: str) -> List[Tuple[str, Message]]:
        srv = self._servers.get(node_id)
        if srv is None:
            return []
        buf = self._partial[node_id]
        while True:
            conn = _accept(srv)
            if conn is None:
                break
            with conn:
                conn.setblocking(True)
                while True:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
        out, consumed = _parse_stream(buf, self.device)
        self._in_flight -= len(out)
        del buf[:consumed]
        self._account_recv(len(out))
        return out

    def pending(self) -> int:
        # conservative: frames sent minus frames decoded; data still in
        # kernel buffers counts as pending until a recv_ready drains it
        return max(0, self._in_flight)

    def close(self) -> None:
        for srv in self._servers.values():
            srv.close()
        self._servers.clear()
        self._ports.clear()


def _parse_stream(buf: bytearray, device: Any
                  ) -> Tuple[List[Tuple[str, Message]], int]:
    """Extract complete (src, message) records from a stream buffer.

    Record layout: u16 src length + src bytes + one wire frame. Returns
    the decoded records and the number of bytes consumed (incomplete
    trailing records stay for the next read). Frames decode in place
    from one view of `buf`, released before the caller trims the
    buffer; every decoded field is a copy, so no view outlives it."""
    out: List[Tuple[str, Message]] = []
    pos = 0
    with memoryview(buf) as mv:
        n = len(mv)
        while n - pos >= 2:
            slen = int.from_bytes(mv[pos:pos + 2], "big")
            fstart = pos + 2 + slen
            if n - fstart < HEADER.size:
                break
            plen = HEADER.unpack_from(mv, fstart)[3]
            fend = fstart + FRAME_OVERHEAD + plen
            if n < fend:
                break
            src = str(mv[pos + 2:fstart], "utf-8")
            msg, _ = decode_frame(mv, fstart, device=device)
            out.append((src, msg))
            pos = fend
    return out, pos


class PersistentLoopbackTransport(Transport):
    """One long-lived TCP connection per (src, dst) pair.

    Every frame after the first rides the established connection —
    `connections_opened` stays at the number of directed pairs that ever
    spoke. Sends are non-blocking: bytes the kernel will not take at
    once are spooled per connection and flushed opportunistically
    (send / recv_ready / flush / pending), so a single-threaded pump
    never deadlocks on a full socket buffer, even with multi-MiB chunk
    frames in flight.

    Each accepted connection keeps its own reassembly buffer — frames
    from different senders interleave at the receiver and must not share
    a stream parser.
    """

    def __init__(self, obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        super().__init__(obs, device)
        self._servers: Dict[str, socket.socket] = {}
        self._ports: Dict[str, int] = {}
        self._conns: Dict[Tuple[str, str], socket.socket] = {}
        # spool of whole records, each (head, frame) written gathered
        # without a join, + bytes of the first record already sent;
        # record alignment lets a reconnect resend the interrupted record
        # from its start instead of corrupting the new stream
        self._outq: Dict[Tuple[str, str], Deque[Tuple[bytes, bytes]]] = {}
        self._head_sent: Dict[Tuple[str, str], int] = {}
        self._accepted: Dict[str, List[List]] = {}   # [sock, buf] pairs
        self._in_flight = 0
        self.connections_opened = 0

    def register(self, node_id: str) -> None:
        if node_id in self._servers:
            return
        srv = _listener()
        self._servers[node_id] = srv
        self._ports[node_id] = srv.getsockname()[1]
        self._accepted[node_id] = []

    def _connect(self, key: Tuple[str, str]) -> socket.socket:
        conn = socket.create_connection(("127.0.0.1", self._ports[key[1]]),
                                        timeout=5.0)
        conn.setblocking(False)
        self.connections_opened += 1
        self._conns[key] = conn
        self._outq.setdefault(key, deque())
        self._head_sent.setdefault(key, 0)
        return conn

    def send(self, src: str, dst: str, msg: Message) -> int:
        if dst not in self._ports:
            raise KeyError(f"unregistered node {dst!r}")
        frame = encode_message(msg)
        key = (src, dst)
        if key not in self._conns:
            self._connect(key)
        self._outq[key].append((_head(src), frame))
        self._in_flight += 1
        self._flush_key(key)
        self._account(msg, len(frame), src, dst)
        return len(frame)

    def _drain(self, key: Tuple[str, str]) -> None:
        """Write spooled records until the queue empties or the kernel
        pushes back (raises OSError on a dead connection)."""
        conn = self._conns[key]
        q = self._outq[key]
        while q:
            head, frame = q[0]
            sent = self._head_sent[key]
            if sent < len(head):
                parts = [memoryview(head)[sent:], frame]
            else:
                parts = [memoryview(frame)[sent - len(head):]]
            sent += conn.sendmsg(parts)
            if sent == len(head) + len(frame):
                q.popleft()
                self._head_sent[key] = 0
            else:
                self._head_sent[key] = sent

    def _drop_conn(self, key: Tuple[str, str]) -> None:
        conn = self._conns.pop(key, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        # the receiver dropped the dead connection's partial record, so
        # the interrupted record must restart from its first byte
        self._head_sent[key] = 0

    def _flush_key(self, key: Tuple[str, str]) -> None:
        if not self._outq.get(key):
            return
        if key not in self._conns:      # a prior flush dropped the conn
            self._connect(key)
        try:
            self._drain(key)
            return
        except (BlockingIOError, InterruptedError):
            return                      # kernel buffer full; spool remains
        except OSError:
            self._drop_conn(key)
        # connection died (peer closed/reset): retry once on a fresh one;
        # a second failure leaves consistent state (no dead socket kept,
        # spool intact) for the next flush attempt
        self._connect(key)
        try:
            self._drain(key)
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop_conn(key)

    def flush(self) -> None:
        for key in list(self._conns):
            self._flush_key(key)

    def recv_ready(self, node_id: str) -> List[Tuple[str, Message]]:
        srv = self._servers.get(node_id)
        if srv is None:
            return []
        self.flush()
        conns = self._accepted[node_id]
        while True:
            conn = _accept(srv)
            if conn is None:
                break
            conn.setblocking(False)
            conns.append([conn, bytearray()])
        out: List[Tuple[str, Message]] = []
        live: List[List] = []
        for entry in conns:
            conn, buf = entry
            closed = False
            while True:
                try:
                    chunk = conn.recv(262144)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    closed = True
                    break
                if not chunk:
                    closed = True
                    break
                buf += chunk
            msgs, consumed = _parse_stream(buf, self.device)
            out.extend(msgs)
            self._in_flight -= len(msgs)
            del buf[:consumed]
            if closed:
                conn.close()
            else:
                live.append(entry)
        self._accepted[node_id] = live
        self._account_recv(len(out))
        return out

    def pending(self) -> int:
        self.flush()
        return max(0, self._in_flight)

    def close(self) -> None:
        for conn in self._conns.values():
            try:
                conn.close()
            except OSError:
                pass
        for conns in self._accepted.values():
            for conn, _buf in conns:
                try:
                    conn.close()
                except OSError:
                    pass
        for srv in self._servers.values():
            srv.close()
        self._conns.clear()
        self._outq.clear()
        self._head_sent.clear()
        self._accepted.clear()
        self._servers.clear()
        self._ports.clear()


def pump(nodes: Mapping[str, Any], transport: Transport,
         max_steps: int = 100_000) -> int:
    """Synchronously deliver messages until the transport drains.

    `nodes` maps node_id -> object with handle(msg) -> [(dst, msg), ...]
    (`net.antientropy.SyncNode`). Returns messages delivered. Raises
    RuntimeError if the protocol does not quiesce within max_steps — a
    liveness tripwire for tests.

    Nodes configured with a chunk_timeout get their clock advanced to
    wall time and their tick() run whenever the pump idles, so straggler
    re-requests (multi-source chunk fetch) work over real transports.
    """
    timed = [(node_id, node) for node_id, node in nodes.items()
             if getattr(node, "chunk_timeout", None) is not None]
    delivered = 0
    for _ in range(max_steps):
        now = time.monotonic()
        for _node_id, node in timed:
            node.clock = now
        progressed = False
        for node_id, node in nodes.items():
            for _src, msg in transport.recv_ready(node_id):
                progressed = True
                delivered += 1
                for dst, reply in node.handle(msg):
                    transport.send(node_id, dst, reply)
        if not progressed:
            for node_id, node in timed:
                for dst, reply in node.tick(now):
                    progressed = True
                    transport.send(node_id, dst, reply)
            if progressed:
                continue
            transport.flush()   # persistent transports: drain send spools
            if transport.pending() == 0:
                return delivered
            time.sleep(0.001)   # socket transports: wait for the kernel
    raise RuntimeError(f"pump did not quiesce in {max_steps} steps")
