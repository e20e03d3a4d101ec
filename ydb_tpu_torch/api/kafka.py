"""Kafka wire-protocol frontend over the topic (PersQueue) plane.

Mirror of the reference's Kafka compatibility proxy
(ydb/core/kafka_proxy/kafka_connection.cpp, actors/): a TCP listener
speaking the Kafka binary protocol so stock Kafka clients can produce
to and consume from the framework's topics. Topics map 1:1 to
``cluster.topics`` entries; Kafka consumer groups map to PersQueue
consumers (committed offset == next-to-read in both models, so offsets
pass through unchanged).

Supported APIs (pinned to pre-flexible versions, so the framing is the
classic fixed one — the same subset the reference proxy started with):

  ApiVersions v0, Metadata v1, Produce v2 (MessageSet v1 with CRC
  verification), Fetch v2, ListOffsets v1 (earliest/latest),
  FindCoordinator v0, OffsetCommit v2, OffsetFetch v1,
  SaslHandshake v1 + SaslAuthenticate v0 (PLAIN, password = cluster
  auth token; all other APIs reject until authenticated when a token
  set is configured).

Message values and keys are bytes on the wire; the PQ plane stores
both as str, so they round-trip via UTF-8 with surrogateescape
(exactly like the gRPC topic service, api/server.py topic_write).

The port's own copy of ``ydb_tpu/api/kafka.py`` over the port's
``Cluster.topics``: the same API versions and the same response bytes
for the same requests and clock.
"""

from __future__ import annotations

import socketserver
import struct
import threading
import zlib

ERR_NONE = 0
ERR_UNKNOWN_TOPIC = 3
ERR_CORRUPT_MESSAGE = 2
ERR_UNSUPPORTED_VERSION = 35
ERR_SASL_AUTH_FAILED = 58
ERR_ILLEGAL_SASL_STATE = 34

_SUPPORTED = {
    0: (2, 2),    # Produce
    1: (2, 2),    # Fetch
    2: (1, 1),    # ListOffsets
    3: (1, 1),    # Metadata
    8: (2, 2),    # OffsetCommit
    9: (1, 1),    # OffsetFetch
    10: (0, 0),   # FindCoordinator
    17: (1, 1),   # SaslHandshake
    18: (0, 0),   # ApiVersions
    36: (0, 0),   # SaslAuthenticate
}

# APIs allowed before SASL authentication completes (when auth is on)
_PRE_AUTH_APIS = {17, 18, 36}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def _take(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        if len(b) < n:
            raise ValueError("short kafka message")
        self.off += n
        return b

    def int8(self) -> int:
        return struct.unpack("!b", self._take(1))[0]

    def int16(self) -> int:
        return struct.unpack("!h", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack("!i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack("!q", self._take(8))[0]

    def string(self) -> str | None:
        n = self.int16()
        if n == -1:
            return None
        return self._take(n).decode("utf-8", "surrogateescape")

    def bytes_(self) -> bytes | None:
        n = self.int32()
        if n == -1:
            return None
        return self._take(n)

    def array(self, fn) -> list:
        n = self.int32()
        if n == -1:
            return []
        return [fn() for _ in range(n)]


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def int8(self, v):
        self.parts.append(struct.pack("!b", v))

    def int16(self, v):
        self.parts.append(struct.pack("!h", v))

    def int32(self, v):
        self.parts.append(struct.pack("!i", v))

    def int64(self, v):
        self.parts.append(struct.pack("!q", v))

    def string(self, v: str | None):
        if v is None:
            self.int16(-1)
        else:
            b = v.encode("utf-8", "surrogateescape")
            self.int16(len(b))
            self.parts.append(b)

    def bytes_(self, v: bytes | None):
        if v is None:
            self.int32(-1)
        else:
            self.int32(len(v))
            self.parts.append(v)

    def array(self, items, fn):
        self.int32(len(items))
        for it in items:
            fn(it)

    def blob(self) -> bytes:
        return b"".join(self.parts)


# ---- MessageSet v1 (magic 1) ----


def _encode_message(offset: int, ts_ms: int, key: bytes | None,
                    value: bytes | None) -> bytes:
    body = _Writer()
    body.int8(1)          # magic
    body.int8(0)          # attributes (no compression)
    body.int64(ts_ms)
    body.bytes_(key)
    body.bytes_(value)
    b = body.blob()
    crc = zlib.crc32(b) & 0xFFFFFFFF
    msg = struct.pack("!I", crc) + b
    return struct.pack("!qi", offset, len(msg)) + msg


def encode_message_set(msgs) -> bytes:
    """msgs: iterable of (offset, ts_ms, key|None, value|None)."""
    return b"".join(_encode_message(*m) for m in msgs)


def decode_message_set(buf: bytes):
    """Yields (offset, ts_ms, key, value); raises on CRC mismatch.
    Accepts magic 0 (no timestamp) and magic 1."""
    r = _Reader(buf)
    out = []
    while r.off + 12 <= len(r.buf):
        offset = r.int64()
        size = r.int32()
        if r.off + size > len(r.buf):
            break  # partial trailing message (legal in Kafka fetches)
        body = r._take(size)
        (crc,) = struct.unpack("!I", body[:4])
        if zlib.crc32(body[4:]) & 0xFFFFFFFF != crc:
            raise ValueError("message CRC mismatch")
        m = _Reader(body[4:])
        magic = m.int8()
        m.int8()  # attributes
        ts_ms = m.int64() if magic >= 1 else -1
        key = m.bytes_()
        value = m.bytes_()
        out.append((offset, ts_ms, key, value))
    return out


# ---- request handling ----


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: KafkaServer = self.server.kafka  # type: ignore[attr-defined]
        sock = self.request
        sock.settimeout(srv.idle_timeout)
        self.authenticated = srv.auth_tokens is None
        try:
            while True:
                hdr = self._read_exact(sock, 4)
                if hdr is None:
                    return
                (size,) = struct.unpack("!i", hdr)
                payload = self._read_exact(sock, size)
                if payload is None:
                    return
                resp = self._dispatch(srv, payload)
                if resp is not None:
                    sock.sendall(struct.pack("!i", len(resp)) + resp)
        except (ConnectionError, OSError, ValueError):
            pass

    def _read_exact(self, sock, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _dispatch(self, srv, payload: bytes) -> bytes | None:
        r = _Reader(payload)
        api_key = r.int16()
        api_version = r.int16()
        correlation_id = r.int32()
        r.string()  # client_id
        w = _Writer()
        w.int32(correlation_id)
        lo_hi = _SUPPORTED.get(api_key)
        if lo_hi is None or not lo_hi[0] <= api_version <= lo_hi[1]:
            if api_key == 18:  # ApiVersions error still lists versions
                w.int16(ERR_UNSUPPORTED_VERSION)
                self._api_versions_body(w)
            else:
                w.int16(ERR_UNSUPPORTED_VERSION)
            return w.blob()
        if not self.authenticated and api_key not in _PRE_AUTH_APIS:
            w.int16(ERR_SASL_AUTH_FAILED)
            return w.blob()
        handler = {
            0: self._produce, 1: self._fetch, 2: self._list_offsets,
            3: self._metadata, 8: self._offset_commit,
            9: self._offset_fetch, 10: self._find_coordinator,
            17: self._sasl_handshake, 18: self._api_versions,
            36: self._sasl_authenticate,
        }[api_key]
        if handler(srv, r, w) is False:  # acks=0: no response at all
            return None
        return w.blob()

    # -- ApiVersions v0 --

    def _api_versions_body(self, w):
        w.int32(len(_SUPPORTED))
        for key, (lo, hi) in sorted(_SUPPORTED.items()):
            w.int16(key)
            w.int16(lo)
            w.int16(hi)

    def _api_versions(self, srv, r, w):
        w.int16(ERR_NONE)
        self._api_versions_body(w)

    # -- SASL (PLAIN only; KIP-152 authenticate-over-kafka-frames) --

    def _sasl_handshake(self, srv, r, w):
        mechanism = r.string()
        if mechanism == "PLAIN":
            w.int16(ERR_NONE)
        else:
            w.int16(ERR_UNSUPPORTED_VERSION)
        w.int32(1)
        w.string("PLAIN")

    def _sasl_authenticate(self, srv, r, w):
        token = r.bytes_() or b""
        # PLAIN: authzid \0 authcid \0 password — the password is the
        # cluster auth token (same token set as the gRPC front)
        parts = token.split(b"\x00")
        password = parts[2].decode() if len(parts) == 3 else ""
        if srv.auth_tokens is not None and password in srv.auth_tokens:
            self.authenticated = True
            w.int16(ERR_NONE)
            w.string(None)    # error message
            w.bytes_(b"")     # auth bytes
        else:
            w.int16(ERR_SASL_AUTH_FAILED)
            w.string("authentication failed")
            w.bytes_(b"")

    # -- Metadata v1 --

    def _metadata(self, srv, r, w):
        requested = r.array(r.string)
        with srv.lock:
            names = (sorted(srv.cluster.topics)
                     if not requested else requested)
            topics = [(n, srv.cluster.topics.get(n)) for n in names]
            w.int32(1)                      # brokers
            w.int32(srv.node_id)
            w.string(srv.host)
            w.int32(srv.port)
            w.string(None)                  # rack
            w.int32(srv.node_id)            # controller id
            w.int32(len(topics))
            for name, t in topics:
                w.int16(ERR_NONE if t is not None else ERR_UNKNOWN_TOPIC)
                w.string(name)
                w.int8(0)                   # is_internal
                parts = t.partitions if t is not None else []
                w.int32(len(parts))
                for pi in range(len(parts)):
                    w.int16(ERR_NONE)
                    w.int32(pi)
                    w.int32(srv.node_id)    # leader
                    w.int32(1)              # replicas
                    w.int32(srv.node_id)
                    w.int32(1)              # isr
                    w.int32(srv.node_id)

    # -- Produce v2 --

    def _produce(self, srv, r, w):
        acks = r.int16()
        r.int32()  # timeout_ms
        results = []  # (topic, [(partition, error, base_offset, ts)])
        n_topics = r.int32()
        for _ in range(n_topics):
            tname = r.string()
            per_part = []
            n_parts = r.int32()
            for _ in range(n_parts):
                pid = r.int32()
                records = r.bytes_() or b""
                with srv.lock:
                    topic = srv.cluster.topics.get(tname)
                    if topic is None or pid >= len(topic.partitions):
                        per_part.append((pid, ERR_UNKNOWN_TOPIC, -1, -1))
                        continue
                    try:
                        decoded = decode_message_set(records)
                    except ValueError:
                        per_part.append(
                            (pid, ERR_CORRUPT_MESSAGE, -1, -1))
                        continue
                    msgs = []
                    for _off, ts_ms, key, value in decoded:
                        m = {"data": (value or b"").decode(
                            "utf-8", "surrogateescape")}
                        if key is not None:
                            m["key"] = key.decode(
                                "utf-8", "surrogateescape")
                        if ts_ms and ts_ms > 0:
                            m["ts"] = ts_ms / 1000.0
                        msgs.append(m)
                    offs = topic.partitions[pid].write(msgs)
                    base = offs[0] if offs else -1
                    per_part.append((pid, ERR_NONE, base, -1))
            results.append((tname, per_part))
        if acks == 0:
            return False  # fire-and-forget: no response at all
        w.int32(len(results))
        for tname, per_part in results:
            w.string(tname)
            w.int32(len(per_part))
            for pid, err, base, ts in per_part:
                w.int32(pid)
                w.int16(err)
                w.int64(base)
                w.int64(ts)
        w.int32(0)  # throttle_time_ms

    # -- Fetch v2 --

    def _fetch(self, srv, r, w):
        r.int32()  # replica_id
        r.int32()  # max_wait_ms
        r.int32()  # min_bytes
        n_topics = r.int32()
        w.int32(0)  # throttle_time_ms
        out = []
        for _ in range(n_topics):
            tname = r.string()
            per_part = []
            n_parts = r.int32()
            for _ in range(n_parts):
                pid = r.int32()
                fetch_offset = r.int64()
                max_bytes = r.int32()
                with srv.lock:
                    topic = srv.cluster.topics.get(tname)
                    if topic is None or pid >= len(topic.partitions):
                        per_part.append(
                            (pid, ERR_UNKNOWN_TOPIC, -1, b""))
                        continue
                    part = topic.partitions[pid]
                    hw = part.head_offset
                    msgs = part.read(fetch_offset,
                                     limit=max(1, max_bytes // 32))
                    wire = []
                    total = 0
                    for m in msgs:
                        value = m["data"].encode(
                            "utf-8", "surrogateescape")
                        key = m.get("key")
                        if key is not None:
                            key = key.encode("utf-8", "surrogateescape")
                        total += len(value) + 34
                        if wire and total > max_bytes:
                            break
                        wire.append((m["offset"],
                                     int(m.get("ts", 0) * 1000),
                                     key, value))
                    per_part.append(
                        (pid, ERR_NONE, hw, encode_message_set(wire)))
            out.append((tname, per_part))
        w.int32(len(out))
        for tname, per_part in out:
            w.string(tname)
            w.int32(len(per_part))
            for pid, err, hw, mset in per_part:
                w.int32(pid)
                w.int16(err)
                w.int64(hw)
                w.bytes_(mset)

    # -- ListOffsets v1 --

    def _list_offsets(self, srv, r, w):
        r.int32()  # replica_id
        n_topics = r.int32()
        out = []
        for _ in range(n_topics):
            tname = r.string()
            per_part = []
            for _ in range(r.int32()):
                pid = r.int32()
                ts = r.int64()
                with srv.lock:
                    topic = srv.cluster.topics.get(tname)
                    if topic is None or pid >= len(topic.partitions):
                        per_part.append((pid, ERR_UNKNOWN_TOPIC, -1, -1))
                        continue
                    part = topic.partitions[pid]
                    off = (part.tail_offset if ts == -2
                           else part.head_offset)
                    per_part.append((pid, ERR_NONE, -1, off))
            out.append((tname, per_part))
        w.int32(len(out))
        for tname, per_part in out:
            w.string(tname)
            w.int32(len(per_part))
            for pid, err, ts, off in per_part:
                w.int32(pid)
                w.int16(err)
                w.int64(ts)
                w.int64(off)

    # -- FindCoordinator v0 --

    def _find_coordinator(self, srv, r, w):
        r.string()  # group id
        w.int16(ERR_NONE)
        w.int32(srv.node_id)
        w.string(srv.host)
        w.int32(srv.port)

    # -- OffsetCommit v2 --

    def _offset_commit(self, srv, r, w):
        group = r.string()
        r.int32()   # generation
        r.string()  # member id
        r.int64()   # retention
        out = []
        for _ in range(r.int32()):
            tname = r.string()
            per_part = []
            for _ in range(r.int32()):
                pid = r.int32()
                offset = r.int64()
                r.string()  # metadata
                with srv.lock:
                    topic = srv.cluster.topics.get(tname)
                    if topic is None or pid >= len(topic.partitions):
                        per_part.append((pid, ERR_UNKNOWN_TOPIC))
                        continue
                    # Kafka committed offset == next-to-read ==
                    # PQ consumer offset: direct pass-through; rewinds
                    # are explicit client seeks, so they must apply
                    topic.partitions[pid].commit(group, offset,
                                                 allow_rewind=True)
                    per_part.append((pid, ERR_NONE))
            out.append((tname, per_part))
        w.int32(len(out))
        for tname, per_part in out:
            w.string(tname)
            w.int32(len(per_part))
            for pid, err in per_part:
                w.int32(pid)
                w.int16(err)

    # -- OffsetFetch v1 --

    def _offset_fetch(self, srv, r, w):
        group = r.string()
        out = []
        for _ in range(r.int32()):
            tname = r.string()
            per_part = []
            for _ in range(r.int32()):
                pid = r.int32()
                with srv.lock:
                    topic = srv.cluster.topics.get(tname)
                    if topic is None or pid >= len(topic.partitions):
                        per_part.append((pid, -1, ERR_UNKNOWN_TOPIC))
                        continue
                    off = topic.partitions[pid].committed(group)
                    per_part.append((pid, off, ERR_NONE))
            out.append((tname, per_part))
        w.int32(len(out))
        for tname, per_part in out:
            w.string(tname)
            w.int32(len(per_part))
            for pid, off, err in per_part:
                w.int32(pid)
                w.int64(off)
                w.string(None)  # metadata
                w.int16(err)


class KafkaServer:
    """Threaded Kafka-wire listener over a Cluster's topics.

    ``lock`` serializes topic access against other front doors; pass
    RequestProxy.lock to co-host with the gRPC server."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 lock: threading.Lock | None = None, node_id: int = 1,
                 auth_tokens: set[str] | None = None,
                 idle_timeout: float = 300.0):
        self.cluster = cluster
        self.host = host
        self.node_id = node_id
        self.lock = lock if lock is not None else threading.Lock()
        self.auth_tokens = auth_tokens
        self.idle_timeout = idle_timeout

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._server.kafka = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> "KafkaServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="kafka-wire")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
