"""TCP interconnect between actor systems in different processes.

The reference's interconnect runs a per-peer proxy actor owning a TCP
session with handshake, reconnect and undelivered-notification semantics
(interconnect_tcp_proxy.h:20, interconnect_handshake.cpp; SURVEY.md §2.2
L2). This is the TPU build's control-plane equivalent: the ActorSystem's
pluggable remote transport (actors.py set_remote_transport) backed by
per-peer TCP sessions.

Semantics mirrored from the reference:
  * location transparency — senders address ActorId(node, local); the
    proxy routes by node id, connecting lazily on first send
  * per-peer SESSIONS with a hello handshake (node ids + session ids);
    a reconnect starts a new session
  * at-most-once delivery: on connection loss, queued/unsent envelopes
    produce ``Undelivered`` notifications back to their senders (the
    TEvUndelivered contract) — senders own retries, exactly like the
    reference's tablet pipes do on NodeDisconnected
  * frames are length-prefixed pickles — a Python↔Python wire for our
    own processes, NOT a trust boundary (the reference's interconnect
    likewise assumes a private cluster fabric; authn happens at the
    gRPC API layer, not between nodes)

Threading: reader threads inject envelopes into the target ActorSystem's
queue (deque appends are GIL-atomic against the run loop's popleft);
``pump()``/``serve()`` drive the cooperative run loop from the owner
thread.

The port's own copy of ``ydb_tpu/runtime/interconnect.py``. Its hello
and reject frames are the reference's byte for byte (plain tuples), but
an envelope pickles its ``ActorId`` and messages by module path, so a
port node and a reference node share no session beyond the handshake.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import socket
import struct
import threading
import time
from typing import Any

from ydb_tpu_torch import chaos
from ydb_tpu_torch.analysis import sanitizer
from ydb_tpu_torch.chaos.retry import RetryPolicy
from ydb_tpu_torch.runtime.actors import ActorSystem, Envelope

_HDR = struct.Struct("!I")

# wire protocol version: gated in the hello handshake (the reference
# gates compatibility in interconnect_handshake.cpp) — a peer speaking
# a different version is REFUSED at session setup with an explicit
# reason instead of failing cryptically mid-stream on an
# unpicklable/renamed message class. Bump on incompatible changes to
# the envelope or channel message formats.
PROTOCOL_VERSION = 1


class HandshakeRejected(OSError):
    """Peer refused the session permanently (version mismatch): not a
    transient failure — no reconnect/backoff, the session closes."""


@dataclasses.dataclass
class Undelivered:
    """Returned to the sender when a cross-node envelope could not be
    handed to the peer (connection refused / lost before flush)."""

    target: object  # ActorId
    message: Any
    reason: str


def _send_frame(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int):
    buf = io.BytesIO()
    while buf.tell() < n:
        chunk = sock.recv(n - buf.tell())
        if not chunk:
            return None
        buf.write(chunk)
    return buf.getvalue()


class _Session:
    """One peer's outbound session: a dedicated sender thread drains a
    queue, so the cooperative actor loop NEVER blocks on connects or
    retries (a peer dropping SYNs stalls only this session's thread).
    Lazy connect, handshake, bounded-backoff reconnect, undelivered
    notification on final failure."""

    def __init__(self, ic: "Interconnect", peer_node: int,
                 addr: tuple[str, int]):
        import queue

        self.ic = ic
        self.peer_node = peer_node
        self.addr = addr
        self.sock: socket.socket | None = None
        self.session_id = 0
        self.lock = sanitizer.make_lock(
            f"interconnect.session.{peer_node}.{id(self):x}.lock")
        self._q: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._sender_loop,
                                        daemon=True)
        self._thread.start()

    def send(self, env: Envelope) -> None:
        """Non-blocking enqueue (called from the actor run loop)."""
        if self._closed.is_set():
            self.ic._notify_undelivered(env, "session closed")
            return
        self._q.put(env)
        if self._closed.is_set():
            # close() may have drained BEFORE our put landed: nothing
            # will ever read the queue again, so drain it ourselves
            # (any queued envelope is equally undeliverable)
            while True:
                try:
                    stranded = self._q.get_nowait()
                except Exception:
                    break
                self.ic._notify_undelivered(stranded, "session closed")

    def _sender_loop(self) -> None:
        while not self._closed.is_set():
            try:
                env = self._q.get(timeout=0.1)
            except Exception:
                continue
            self._deliver(env)

    def _deliver(self, env: Envelope) -> None:
        # no lock across the attempt loop: the blocking work (connect,
        # sendall, backoff sleeps) runs lock-free on this sender thread,
        # so close() from another thread is never stalled behind a
        # retry storm — self.lock guards only the self.sock field
        for attempt in range(self.ic.max_retries + 1):
            if self._closed.is_set():
                break
            try:
                # chaos: 'delay' sleeps on THIS sender thread (reorder-
                # safe — one thread drains the queue in order),
                # 'disconnect' forces the reconnect+retry path below
                fault = chaos.hit("interconnect.send",
                                  peer=self.peer_node)
                if fault is not None:
                    fault.sleep()
                    if fault.kind == "disconnect":
                        raise OSError("injected peer disconnect")
                sock = self._ensure_sock()
                _send_frame(sock, ("env", env.target, env.sender,
                                   env.message))
                return
            except HandshakeRejected as e:
                # permanent: close the session so later envelopes
                # fail fast instead of re-dialing a refusing peer
                self._drop()
                self._closed.set()
                self.ic._notify_undelivered(env, str(e))
                return
            except OSError as e:
                self._drop()
                if attempt >= self.ic.max_retries:
                    self.ic._notify_undelivered(env, str(e))
                    return
                chaos.note_retry("interconnect.send", attempt + 1, e)
                time.sleep(self.ic.retry_policy.delay(attempt))
        self.ic._notify_undelivered(env, "session closed")

    def _ensure_sock(self) -> socket.socket:
        """The current socket, dialing a fresh session if none. Only
        the sender thread calls this; the lock covers the handover of
        the connected socket into self.sock against close()."""
        with self.lock:
            s = self.sock
        if s is not None:
            return s
        s = self._connect()
        with self.lock:
            if self._closed.is_set():
                s.close()
                raise OSError("session closed")
            self.sock = s
        return s

    def _connect(self) -> socket.socket:
        s = socket.create_connection(self.addr, timeout=self.ic.timeout)
        s.settimeout(self.ic.timeout)
        self.session_id += 1
        # the hello advertises our own listen port so the peer learns the
        # reverse route from the same handshake (mutual discovery), and
        # the protocol version so incompatible peers are refused HERE
        _send_frame(s, ("hello", self.ic.node, self.session_id,
                        self.ic.port, PROTOCOL_VERSION))
        resp = _recv_frame(s)
        if isinstance(resp, tuple) and resp[0] == "reject":
            s.close()
            raise HandshakeRejected(
                f"handshake rejected by {self.addr}: {resp[1]}")
        if not (isinstance(resp, tuple) and resp[0] == "hello"):
            s.close()
            raise OSError(f"bad handshake from {self.addr}: {resp!r}")
        # the gate is MUTUAL: an old listener that accepted our hello
        # still fails here if its own version differs
        resp_ver = resp[4] if len(resp) > 4 else 0
        if resp_ver != PROTOCOL_VERSION:
            s.close()
            raise HandshakeRejected(
                f"peer {self.addr} speaks protocol {resp_ver}, "
                f"we speak {PROTOCOL_VERSION}")
        return s

    def _drop(self) -> None:
        with self.lock:
            s, self.sock = self.sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed.set()
        # drain: anything still queued is undeliverable
        while True:
            try:
                env = self._q.get_nowait()
            except Exception:
                break
            self.ic._notify_undelivered(env, "session closed")
        self._drop()


class Interconnect:
    """Wire transport for one ActorSystem ('node')."""

    def __init__(self, system: ActorSystem, listen_port: int = 0,
                 peers: dict[int, tuple[str, int]] | None = None,
                 timeout: float = 5.0, max_retries: int = 2,
                 retry_delay: float = 0.1):
        self.system = system
        self.node = system.node
        self.peers = dict(peers or {})
        self.timeout = timeout
        self.max_retries = max_retries
        self.retry_delay = retry_delay
        # shared backoff shape (exponential + jitter) for the sender
        # retry loop; the loop stays hand-rolled because reconnect
        # state (drop/redial) lives between attempts
        self.retry_policy = RetryPolicy(
            max_attempts=max_retries + 1, base_delay=retry_delay,
            max_delay=max(4 * retry_delay, retry_delay))
        # session map is sanitizer-tracked under YDB_TPU_TORCH_TSAN=1: the
        # actor loop, reader threads (reverse-route add_peer) and
        # close() all touch it
        self._sessions = sanitizer.share(
            {}, f"interconnect.{self.node}.{id(self):x}.sessions")
        self._slock = sanitizer.make_lock(
            f"interconnect.{self.node}.{id(self):x}.slock")
        self._listener: socket.socket | None = None
        self.port: int | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        if listen_port is not None:
            self._listen(listen_port)
        system.set_remote_transport(self._send_remote)

    # ---- outbound ----

    def add_peer(self, node: int, host: str, port: int) -> None:
        with self._slock:
            addr = (host, port)
            old = self._sessions.get(node)
            if old is not None and old.addr == addr:
                # same address (e.g. a peer's inbound reconnect): keep
                # the healthy outbound session
                self.peers[node] = addr
                return
            self.peers[node] = addr
            if old is not None:
                old.close()  # stop the sender thread; no fd leak
                del self._sessions[node]

    def remove_peer(self, node: int) -> None:
        """Forget a peer (dynamic node removal): close its outbound
        session and drop the address, so nodes coming and going cannot
        grow the peer map without bound (lifecycle R007)."""
        with self._slock:
            self.peers.pop(node, None)
            sess = self._sessions.pop(node, None)
            if sess is not None:
                sess.close()

    def _send_remote(self, env: Envelope) -> None:
        addr = self.peers.get(env.target.node)
        if addr is None:
            self._notify_undelivered(env, f"unknown node {env.target.node}")
            return
        with self._slock:
            sess = self._sessions.get(env.target.node)
            if sess is None or sess.addr != addr:
                if sess is not None:
                    sess.close()
                sess = _Session(self, env.target.node, addr)
                self._sessions[env.target.node] = sess
        sess.send(env)

    def _notify_undelivered(self, env: Envelope, reason: str) -> None:
        if env.sender is not None and env.sender.node == self.node:
            self.system.send(
                env.sender, Undelivered(env.target, env.message, reason))
        else:
            self.system.dead_letters.append(env)

    # ---- inbound ----

    def _listen(self, port: int) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(16)
        self._listener = srv
        self.port = srv.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self, conn: socket.socket) -> None:
        try:
            hello = _recv_frame(conn)
            if not (isinstance(hello, tuple) and hello[0] == "hello"):
                return
            peer_ver = hello[4] if len(hello) > 4 else 0
            if peer_ver != PROTOCOL_VERSION:
                # version gate (interconnect_handshake.cpp shape): an
                # incompatible peer gets an explicit reject + reason
                _send_frame(conn, (
                    "reject",
                    f"protocol version {peer_ver} != "
                    f"{PROTOCOL_VERSION}"))
                return
            peer_node, peer_port = hello[1], hello[3]
            if peer_port is not None:
                # learn the reverse route (replies cross a new session)
                self.add_peer(peer_node, conn.getpeername()[0], peer_port)
            _send_frame(conn, ("hello", self.node, hello[2],
                                self.port, PROTOCOL_VERSION))
            while not self._stop.is_set():
                frame = _recv_frame(conn)
                if frame is None:
                    return
                kind, target, sender, message = frame
                if kind == "env":
                    # GIL-atomic deque append; drained by pump()/serve()
                    self.system.inject(
                        Envelope(target, sender, message))
        except OSError:
            return
        finally:
            conn.close()

    # ---- driving the cooperative loop alongside the network ----

    def pump(self, duration: float = 0.5, idle_sleep: float = 0.005
             ) -> None:
        """Drive the actor run loop for ``duration`` seconds, interleaving
        network-injected messages."""
        deadline = time.monotonic() + duration
        while time.monotonic() < deadline:
            if self.system.run() == 0:
                time.sleep(idle_sleep)

    def serve(self) -> None:
        """Run until close() — a node process's main loop."""
        while not self._stop.is_set():
            if self.system.run() == 0:
                time.sleep(0.005)

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
        with self._slock:
            for s in self._sessions.values():
                s.close()
            self._sessions.clear()
