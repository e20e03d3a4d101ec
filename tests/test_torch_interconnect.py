"""The port's TCP interconnect (``ydb_tpu_torch/runtime/interconnect.py``)
against the reference's.

The 3 cases of ``tests/test_interconnect.py`` and
``tests/test_lifecycle.py::test_interconnect_remove_peer``. The
two-process failover spawns children that run the port with jax made
unimportable (a child of the reference takes seconds to import jax, so
that case runs the port alone and holds it to the reference test's
messages: three acks, an ``Undelivered`` after the kill, the count read
back from the store by the second child). The other cases run through
both packages with equal results, and the hello and reject frames the
port puts on the wire are the reference's byte for byte. The
``interconnect.send`` chaos site fires the same seeded faults in both
and the envelope still arrives after the retry. Every wait is bounded
by a deadline. Tolerance: none."""

import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from ydb_tpu import chaos as rchaos
from ydb_tpu.runtime import actors as ractors
from ydb_tpu.runtime import interconnect as rinterconnect

from ydb_tpu_torch import chaos
from ydb_tpu_torch.runtime import actors
from ydb_tpu_torch.runtime import interconnect
from ydb_tpu_torch.runtime.actors import ActorId, ActorSystem
from ydb_tpu_torch.runtime.interconnect import Interconnect, Undelivered

KITS = {"ref": (ractors, rinterconnect, rchaos),
        "port": (actors, interconnect, chaos)}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys
sys.modules["jax"] = None
from ydb_tpu_torch.engine.blobs import DirBlobStore
from ydb_tpu_torch.runtime.actors import Actor, ActorSystem
from ydb_tpu_torch.runtime.interconnect import Interconnect

store_dir, port_file = sys.argv[1], sys.argv[2]


class CounterTablet(Actor):
    '''Minimal persistent tablet: WAL-append each increment, replay on
    boot, so killing the process loses nothing.'''

    def __init__(self, store):
        super().__init__()
        self.store = store
        self.n = self.seq = len(store.list("wal/"))

    def receive(self, message, sender):
        if message == ("inc",):
            self.seq += 1
            self.store.put(f"wal/{self.seq:08d}", b"+1")
            self.n += 1
            self.send(sender, ("ack", self.n))
        elif message == ("get",):
            self.send(sender, ("val", self.n))


system = ActorSystem(node=2)
system.register(CounterTablet(DirBlobStore(store_dir)))  # ActorId(2, 1)
ic = Interconnect(system, listen_port=0)
assert not any(m == "ydb_tpu" or m.startswith("ydb_tpu.")
               for m in sys.modules)
with open(port_file + ".tmp", "w") as f:
    f.write(str(ic.port))
os.replace(port_file + ".tmp", port_file)
ic.serve()
"""


def _spawn_child(store_dir, port_file):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(store_dir), str(port_file)],
        env=env)
    deadline = time.monotonic() + 30
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise RuntimeError("child died during startup")
        if time.monotonic() > deadline:
            proc.kill()
            proc.wait(timeout=10)
            raise TimeoutError("child did not report a port")
        time.sleep(0.02)
    with open(port_file) as f:
        return proc, int(f.read())


def collector(am):
    class Client(am.Actor):
        def __init__(self):
            super().__init__()
            self.got = []

        def receive(self, message, sender):
            self.got.append(message)

    return Client()


def _pump_until(ic, cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ic.pump(0.05)
        if cond():
            return
    raise TimeoutError("condition not reached")


def test_two_process_transport_and_failover(tmp_path):
    store_dir = tmp_path / "tablet_store"
    system = ActorSystem(node=1)
    client = collector(actors)
    client_id = system.register(client)
    ic = Interconnect(system, listen_port=0)
    tablet_id = ActorId(2, 1)

    proc1, port1 = _spawn_child(store_dir, str(tmp_path / "p1.port"))
    try:
        ic.add_peer(2, "127.0.0.1", port1)
        for _ in range(3):
            system.send(tablet_id, ("inc",), sender=client_id)
        _pump_until(ic, lambda: len(client.got) >= 3)
        assert client.got == [("ack", 1), ("ack", 2), ("ack", 3)]

        # hard-kill the node: the in-flight peer session dies
        proc1.kill()
        proc1.wait(timeout=10)

        # the first send after a kill can still succeed locally (TCP
        # buffers it; the RST arrives later): send until the session
        # sees the dead peer
        client.got.clear()
        deadline = time.monotonic() + 15
        while not any(isinstance(m, Undelivered) for m in client.got):
            if time.monotonic() > deadline:
                raise TimeoutError("no Undelivered after peer death")
            system.send(tablet_id, ("get",), sender=client_id)
            ic.pump(0.05)
        lost = [m for m in client.got if isinstance(m, Undelivered)][0]
        assert lost.target == tablet_id and lost.message == ("get",)

        # failover: a NEW process boots the tablet from the same store
        # (WAL replay) on a new port; a new session is dialled
        proc2, port2 = _spawn_child(store_dir, str(tmp_path / "p2.port"))
        try:
            ic.add_peer(2, "127.0.0.1", port2)
            client.got.clear()
            system.send(tablet_id, ("get",), sender=client_id)
            _pump_until(ic, lambda: ("val", 3) in client.got)
        finally:
            proc2.kill()
            proc2.wait(timeout=10)
    finally:
        if proc1.poll() is None:
            proc1.kill()
            proc1.wait(timeout=10)
        ic.close()


def test_unknown_peer_is_undelivered():
    outs = []
    for am, icm, _ in KITS.values():
        system = am.ActorSystem(node=1)
        client = collector(am)
        cid = system.register(client)
        ic = icm.Interconnect(system, listen_port=None)
        try:
            system.send(am.ActorId(9, 1), "hello", sender=cid)
            system.run()
            assert [type(m).__name__ for m in client.got] == ["Undelivered"]
            u = client.got[0]
            outs.append(((u.target.node, u.target.local), u.message,
                         u.reason))
        finally:
            ic.close()
    assert outs[0] == outs[1] == ((9, 1), "hello", "unknown node 9")


def _listener_frames(am, icm, hello):
    """Bytes a listener of ``icm`` answers to ``hello`` (a raw frame)."""
    ic_a = icm.Interconnect(am.ActorSystem(node=1), listen_port=0)
    try:
        s = socket.create_connection(("127.0.0.1", ic_a.port), timeout=5)
        s.sendall(hello)
        s.settimeout(5)
        got = b""
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            got += chunk
            if len(got) >= 4 and len(got) >= 4 + int.from_bytes(
                    got[:4], "big"):
                break
        s.close()
        return got
    finally:
        ic_a.close()


def _dialled_hello(icm, am):
    """Bytes of the hello frame an ``icm`` session sends on connect."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = {}

    def fake_peer():
        conn, _ = srv.accept()
        conn.settimeout(5)
        hdr = conn.recv(4)
        n = int.from_bytes(hdr, "big")
        body = b""
        while len(body) < n:
            body += conn.recv(n - len(body))
        got["hello"] = hdr + body
        conn.close()

    t = threading.Thread(target=fake_peer, daemon=True)
    t.start()
    system = am.ActorSystem(node=3)
    ic = icm.Interconnect(system, listen_port=None, max_retries=0)
    try:
        ic.add_peer(1, "127.0.0.1", srv.getsockname()[1])
        system.send(am.ActorId(1, 1), "x", sender=am.ActorId(3, 1))
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        ic.close()
        srv.close()
    return got["hello"]


def test_hello_and_reject_frames_are_the_reference_bytes():
    """The port's hello (from a dialling session) and its listener's
    reject and hello answers are the reference's bytes."""
    assert (_dialled_hello(interconnect, actors)
            == _dialled_hello(rinterconnect, ractors))
    for version in (99, 1):
        frame = {}
        for name, (am, icm, _) in KITS.items():
            hello = ("hello", 2, 1, None, version)
            raw = icm.pickle.dumps(hello, protocol=icm.pickle.HIGHEST_PROTOCOL)
            frame[name] = (_listener_frames(am, icm, icm._HDR.pack(len(raw))
                                            + raw), raw)
        assert frame["ref"][1] == frame["port"][1]  # the same hello bytes
        if version == 99:
            assert frame["ref"][0] == frame["port"][0]  # the same reject
            assert interconnect.pickle.loads(frame["port"][0][4:])[0] == \
                "reject"
        else:
            # the answer names the listener's port: equal past it
            answers = [interconnect.pickle.loads(frame[k][0][4:])
                       for k in ("ref", "port")]
            assert [a[:3] + a[4:] for a in answers] == [
                ("hello", 1, 1, interconnect.PROTOCOL_VERSION)] * 2


def test_handshake_version_gate():
    """An incompatible peer is refused at the handshake with an explicit
    reason, and a client whose handshake is rejected turns the envelope
    into ``Undelivered`` for its sender, in both packages."""
    outs = []
    for am, icm, _ in KITS.values():
        sys_a = am.ActorSystem(node=1)
        ic_a = icm.Interconnect(sys_a, listen_port=0)
        try:
            s = socket.create_connection(("127.0.0.1", ic_a.port),
                                         timeout=5)
            icm._send_frame(s, ("hello", 2, 1, None, 99))
            resp = icm._recv_frame(s)
            s.close()
            assert resp[0] == "reject" and "protocol version" in resp[1]
        finally:
            ic_a.close()

        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)

        def fake_peer():
            conn, _ = srv.accept()
            icm._recv_frame(conn)  # the hello
            icm._send_frame(conn, ("reject", "protocol version 1 != 2"))
            conn.close()

        t = threading.Thread(target=fake_peer, daemon=True)
        t.start()
        sys_b = am.ActorSystem(node=2)
        ic_b = icm.Interconnect(sys_b, listen_port=0, max_retries=0)
        try:
            ic_b.add_peer(1, "127.0.0.1", srv.getsockname()[1])
            probe = collector(am)
            pid = sys_b.register(probe)
            sys_b.send(am.ActorId(1, 7), ("ping",), sender=pid)
            deadline = time.monotonic() + 10
            while not probe.got and time.monotonic() < deadline:
                ic_b.pump(0.05)
            assert probe.got and type(probe.got[0]).__name__ == "Undelivered"
            assert "protocol version" in probe.got[0].reason
            outs.append((resp, probe.got[0].message,
                         probe.got[0].reason.split(": ", 1)[1]))
        finally:
            ic_b.close()
            srv.close()
            t.join(timeout=10)
    assert outs[0] == outs[1]


def test_interconnect_remove_peer():
    """The peer map can forget a node (``test_lifecycle.py``, R007)."""
    for am, icm, _ in KITS.values():
        ic = icm.Interconnect(am.ActorSystem(node=1), listen_port=None)
        ic.add_peer(2, "127.0.0.1", 19999)
        assert 2 in ic.peers
        ic.remove_peer(2)
        assert ic.peers == {}
        ic.remove_peer(2)  # absent: a no-op
        ic.close()


@pytest.fixture
def chaos_on(monkeypatch):
    monkeypatch.setattr(chaos, "CHAOS_FORCE", True)
    monkeypatch.setattr(rchaos, "CHAOS_FORCE", True)
    yield
    chaos.clear()
    rchaos.clear()


def test_interconnect_send_chaos_site(chaos_on):
    """A seeded ``disconnect`` at ``interconnect.send`` forces the
    redial and retry; the envelope still arrives, with the same hits,
    fires and retries in both packages."""
    outs = []
    for am, icm, ch in KITS.values():
        ch.install(ch.Scenario(seed=11, sites={"interconnect.send": {
            "kind": "disconnect", "p": 0.5, "budget": 2}}))
        sys_a, sys_b = am.ActorSystem(node=1), am.ActorSystem(node=2)
        ic_a = icm.Interconnect(sys_a, listen_port=0, retry_delay=0.01,
                                max_retries=3)
        ic_b = icm.Interconnect(sys_b, listen_port=0)
        try:
            ic_a.add_peer(2, "127.0.0.1", ic_b.port)
            sink = collector(am)
            sys_b.register(sink)  # ActorId(2, 1)
            for i in range(6):
                sys_a.send(am.ActorId(2, 1), ("m", i),
                           sender=am.ActorId(1, 1))
            deadline = time.monotonic() + 10
            while len(sink.got) < 6 and time.monotonic() < deadline:
                ic_b.pump(0.02)
            assert sink.got == [("m", i) for i in range(6)]
            st = ch.counters_snapshot()["sites"]["interconnect.send"]
            outs.append((sink.got, st["hits"], st["fired"]))
        finally:
            ic_a.close()
            ic_b.close()
            ch.clear()
    assert outs[0] == outs[1]
    assert outs[1][2] >= 1
