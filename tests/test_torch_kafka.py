"""The port's Kafka front (``ydb_tpu_torch/api/kafka.py``) against the
reference's.

Each of the 7 cases of ``tests/test_kafka.py`` runs, as written there,
against a reference ``KafkaServer`` over a reference ``Cluster`` and
against a port one over a port ``Cluster(device="cpu")``, each topic on a
manual clock; every response the case's client reads is recorded, and
the two packages' responses must be the same bytes (the servers' own
port numbers masked). Added: one request sequence (ApiVersions, Metadata,
Produce with and without keys and timestamps, a corrupt CRC, Fetch from
several offsets, ListOffsets, FindCoordinator, OffsetCommit with a
rewind, OffsetFetch, an unknown topic, an unsupported version) sent to
both servers, byte for byte the same. Tolerance: none."""

import struct
import sys
import types

import pytest

import test_kafka as rk
import ydb_tpu.ssa
from ydb_tpu.api.kafka import KafkaServer as RKafkaServer
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.topic.topic import Topic as RTopic

from ydb_tpu_torch.api.kafka import KafkaServer
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.topic.topic import Topic

from conftest import Clock


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


#: (Cluster factory, Topic, MemBlobStore, KafkaServer) of each package
KITS = {"ref": (RCluster, RTopic, RMemBlobStore, RKafkaServer),
        "port": (lambda: Cluster(device="cpu"), Topic, MemBlobStore,
                 KafkaServer)}


class RecordingClient(rk.MiniKafkaClient):
    """The reference test's client, keeping every response payload with
    the server's port masked."""

    def __init__(self, port):
        super().__init__(port)
        self.port = port
        self.seen: list[bytes] = []

    def call(self, api_key, api_version, body, expect_response=True):
        out = super().call(api_key, api_version, body, expect_response)
        if out is not None:
            self.seen.append(out.replace(struct.pack("!i", self.port),
                                         b"\0\0\0\0"))
        return out


def _serve(pkg, topics=(("events", 2),), auth_tokens=None):
    make, topic, mem, server = KITS[pkg]
    cluster = make()
    for name, n in topics:
        cluster.topics[name] = topic(name, mem(), n_partitions=n,
                                     now=Clock(1000.0))
    kw = {} if auth_tokens is None else {"auth_tokens": auth_tokens}
    srv = server(cluster, **kw).start()
    return cluster, srv, RecordingClient(srv.port)


def _both(body, **serve_kw):
    """``body((cluster, srv, client))`` against each package's server;
    the responses it read are the same bytes."""
    seen = {}
    for pkg in KITS:
        cluster, srv, client = _serve(pkg, **serve_kw)
        try:
            body((cluster, srv, client))
            seen[pkg] = client.seen
        finally:
            client.close()
            srv.stop()
    assert seen["ref"] and seen["port"] == seen["ref"]
    return seen["port"]


@pytest.mark.parametrize("case", [
    "test_api_versions_and_metadata",
    "test_produce_fetch_roundtrip",
    "test_produce_acks0_and_corrupt_crc",
    "test_list_offsets_and_group_offsets",
    "test_key_roundtrip_and_offset_rewind",
    "test_unknown_topic_and_unsupported_version",
])
def test_reference_case_same_bytes(case):
    _both(getattr(rk, case))


def test_sasl_plain_auth():
    """``tests/test_kafka.py::test_sasl_plain_auth`` against both servers
    (topic ``ev``, token ``sesame``)."""
    def body(served):
        _cluster, _srv, c = served
        resp = c.call(3, 1, struct.pack("!i", -1))
        assert rk._SkipReader(resp).i16() == 58
        r = rk._SkipReader(c.call(17, 1, rk.enc_str("PLAIN")))
        assert r.i16() == 0 and r.i32() == 1 and r.string() == "PLAIN"
        r = rk._SkipReader(c.call(36, 0, rk.enc_bytes(b"\x00user\x00nope")))
        assert r.i16() == 58
        r = rk._SkipReader(c.call(36, 0,
                                  rk.enc_bytes(b"\x00user\x00sesame")))
        assert r.i16() == 0
        resp = c.call(3, 1, struct.pack("!i", -1))
        assert rk._SkipReader(resp).i32() == 1

    _both(body, topics=(("ev", 1),), auth_tokens={"sesame"})


def test_request_sequence_same_response_bytes():
    def body(served):
        _cluster, _srv, c = served
        c.call(18, 0, b"")
        c.call(3, 1, struct.pack("!i", -1))
        c.call(3, 1, struct.pack("!i", 2) + rk.enc_str("events")
               + rk.enc_str("nope"))
        rk._produce(c, "events", 0, [(b"k%d" % i, b"v%d" % i, 100 + i)
                                     for i in range(20)])
        rk._produce(c, "events", 1, [(None, "é%d".encode() * 3, 0)
                                     for i in range(5)])
        rk._produce(c, "events", 1, [(None, b"bad", 1)], corrupt=True)
        rk._produce(c, "events", 7, [(None, b"x", 1)])
        rk._produce(c, "missing", 0, [(None, b"x", 1)])
        for part, off, max_bytes in ((0, 0, 1 << 20), (0, 7, 64),
                                     (1, 0, 1 << 20), (1, 9, 100)):
            rk._fetch(c, "events", part, off, max_bytes)
        c.call(2, 1, struct.pack("!i", -1) + struct.pack("!i", 1)
               + rk.enc_str("events") + struct.pack("!i", 2)
               + struct.pack("!iq", 0, -1) + struct.pack("!iq", 1, -2))
        c.call(10, 0, rk.enc_str("grp"))
        for off in (12, 3):
            c.call(8, 2, rk.enc_str("grp") + struct.pack("!i", -1)
                   + rk.enc_str("m") + struct.pack("!q", -1)
                   + struct.pack("!i", 1) + rk.enc_str("events")
                   + struct.pack("!i", 1) + struct.pack("!iq", 0, off)
                   + rk.enc_str(None))
        c.call(9, 1, rk.enc_str("grp") + struct.pack("!i", 1)
               + rk.enc_str("events") + struct.pack("!i", 2)
               + struct.pack("!ii", 0, 1))
        c.call(0, 7, b"")

    seen = _both(body)
    assert len(seen) == 18
