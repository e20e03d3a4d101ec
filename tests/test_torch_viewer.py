"""The port's monitoring HTTP viewer (``ydb_tpu_torch/obs/viewer.py``,
``viewer_html.py``) against the reference's.

A reference and a port ``Cluster(device="cpu")`` take the same
statements; each gets its own ``Viewer`` on a real socket, and every
case of ``tests/test_viewer.py`` reads both over HTTP. Tolerance: the
JSON bodies equal, apart from ``uptime_seconds``, the statements'
``duration_us`` and the process memory figures (compared by key), and
the counters pages (compared by the names they carry). The page at
``/viewer`` is the reference's, byte for byte. As in the reference's
fixture, each cluster holds a one-partition topic ``ev`` with one
message (on a manual clock, so its tablet's redo bytes are equal), which
``/viewer/json/topics``, the cluster summary and the tablet counters
(``pq/`` tablets) show."""

import json
import sys
import types
import urllib.error
import urllib.request

import pytest

import ydb_tpu.ssa
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.obs.viewer import Viewer as RViewer
from ydb_tpu.topic.topic import Topic as RTopic

from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.obs.viewer import Viewer
from ydb_tpu_torch.topic.topic import Topic

from conftest import Clock

SETUP = ("CREATE TABLE t (id int64, name string, PRIMARY KEY (id))",
         "INSERT INTO t VALUES (1, 'a'), (2, 'b')",
         "SELECT id FROM t ORDER BY id")


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


@pytest.fixture
def served():
    """(reference viewer, port viewer) over clusters after SETUP."""
    viewers = []
    for c, make, topic, mem in ((RCluster(), RViewer, RTopic, RMemBlobStore),
                                (Cluster(device="cpu"), Viewer, Topic,
                                 MemBlobStore)):
        s = c.session()
        for sql in SETUP:
            s.execute(sql)
        c.topics["ev"] = topic("ev", mem(), n_partitions=1, now=Clock(7.0))
        c.topics["ev"].write("m1")
        viewers.append(make(c).start())
    yield viewers
    for v in viewers:
        v.stop()


def get(v, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{v.port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def both(served, path):
    """The two JSON bodies of ``path``, same status and content type."""
    (rs, rt, rb), (ps, pt, pb) = (get(v, path) for v in served)
    assert (ps, pt) == (rs, rt), path
    return json.loads(rb), json.loads(pb)


def test_cluster_scheme_tables_topics(served):
    ref, info = both(served, "/viewer/json/cluster")
    assert info["uptime_seconds"] >= 0
    for d in (ref, info):
        d.pop("uptime_seconds")
    assert info == ref
    assert info["tables"] == ["t"] and info["topics"] == ["ev"]

    ref, scheme = both(served, "/viewer/json/scheme")
    assert scheme == ref and {"path": "/t", "type": "table"} in scheme

    ref, tables = both(served, "/viewer/json/tables")
    assert tables == ref
    assert sum(r["rows"] for r in tables if r["table_name"] == "t") == 2

    ref, topics = both(served, "/viewer/json/topics")
    assert topics == ref == [{"topic": "ev", "partition": 0,
                              "start_offset": 0, "end_offset": 1}]


def test_health_whiteboard_counters(served):
    ref, health = both(served, "/viewer/json/healthcheck")
    assert health == ref and health["status"] == "GOOD"

    ref, wb = both(served, "/viewer/json/whiteboard")
    for d in (ref, wb):
        d.pop("uptime_seconds")
        for q in d["recent_queries"]:
            assert q.pop("duration_us") >= 0
    assert wb["memory"], "memory stats empty"
    assert sorted(wb.pop("memory")) == sorted(ref.pop("memory"))
    assert wb == ref
    assert wb["tables"] == 1 and wb["topics"] == 1
    assert any(q["kind"] == "select" for q in wb["recent_queries"])

    ref, counters = both(served, "/counters")
    assert counters and set(ref) <= set(counters)
    (_, _, rprom), (st, ctype, prom) = (get(v, "/counters/prometheus")
                                        for v in served)
    assert st == 200 and ctype.startswith("text/plain")

    def names(text):
        return {line.split("{")[0].split()[0] for line in
                text.decode().splitlines()
                if line and not line.startswith("#")}

    assert names(prom) and names(rprom) <= names(prom)


def test_tablet_counters_aggregation(served):
    ref, data = both(served, "/viewer/json/tablets")
    assert data == ref
    rows = data["tablets"]
    assert rows and all(r["tx_committed"] <= r["tx_executed"]
                        for r in rows)
    # the topic's one partition is a pq/ tablet on both sides
    pq = [r for r in rows if r["type"] == "pq"]
    assert [r["tablet_id"] for r in pq] == ["pq/ev/0"]
    assert pq[0]["tx_committed"] == 1 and pq[0]["redo_bytes"] > 0
    for t, a in data["aggregates"].items():
        mine = [r for r in rows if r["type"] == t]
        assert a["tablets"] == len(mine)
        assert a["redo_bytes"] == sum(r["redo_bytes"] for r in mine)
    assert sum(a["redo_bytes"] for a in data["aggregates"].values()) > 0


def test_sysview_listing_and_rows(served):
    ref, names = both(served, "/viewer/json/sysview")
    assert names == ref and "sys_query_stats" in names
    ref, rows = both(served, "/viewer/json/sysview?name=sys_query_stats")
    for d in (ref, rows):
        for r in d:
            assert r.pop("duration_us") >= 0
    assert rows == ref
    assert any("SELECT" in r["query_text"].upper() for r in rows)


def test_bearer_auth():
    for c, make in ((RCluster(), RViewer), (Cluster(device="cpu"), Viewer)):
        v = make(c, auth_tokens={"tok"}).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(v, "/viewer/json/cluster")
            assert ei.value.code == 401
            st, _, _ = get(v, "/viewer/json/cluster",
                           {"Authorization": "Bearer tok"})
            assert st == 200
        finally:
            v.stop()


def test_unknown_endpoint_404(served):
    for v in served:
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(v, "/viewer/json/nope")
        assert ei.value.code == 404


def test_embedded_html_ui(served):
    """/viewer (and the /monitoring alias) serves the reference's page,
    which polls the JSON endpoints."""
    for path in ("/viewer", "/monitoring"):
        (_, rt, rb), (_, pt, pb) = (get(v, path) for v in served)
        assert pt == rt and pt.startswith("text/html")
        assert pb == rb
        assert "ydb_tpu viewer" in pb.decode()
        assert "/viewer/json/tablets" in pb.decode()
