"""The port's sys views and health check (``ydb_tpu_torch/obs/sysview.py``
and their wiring in ``kqp/session.py``) against the reference's.

The same statements run through a reference ``Cluster()`` and a port
``Cluster(device="cpu")``; each sys view read through SQL must be the
reference's. Tolerance: integer, dictionary-id and validity columns bit
for bit (and the decoded strings with them); timing columns (seconds,
``duration_us``, ``elapsed_seconds``) and the memory values of
``sys_memory`` and ``sys_device_memory`` only non-negative; after the
history, every cluster dictionary holds the reference's values in the
reference's order. ``sys_top_queries`` ranks by seconds, so both rings'
seconds are pinned to the arrival order just before it is read (the
measured seconds are checked non-negative first).

One difference is the port's on purpose: a statement that reads a sys
view runs fused in the port, since its lazy sources answer ``get`` by
building the view (the reference's ``_SysLazySources`` answers ``get``
with None and such statements walk), so ``sys_query_log.spans`` of
those statements is not compared.

Mirrors the sys-view cases that the port's earlier mirrors left out:
``tests/test_obs_config.py`` (3), ``test_acl.py``, ``test_batching.py``,
``test_query_profile.py``, ``test_resident.py``, ``test_serving.py``,
``test_stats.py``, ``test_timeline.py`` (2), ``test_memsan.py`` and
``test_stats_quoter.py::test_table_stats_and_sys_views``. Health is
GOOD over a working store and EMERGENCY over one whose ``put`` raises,
and over a block-4-2 ``GroupBlobStore`` GOOD, then DEGRADED with one disk
down, then EMERGENCY with three, in both packages."""

import contextlib
import json
import sys
import threading
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.config import AppConfig as RAppConfig
from ydb_tpu.config import FeatureFlags as RFeatureFlags
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.sql.planner import PlanError as RPlanError

from ydb_tpu_torch.config import AppConfig, FeatureFlags
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.obs.sysview import SYS_SCHEMAS
from ydb_tpu_torch.sql.planner import PlanError


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C): a stand-in sends its GROUP BYs to its scatter
    tier, as the other port tests do."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


#: per view, the columns compared only as non-negative
VOLATILE = {
    "sys_query_stats": {"duration_us"},
    "sys_audit": {"duration_us"},
    "sys_memory": {"value"},
    "sys_top_queries": {"seconds", "compile_seconds", "execute_seconds",
                        "read_seconds", "merge_seconds", "stage_seconds",
                        "compute_seconds"},
    "sys_query_log": {"seconds"},
    "sys_active_queries": {"elapsed_seconds"},
    "sys_device_memory": {"live_bytes", "peak_bytes", "charges",
                          "releases", "evictions"},
}


def _pair(statements=(), n_shards=None, ref_kw=None, port_kw=None):
    """A reference and a port Cluster after the same statements."""
    ref = RCluster(n_shards=n_shards, **(ref_kw or {}))
    port = Cluster(n_shards=n_shards, device="cpu", **(port_kw or {}))
    _both(ref, port, statements)
    return ref, port


def _both(ref, port, statements):
    rs, ps = ref.session(), port.session()
    for sql in statements:
        rs.execute(sql)
        ps.execute(sql)


def _pin_seconds(*clusters):
    """Seconds of every retained profile set to its arrival number, so
    ``sys_top_queries`` ranks alike in both packages."""
    for c in clusters:
        for p in c.profiles.recent():
            assert p.seconds >= 0, p.sql
            p.seconds = float(p.seq)


def _same_table(r, p, volatile=(), what=""):
    assert list(r.schema.names) == list(p.schema.names), what
    assert r.num_rows == p.num_rows, (what, r.num_rows, p.num_rows)
    for f in p.schema.fields:
        rv, rok = r.cols[f.name]
        pv, pok = p.cols[f.name]
        rok, pok = np.asarray(rok, bool), np.asarray(pok, bool)
        np.testing.assert_array_equal(pok, rok, err_msg=f"{what} {f.name}")
        rv, pv = np.asarray(rv), np.asarray(pv)
        if f.name in volatile:
            assert (rv[rok] >= 0).all() and (pv[pok] >= 0).all(), \
                (what, f.name)
            continue
        np.testing.assert_array_equal(pv, rv, err_msg=f"{what} {f.name}")
        if f.type.is_string:
            assert p.strings(f.name) == r.strings(f.name), (what, f.name)


def _same_view(ref, port, sql, view):
    """``sql`` over sys view ``view`` through both clusters, equal."""
    r = ref.session().execute(sql)
    p = port.session().execute(sql)
    volatile = set(VOLATILE.get(view, ()))
    if view == "sys_query_log":
        volatile.add("spans")
        _same_spans(ref, port)
    _same_table(r, p, volatile, sql)
    return r, p


def _same_spans(ref, port):
    """Span counts of every retained statement that reads no sys view
    (those run fused in the port and walk in the reference)."""
    rp, pp = ref.profiles.recent(), port.profiles.recent()
    assert [p.sql for p in pp] == [p.sql for p in rp]
    for r, p in zip(rp, pp):
        if "sys_" not in p.sql:
            assert len(p.spans) == len(r.spans), p.sql


def _same_dicts(ref, port):
    """Every cluster dictionary: the reference's values, in its order."""
    assert sorted(port.dicts.columns()) == sorted(ref.dicts.columns())
    for col in ref.dicts.columns():
        assert list(port.dicts[col].values) == \
            list(ref.dicts[col].values), col


_HISTORY = (
    "CREATE TABLE t (id int64, name string, v int64, PRIMARY KEY (id)) "
    "WITH (shards = 2)",
    "INSERT INTO t VALUES (1, 'a', 10), (2, 'b', 20), (3, 'a', 30)",
    "INSERT INTO t VALUES (4, 'c', 40)",
    "CREATE TABLE r (id int64, w int64, PRIMARY KEY (id)) "
    "WITH (store = row, shards = 2)",
    "INSERT INTO r VALUES (1, 5), (2, 6), (7, 8)",
    "UPDATE r SET w = 9 WHERE id = 2",
    "SELECT name, sum(v) AS s FROM t GROUP BY name ORDER BY name",
    "SELECT count(*) AS n FROM r",
)


def test_every_sys_view_equals_the_reference():
    """All 15 views after one history of column- and row-table
    statements (``sys_partition_stats`` walks the row shards' pages, as
    the reference does), then the dictionaries they interned."""
    ref, port = _pair(_HISTORY)
    for view in SYS_SCHEMAS:
        if view == "sys_top_queries":
            _pin_seconds(ref, port)
        r, p = _same_view(ref, port, f"SELECT * FROM {view}", view)
        if view == "sys_partition_stats":
            kinds = p.strings("store")
            assert kinds.count(b"row") == 2 and kinds.count(b"column") == 2
            rows = np.asarray(p.cols["rows"][0])
            assert rows[[k == b"row" for k in kinds]].sum() == 3
    _same_dicts(ref, port)


# ---------------- tests/test_obs_config.py ----------------

def test_sys_views_via_sql():
    ref, port = _pair([
        "CREATE TABLE t (id int64, PRIMARY KEY (id)) WITH (shards = 2)",
        "INSERT INTO t VALUES (1), (2), (3)"])
    _, out = _same_view(ref, port,
                        "SELECT table_name, rows FROM sys_partition_stats "
                        "WHERE table_name = 't'", "sys_partition_stats")
    assert sum(out.cols["rows"][0]) == 3
    _, out = _same_view(ref, port,
                        "SELECT kind, count(*) AS n FROM sys_query_stats "
                        "GROUP BY kind ORDER BY kind", "sys_query_stats")
    assert "insert" in [v.decode() for v in out.strings("kind")]
    _, out = _same_view(ref, port,
                        "SELECT path FROM sys_scheme_paths ORDER BY path",
                        "sys_scheme_paths")
    assert "/t" in [v.decode() for v in out.strings("path")]
    _same_dicts(ref, port)


def test_sys_views_can_be_disabled():
    ref = RCluster(config=RAppConfig(
        feature_flags=RFeatureFlags(enable_sys_views=False)))
    port = Cluster(device="cpu", config=AppConfig(
        feature_flags=FeatureFlags(enable_sys_views=False)))
    with pytest.raises(RPlanError) as want:
        ref.session().execute("SELECT path FROM sys_scheme_paths")
    with pytest.raises(PlanError) as got:
        port.session().execute("SELECT path FROM sys_scheme_paths")
    assert str(got.value) == str(want.value)
    assert not set(SYS_SCHEMAS) & set(port.catalog().schemas)
    assert set(SYS_SCHEMAS) <= set(Cluster(device="cpu").catalog().schemas)


class _BrokenPut(MemBlobStore):
    def put(self, blob_id, data):
        if blob_id == "health/canary":
            raise OSError("disk gone")
        super().put(blob_id, data)


class _RBrokenPut(RMemBlobStore):
    def put(self, blob_id, data):
        if blob_id == "health/canary":
            raise OSError("disk gone")
        super().put(blob_id, data)


def test_health_check_good_and_degraded():
    ref, port = RCluster(), Cluster(device="cpu")
    assert port.health() == ref.health() == {"status": "GOOD",
                                             "issues": []}
    ref = RCluster(store=_RBrokenPut())
    port = Cluster(store=_BrokenPut(), device="cpu")
    h = port.health()
    assert h == ref.health()
    assert h["status"] == "EMERGENCY"
    assert h["issues"] == [{"severity": "red",
                            "message": "storage unavailable: disk gone"}]
    # tests/test_obs_config.py::test_health_check_good_and_degraded
    from ydb_tpu.blobstorage import DSProxy as RDSProxy
    from ydb_tpu.blobstorage import GroupBlobStore as RGroupBlobStore
    from ydb_tpu.blobstorage import GroupInfo as RGroupInfo
    from ydb_tpu_torch.blobstorage import DSProxy, GroupBlobStore, GroupInfo

    rgroup, group = RGroupInfo(1, "block42"), GroupInfo(1, "block42")
    ref = RCluster(store=RGroupBlobStore(RDSProxy(rgroup)))
    port = Cluster(store=GroupBlobStore(DSProxy(group)), device="cpu")
    seen = []
    for down in ((), (0,), (1, 2)):
        for g in (rgroup, group):
            for i in down:
                g.disks[i].down = True
        h = port.health()
        assert h == ref.health()
        seen.append(h)
    assert [h["status"] for h in seen] == ["GOOD", "DEGRADED", "EMERGENCY"]
    assert seen[1]["issues"] == [{"severity": "yellow",
                                  "message": "group 1: 1 disk(s) down"}]
    assert seen[2]["issues"] == [
        {"severity": "red",
         "message": "storage unavailable: write quorum failed: 6/6 parts "
                    "on 3 disks (need all parts on >= 4 disks)"},
        {"severity": "red", "message": "group 1: 3 disk(s) down"}]


# ---------------- tests/test_acl.py ----------------

def test_sys_prefix_is_read_only_exemption():
    for c, err in ((RCluster(), RPlanError), (Cluster(device="cpu"),
                                               PlanError)):
        s = c.session()
        s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id))")
        s.execute("INSERT INTO t VALUES (1, 10)")
        c.scheme.grant("/t", "other", "read")  # activate ACLs
        eve = c.session()
        eve.principal = "eve"
        # reads of sys views pass without grants ...
        assert eve.execute(
            "SELECT count(*) AS c FROM sys_scheme_paths").num_rows == 1
        # ... but sys_ names grant no ddl/write escape hatch
        with pytest.raises(err):
            eve.execute("CREATE TABLE sys_evil (id int64, "
                        "PRIMARY KEY (id))")
        with pytest.raises(err, match="reserved"):
            c.session().execute("CREATE TABLE sys_evil (id int64, "
                                "PRIMARY KEY (id))")


# ---------------- tests/test_batching.py ----------------

@contextlib.contextmanager
def _armed(c, window_ms, max_batch):
    bt = c.batcher
    saved = bt.window_ms, bt.max_batch
    bt.window_ms, bt.max_batch = float(window_ms), max_batch
    try:
        yield bt
    finally:
        bt.window_ms, bt.max_batch = saved


def _batched_round(c, sql, n):
    """``sql`` on ``n`` sessions at once, with a window that closes at
    ``n`` members."""
    sessions = [c.session() for _ in range(n)]
    barrier = threading.Barrier(n)
    errors = []

    def run(s):
        try:
            barrier.wait()
            s.execute(sql)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    with _armed(c, 5000.0, n):
        threads = [threading.Thread(target=run, args=(s,))
                   for s in sessions]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert not errors, errors


def test_sys_views_expose_batch_columns():
    setup = ["CREATE TABLE t (id int64, g int64, v int64, "
             "PRIMARY KEY (id)) WITH (shards = 1)",
             "INSERT INTO t VALUES " + ", ".join(
                 f"({i}, {i % 3}, {i * 7})" for i in range(40))]
    ref, port = _pair(setup)
    q = "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g"
    for c in (ref, port):
        c.session().execute(q)  # compiled outside the batched round
        _batched_round(c, q, 3)
    _pin_seconds(ref, port)
    r, top = _same_view(ref, port,
                        "SELECT batch_id, batch_size, shared_scan "
                        "FROM sys_top_queries", "sys_top_queries")
    assert tuple(top.schema.names) == ("batch_id", "batch_size",
                                       "shared_scan")
    assert top.num_rows > 0
    assert int(np.asarray(top.cols["batch_size"][0]).max()) == 3
    _, act = _same_view(ref, port,
                        "SELECT query_text, batch_id, batch_size, "
                        "shared_scan FROM sys_active_queries",
                        "sys_active_queries")
    # the introspection statement itself is live and unbatched
    assert act.num_rows == 1
    assert int(np.asarray(act.cols["batch_id"][0]).min()) >= 0


# ---------------- tests/test_query_profile.py ----------------

_EV = ["CREATE TABLE ev (id int64, ts int64, v int64, PRIMARY KEY (id)) "
       "WITH (shards = 2)"] + [
    "INSERT INTO ev VALUES " + ", ".join(
        f"({b + i}, {b + i}, {(b + i) * 3})" for i in range(8))
    for b in (0, 100, 200)]


def test_top_queries_and_query_log_sysviews():
    ref, port = _pair(_EV + ["SELECT ts, sum(v) AS sv FROM ev GROUP BY ts"])
    _pin_seconds(ref, port)
    _, out = _same_view(
        ref, port, "SELECT rank, query_text, query_class, seconds, rows, "
        "compile_seconds, compile_cache FROM sys_top_queries ORDER BY rank",
        "sys_top_queries")
    assert out.num_rows >= 3
    ranks = list(out.cols["rank"][0])
    assert ranks == sorted(ranks)
    texts = [v.decode() for v in out.strings("query_text")]
    assert any("GROUP BY ts" in t for t in texts)
    assert "select_agg" in [v.decode() for v in out.strings("query_class")]
    secs = list(out.cols["seconds"][0])
    assert secs == sorted(secs, reverse=True)
    r, log = _same_view(ref, port, "SELECT seq, kind, spans FROM "
                        "sys_query_log ORDER BY seq", "sys_query_log")
    seqs = list(log.cols["seq"][0])
    assert seqs == sorted(seqs) and len(seqs) >= 4
    assert all(n > 0 for n in log.cols["spans"][0])
    _same_dicts(ref, port)


# ---------------- tests/test_resident.py ----------------

def test_sysview_and_viewer_surface(monkeypatch):
    import ydb_tpu.engine.resident as rres

    import ydb_tpu_torch.engine.resident as tres
    from ydb_tpu.obs.viewer import Viewer as RViewer

    from ydb_tpu_torch.obs.viewer import Viewer

    monkeypatch.setattr(rres, "RESIDENT_FORCE", True)
    monkeypatch.setattr(tres, "RESIDENT_FORCE", True)
    ref, port = _pair(["create table t (k bigint not null, v bigint, "
                       "primary key (k))", "insert into t values (1, 10)",
                       "insert into t values (2, 20)"], n_shards=2)
    for c in (ref, port):
        for sh in c.tables["t"].shards:
            sh.resident.drain()
    _, r = _same_view(ref, port, "select shard, portions, promotions "
                      "from sys_resident_store order by shard",
                      "sys_resident_store")
    assert int(np.asarray(r.cols["portions"][0]).sum()) >= 1
    port.run_background()
    assert "resident" in port.counters.encode_prometheus()
    totals = []
    for c, make in ((ref, RViewer), (port, Viewer)):
        v = make(c).start()
        try:
            body, ctype = v.render("/viewer/json/resident", {})
            assert ctype.startswith("application/json")
            totals.append(json.loads(body)["total"])
        finally:
            v.stop()
    assert totals[1]["portions"] >= 1
    for k in ("portions", "promotions", "evictions", "spills"):
        assert totals[1][k] == totals[0][k], k


# ---------------- tests/test_serving.py ----------------

def _front(c, serving):
    reg = serving.TenantRegistry()
    reg.register("gold", weight=3.0, max_inflight=32)
    reg.register("bronze", weight=1.0, max_inflight=16)
    reg.register("small", weight=0.5, max_inflight=1, queue_size=0)
    reg.bind_principal("gold-token", "gold")
    serving.install(c, reg)


def test_tenant_rides_profile_views_and_gauges():
    import ydb_tpu.serving as rserving

    import ydb_tpu_torch.serving as tserving

    ref, port = _pair(_EV)
    _front(ref, rserving)
    _front(port, tserving)
    views = {}
    for c in (ref, port):
        s = c.session()
        s.tenant = "gold"
        assert s.execute("SELECT count(*) AS n FROM ev").num_rows == 1
        assert s.last_profile.tenant == "gold"
        _pin_seconds(c)
        views[c] = [s.execute(q) for q in (
            "SELECT tenant FROM sys_top_queries",
            "SELECT tenant FROM sys_active_queries",
            "SELECT tenant, weight, max_inflight, admitted, shed, "
            "pool_limit FROM sys_tenant_pools")]
    for r, p in zip(views[ref], views[port]):
        _same_table(r, p)
    top, live, pools = views[port]
    assert "gold" in {v.decode() for v in top.strings("tenant")}
    assert "gold" in {v.decode() for v in live.strings("tenant")}
    assert {"default", "gold", "bronze", "small"} <= {
        v.decode() for v in pools.strings("tenant")}
    port.run_background()
    prom = port.counters.encode_prometheus()
    assert 'tenant="gold"' in prom and "query_latency_p99" in prom
    _same_dicts(ref, port)


# ---------------- tests/test_stats.py ----------------

def test_sql_scan_pruning_bit_identical_and_sysviews(monkeypatch):
    import ydb_tpu.stats as rstats

    import ydb_tpu_torch.stats as tstats

    setup = ["create table ev (id bigint not null, ts bigint not null, "
             "tag string, val int) with (shards = 2)"] + [
        "insert into ev (id, ts, tag, val) values " + ",".join(
            f"({i * 100 + j}, {i * 100 + j}, 't{j % 3}', {j})"
            for j in range(50)) for i in range(3)]
    ref, port = _pair(setup, n_shards=2)
    for c in (ref, port):
        c.run_background()  # aggregator refresh rides maintenance
    q = ("select tag, count(*) as n, sum(val) as sv from ev "
         "where ts >= 200 and ts < 230 group by tag order by tag")
    outs = []
    for flag in (True, False):
        monkeypatch.setattr(rstats, "STATS_FORCE", flag)
        monkeypatch.setattr(tstats, "STATS_FORCE", flag)
        r, p = ref.session().execute(q), port.session().execute(q)
        _same_table(r, p, what=q)
        outs.append(p)
    for col in ("n", "sv"):
        np.testing.assert_array_equal(outs[0].cols[col][0],
                                      outs[1].cols[col][0])
    _, st = _same_view(ref, port, "select column_name, ndv, rows from "
                       "sys_statistics where table_name = 'ev'",
                       "sys_statistics")
    assert st.num_rows == 4
    ndv = dict(zip((v.decode() for v in st.strings("column_name")),
                   np.asarray(st.cols["ndv"][0]).tolist()))
    assert ndv["tag"] == 3 and abs(ndv["id"] - 150) / 150 < 0.1
    _, pr = _same_view(ref, port, "select shard, scans, portions_total, "
                       "chunks_read from sys_scan_pruning",
                       "sys_scan_pruning")
    assert pr.num_rows == 2
    _same_dicts(ref, port)


# ---------------- tests/test_timeline.py ----------------

def test_sys_active_queries_shows_then_clears():
    ref, port = _pair(_EV[:2])
    # a statement reading sys_active_queries observes ITSELF in flight
    _, out = _same_view(ref, port, "SELECT query_text, stage, "
                        "elapsed_seconds FROM sys_active_queries",
                        "sys_active_queries")
    assert out.num_rows == 1
    assert out.strings("stage") == [b"execute"]
    # ...and the registry clears once execution finishes
    assert port.active_query_snapshot() == []
    _, out = _same_view(ref, port, "SELECT query_text FROM "
                        "sys_active_queries", "sys_active_queries")
    assert out.num_rows == 1  # only itself again, not a leak


def test_failed_query_recorded_with_error_flag():
    ref, port = _pair(_EV[:2])
    for c in (ref, port):
        n_before = len(c.profiles.recent())
        with pytest.raises(Exception):
            c.session().execute("SELECT * FROM no_such_table")
        recent = c.profiles.recent()
        assert len(recent) == n_before + 1
        assert recent[-1].error == 1 and "no_such_table" in recent[-1].sql
    _pin_seconds(ref, port)
    _, out = _same_view(ref, port, "SELECT query_text, error, error_reason "
                        "FROM sys_top_queries WHERE error = 1",
                        "sys_top_queries")
    assert out.num_rows == 1
    _same_dicts(ref, port)


# ---------------- tests/test_memsan.py ----------------

def test_sys_device_memory_view_and_counters():
    """Both packages' views list the same ledger components with a
    <global> row (their byte counts are each package's own device
    footprint); run_background exports the port's ledger as
    component=devmem counters."""
    from ydb_tpu.analysis import memsan as rmemsan

    from ydb_tpu_torch.analysis import memsan
    from ydb_tpu_torch.obs.sysview import _device_memory_rows

    stmts = ["CREATE TABLE dm (id int64, v int64, PRIMARY KEY (id))",
             "INSERT INTO dm VALUES (1, 2), (2, 4)",
             "SELECT sum(v) AS sv FROM dm"]
    q = "SELECT component, live_bytes, peak_bytes, charges FROM " \
        "sys_device_memory ORDER BY component"
    with rmemsan.activate():
        ref = RCluster()
        for sql in stmts:
            ref.session().execute(sql)
        r = ref.session().execute(q)
    with memsan.activate():
        port = Cluster(device="cpu")
        for sql in stmts:
            port.session().execute(sql)
        comps, live, peak, charges, releases, evictions = \
            _device_memory_rows(port)
        assert "<global>" in comps and "staging" in comps
        assert peak[comps.index("<global>")] == memsan.global_peak() > 0
        p = port.session().execute(q)
        port.run_background()
        snap = port.counters.snapshot()
    _same_table(r, p, VOLATILE["sys_device_memory"], q)
    assert p.num_rows >= 2
    assert int(np.asarray(p.cols["peak_bytes"][0]).max()) > 0
    devmem = {k: v for k, v in snap.items() if "component=devmem" in k}
    assert any(k.startswith("peak_bytes|") for k in devmem), devmem
    assert any(k.startswith("global_peak_bytes|") for k in devmem)
    # sanitizer off: the view exists but reports no rows
    assert all(col == [] for col in _device_memory_rows(port))
    assert port.session().execute(q).num_rows == 0


# ---------------- tests/test_stats_quoter.py ----------------

def test_table_stats_and_sys_views():
    ref, port = _pair([
        "create table kv (k bigint not null, v bigint, primary key (k))",
        "insert into kv (k, v) values (1, 10), (2, 20), (3, 30)"])
    _, r = _same_view(ref, port, "select table_name, rows from "
                      "sys_table_stats", "sys_table_stats")
    assert r.strings("table_name") == [b"kv"]
    assert int(r.cols["rows"][0][0]) == 3
    _, r = _same_view(ref, port, "select kind, status from sys_audit "
                      "order by kind", "sys_audit")
    kinds = r.strings("kind")
    assert b"createtable" in kinds and b"insert" in kinds
    assert all(v == b"ok" for v in r.strings("status"))
    _both(ref, port, ["select count(*) as n from kv"])
    _, r = _same_view(ref, port, "select kind from sys_audit", "sys_audit")
    assert r.num_rows == len(kinds)  # reads not audited
    _same_dicts(ref, port)


# ---------------- lazy building ----------------

def test_statement_reading_no_sys_view_builds_none(monkeypatch):
    """A SELECT of a user table, DML and DDL build no sys view; a
    statement that reads one builds exactly it."""
    from ydb_tpu_torch.obs import sysview

    built = []
    real = sysview.sys_source

    def spy(cluster, name):
        built.append(name)
        return real(cluster, name)

    monkeypatch.setattr(sysview, "sys_source", spy)
    s = Cluster(device="cpu").session()
    for sql in ("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id))",
                "INSERT INTO t VALUES (1, 2), (3, 4)",
                "SELECT sum(v) AS s FROM t",
                "SELECT id FROM t WHERE id IN (SELECT id FROM t)",
                "EXPLAIN SELECT * FROM sys_audit"):
        s.execute(sql)
    assert built == []
    s.execute("SELECT count(*) AS n FROM sys_audit")
    assert built == ["sys_audit"]


def test_get_and_in_build_a_view(monkeypatch):
    from ydb_tpu_torch.obs import sysview

    built = []
    real = sysview.sys_source
    monkeypatch.setattr(sysview, "sys_source", lambda c, name: (
        built.append(name), real(c, name))[1])
    c = Cluster(device="cpu")
    c.session().execute("CREATE TABLE t (id int64, PRIMARY KEY (id))")
    db = c.snapshot_db(include_sys=True)
    assert built == []
    assert "sys_scheme_paths" in db.sources
    assert built == ["sys_scheme_paths"]
    src = db.sources.get("sys_audit")
    assert built == ["sys_scheme_paths", "sys_audit"]
    assert src.num_rows == 1 and db.sources["sys_audit"] is src
    assert db.sources.get("sys_nope") is None and "sys_nope" not in \
        db.sources
    assert built == ["sys_scheme_paths", "sys_audit"]
    # without include_sys a sys name is no source at all
    plain = c.snapshot_db()
    assert "sys_audit" not in plain.sources
    assert plain.sources.get("sys_audit") is None
    assert len(built) == 2
