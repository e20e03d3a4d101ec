"""The port's gRPC front (``ydb_tpu_torch/api/server.py``, ``client.py``,
``arrow_io.py``, ``build.py``) against the reference's.

Mirrors the cases of ``tests/test_api.py`` (its two topic cases over
changefeed tables, and ``test_cli_parser_smoke`` against the port's
``cli.py``), the two gRPC cases of ``tests/test_acl.py``, the
``RequestProxy`` case of ``tests/test_serving.py`` and
``tests/test_stats_quoter.py::test_cbo_orders_smallest_connectable_first``.
Each case sends the same statements through a reference server over a
reference ``Cluster`` and a port server over a port ``Cluster`` on the
CPU (one of each for the module, with a table name per case): the same
answers, the same errors, and where a result is exact the same Arrow IPC
bytes. Wire cases: each package's client against the other's server;
the ``.proto`` files byte-equal and the tracked ``_pb2.py`` equal to a
fresh ``protoc`` run; ``ensure_protos()`` with no ``protoc`` anywhere;
the three KeyValue cases of ``tests/test_api_table.py`` on both servers,
and each KeyValue RPC's response bytes equal across the two servers for
one request sequence; the port's topic and key-value clients against
the reference's server; the ``topic write`` and ``topic read``
verbs of the port's CLI against both servers. Tolerance: none."""

import decimal
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time
import types
from contextlib import contextmanager

import grpc
import pyarrow as pa
import pytest

import ydb_tpu.ssa
from ydb_tpu.analysis import leaksan as rleaksan
from ydb_tpu.api import client as rclient
from ydb_tpu.api import server as rserver
from ydb_tpu.kqp.session import Cluster as RCluster

from ydb_tpu_torch.analysis import leaksan
from ydb_tpu_torch.api import build, client, server
from ydb_tpu_torch.api.arrow_io import ipc_to_table
from ydb_tpu_torch.kqp.session import Cluster

pb = server.pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


class Side:
    """One package's cluster, server and driver."""

    def __init__(self, name, cluster, srv_mod, client_mod):
        self.name = name
        self.cluster = cluster
        self.srv_mod = srv_mod
        self.client = client_mod
        self.ApiError = client_mod.ApiError
        self.server, self.port = srv_mod.make_server(cluster, port=0)
        self.server.start()
        self.driver = client_mod.Driver(f"127.0.0.1:{self.port}")

    def close(self):
        self.driver.close()
        self.server.stop(0)
        self.server.request_proxy.close()


@pytest.fixture(scope="module")
def served():
    sides = (Side("ref", RCluster(), rserver, rclient),
             Side("port", Cluster(device="cpu"), server, client))
    yield sides
    for s in sides:
        s.close()
    sides[1].cluster.stop()


@contextmanager
def auth_server(side, tokens):
    """A second server over the side's cluster, with ``auth_tokens``."""
    srv, port = side.srv_mod.make_server(side.cluster, port=0,
                                         auth_tokens=set(tokens))
    srv.start()
    try:
        yield port
    finally:
        srv.stop(0)
        srv.request_proxy.close()


@contextmanager
def granted(cluster, grants):
    """Path ACEs for the case, revoked after it: enforcement is on only
    while some ACE exists, so the module's other cases stay open."""
    for path, who, perms in grants:
        cluster.scheme.grant(path, who, perms)
    try:
        yield
    finally:
        for path, who, _perms in grants:
            cluster.scheme.revoke(path, who)


def raw_query(side, sql, session_id=""):
    return side.driver._call(
        "/ydb_tpu.Query/ExecuteQuery",
        pb.ExecuteQueryRequest(session_id=session_id, sql=sql),
        pb.ExecuteQueryResponse)


def test_query_service_end_to_end(served):
    ipc = {}
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_q (id int64, name string, amount "
                  "decimal(10,2), d date, PRIMARY KEY (id))")
        step, committed = q.execute(
            "INSERT INTO api_q VALUES (1, 'ann', 12.50, date "
            "'2026-01-05'), (2, 'bob', 0.75, date '2026-02-06'), "
            "(3, NULL, NULL, NULL)")
        assert committed
        out = q.execute("SELECT id, name, amount, d FROM api_q ORDER BY id")
        assert isinstance(out, pa.Table)
        assert out.column("id").to_pylist() == [1, 2, 3]
        assert out.column("name").to_pylist() == ["ann", "bob", None]
        assert out.column("amount").to_pylist() == [
            decimal.Decimal("12.50"), decimal.Decimal("0.75"), None]
        assert str(out.column("d").to_pylist()[0]) == "2026-01-05"
        with pytest.raises(s.ApiError):
            q.execute("SELECT nope FROM api_q")
        ipc[s.name] = raw_query(
            s, "SELECT id, name, amount, d FROM api_q ORDER BY id",
            q.session_id).arrow_ipc
        q.close()
    assert ipc["ref"] == ipc["port"]


def test_scheme_service(served):
    got = {}
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_users (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 3)")
        sc = s.driver.scheme_client()
        assert ("/api_users", "table") in sc.list_directory("/")
        d = sc.describe_table("/api_users")
        assert d.store == "row" and d.shards == 3
        assert list(d.primary_key) == ["id"]
        with pytest.raises(s.ApiError):
            sc.describe_table("/missing")
        got[s.name] = d.SerializeToString()
    assert got["ref"] == got["port"]


def test_discovery(served):
    for s in served:
        eps = s.driver.discovery()
        assert eps == [("127.0.0.1", s.port)]


def test_auth_tickets(served):
    for s in served:
        with auth_server(s, {"secret-token"}) as port:
            bad = s.client.Driver(f"127.0.0.1:{port}")
            with pytest.raises(grpc.RpcError) as ei:
                bad.query_client()
            assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
            bad.close()
            good = s.client.Driver(f"127.0.0.1:{port}",
                                   auth_token="secret-token")
            q = good.query_client()
            q.execute("CREATE TABLE api_auth (id int64, PRIMARY KEY (id))")
            good.close()


def test_workload_runner_smoke():
    from ydb_tpu.workload.runner import run_tpch as rrun_tpch

    from ydb_tpu_torch.workload.runner import run_tpch

    results = run_tpch(sf=0.002, queries=["q1", "q6"], iterations=1,
                       device="cpu")
    ref = rrun_tpch(sf=0.002, queries=["q1", "q6"], iterations=1)
    assert [r[0] for r in results] == [r[0] for r in ref] == ["q1", "q6"]
    assert all(r[1] > 0 for r in results)
    assert results[0][2] > 0  # q1 returns groups
    assert [r[2] for r in results] == [r[2] for r in ref]


def test_string_alias_decodes_correctly(served):
    ipc = {}
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_alias (id int64, name string, "
                  "PRIMARY KEY (id))")
        q.execute("INSERT INTO api_alias VALUES (1, 'ann')")
        out = q.execute("SELECT name AS n FROM api_alias")
        assert out.column("n").to_pylist() == ["ann"]
        ipc[s.name] = raw_query(s, "SELECT name AS n FROM api_alias",
                                q.session_id).arrow_ipc
        q.close()
    assert ipc["ref"] == ipc["port"]


def test_session_lifecycle_and_commit_validation(served):
    """The session map drops a closed session; a topic commit with a
    bad partition on a live changefeed topic is refused, with the same
    error on both servers."""
    errors = {}
    for s in served:
        proxy = s.server.request_proxy
        q = s.driver.query_client()
        assert q.session_id in proxy.sessions
        q.execute("CREATE TABLE api_cf (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, changefeed = on)")
        q.close()
        tc = s.driver.topic_client()
        errors[s.name] = []
        for part in (-1, 99):
            with pytest.raises(s.ApiError) as ei:
                tc.commit("api_cf_changefeed", "c", part, 0)
            errors[s.name].append(str(ei.value))
        assert q.session_id not in proxy.sessions
    assert errors["ref"] == errors["port"]


def test_topic_service(served):
    """``tests/test_api.py::test_topic_service`` on both servers: the
    changefeed read, commit and re-read, a direct write, a write to a
    missing topic refused; the same messages on both."""
    got = {}
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_tt (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, changefeed = on)")
        q.execute("INSERT INTO api_tt VALUES (7)")
        q.close()
        s.cluster.run_background()
        tc = s.driver.topic_client()
        msgs = tc.read("api_tt_changefeed", "app")
        assert len(msgs) == 1
        p, off, data = msgs[0]
        assert b'"key": [7]' in data
        tc.commit("api_tt_changefeed", "app", p, off)
        assert tc.read("api_tt_changefeed", "app") == []
        p2, off2 = tc.write("api_tt_changefeed", "hello", key="k")
        assert off2 >= 0
        with pytest.raises(s.ApiError):
            tc.write("missing", "x")
        after = tc.read("api_tt_changefeed", "app")
        got[s.name] = ([(p, off, json.loads(data)["key"])], (p2, off2),
                       after)
    assert got["ref"] == got["port"]
    assert got["port"][2] == [(got["port"][1][0], got["port"][1][1],
                               b"hello")]


def test_topic_streaming_sessions(served):
    """``tests/test_api.py::test_topic_streaming_sessions`` on both
    servers: one ack per streamed write, a duplicate seqno swallowed, an
    auto-committing read session that ends on its idle timeout, and
    sessions without commits that see everything again."""
    got = {}
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_st (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, changefeed = on)")
        q.close()
        tc = s.driver.topic_client()
        acks = tc.stream_write(
            "api_st_changefeed",
            [(f"m{i}".encode(), "", "prod-1", i + 1) for i in range(5)])
        dup = tc.stream_write("api_st_changefeed",
                              [(b"m0", "", "prod-1", 1)])
        first = list(tc.stream_read("api_st_changefeed", "sapp",
                                    idle_timeout_ms=300))
        assert sorted(d for _, _, d in first) == [
            f"m{i}".encode() for i in range(5)]
        assert list(tc.stream_read("api_st_changefeed", "sapp",
                                   idle_timeout_ms=200)) == []
        again = [list(tc.stream_read("api_st_changefeed", "s2",
                                     auto_commit=False,
                                     idle_timeout_ms=200))
                 for _ in range(2)]
        assert [len(a) for a in again] == [5, 5]
        got[s.name] = (acks, dup, sorted(first), sorted(again[0]))
    assert got["ref"] == got["port"]


def test_cli_parser_smoke():
    """``tests/test_api.py::test_cli_parser_smoke`` for the port's
    ``cli.py``: a verb without its subcommand exits non-zero, as the
    reference's does."""
    from ydb_tpu import cli as rcli

    from ydb_tpu_torch import cli

    codes = []
    for mod in (rcli, cli):
        with pytest.raises(SystemExit) as ei:
            mod.main(["scheme"])  # missing subcommand
        codes.append(ei.value.code)
    assert codes[0] == codes[1] != 0


def test_cli_topic_and_scheme_verbs_against_both_servers(served, capsys):
    """The port's ``topic write``, ``topic read --commit``, ``scheme ls``
    and ``scheme describe`` against each server print what the
    reference's CLI prints (each CLI on its own changefeed table)."""
    from ydb_tpu import cli as rcli

    from ydb_tpu_torch import cli

    outs = {}
    for s in served:
        ep = ["-e", f"127.0.0.1:{s.port}"]
        for label, mod in (("ref", rcli), ("port", cli)):
            table = f"api_cli_{label}"
            q = s.driver.query_client()
            q.execute(f"CREATE TABLE {table} (id int64, v string, "
                      "PRIMARY KEY (id)) WITH (store = row, shards = 2, "
                      "changefeed = on)")
            q.close()
            topic = f"{table}_changefeed"
            mod.main(["topic", "write", *ep, topic, "hello", "--key", "a"])
            mod.main(["topic", "read", *ep, topic, "--consumer", "c",
                      "--commit"])
            mod.main(["topic", "read", *ep, topic, "--consumer", "c"])
            mod.main(["scheme", "describe", *ep, f"/{table}"])
            outs[(s.name, label)] = capsys.readouterr().out.replace(
                table, "T")
        for label, mod in (("ref", rcli), ("port", cli)):
            mod.main(["scheme", "ls", *ep, "/"])
            outs[(s.name, label, "ls")] = capsys.readouterr().out
    for side in ("ref", "port"):
        assert outs[(side, "port")] == outs[(side, "ref")]
        assert outs[(side, "port", "ls")] == outs[(side, "ref", "ls")]
        assert "/api_cli_port" in outs[(side, "port", "ls")]
    text = outs[("port", "port")]
    assert text.startswith("partition ") and "] hello\n" in text
    assert "table /T  store=row  shards=2" in text
    assert text == outs[("ref", "ref")]


def test_export_import_service_roundtrip(served):
    """Snapshot a table into the cluster store via the SDK, import it
    back as a new resharded cluster table with string ids remapped into
    the shared dictionary set."""
    got = {}
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_inv (id int64, name text, qty int64, "
                  "PRIMARY KEY (id)) WITH (shards = 2)")
        q.execute("INSERT INTO api_inv VALUES (1, 'bolt', 10), "
                  "(2, 'nut', 20), (3, 'washer', 30)")
        ex = s.driver.export_client()
        man = ex.export_table("api_inv", "api_inv_snap")
        assert man["rows"] == 3 and man["parts"] >= 1
        # a write AFTER the snapshot must not appear in the restore
        q.execute("INSERT INTO api_inv VALUES (4, 'screw', 40)")
        assert ex.import_table("api_inv_snap", table="api_inv2",
                               shards=3) == 3
        out = q.execute("SELECT i.name AS n, i.qty AS v FROM api_inv2 i "
                        "ORDER BY v")
        assert out.to_pydict() == {"n": ["bolt", "nut", "washer"],
                                   "v": [10, 20, 30]}
        backups = [(n, r) for n, r, _snap in ex.list_backups()]
        assert ("api_inv_snap", 3) in backups
        # a join across original and restored proves the shared-dict remap
        out2 = q.execute(
            "SELECT a.name AS n FROM api_inv a JOIN api_inv2 b "
            "ON a.name = b.name WHERE b.qty = 20")
        assert out2.to_pydict()["n"] == ["nut"]
        with pytest.raises(s.ApiError):
            ex.import_table("api_inv_snap", table="api_inv2")  # exists
        with pytest.raises(s.ApiError):
            ex.export_table("nope")
        got[s.name] = (man["rows"], man["parts"], out.to_pydict(),
                       out2.to_pydict())
        q.close()
    assert got["ref"] == got["port"]


def test_rate_limiter_service(served):
    for s in served:
        rl = s.driver.rate_limiter_client()
        rl.create_resource("api/read", rate=50.0, burst=2.0)
        assert rl.acquire("api/read")[0]
        assert rl.acquire("api/read")[0]
        ok, retry = rl.acquire("api/read")
        assert not ok and retry > 0
        time.sleep(0.1)  # rate 50/s refills ~5 tokens
        assert rl.acquire("api/read")[0]
        desc = rl.describe_resource("api/read")
        assert desc["rate"] == 50.0 and desc["burst"] == 2.0
        with pytest.raises(s.ApiError):
            rl.acquire("api/missing")
        with pytest.raises(s.ApiError):
            rl.create_resource("bad", rate=0.0)
        with pytest.raises(s.ApiError, match="already exists"):
            rl.create_resource("api/read", rate=1.0)


def test_monitoring_coordination_cms_auth_services(served):
    """Monitoring health, Coordination (Kesus sessions and counting
    semaphores with contention), Cms dynamic config (versioned,
    stale-version refusal, applied to the running cluster) and Auth
    WhoAmI on open and token-authenticated servers."""
    got = {}
    for s in served:
        d = s.driver
        h = d._call("/ydb_tpu.Monitoring/HealthCheck",
                    pb.HealthCheckRequest(), pb.HealthCheckResponse)
        assert h.status == "GOOD"
        mk = pb.CoordSemaphoreRequest
        s1 = d._call("/ydb_tpu.Coordination/CreateSession",
                     pb.CoordSessionRequest(),
                     pb.CoordSessionResponse).session_id
        s2 = d._call("/ydb_tpu.Coordination/CreateSession",
                     pb.CoordSessionRequest(),
                     pb.CoordSessionResponse).session_id
        d._call("/ydb_tpu.Coordination/CreateSemaphore",
                mk(name="api_lock", limit=1), pb.CoordSemaphoreResponse)
        acq = "/ydb_tpu.Coordination/AcquireSemaphore"
        assert d._call(acq, mk(session_id=s1, name="api_lock", count=1),
                       pb.CoordSemaphoreResponse).acquired
        assert not d._call(acq, mk(session_id=s2, name="api_lock", count=1),
                           pb.CoordSemaphoreResponse).acquired
        desc = d._call("/ydb_tpu.Coordination/DescribeSemaphore",
                       mk(name="api_lock"), pb.CoordSemaphoreResponse)
        assert desc.count == 1 and desc.limit == 1
        d._call("/ydb_tpu.Coordination/ReleaseSemaphore",
                mk(session_id=s1, name="api_lock"),
                pb.CoordSemaphoreResponse)
        assert d._call(acq, mk(session_id=s2, name="api_lock", count=1),
                       pb.CoordSemaphoreResponse).acquired
        v = d._call("/ydb_tpu.Cms/SetConfig",
                    pb.SetConfigRequest(yaml="n_shards: 8",
                                        expect_version=-1),
                    pb.SetConfigResponse)
        assert not v.error and v.version == 1
        g = d._call("/ydb_tpu.Cms/GetConfig", pb.GetConfigRequest(),
                    pb.GetConfigResponse)
        assert g.yaml.strip() == "n_shards: 8" and g.version == 1
        assert s.cluster.n_shards == 8  # the dispatcher applied it
        stale = d._call("/ydb_tpu.Cms/SetConfig",
                        pb.SetConfigRequest(yaml="n_shards: 2",
                                            expect_version=0),
                        pb.SetConfigResponse)
        assert stale.error  # optimistic version check
        w = d._call("/ydb_tpu.Auth/WhoAmI", pb.WhoAmIRequest(),
                    pb.WhoAmIResponse)
        assert not w.authenticated
        with auth_server(s, {"tok1"}) as port:
            d2 = s.client.Driver(f"127.0.0.1:{port}", auth_token="tok1")
            w2 = d2._call("/ydb_tpu.Auth/WhoAmI", pb.WhoAmIRequest(),
                          pb.WhoAmIResponse)
            assert w2.authenticated and w2.user == "tok1"
            d2.close()
        got[s.name] = (h.SerializeToString(), (s1, s2),
                       desc.SerializeToString(), g.SerializeToString(),
                       stale.error)
    assert got["ref"] == got["port"]


def _poll(driver, op_id):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = driver._call("/ydb_tpu.Operation/GetOperation",
                          pb.GetOperationRequest(id=op_id),
                          pb.OperationStatus)
        if st.ready:
            return st
        time.sleep(0.02)
    return st


def test_operation_service_async_export(served):
    """Async export returns an operation id at once; polling reaches
    ready with the result; list shows it; cancel forgets finished ops
    and refuses unknown ids."""
    for s in served:
        d = s.driver
        q = d.query_client()
        q.execute("CREATE TABLE api_op (id int64, v int64, "
                  "PRIMARY KEY (id))")
        q.execute("INSERT INTO api_op VALUES (1, 1), (2, 2)")
        resp = d._call("/ydb_tpu.Export/ExportBackup",
                       pb.ExportRequest(table="api_op", name="api_op_snap",
                                        async_op=True),
                       pb.ExportResponse)
        assert resp.operation_id and not resp.error
        st = _poll(d, resp.operation_id)
        assert st.ready and not st.error and st.rows == 2
        lst = d._call("/ydb_tpu.Operation/ListOperations",
                      pb.ListOperationsRequest(),
                      pb.ListOperationsResponse)
        assert any(o.id == resp.operation_id for o in lst.operations)
        # async failure surfaces on poll, not as an RPC error
        bad = d._call("/ydb_tpu.Export/ExportBackup",
                      pb.ExportRequest(table="nope", async_op=True),
                      pb.ExportResponse)
        st2 = _poll(d, bad.operation_id)
        assert st2.ready and "unknown table" in st2.error
        gone = d._call("/ydb_tpu.Operation/CancelOperation",
                       pb.CancelOperationRequest(id=resp.operation_id),
                       pb.OperationStatus)
        assert not gone.error
        miss = d._call("/ydb_tpu.Operation/GetOperation",
                       pb.GetOperationRequest(id=resp.operation_id),
                       pb.OperationStatus)
        assert miss.error == "unknown operation"
        q.close()


def test_scripting_service(served):
    """A multi-statement script runs in one session, aborts at the
    first error with per-statement status, and returns the final SELECT
    as Arrow IPC (the same bytes from both servers)."""
    ipc = {}
    for s in served:
        d = s.driver
        r = d._call("/ydb_tpu.Scripting/ExecuteScript",
                    pb.ExecuteScriptRequest(script=(
                        "CREATE TABLE api_sc (id int64, v int64, "
                        "PRIMARY KEY (id)); "
                        "INSERT INTO api_sc VALUES (1, 10), (2, 20); "
                        "SELECT t.v AS v FROM api_sc t ORDER BY v")),
                    pb.ExecuteScriptResponse)
        assert not r.error and len(r.statements) == 3
        assert ipc_to_table(r.last_result_ipc).to_pydict() == {
            "v": [10, 20]}
        bad = d._call("/ydb_tpu.Scripting/ExecuteScript",
                      pb.ExecuteScriptRequest(script=(
                          "INSERT INTO api_sc VALUES (3, 30); "
                          "SELECT nope FROM api_sc; "
                          "INSERT INTO api_sc VALUES (4, 40)")),
                      pb.ExecuteScriptResponse)
        assert bad.error and len(bad.statements) == 2  # aborted at 2nd
        out = d.query_client().execute("SELECT COUNT(*) AS n FROM api_sc")
        assert out.to_pydict()["n"] == [3]  # 3rd statement never ran
        open_tx = d._call("/ydb_tpu.Scripting/ExecuteScript",
                          pb.ExecuteScriptRequest(script=(
                              "CREATE TABLE api_sc_row (id int64, "
                              "PRIMARY KEY (id)) WITH (store = row); "
                              "BEGIN; INSERT INTO api_sc_row VALUES (1)")),
                          pb.ExecuteScriptResponse)
        assert "open transaction" in open_tx.error
        out = d.query_client().execute(
            "SELECT COUNT(*) AS n FROM api_sc_row")
        assert out.to_pydict()["n"] == [0]  # rolled back
        ipc[s.name] = r.last_result_ipc
    assert ipc["ref"] == ipc["port"]


# ---- tests/test_acl.py's gRPC cases ----

def test_session_cannot_be_hijacked_across_principals(served):
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_hj (id int64, v int64, "
                  "PRIMARY KEY (id))")
        q.execute("INSERT INTO api_hj VALUES (1, 10)")
        with granted(s.cluster, [("/api_hj", "alice", "read")]), \
                auth_server(s, {"alice", "bob"}) as port:
            alice = s.client.Driver(f"127.0.0.1:{port}",
                                    auth_token="alice")
            qa = alice.query_client()  # creates a server-side session
            sid = qa.session_id
            assert sid
            bob = s.client.Driver(f"127.0.0.1:{port}", auth_token="bob")
            qb = bob.query_client()
            qb.session_id = sid  # guessed/stolen session id
            with pytest.raises(grpc.RpcError) as ei:
                qb.execute("SELECT v FROM api_hj")
            assert ei.value.code() == grpc.StatusCode.PERMISSION_DENIED
            alice.close()
            bob.close()


def test_grpc_front_carries_principal(served):
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_pr (id int64, v int64, "
                  "PRIMARY KEY (id))")
        q.execute("INSERT INTO api_pr VALUES (1, 10)")
        with granted(s.cluster, [("/api_pr", "sesame", "read")]), \
                auth_server(s, {"sesame", "other"}) as port:
            drv = s.client.Driver(f"127.0.0.1:{port}", auth_token="sesame")
            qs = drv.query_client()
            out = qs.execute("SELECT v FROM api_pr")
            assert out.column("v").to_pylist() == [10]
            with pytest.raises(s.ApiError, match="access denied"):
                qs.execute("INSERT INTO api_pr VALUES (9, 9)")
            drv.close()
            drv2 = s.client.Driver(f"127.0.0.1:{port}", auth_token="other")
            with pytest.raises(s.ApiError, match="access denied"):
                drv2.query_client().execute("SELECT v FROM api_pr")
            drv2.close()


# ---- tests/test_serving.py's RequestProxy case ----

def test_request_proxy_close_drains_sessions(served):
    """RequestProxy sessions are serving.conn handles; close() drops
    every server-side session (and joins operation threads), so the
    leak sanitizer sees them drain."""

    class Ctx:
        def invocation_metadata(self):
            return []

        def abort(self, code, msg):
            raise RuntimeError(msg)

    for s, san in zip(served, (rleaksan, leaksan)):
        with san.activate():
            proxy = s.srv_mod.RequestProxy(s.cluster)
            for _ in range(5):
                proxy.create_session(pb.CreateSessionRequest(), Ctx())
            assert san.counts().get("serving.conn") == 5
            proxy.close()
            assert not san.counts().get("serving.conn")
            san.assert_drained(kinds=("serving.conn", "serving.seat"))


# ---- tests/test_stats_quoter.py::test_cbo_orders_smallest_connectable_first

def _probe_order(plan, TableScan) -> list:
    """The build-side scan tables along the left-deep probe spine."""
    order = []

    def walk(node):
        if isinstance(node, TableScan):
            order.append(node.table)
            return
        if hasattr(node, "probe"):
            walk(node.probe)
            b = node.build
            while not isinstance(b, TableScan):
                if hasattr(b, "probe"):
                    b = b.probe
                elif hasattr(b, "input"):
                    b = b.input
                else:
                    return
            order.append(b.table)
        elif hasattr(node, "input"):
            walk(node.input)

    walk(plan)
    return order


def test_cbo_orders_smallest_connectable_first():
    """q5 with row counts in the catalog: supplier (small) joins before
    lineitem (the big fact expansion), and the join order is the
    reference's."""
    from ydb_tpu.plan.nodes import TableScan as RTableScan
    from ydb_tpu.sql import parser as rparser
    from ydb_tpu.sql import planner as rplanner
    from ydb_tpu.workload import tpch as rtpch
    from ydb_tpu.workload.queries import TPCH as RTPCH

    from ydb_tpu_torch.plan.nodes import TableScan
    from ydb_tpu_torch.sql import parser, planner
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    orders = []
    for tp_mod, parse_mod, plan_mod, queries, scan in (
            (rtpch, rparser, rplanner, RTPCH, RTableScan),
            (tpch, parser, planner, TPCH, TableScan)):
        data = tp_mod.TpchData(sf=0.005, seed=9)
        counts = {t: len(next(iter(cols.values())))
                  for t, cols in data.tables.items()}
        catalog = plan_mod.Catalog(
            schemas={t: data.schema(t) for t in data.tables},
            primary_keys=dict(tp_mod.PRIMARY_KEYS),
            dicts=data.dicts,
            row_counts=counts,
        )
        pq = plan_mod.plan_select_full(parse_mod.parse(queries["q5"]),
                                       catalog)
        order = _probe_order(pq.plan, scan)
        assert order.index("supplier") < order.index("lineitem")
        orders.append(order)
    assert orders[0] == orders[1]


# ---- the wire between the packages ----

def test_each_client_drives_the_other_server(served):
    """The port's client against the reference's server and the
    reference's client against the port's: the same answers (IPC bytes)
    as each package's own pair."""
    ref, port = served
    ipc = {}
    for label, side, client_mod in (("ref-ref", ref, rclient),
                                    ("port-ref", ref, client),
                                    ("ref-port", port, rclient),
                                    ("port-port", port, client)):
        d = client_mod.Driver(f"127.0.0.1:{side.port}")
        q = d.query_client()
        table = "api_x_" + label.replace("-", "_")
        q.execute(f"CREATE TABLE {table} (id int64, name string, "
                  f"amount decimal(10,2), PRIMARY KEY (id))")
        step, committed = q.execute(
            f"INSERT INTO {table} VALUES (1, 'ann', 1.25), (2, NULL, 2.5)")
        assert committed
        out = q.execute(f"SELECT name, amount FROM {table} ORDER BY id")
        assert out.to_pydict() == {
            "name": ["ann", None],
            "amount": [decimal.Decimal("1.25"), decimal.Decimal("2.50")]}
        with pytest.raises(client_mod.ApiError):
            q.execute(f"SELECT nope FROM {table}")
        assert d.discovery() == [("127.0.0.1", side.port)]
        ipc[label] = d._call(
            "/ydb_tpu.Query/ExecuteQuery",
            pb.ExecuteQueryRequest(
                session_id=q.session_id,
                sql=f"SELECT name, amount FROM {table} ORDER BY id"),
            pb.ExecuteQueryResponse).arrow_ipc
        q.close()
        d.close()
    assert len(set(ipc.values())) == 1, ipc.keys()


def test_port_stubs_drive_the_reference_topic_and_keyvalue(served):
    """``TopicClient`` and ``KeyValueClient`` of the port are thin
    clients over the wire: against the reference's server they work."""
    ref = served[0]
    rq = ref.driver.query_client()
    rq.execute("CREATE TABLE api_feed (id int64, PRIMARY KEY (id)) "
               "WITH (store = row, changefeed = on)")
    rq.execute("INSERT INTO api_feed VALUES (7)")
    ref.cluster.run_background()
    d = client.Driver(f"127.0.0.1:{ref.port}")
    tc = d.topic_client()
    msgs = tc.read("api_feed_changefeed", "app")
    assert len(msgs) == 1 and b"7" in msgs[0][2]
    tc.commit("api_feed_changefeed", "app", msgs[0][0], msgs[0][1])
    assert tc.read("api_feed_changefeed", "app") == []
    acks = tc.stream_write("api_feed_changefeed",
                           [(b"m0", "", "p", 1), (b"m1", "", "p", 2)])
    assert len(acks) == 2
    got = list(tc.stream_read("api_feed_changefeed", "app",
                              idle_timeout_ms=200))
    assert sorted(m for _p, _o, m in got) == [b"m0", b"m1"]
    kv = d.keyvalue_client()
    kv.create_volume("api_vol")
    kv.write("api_vol", "a", b"1")
    kv.write("api_vol", "b", b"2")
    assert kv.read("api_vol", "a") == b"1"
    assert kv.list_range("api_vol", "a", "c") == [("a", b"1"), ("b", b"2")]
    assert kv.rename("api_vol", "b", "bb")
    assert kv.delete_range("api_vol", "a", "b") == 1
    kv.drop_volume("api_vol")
    with pytest.raises(client.ApiError):
        kv.read("api_vol", "bb")
    d.close()
    rq.close()


def test_keyvalue_service(served):
    """``tests/test_api_table.py::test_keyvalue_service`` on both
    servers: volume lifecycle, the seven RPCs, and a second server over
    the same cluster that boots the volume on access."""
    for s in served:
        kv = s.driver.keyvalue_client()
        kv.create_volume("kvs_vol1")
        with pytest.raises(s.ApiError):
            kv.create_volume("kvs_vol1")  # duplicate
        kv.write("kvs_vol1", "a", b"1")
        kv.write("kvs_vol1", "b", b"2")
        kv.write("kvs_vol1", "c", b"3")
        assert kv.read("kvs_vol1", "b") == b"2"
        assert kv.read("kvs_vol1", "nope") is None
        assert kv.list_range("kvs_vol1", "a", "c") == [("a", b"1"),
                                                       ("b", b"2")]
        assert kv.rename("kvs_vol1", "b", "bb")
        assert kv.read("kvs_vol1", "bb") == b"2"
        assert kv.delete_range("kvs_vol1", "a", "b") == 1
        assert kv.read("kvs_vol1", "a") is None
        with pytest.raises(s.ApiError):
            kv.write("kvs_ghost", "k", b"v")

        # durability: a NEW proxy over the same store still sees the data
        server2, port2 = s.srv_mod.make_server(s.cluster, port=0)
        server2.start()
        d2 = s.client.Driver(f"127.0.0.1:{port2}")
        try:
            kv2 = d2.keyvalue_client()
            assert kv2.read("kvs_vol1", "bb") == b"2"
            assert kv2.read("kvs_vol1", "c") == b"3"
            kv2.drop_volume("kvs_vol1")
            with pytest.raises(s.ApiError):
                kv2.read("kvs_vol1", "bb")
        finally:
            d2.close()
            server2.stop(0)
            server2.request_proxy.close()


def test_kv_volume_prefix_names_do_not_collide(served):
    """Registry probes are exact-key: volume 'kvp_a' must not shadow
    'kvp_ab' (``tests/test_api_table.py``), on both servers."""
    for s in served:
        kv = s.driver.keyvalue_client()
        kv.create_volume("kvp_ab")
        kv.create_volume("kvp_a")  # exact-key check: no phantom 'exists'
        kv.write("kvp_ab", "k", b"ab-val")
        kv.write("kvp_a", "k", b"a-val")
        assert kv.read("kvp_ab", "k") == b"ab-val"
        assert kv.read("kvp_a", "k") == b"a-val"
        with pytest.raises(s.ApiError):
            kv.read("kvp_abc", "k")  # never created


def test_kv_volume_name_validation(served):
    for s in served:
        kv = s.driver.keyvalue_client()
        with pytest.raises(s.ApiError, match="'/'-free"):
            kv.create_volume("a/log")
        with pytest.raises(s.ApiError, match="'/'-free"):
            kv.create_volume("")


def _kv_requests(rpc: str, vol: str) -> list:
    """A request sequence that ends on ``rpc``'s own calls (hits,
    misses, error answers), each a (method, request) pair."""
    big = bytes(range(256)) * 20  # 5,120 bytes: spills past 4,096
    setup = [("CreateVolume", pb.KvVolumeRequest(path=vol))] + [
        ("ExecuteTransaction", pb.KvWriteRequest(
            volume=vol, key=k, value=v))
        for k, v in (("a", b"1"), ("b", b""), ("c", big), ("d", b"4"))]
    calls = {
        "CreateVolume": [pb.KvVolumeRequest(path=vol),
                         pb.KvVolumeRequest(path="x/y"),
                         pb.KvVolumeRequest(path="")],
        "DropVolume": [pb.KvVolumeRequest(path=vol),
                       pb.KvVolumeRequest(path=vol)],
        "ExecuteTransaction": [
            pb.KvWriteRequest(volume=vol, key="a", value=big),
            pb.KvWriteRequest(volume=vol, key="a", value=b"small"),
            pb.KvWriteRequest(volume=vol + "_ghost", key="a", value=b"")],
        "Read": [pb.KvReadRequest(volume=vol, key=k)
                 for k in ("a", "b", "c", "nope")]
                + [pb.KvReadRequest(volume=vol + "_ghost", key="a")],
        "ListRange": [pb.KvListRangeRequest(volume=vol, to="c"),
                      pb.KvListRangeRequest(volume=vol, limit=2),
                      pb.KvListRangeRequest(**{"volume": vol,
                                               "from": "b"}),
                      pb.KvListRangeRequest(volume=vol + "_ghost")],
        "DeleteRange": [pb.KvDeleteRangeRequest(volume=vol, to="b"),
                        pb.KvDeleteRangeRequest(**{"volume": vol,
                                                   "from": "c"}),
                        pb.KvDeleteRangeRequest(volume=vol + "_ghost")],
        "Rename": [pb.KvRenameRequest(volume=vol, old_key="c",
                                      new_key="c"),
                   pb.KvRenameRequest(volume=vol, old_key="c",
                                      new_key="a"),
                   pb.KvRenameRequest(volume=vol, old_key="ghost",
                                      new_key="z"),
                   pb.KvRenameRequest(volume=vol + "_ghost",
                                      old_key="a", new_key="b")],
    }[rpc]
    tail = [("ListRange", pb.KvListRangeRequest(volume=vol))]
    return setup + [(rpc, r) for r in calls] + tail


@pytest.mark.parametrize("rpc", list(server._SERVICES["ydb_tpu.KeyValue"]))
def test_keyvalue_rpc_response_bytes_equal(served, rpc):
    """The same request sequence against the reference's server and the
    port's: every response, serialized, byte for byte equal."""
    methods = server._SERVICES["ydb_tpu.KeyValue"]
    got = {}
    for s in served:
        out = []
        for name, req in _kv_requests(rpc, f"kvb_{rpc}"):
            resp_cls = methods[name][2]
            call = s.driver.channel.unary_unary(
                f"/ydb_tpu.KeyValue/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=lambda b: b)
            raw = call(req)
            resp_cls.FromString(raw)  # a well-formed answer
            out.append((name, raw))
        got[s.name] = out
    assert got["ref"] == got["port"]


def test_proto_files_are_the_reference_and_pb2_is_protoc_output(tmp_path):
    """The port's ``.proto`` is the reference's byte for byte, and the
    tracked ``_gen/ydb_tpu_api_pb2.py`` is what ``protoc`` writes for it
    (skipped only where there is no ``protoc``)."""
    ref_proto = os.path.join(REPO, "ydb_tpu", "api", "protos",
                             "ydb_tpu_api.proto")
    assert filecmp.cmp(build.PROTO, ref_proto, shallow=False)
    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("no protoc on this host to regenerate with")
    subprocess.run([protoc, f"--python_out={tmp_path}",
                    f"--proto_path={os.path.dirname(build.PROTO)}",
                    os.path.basename(build.PROTO)],
                   check=True, capture_output=True, timeout=60)
    fresh = tmp_path / "ydb_tpu_api_pb2.py"
    with open(build.GEN, "rb") as f:
        assert f.read() == fresh.read_bytes()


def test_ensure_protos_needs_no_protoc(monkeypatch):
    """With PATH emptied and process spawning refused, the message
    module still imports (fresh, from the repo) and its messages
    round-trip; they are the reference's classes."""
    name = "ydb_tpu_torch.api._gen.ydb_tpu_api_pb2"
    monkeypatch.setenv("PATH", "")
    monkeypatch.delitem(sys.modules, name)

    def refuse(*_a, **_k):
        raise AssertionError("ensure_protos spawned a process")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    assert shutil.which("protoc") is None
    mod = build.ensure_protos()
    assert mod.__name__ == name and name in sys.modules
    msg = mod.ExecuteQueryRequest(session_id="s", sql="SELECT 1")
    back = rserver.pb.ExecuteQueryRequest.FromString(
        msg.SerializeToString())
    assert back.sql == "SELECT 1"
    assert mod.ExecuteQueryRequest is rserver.pb.ExecuteQueryRequest


def test_every_wire_type_reads_back_equal(served):
    """A result with every wire type — ints, float, bool, string with
    NULLs, decimal, date — reads back equal from both servers."""
    got = {}
    for s in served:
        q = s.driver.query_client()
        q.execute("CREATE TABLE api_types (id int64, i32 int32, f float64, "
                  "b bool, s string, m decimal(12,3), d date, "
                  "PRIMARY KEY (id))")
        q.execute("INSERT INTO api_types VALUES "
                  "(1, -5, 0.5, true, 'x', 1.125, date '2020-02-29'), "
                  "(2, NULL, NULL, NULL, NULL, NULL, NULL), "
                  "(3, 7, -2.25, false, 'yy', -0.001, date '1970-01-01')")
        out = q.execute("SELECT * FROM api_types ORDER BY id")
        got[s.name] = out.to_pydict()
        assert out.column("m").to_pylist()[2] == decimal.Decimal("-0.001")
        assert out.column("f").to_pylist()[1] is None  # NULL, not NaN
        q.close()
    assert got["ref"] == got["port"]
