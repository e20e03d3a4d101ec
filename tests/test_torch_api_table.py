"""The port's Table and FederationDiscovery gRPC services
(``ydb_tpu_torch/api/server.py``: structured DDL, data queries with
client transaction control, Arrow BulkUpsert, streaming ReadTable,
CopyTable, Explain) against the reference's.

Mirrors the cases of ``tests/test_api_table.py`` less its three KeyValue
cases, which ``tests/test_torch_api.py`` holds. Each case sends the same calls through a
reference server over a reference ``Cluster`` and a port server over a
port ``Cluster`` on the CPU (one of each for the module, a table name
per case): the same answers and errors, and where a result is exact the
same Arrow IPC bytes. One more case streams a table written by BulkUpsert
back through ReadTable, frame by frame equal between the packages.
Tolerance: none but a float sum, rtol 1e-12."""

import sys
import types

import numpy as np
import pyarrow as pa
import pytest

import ydb_tpu.ssa
from ydb_tpu.api import client as rclient
from ydb_tpu.api import server as rserver
from ydb_tpu.kqp.session import Cluster as RCluster

from ydb_tpu_torch.api import client, server
from ydb_tpu_torch.kqp.session import Cluster

from test_torch_api import Side, auth_server

pb = server.pb


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


@pytest.fixture(scope="module")
def served():
    sides = (Side("ref", RCluster(), rserver, rclient),
             Side("port", Cluster(device="cpu"), server, client))
    yield sides
    for s in sides:
        s.close()
    sides[1].cluster.stop()


def raw_table_query(side, t, sql):
    return side.driver._call(
        "/ydb_tpu.Table/ExecuteDataQuery",
        pb.ExecuteDataQueryRequest(session_id=t.session_id, sql=sql,
                                   tx=pb.TxControl()),
        pb.ExecuteDataQueryResponse).arrow_ipc


def test_table_ddl_lifecycle(served):
    got = {}
    for s in served:
        t = s.driver.table_client()
        t.create_table(
            "tb_orders",
            [("id", "int64", True), ("who", "string", False),
             ("amt", "float64", False)],
            primary_key=["id"], store="column", shards=2)
        d = s.driver.scheme_client().describe_table("/tb_orders")
        assert d.shards == 2 and d.store == "column"
        ver = t.alter_table("tb_orders", [("note", "string")])
        assert ver > 1
        d2 = s.driver.scheme_client().describe_table("/tb_orders")
        assert "note" in [c.name for c in d2.columns]
        # duplicate create surfaces as an error, not a crash
        with pytest.raises(s.ApiError):
            t.create_table("tb_orders", [("id", "int64", True)],
                           primary_key=["id"])
        t.drop_table("tb_orders")
        with pytest.raises(s.ApiError):
            s.driver.scheme_client().describe_table("/tb_orders")
        got[s.name] = (d.SerializeToString(), ver, d2.SerializeToString())
        t.close()
    assert got["ref"] == got["port"]


def test_execute_data_query_tx_control(served):
    got = {}
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_acct", [("id", "int64", True),
                                   ("bal", "int64", False)],
                       primary_key=["id"], store="row")
        (_, committed), tx = t.execute(
            "INSERT INTO tb_acct VALUES (1, 100), (2, 50)")
        assert committed and tx == ""
        # interactive tx: begin -> statements under tx_id -> commit
        _, tx = t.execute("UPDATE tb_acct SET bal = bal - 30 WHERE id = 1",
                          begin=True)
        assert tx
        # another session sees nothing while the tx is open
        other = s.driver.table_client()
        out, _ = other.execute("SELECT bal FROM tb_acct ORDER BY id")
        assert out.column("bal").to_pylist() == [100, 50]
        (_, committed), tx3 = t.execute(
            "UPDATE tb_acct SET bal = bal + 30 WHERE id = 2",
            tx_id=tx, commit=True)
        assert committed and tx3 == ""
        out, _ = other.execute("SELECT bal FROM tb_acct ORDER BY id")
        assert out.column("bal").to_pylist() == [70, 80]
        # unknown tx id is rejected
        with pytest.raises(s.ApiError):
            t.execute("SELECT 1 AS one", tx_id="tx-999")
        got[s.name] = (tx, raw_table_query(
            s, other, "SELECT id, bal FROM tb_acct ORDER BY id"))
        t.close()
        other.close()
    assert got["ref"] == got["port"]


def _events(n):
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "tag": pa.array([f"t{i % 7}" for i in range(n)]),
        "v": pa.array(np.linspace(0.0, 1.0, n)),
    })


def test_bulk_upsert_and_stream_read(served):
    n = 10_000
    at = _events(n)
    got = {}
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_ev", [("id", "int64", True),
                                 ("tag", "string", False),
                                 ("v", "float64", False)],
                       primary_key=["id"], store="column", shards=2)
        assert t.bulk_upsert("tb_ev", at) == n
        out, _ = t.execute("SELECT count(*) AS c, sum(v) AS s FROM tb_ev")
        assert out.column("c").to_pylist() == [n]
        assert abs(out.column("s").to_pylist()[0] - n / 2) < 1.0
        # streaming ReadTable: batches reassemble to the full table
        got_t = pa.concat_tables(
            t.read_table("tb_ev", columns=["id", "tag"], batch_rows=2048))
        assert got_t.num_rows == n
        assert sorted(got_t.column("id").to_pylist()) == list(range(n))
        assert got_t.column("tag").to_pylist()[:3] is not None
        # error paths: unknown table, missing column
        with pytest.raises(s.ApiError):
            list(t.read_table("nope"))
        with pytest.raises(s.ApiError):
            t.bulk_upsert("nope", at)
        with pytest.raises(s.ApiError):
            t.bulk_upsert("tb_ev", at.drop_columns(["v"]))
        got[s.name] = (out.column("s").to_pylist()[0],
                       got_t.sort_by("id").to_pydict())
        t.close()
    np.testing.assert_allclose(got["ref"][0], got["port"][0], rtol=1e-12)
    assert got["ref"][1] == got["port"][1]


def test_read_table_frames_equal_between_packages(served):
    """ReadTable of a BulkUpsert-written table, ordered by its key
    (one shard): every streamed Arrow IPC frame byte-equal."""
    n = 5_000
    at = _events(n)
    frames = {}
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_frames", [("id", "int64", True),
                                     ("tag", "string", False),
                                     ("v", "float64", False)],
                       primary_key=["id"], store="column", shards=1)
        assert t.bulk_upsert("tb_frames", at) == n
        rpc = s.driver.channel.unary_stream(
            "/ydb_tpu.Table/StreamReadTable",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.ReadTableBatch.FromString)
        frames[s.name] = [b.arrow_ipc for b in rpc(pb.ReadTableRequest(
            path="tb_frames", batch_rows=2048))]
        t.close()
    assert len(frames["port"]) == 3
    assert frames["ref"] == frames["port"]


def test_copy_table_and_explain(served):
    got = {}
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_src", [("id", "int64", True),
                                  ("name", "string", False)],
                       primary_key=["id"], store="column")
        t.execute("INSERT INTO tb_src VALUES (1, 'a'), (2, 'b'), (3, 'c')")
        assert t.copy_table("tb_src", "tb_dst") == 3
        out, _ = t.execute("SELECT id, name FROM tb_dst ORDER BY id")
        assert out.column("name").to_pylist() == ["a", "b", "c"]
        # source unchanged, independent afterwards
        t.execute("INSERT INTO tb_dst VALUES (4, 'd')")
        out, _ = t.execute("SELECT count(*) AS c FROM tb_src")
        assert out.column("c").to_pylist() == [3]
        plan = t.explain("SELECT id FROM tb_src WHERE id = 2")
        assert "tb_src" in plan
        got[s.name] = raw_table_query(
            s, t, "SELECT id, name FROM tb_dst ORDER BY id")
        t.close()
    assert got["ref"] == got["port"]


def test_federation_discovery(served):
    for s in served:
        dbs = s.driver.federation_databases()
        assert dbs == [{"name": "/local",
                        "endpoint": f"127.0.0.1:{s.port}",
                        "status": "AVAILABLE"}]


def test_copy_table_decimal_roundtrip(served):
    """DescribeTable -> CreateTable type round trip including decimal
    (the copy path emits a DDL-parseable spelling)."""
    import decimal

    got = {}
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_px", [("id", "int64", True),
                                 ("amt", "decimal(10,2)", False),
                                 ("w", "float64", False)],
                       primary_key=["id"], store="column")
        t.execute("INSERT INTO tb_px VALUES (1, 12.50, 0.5), (2, 0.75, 1.5)")
        assert t.copy_table("tb_px", "tb_px2") == 2
        out, _ = t.execute("SELECT amt, w FROM tb_px2 ORDER BY id")
        assert out.column("amt").to_pylist() == [
            decimal.Decimal("12.50"), decimal.Decimal("0.75")]
        assert out.column("w").to_pylist() == [0.5, 1.5]
        got[s.name] = raw_table_query(
            s, t, "SELECT amt, w FROM tb_px2 ORDER BY id")
        t.close()
    assert got["ref"] == got["port"]


def test_table_service_enforces_acls(served):
    """The structured Table API honours path ACLs as the SQL front door
    does (every handler binds the ticket's principal). The grants are
    revoked after, so the module's other cases stay open."""
    for s in served:
        cl = s.cluster
        sess = cl.session()
        sess.execute("CREATE TABLE tb_sec (id int64, v int64, "
                     "PRIMARY KEY (id)) WITH (store = column)")
        sess.execute("INSERT INTO tb_sec VALUES (1, 10)")
        grants = [("/tb_sec", "alice", ["read", "write"]),
                  ("/", "admin", "full")]
        for path, who, perms in grants:
            cl.scheme.grant(path, who, perms)
        try:
            with auth_server(s, {"alice", "admin", "eve"}) as port:
                eve = s.client.Driver(f"127.0.0.1:{port}", auth_token="eve")
                te = eve.table_client()
                # eve has no grants anywhere: reads, writes, DDL denied
                with pytest.raises(s.ApiError, match="access denied"):
                    list(te.read_table("tb_sec"))
                with pytest.raises(s.ApiError, match="access denied"):
                    te.bulk_upsert("tb_sec", pa.table(
                        {"id": pa.array([9], pa.int64()),
                         "v": pa.array([9], pa.int64())}))
                with pytest.raises(s.ApiError, match="access denied"):
                    te.create_table("tb_evil", [("id", "int64", True)],
                                    primary_key=["id"])
                with pytest.raises(s.ApiError, match="access denied"):
                    te.drop_table("tb_sec")
                with pytest.raises(s.ApiError, match="access denied"):
                    te.copy_table("tb_sec", "tb_sec_copy")
                eve.close()
                # alice reads and writes; admin does DDL
                alice = s.client.Driver(f"127.0.0.1:{port}",
                                        auth_token="alice")
                ta = alice.table_client()
                assert pa.concat_tables(ta.read_table("tb_sec")).num_rows \
                    == 1
                assert ta.bulk_upsert("tb_sec", pa.table(
                    {"id": pa.array([2], pa.int64()),
                     "v": pa.array([20], pa.int64())})) == 1
                alice.close()
                admin = s.client.Driver(f"127.0.0.1:{port}",
                                        auth_token="admin")
                tadm = admin.table_client()
                assert tadm.copy_table("tb_sec", "tb_sec_copy") == 2
                tadm.drop_table("tb_sec_copy")
                admin.close()
        finally:
            for path, who, _perms in grants:
                cl.scheme.revoke(path, who)


def test_delete_session_rolls_back_open_tx(served):
    """Dropping a session with an open interactive tx releases its shard
    locks, so later writers proceed."""
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_lk", [("id", "int64", True),
                                 ("v", "int64", False)],
                       primary_key=["id"], store="row")
        t.execute("INSERT INTO tb_lk VALUES (1, 1)")
        _, tx = t.execute("UPDATE tb_lk SET v = 2 WHERE id = 1",
                          begin=True)
        assert tx
        t.close()  # DeleteSession with the tx still open
        # the buffered write vanished and the lock is free
        t2 = s.driver.table_client()
        out, _ = t2.execute("SELECT v FROM tb_lk")
        assert out.column("v").to_pylist() == [1]
        (_, ok), _ = t2.execute("UPDATE tb_lk SET v = 7 WHERE id = 1",
                                begin=True, commit=True)
        assert ok
        out, _ = t2.execute("SELECT v FROM tb_lk")
        assert out.column("v").to_pylist() == [7]
        t2.close()


def test_bulk_upsert_bool_and_nulls(served):
    got = {}
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_flags", [("id", "int64", True),
                                    ("ok", "bool", False)],
                       primary_key=["id"], store="column")
        at = pa.table({"id": pa.array([1, 2, 3], pa.int64()),
                       "ok": pa.array([True, None, False])})
        assert t.bulk_upsert("tb_flags", at) == 3
        out, _ = t.execute("SELECT id, ok FROM tb_flags ORDER BY id")
        assert out.column("ok").to_pylist() == [True, None, False]
        got[s.name] = raw_table_query(
            s, t, "SELECT id, ok FROM tb_flags ORDER BY id")
        t.close()
    assert got["ref"] == got["port"]


def test_out_of_band_rollback_resets_api_tx(served):
    """SQL ROLLBACK through the Query service on the same session
    invalidates the Table service's open tx id (no silent autocommit
    under a stale id)."""
    for s in served:
        t = s.driver.table_client()
        t.create_table("tb_ob", [("id", "int64", True),
                                 ("v", "int64", False)],
                       primary_key=["id"], store="row")
        t.execute("INSERT INTO tb_ob VALUES (1, 1)")
        _, tx = t.execute("UPDATE tb_ob SET v = 2 WHERE id = 1", begin=True)
        assert tx
        # the Query service shares the session map keyed by session id
        s.driver._call("/ydb_tpu.Query/ExecuteQuery",
                       pb.ExecuteQueryRequest(session_id=t.session_id,
                                              sql="ROLLBACK"),
                       pb.ExecuteQueryResponse)
        with pytest.raises(s.ApiError, match="unknown tx"):
            t.execute("UPDATE tb_ob SET v = 3 WHERE id = 1", tx_id=tx)
        out, _ = t.execute("SELECT v FROM tb_ob")
        assert out.column("v").to_pylist() == [1]
        t.close()
