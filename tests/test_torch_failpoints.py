"""The port's failpoint registry and ``FailpointBlobStore``
(``ydb_tpu_torch/runtime/failpoints.py``) against the reference's.

Mirrors ``tests/test_failpoints.py`` (3 cases): each body runs over the
reference's classes (its DataShard over its ``MemBlobStore``) and over the
port's on the same inputs and returns what it observed (which hits fired,
``stats``, rows read back); the records must be equal. Then the store
wrapper over a port ``GroupBlobStore``: a statement of a port ``Cluster``
fails soft under ``blob.get`` faults and then answers as before.
"""

import types

import pytest

from ydb_tpu import dtypes as rdtypes
from ydb_tpu.datashard.shard import DataShard as RDataShard
from ydb_tpu.datashard.shard import RowOp as RRowOp
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.runtime import failpoints as r_fp

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blobstorage import DSProxy, GroupBlobStore, GroupInfo
from ydb_tpu_torch.datashard.shard import DataShard, RowOp
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.runtime import failpoints as t_fp


def _ns(fp, dt, shard, rowop, mem):
    return types.SimpleNamespace(
        Failpoints=fp.Failpoints, FailpointBlobStore=fp.FailpointBlobStore,
        InjectedFault=fp.InjectedFault, DataShard=shard, RowOp=rowop,
        MemBlobStore=mem,
        SCHEMA=dt.schema(("id", dt.INT64, False), ("v", dt.INT64, True)))


REF = _ns(r_fp, rdtypes, RDataShard, RRowOp, RMemBlobStore)
PORT = _ns(t_fp, dtypes, DataShard, RowOp, MemBlobStore)


def _both(body):
    want, got = body(REF), body(PORT)
    assert got == want
    return got


def _fires(P, fn) -> bool:
    try:
        fn()
        return False
    except P.InjectedFault:
        return True


def test_trigger_policies():
    def body(P):
        fp = P.Failpoints()
        fp.arm("a", "nth", 3)
        fired = [_fires(P, lambda: fp.hit("a")) for _ in range(4)]
        assert fired == [False, False, True, False]
        assert fp.stats("a") == {"hits": 4, "fired": 1}
        fp.arm("b", "times", 2)
        b = [_fires(P, lambda: fp.hit("b")) for _ in range(3)]
        assert b == [True, True, False]
        fp.arm("c", "prob", 0.5, seed=7)
        c = [_fires(P, lambda: fp.hit("c")) for _ in range(100)]
        assert 20 < sum(c) < 80
        fp2 = P.Failpoints()
        fp2.arm("c", "prob", 0.5, seed=7)
        assert [_fires(P, lambda: fp2.hit("c")) for _ in range(100)] == c
        hits = []
        fp.arm("d", "always", action=lambda **ctx: hits.append(ctx))
        fp.hit("d", blob_id="x")
        assert hits == [{"blob_id": "x"}]
        for kind, arg in (("sometimes", None), ("nth", 0.5), ("prob", "x")):
            with pytest.raises(ValueError):
                fp.arm("e", kind, arg)
        fp.disarm("a")
        fp.hit("a")
        stats = [fp.stats(n) for n in "abcd"]
        fp.disarm()
        return fired, b, c, hits, stats, fp.stats("b")
    _both(body)


def test_wal_write_fault_keeps_tablet_consistent():
    def body(P):
        fp = P.Failpoints()
        backend = P.MemBlobStore()
        store = P.FailpointBlobStore(backend, fp)
        shard = P.DataShard("f0", P.SCHEMA, store, ("id",))
        wid = shard.propose([P.RowOp((1,), {"id": 1, "v": 10})])
        shard.prepare([wid])
        shard.commit_at([wid], 5)
        fp.arm("blob.put", "always")
        with pytest.raises(P.InjectedFault):
            shard.propose([P.RowOp((2,), {"id": 2, "v": 20})])
        fp.disarm("blob.put")
        shard2 = P.DataShard("f0", P.SCHEMA, backend, ("id",))
        rows = {k[0]: r["v"] for page in shard2.read(10) for k, r in page}
        assert rows == {1: 10}
        assert store.base is backend
        return rows, sorted(backend.list(""))
    _both(body)


def test_read_faults_fail_soft_then_recover():
    def body(P):
        fp = P.Failpoints()
        store = P.FailpointBlobStore(P.MemBlobStore(), fp)
        store.put("k", b"v")
        fp.arm("blob.get", "times", 2)
        for _ in range(2):
            with pytest.raises(P.InjectedFault):
                store.get("k")
        assert store.get("k") == b"v"
        assert fp.stats("blob.get")["fired"] == 2
        fp.arm("blob.get_range", "nth", 1)
        with pytest.raises(P.InjectedFault):
            store.get_range("k", 0, 1)
        fp.arm("blob.delete", "always")
        with pytest.raises(P.InjectedFault):
            store.delete("k")
        assert store.exists("k") and store.list("") == ["k"]
        return [fp.stats(n) for n in ("blob.get", "blob.get_range",
                                      "blob.delete", "blob.put")]
    _both(body)


def test_cluster_on_a_group_fails_soft_under_get_faults():
    """A port ``Cluster`` on a block-4-2 group behind ``FailpointBlobStore``:
    with ``blob.get`` armed ``times`` 2 the first reads of a reboot raise
    ``InjectedFault``; once the faults pass, a Cluster rebooted over the
    same store answers as before the faults."""
    fp = t_fp.Failpoints()
    store = t_fp.FailpointBlobStore(
        GroupBlobStore(DSProxy(GroupInfo(3, "block42"))), fp)
    c = Cluster(store=store, device="cpu")
    s = c.session()
    s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id)) "
              "WITH (shards = 2)")
    s.execute("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
    sql = "SELECT sum(v) AS s, count(*) AS n FROM t"
    want = s.execute(sql)
    fp.arm("blob.get", "times", 2)
    failed = 0
    for _ in range(3):
        try:
            got = Cluster(store=store, device="cpu").session().execute(sql)
            break
        except t_fp.InjectedFault:
            failed += 1
    assert failed >= 1
    assert fp.stats("blob.get")["fired"] == 2
    assert list(got.column("s")) == list(want.column("s")) == [60]
    assert list(got.column("n")) == [3]
