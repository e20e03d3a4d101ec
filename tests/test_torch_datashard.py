"""The port's row store (``ydb_tpu_torch/datashard/``) against the
reference's: the 14 cases of ``tests/test_datashard.py``.

Each case runs the same operations through both packages (``PORT`` and
``REF`` below) and makes the reference test's own assertions on each; the
observations it returns (row pages, ``TxResult`` fields, lock outcomes,
SQL results) must be equal between the two. Tolerance: none, floats
included (the cases' floats are exact in binary)."""

import functools
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.datashard import shard as rshard
from ydb_tpu.datashard.table import RowTable as RRowTable
from ydb_tpu.engine.blobs import MemBlobStore as RStore
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.sql.planner import PlanError as RPlanError
from ydb_tpu.tx.coordinator import Coordinator as RCoord

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.datashard import shard as tshard
from ydb_tpu_torch.datashard.table import RowTable as TRowTable
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore
from ydb_tpu_torch.kqp.session import Cluster as TCluster
from ydb_tpu_torch.sql.planner import PlanError as TPlanError
from ydb_tpu_torch.tx.coordinator import Coordinator as TCoord


def _ns(dt, sh, RowTable, Store, Cluster, PlanError, Coord):
    return types.SimpleNamespace(
        dtypes=dt, DataShard=sh.DataShard, LockBroken=sh.LockBroken,
        RowOp=sh.RowOp, TxRejected=sh.TxRejected, RowTable=RowTable,
        MemBlobStore=Store, Cluster=Cluster, PlanError=PlanError,
        Coordinator=Coord)


PORT = _ns(tdt, tshard, TRowTable, TStore,
           functools.partial(TCluster, device="cpu"), TPlanError, TCoord)
REF = _ns(rdt, rshard, RRowTable, RStore, RCluster, RPlanError, RCoord)


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C): its GROUP BYs take the scatter tier."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def both(case):
    """Run ``case(P)`` on both packages; the observations must agree."""
    got = case(PORT)
    want = case(REF)
    assert got == want
    return got


def host(out):
    """A SELECT result as plain values (strings decoded)."""
    cols = []
    for f in out.schema.fields:
        vals = (out.strings(f.name) if f.type.is_string
                else np.asarray(out.column(f.name)).tolist())
        cols.append((f.name, vals,
                     np.asarray(out.validity(f.name)).tolist()))
    return cols


def tx(res):
    return (bool(res.committed), res.step, (res.error or "")[:7])


def _schema(P):
    return P.dtypes.schema(("id", P.dtypes.INT64), ("v", P.dtypes.INT64))


def _shard(P, store=None):
    return P.DataShard("t/0", _schema(P), store or P.MemBlobStore(), ("id",))


def _rows_at(ds, snap, **kw):
    return [r for page in ds.read(snap, **kw) for r in page]


def test_propose_commit_read_mvcc():
    def case(P):
        ds = _shard(P)
        w1 = ds.propose([P.RowOp((1,), {"id": 1, "v": 10}),
                         P.RowOp((2,), {"id": 2, "v": 20})])
        ds.prepare([w1])
        ds.commit_at([w1], step=5)
        w2 = ds.propose([P.RowOp((1,), {"id": 1, "v": 11}),
                         P.RowOp((2,), None)])  # update + delete
        ds.commit_at([w2], step=9)
        assert _rows_at(ds, 4) == []
        assert _rows_at(ds, 5) == [((1,), {"id": 1, "v": 10}),
                                   ((2,), {"id": 2, "v": 20})]
        assert _rows_at(ds, 9) == [((1,), {"id": 1, "v": 11})]
        assert ds.last_step == 9
        return [w1, w2, _rows_at(ds, 5), _rows_at(ds, 9), ds.last_step]
    both(case)


def test_read_iterator_paging_and_range():
    def case(P):
        ds = _shard(P)
        w = ds.propose([P.RowOp((i,), {"id": i, "v": i})
                        for i in range(50)])
        ds.commit_at([w], step=1)
        pages = list(ds.read(1, page_rows=16))
        assert [len(p) for p in pages] == [16, 16, 16, 2]
        ranged = _rows_at(ds, 1, lo=(10,), hi=(20,))
        assert [k for k, _ in ranged] == [(i,) for i in range(10, 20)]
        pts = _rows_at(ds, 1, keys=[(3,), (99,), (7,)])
        assert [k for k, _ in pts] == [(3,), (7,)]
        return [pages, ranged, pts]
    both(case)


def test_shard_survives_reboot():
    def case(P):
        store = P.MemBlobStore()
        ds = _shard(P, store)
        w = ds.propose([P.RowOp((1,), {"id": 1, "v": 10})])
        ds.commit_at([w], step=3)
        ds2 = P.DataShard("t/0", _schema(P), store, ("id",))
        rows = _rows_at(ds2, 3)
        assert rows == [((1,), {"id": 1, "v": 10})]
        assert ds2.last_step == 3
        return [rows, ds2.last_step,
                {k: bytes(store.get(k)) for k in store.list("")}]
    both(case)


def test_optimistic_lock_breaks_on_conflicting_write():
    def case(P):
        ds = _shard(P)
        w = ds.propose([P.RowOp((1,), {"id": 1, "v": 10})])
        ds.commit_at([w], step=1)
        lock = ds.acquire_lock()
        _rows_at(ds, 1, lo=(0,), hi=(100,), lock_id=lock)
        w2 = ds.propose([P.RowOp((1,), {"id": 1, "v": 99})])
        ds.commit_at([w2], step=2)
        assert ds.lock_broken(lock)
        w3 = ds.propose([P.RowOp((1,), {"id": 1, "v": 50})], lock_id=lock)
        with pytest.raises(P.LockBroken) as e:
            ds.prepare([w3])
        lock2 = ds.acquire_lock()
        _rows_at(ds, 2, keys=[(5,)], lock_id=lock2)
        w4 = ds.propose([P.RowOp((7,), {"id": 7, "v": 1})])
        ds.commit_at([w4], step=3)
        assert not ds.lock_broken(lock2)
        return [lock, lock2, str(e.value), ds.lock_broken(lock),
                ds.lock_broken(lock2)]
    both(case)


def test_precondition_insert_semantics():
    def case(P):
        ds = _shard(P)
        w = ds.propose([P.RowOp((1,), {"id": 1, "v": 10})],
                       expect={(1,): None})  # INSERT: must not exist
        ds.prepare([w])
        ds.commit_at([w], step=1)
        w2 = ds.propose([P.RowOp((1,), {"id": 1, "v": 20})],
                        expect={(1,): None})
        with pytest.raises(P.TxRejected) as e:
            ds.prepare([w2])
        return [w, w2, str(e.value), _rows_at(ds, 1)]
    both(case)


def test_row_table_two_phase_commit_and_abort():
    def case(P):
        t = P.RowTable("t", _schema(P), P.MemBlobStore(), P.Coordinator(),
                       n_shards=3)
        res = t.insert({"id": np.arange(10, dtype=np.int64),
                        "v": np.arange(10, dtype=np.int64) * 10})
        assert res.committed
        src = t.source_at()
        assert sorted(src.columns["id"]) == list(range(10))
        assert t.source_at(res.step - 1).num_rows == 0
        res2 = t.delete_keys([(0,), (5,)])
        after = t.source_at()
        assert sorted(after.columns["id"]) == [1, 2, 3, 4, 6, 7, 8, 9]
        return [tx(res), tx(res2), src.columns["id"].tolist(),
                src.columns["v"].tolist(), after.columns["id"].tolist(),
                [[k for page in s.read(res2.step) for k, _ in page]
                 for s in t.shards]]
    both(case)


def test_sql_row_table_update_delete():
    def case(P):
        s = P.Cluster().session()
        s.execute("CREATE TABLE kv (id int64, city string, score double, "
                  "PRIMARY KEY (id)) WITH (store = row, shards = 2)")
        s.execute("INSERT INTO kv VALUES (1, 'berlin', 1.0), "
                  "(2, 'tokyo', 2.0), (3, 'berlin', 3.0)")
        obs = [host(s.execute("SELECT id, score FROM kv ORDER BY id"))]
        obs.append(tx(s.execute(
            "UPDATE kv SET score = score * 10 WHERE city = 'berlin'")))
        out = s.execute("SELECT id, score FROM kv ORDER BY id")
        assert list(out.column("score")) == [10.0, 2.0, 30.0]
        obs.append(host(out))
        s.execute("UPDATE kv SET city = 'kyoto' WHERE id = 2")
        out = s.execute("SELECT city FROM kv WHERE id = 2")
        assert out.strings("city") == [b"kyoto"]
        obs.append(tx(s.execute("DELETE FROM kv WHERE score >= 30")))
        out = s.execute("SELECT id FROM kv ORDER BY id")
        assert list(out.column("id")) == [1, 2]
        obs.append(host(out))
        s.execute("CREATE TABLE olap (id int64, PRIMARY KEY (id))")
        for sql in ("UPDATE olap SET id = 1", "UPDATE kv SET id = 9"):
            with pytest.raises(P.PlanError) as e:
                s.execute(sql)
            obs.append(str(e.value))
        return obs
    both(case)


def test_sql_row_table_survives_reboot():
    def case(P):
        store = P.MemBlobStore()
        s = P.Cluster(store=store).session()
        s.execute("CREATE TABLE r (id int64, name string, PRIMARY KEY (id)) "
                  "WITH (store = row)")
        s.execute("INSERT INTO r VALUES (1, 'a'), (2, 'b')")
        s.execute("UPDATE r SET name = 'z' WHERE id = 1")
        c2 = P.Cluster(store=store)
        out = c2.session().execute("SELECT id, name FROM r ORDER BY id")
        assert list(out.column("id")) == [1, 2]
        assert out.strings("name") == [b"z", b"b"]
        s2 = c2.session()
        s2.execute("CREATE TABLE facts (id int64, amount int64, "
                   "PRIMARY KEY (id))")
        s2.execute("INSERT INTO facts VALUES (1, 100), (2, 200), (1, 300)")
        joined = s2.execute(
            "SELECT r.name AS name, sum(f.amount) AS total "
            "FROM facts f JOIN r ON f.id = r.id GROUP BY r.name "
            "ORDER BY r.name")
        assert joined.strings("name") == [b"b", b"z"]
        assert list(joined.column("total")) == [200, 400]
        return [host(out), host(joined)]
    both(case)


def test_row_table_alter_add_drop():
    def case(P):
        s = P.Cluster().session()
        s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id)) "
                  "WITH (store = row)")
        s.execute("INSERT INTO t VALUES (1, 10)")
        s.execute("ALTER TABLE t ADD COLUMN w int64")
        out = s.execute("SELECT id, w FROM t")
        assert not out.validity("w").any()
        obs = [host(out)]
        s.execute("INSERT INTO t VALUES (2, 20, 200)")
        s.execute("ALTER TABLE t DROP COLUMN v")
        s.execute("ALTER TABLE t ADD COLUMN v int64")
        out = s.execute("SELECT id, v FROM t ORDER BY id")
        assert not out.validity("v").any()   # no resurrection
        return obs + [host(out), host(s.execute("SELECT * FROM t "
                                                "ORDER BY id"))]
    both(case)


def test_row_drop_then_recreate_does_not_resurrect():
    def case(P):
        store = P.MemBlobStore()
        s = P.Cluster(store=store).session()
        ddl = ("CREATE TABLE t (id int64, PRIMARY KEY (id)) "
               "WITH (store = row, shards = 1)")
        s.execute(ddl)
        s.execute("INSERT INTO t VALUES (1), (2), (3)")
        s.execute("DROP TABLE t")
        s.execute(ddl)
        s.execute("INSERT INTO t VALUES (100)")
        out = s.execute("SELECT id FROM t ORDER BY id")
        assert list(out.column("id")) == [100]
        out2 = P.Cluster(store=store).session().execute(
            "SELECT id FROM t ORDER BY id")
        assert list(out2.column("id")) == [100]
        return [host(out), host(out2), sorted(store.list("tablet/ds/"))]
    both(case)


def test_update_string_column_from_other_column():
    def case(P):
        c = P.Cluster()
        s = c.session()
        s.execute("CREATE TABLE t (id int64, a string, b string, "
                  "PRIMARY KEY (id)) WITH (store = row)")
        s.execute("INSERT INTO t VALUES (1, 'aaa', 'bbb'), (2, 'xxx', 'yyy')")
        s.execute("UPDATE t SET a = b WHERE id = 2")
        out = s.execute("SELECT id, a FROM t ORDER BY id")
        assert out.strings("a") == [b"aaa", b"yyy"]
        with pytest.raises(P.PlanError) as e:
            s.execute("UPDATE t SET a = id")  # unsupported string expr
        return [host(out), str(e.value),
                {col: list(c.dicts[col].values) for col in ("a", "b")}]
    both(case)


def test_concurrent_update_no_lost_increment():
    """Two racing read-modify-write UPDATEs serialize: the second sees a
    broken lock at prepare and retries against the new state."""
    def case(P):
        c = P.Cluster()
        s = c.session()
        s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 1)")
        s.execute("INSERT INTO t VALUES (1, 0)")
        t = c.tables["t"]
        locks = t.lock_all_shards()
        snap = c.coordinator.read_snapshot()
        row = dict(t.read_row((1,), snap))
        row["v"] = row["v"] + 1
        sneak = t.upsert_rows([{"id": 1, "v": 100}])
        res = t._commit_ops([P.RowOp((1,), row)], lock_ids=locks)
        t.release_locks(locks)
        assert not res.committed and "prepare" in res.error
        upd = s.execute("UPDATE t SET v = v + 1 WHERE id = 1")
        out = s.execute("SELECT v FROM t")
        assert list(out.column("v")) == [101]
        return [locks, tx(sneak), tx(res), res.error, tx(upd), host(out)]
    both(case)


def test_drop_table_crash_between_scheme_and_blob_delete():
    """Crash after the scheme drop committed but before blob deletion: the
    boot sweep finishes the job (trash record)."""
    def case(P):
        store = P.MemBlobStore()
        c = P.Cluster(store=store)
        s = c.session()
        ddl = ("CREATE TABLE t (id int64, PRIMARY KEY (id)) "
               "WITH (store = row, shards = 1)")
        s.execute(ddl)
        s.execute("INSERT INTO t VALUES (1), (2)")
        t = c.tables["t"]
        c.scheme.drop_table("/t", trash_prefixes=t.storage_prefixes())
        assert c.scheme.trash()
        c2 = P.Cluster(store=store)
        assert not c2.scheme.trash()
        left = sorted(store.list("tablet/ds/"))
        s2 = c2.session()
        s2.execute(ddl)
        s2.execute("INSERT INTO t VALUES (100)")
        out = P.Cluster(store=store).session().execute("SELECT id FROM t")
        assert list(out.column("id")) == [100]
        return [t.storage_prefixes(), left, host(out)]
    both(case)


def test_eager_lock_registration():
    def case(P):
        ds = _shard(P)
        w = ds.propose([P.RowOp((1,), {"id": 1, "v": 10})])
        ds.commit_at([w], step=1)
        lock = ds.acquire_lock()
        it = ds.read(1, lo=(0,), hi=(100,), lock_id=lock)  # NOT consumed
        w2 = ds.propose([P.RowOp((1,), {"id": 1, "v": 99})])
        ds.commit_at([w2], step=2)
        assert ds.lock_broken(lock)   # broke despite unconsumed iterator
        return [ds.lock_broken(lock), list(it)]
    both(case)
