"""Serializability of the port's row store under interleaved
transactions and reboots, against the reference's: the 3 cases of
``tests/test_serializable.py``.

The interleavings are seeded, so each case is deterministic: it runs
through both packages, makes the reference test's assertions on each,
and the committed increments, final counters, snapshot reads and rows
after the reboots must be equal between the two. Tolerance: none."""

import functools
import random
import sys
import types

import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.datashard import shard as rshard
from ydb_tpu.engine.blobs import MemBlobStore as RStore
from ydb_tpu.kqp.session import Cluster as RCluster

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.datashard import shard as tshard
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore
from ydb_tpu_torch.kqp.session import Cluster as TCluster


def _ns(dt, sh, Store, Cluster):
    return types.SimpleNamespace(
        dtypes=dt, DataShard=sh.DataShard, RowOp=sh.RowOp,
        MemBlobStore=Store, Cluster=Cluster)


PORT = _ns(tdt, tshard, TStore, functools.partial(TCluster, device="cpu"))
REF = _ns(rdt, rshard, RStore, RCluster)


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
    got = case(PORT)
    assert got == case(REF)


def test_interleaved_rmw_serializes_no_lost_updates():
    """Workers interleave mid-transaction (between snapshot read and
    commit): conflicting commits break the reader's optimistic lock,
    forcing a retry — every committed increment lands."""
    def case(P):
        cluster = P.Cluster()
        s = cluster.session()
        s.execute("CREATE TABLE counters (id int64, v int64, "
                  "PRIMARY KEY (id)) WITH (store = row, shards = 2)")
        s.execute("INSERT INTO counters VALUES (0, 0), (1, 0)")
        table = cluster.tables["counters"]
        rng = random.Random(17)
        history = []

        class Worker:
            def __init__(self, wid):
                self.wid = wid
                self.rng = random.Random(wid)
                self.committed = [0, 0]
                self.remaining = 12
                self.state = "idle"

            def step(self):
                if self.remaining == 0:
                    return False
                if self.state == "idle":
                    self.key = self.rng.randrange(2)
                    self.locks = table.lock_all_shards()
                    snap = cluster.coordinator.read_snapshot()
                    row = table.read_row((self.key,), snap)
                    self.new_v = row["v"] + 1
                    self.state = "read"  # <- interleave point
                else:
                    res = table._commit_ops(
                        [P.RowOp((self.key,),
                                 {"id": self.key, "v": self.new_v})],
                        lock_ids=self.locks)
                    table.release_locks(self.locks)
                    history.append((self.wid, self.key, res.committed,
                                    res.step))
                    if res.committed:
                        self.committed[self.key] += 1
                        self.remaining -= 1
                    self.state = "idle"
                return True

        workers = [Worker(i) for i in range(4)]
        live = list(workers)
        conflicts_possible = 0
        while live:
            w = rng.choice(live)
            if sum(1 for x in workers if x.state == "read") > 1:
                conflicts_possible += 1
            if not w.step():
                live.remove(w)
        assert conflicts_possible > 0
        out = s.execute("SELECT id, v FROM counters ORDER BY id")
        got = [int(x) for x in out.column("v")]
        want = [sum(w.committed[k] for w in workers) for k in (0, 1)]
        assert got == want, (got, want)
        assert sum(want) == 4 * 12
        return [got, conflicts_possible, history]
    both(case)


def test_snapshot_reads_are_stable_under_writes():
    """A reader pinned to a snapshot sees the same rows no matter how
    many commits land after it (repeatable read)."""
    def case(P):
        cluster = P.Cluster()
        s = cluster.session()
        s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 2)")
        s.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
        table = cluster.tables["t"]
        snap = cluster.coordinator.read_snapshot()
        before = {k: dict(r) for k, r in sorted(
            table.read_rows([(1,), (2,)], snap).items())}
        assert before == {(1,): {"id": 1, "v": 10},
                          (2,): {"id": 2, "v": 20}}
        for i in range(5):
            s.execute("UPDATE t SET v = v + 100 WHERE id = 1")
            s.execute(f"INSERT INTO t VALUES ({10 + i}, {i})")
        after = {k: dict(r) for k, r in sorted(
            table.read_rows([(1,), (2,)], snap).items())}
        assert before == after
        now = int(s.execute("SELECT v FROM t WHERE id = 1").column("v")[0])
        assert now == 510
        return [before, now, cluster.coordinator.read_snapshot()]
    both(case)


def test_chaos_reboot_mid_workload_loses_nothing():
    """Nemesis-style restart: shards reboot from storage between batches
    of committed writes; every committed row survives, undecided volatile
    state does not resurrect."""
    def case(P):
        store = P.MemBlobStore()
        schema = P.dtypes.schema(("id", P.dtypes.INT64, False),
                                 ("v", P.dtypes.INT64, True))
        rng = random.Random(5)
        committed = {}
        shard = P.DataShard("c0", schema, store, ("id",))
        step = 0
        for round_no in range(6):
            for _ in range(20):
                k = rng.randrange(50)
                v = rng.randrange(1_000_000)
                wid = shard.propose([P.RowOp((k,), {"id": k, "v": v})])
                shard.prepare([wid])
                step += 1
                shard.commit_at([wid], step)
                committed[k] = v
            wid = shard.propose([P.RowOp((999,), {"id": 999, "v": 1})])
            assert shard.apply_volatile([wid], txid=1000 + round_no,
                                        step=step + 1, expected_peers=[1])
            shard = P.DataShard("c0", schema, store, ("id",))  # nemesis
        rows = {k[0]: r["v"] for page in shard.read(step + 10)
                for k, r in page}
        assert 999 not in rows
        assert rows == committed
        return [rows, {k: bytes(store.get(k)) for k in store.list("")}]
    both(case)
