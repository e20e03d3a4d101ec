"""Volatile distributed transactions in the port (``DataShard``'s
volatile path over ``tx/coordinator.py``'s ``commit_volatile``) against
the reference's: the 9 cases of ``tests/test_volatile.py``.

Each case runs through both packages and makes the reference test's
assertions on each; the ``TxResult``s (committed, step, error class),
rows, pending entries and readset decisions it observes must be equal
between the two. The two barrier cases interleave threads on events, so
they compare the order of steps, not wall clock. Tolerance: none."""

import sys
import threading
import types

import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.datashard import shard as rshard
from ydb_tpu.engine.blobs import MemBlobStore as RStore
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.tx.coordinator import Coordinator as RCoord

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.datashard import shard as tshard
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore
from ydb_tpu_torch.kqp.session import Cluster as TCluster
from ydb_tpu_torch.tx.coordinator import Coordinator as TCoord


def _ns(dt, sh, Store, Coord, cluster):
    return types.SimpleNamespace(
        DataShard=sh.DataShard, RowOp=sh.RowOp, TxRejected=sh.TxRejected,
        VolatileUndecided=sh.VolatileUndecided, MemBlobStore=Store,
        Coordinator=Coord, Cluster=cluster,
        SCHEMA=dt.schema(("id", dt.INT64, False), ("v", dt.INT64, True)))


PORT = _ns(tdt, tshard, TStore, TCoord, lambda: TCluster(device="cpu"))
REF = _ns(rdt, rshard, RStore, RCoord, RCluster)


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


def tx(res):
    return (bool(res.committed), res.step, (res.error or "")[:15])


def make_shards(P, n=2):
    store = P.MemBlobStore()
    return store, [P.DataShard(f"s{i}", P.SCHEMA, store, ("id",))
                   for i in range(n)]


def propose(shard, P, key, v):
    return shard.propose([P.RowOp((key,), {"id": key, "v": v})])


def rows(shard, snap):
    return [r for page in shard.read(snap) for r in page]


def test_volatile_commit_across_shards():
    def case(P):
        _store, (a, b) = make_shards(P)
        coord = P.Coordinator()
        wa, wb = propose(a, P, 1, 10), propose(b, P, 2, 20)
        res = coord.commit_volatile([a, b], [[wa], [wb]])
        assert res.committed
        snap = coord.read_snapshot()
        assert snap >= res.step
        ra, rb = rows(a, snap), rows(b, snap)
        assert ra[0][1]["v"] == 10 and rb[0][1]["v"] == 20
        return [tx(res), snap, ra, rb]
    both(case)


def test_volatile_abort_rolls_back_all_participants():
    def case(P):
        _store, (a, b) = make_shards(P)
        coord = P.Coordinator()
        wa = propose(a, P, 1, 10)
        res = coord.commit_volatile([a, b], [[wa], [9999]])
        assert not res.committed and "volatile abort" in res.error
        snap = coord.read_snapshot()
        assert rows(a, snap) == []
        assert a.executor.db.table("pending").get((wa,)) is None
        return [tx(res), res.error, snap]
    both(case)


def test_undecided_volatile_fences_readers():
    def case(P):
        _store, (a, b) = make_shards(P)
        wa = propose(a, P, 1, 10)
        assert a.apply_volatile([wa], txid=7, step=5, expected_peers=[1])
        errs = []
        with pytest.raises(P.VolatileUndecided) as e:
            a.read(5, keys=[(1,)])
        errs.append(str(e.value))
        with pytest.raises(P.VolatileUndecided) as e:
            list(a.read(6))
        errs.append(str(e.value))
        assert rows(a, 4) == []
        assert [r for page in a.read(6, keys=[(42,)]) for r in page] == []
        assert b is not a
        decided = a.deliver_readset(7, 1, True)
        assert decided is True
        got = rows(a, 5)
        assert got[0][1]["v"] == 10
        return errs + [decided, got]
    both(case)


def test_negative_readset_rolls_back():
    def case(P):
        _store, (a, _b) = make_shards(P)
        wa = propose(a, P, 1, 10)
        assert a.apply_volatile([wa], txid=9, step=3, expected_peers=[1])
        decided = a.deliver_readset(9, 1, False)
        assert decided is False
        assert rows(a, 3) == []
        assert a.executor.db.table("pending").get((wa,)) is None
        return [decided]
    both(case)


def test_restart_forgets_undecided_volatile():
    """Volatile effects are not durable before the decision: a reboot
    auto-aborts them (the reference's volatile contract)."""
    def case(P):
        store, (a, _b) = make_shards(P)
        wa = propose(a, P, 1, 10)
        assert a.apply_volatile([wa], txid=11, step=4, expected_peers=[1])
        a2 = P.DataShard("s0", P.SCHEMA, store, ("id",))  # reboot
        assert rows(a2, 10) == []
        pend = a2.executor.db.table("pending").get((wa,))
        assert pend is not None
        return [pend]
    both(case)


def test_barrier_never_passes_undecided_step():
    """A later classic commit must not advance the read barrier past an
    undecided volatile step (snapshot monotonicity)."""
    def case(P):
        _store, (a, b) = make_shards(P)
        coord = P.Coordinator()

        class SlowShard:
            """Participant that accepts but never hears back."""

            def __init__(self, inner):
                self.inner = inner

            def apply_volatile(self, args, txid, step, peers):
                return self.inner.apply_volatile(args, txid, step, peers)

            def deliver_readset(self, txid, frm, ok):
                return None  # swallow: decision never settles

        wa, wb = propose(a, P, 1, 10), propose(b, P, 2, 20)
        slow_a = SlowShard(a)
        started, release = threading.Event(), threading.Event()
        real_apply = slow_a.apply_volatile

        def blocking_apply(args, txid, step, peers):
            ok = real_apply(args, txid, step, peers)
            started.set()
            release.wait(timeout=10)
            return ok

        slow_a.apply_volatile = blocking_apply
        t = threading.Thread(
            target=lambda: coord.commit_volatile([slow_a, b], [[wa], [wb]]),
            daemon=True)
        t.start()
        assert started.wait(timeout=10)
        vol_step = next(iter(a._volatile.values())).step
        later = coord.background_plan()
        assert later > vol_step
        held = coord.read_snapshot()
        assert held < vol_step
        release.set()
        t.join(timeout=10)
        assert coord.read_snapshot() >= later
        return [vol_step, later, held, coord.read_snapshot()]
    both(case)


def test_prepare_rejects_key_with_undecided_volatile():
    """expect-preconditions (and blind writes) must not validate against
    committed data while an undecided volatile write owns the key."""
    def case(P):
        _store, (a, _b) = make_shards(P)
        wa = propose(a, P, 1, 10)
        assert a.apply_volatile([wa], txid=21, step=5, expected_peers=[1])
        w2 = a.propose([P.RowOp((1,), {"id": 1, "v": 99})],
                       expect={(1,): None})
        with pytest.raises(P.TxRejected, match="undecided volatile") as e1:
            a.prepare([w2])
        a.deliver_readset(21, 1, True)
        with pytest.raises(P.TxRejected, match="precondition") as e2:
            a.prepare([w2])
        return [str(e1.value), str(e2.value)]
    both(case)


def test_volatile_never_overtakes_classic_commit_mid_apply():
    """A volatile commit finishing while a classic commit is still
    applying must not advance the barrier past the classic step."""
    def case(P):
        _store, (a, b, c, d) = make_shards(P, 4)
        coord = P.Coordinator()
        applied_first, release = threading.Event(), threading.Event()
        real_commit_at = b.commit_at

        def slow_commit_at(write_ids, step):
            applied_first.set()
            release.wait(timeout=10)
            return real_commit_at(write_ids, step)

        b.commit_at = slow_commit_at
        wa, wb = propose(a, P, 1, 10), propose(b, P, 2, 20)
        classic = {}
        t = threading.Thread(
            target=lambda: classic.update(
                res=coord.commit([a, b], [[wa], [wb]])), daemon=True)
        t.start()
        assert applied_first.wait(timeout=10)
        classic_step = coord.last_step
        wc, wd = propose(c, P, 3, 30), propose(d, P, 4, 40)
        vres = coord.commit_volatile([c, d], [[wc], [wd]])
        assert vres.committed and vres.step > classic_step
        held = coord.read_snapshot()
        assert held < classic_step
        release.set()
        t.join(timeout=10)
        assert classic["res"].committed
        assert coord.read_snapshot() >= vres.step
        return [classic_step, tx(vres), held, tx(classic["res"])]
    both(case)


def test_sql_multi_shard_upsert_goes_volatile():
    """The row-table SQL path commits multi-shard writes through the
    volatile protocol end to end."""
    def case(P):
        s = P.Cluster().session()
        s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 4)")
        res = s.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i}, {i * 10})" for i in range(16)))
        out = s.execute("SELECT count(*) AS c, sum(v) AS s FROM t")
        assert int(out.column("c")[0]) == 16
        assert int(out.column("s")[0]) == sum(i * 10 for i in range(16))
        return [tx(res), int(out.column("c")[0]), int(out.column("s")[0])]
    both(case)
