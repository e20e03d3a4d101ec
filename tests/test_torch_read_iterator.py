"""The port's read iterator (``ydb_tpu_torch/datashard/read_iterator.py``)
against the reference's: the 5 cases of ``tests/test_read_iterator.py``.

Each case runs through both packages and makes the reference test's
assertions on each; its pages (rows, continuation tokens, finished
flags, stalls on credit) must be equal between the two. Tolerance:
none."""

import types

import pytest

from ydb_tpu import dtypes as rdt
from ydb_tpu.datashard import read_iterator as rri
from ydb_tpu.datashard import shard as rshard
from ydb_tpu.engine.blobs import MemBlobStore as RStore

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.datashard import read_iterator as tri
from ydb_tpu_torch.datashard import shard as tshard
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore


def _ns(dt, sh, ri, Store):
    return types.SimpleNamespace(
        DataShard=sh.DataShard, RowOp=sh.RowOp,
        VolatileUndecided=sh.VolatileUndecided,
        ReadIterator=ri.ReadIterator, MemBlobStore=Store,
        SCHEMA=dt.schema(("id", dt.INT64, False), ("v", dt.INT64, True)))


PORT = _ns(tdt, tshard, tri, TStore)
REF = _ns(rdt, rshard, rri, RStore)


def both(case):
    got = case(PORT)
    assert got == case(REF)


def make_shard(P, n_rows=20, store=None):
    store = store if store is not None else P.MemBlobStore()
    s = P.DataShard("s0", P.SCHEMA, store, ("id",))
    wid = s.propose([P.RowOp((i,), {"id": i, "v": i * 10})
                     for i in range(n_rows)])
    s.prepare([wid])
    s.commit_at([wid], step=5)
    return store, s


def page(p):
    return None if p is None else (p.rows, p.continuation, p.finished)


def drain(it, page_rows=7, log=None):
    got = []
    while True:
        p = it.next_page(page_rows)
        if log is not None:
            log.append(page(p))
        if p is None:
            it.ack(1000)
            continue
        got.extend(p.rows)
        if p.finished:
            return got


def test_pages_quota_and_finish():
    def case(P):
        _store, s = make_shard(P, 20)
        it = P.ReadIterator(s, snapshot=5, quota_rows=5)
        p1 = it.next_page(page_rows=3)
        assert [k for k, _ in p1.rows] == [(0,), (1,), (2,)]
        assert p1.continuation == (2,) and not p1.finished
        p2 = it.next_page(page_rows=10)  # only 2 credit left
        assert len(p2.rows) == 2 and p2.continuation == (4,)
        stalled = it.next_page()
        assert stalled is None
        it.ack(100)
        log = [page(p1), page(p2), page(stalled)]
        rest = drain(it, log=log)
        assert [k for k, _ in rest] == [(i,) for i in range(5, 20)]
        return log
    both(case)


def test_range_and_columns():
    def case(P):
        _store, s = make_shard(P, 20)
        it = P.ReadIterator(s, snapshot=5, lo=(5,), hi=(9,),
                            columns=("v",), quota_rows=100)
        log = []
        rows = drain(it, log=log)
        assert [k for k, _ in rows] == [(5,), (6,), (7,), (8,)]
        assert rows[0][1] == {"v": 50}
        return log
    both(case)


def test_snapshot_stability_mid_stream():
    """Writes landing after the session opened never appear."""
    def case(P):
        _store, s = make_shard(P, 10)
        it = P.ReadIterator(s, snapshot=5, quota_rows=100)
        p1 = it.next_page(page_rows=4)
        assert len(p1.rows) == 4
        wid = s.propose([P.RowOp((4,), {"id": 4, "v": 999}),
                         P.RowOp((100,), {"id": 100, "v": 1000})])
        s.prepare([wid])
        s.commit_at([wid], step=9)
        log = [page(p1)]
        rest = drain(it, log=log)
        keys = [k for k, _ in p1.rows + rest]
        assert keys == [(i,) for i in range(10)]  # no (100,), old (4,)
        assert dict(p1.rows + rest)[(4,)]["v"] == 40
        return log
    both(case)


def test_resume_across_shard_reboot():
    def case(P):
        store, s = make_shard(P, 12)
        it = P.ReadIterator(s, snapshot=5, quota_rows=100)
        p1 = it.next_page(page_rows=5)
        token = it.resume_token()
        assert token["continuation"] == (4,)
        s2 = P.DataShard("s0", P.SCHEMA, store, ("id",))  # reboot
        it2 = P.ReadIterator.from_token(s2, token, quota_rows=100)
        log = [page(p1), token]
        rest = drain(it2, log=log)
        assert [k for k, _ in p1.rows] + [k for k, _ in rest] == \
            [(i,) for i in range(12)]
        return log
    both(case)


def test_iterator_fenced_by_undecided_volatile():
    def case(P):
        _store, s = make_shard(P, 5)
        wid = s.propose([P.RowOp((2,), {"id": 2, "v": 0})])
        assert s.apply_volatile([wid], txid=1, step=7, expected_peers=[9])
        it = P.ReadIterator(s, snapshot=8, quota_rows=100)
        with pytest.raises(P.VolatileUndecided) as e:
            it.next_page()
        decided = s.deliver_readset(1, 9, True)
        log = [str(e.value), decided]
        rows = drain(it, log=log)
        assert dict(rows)[(2,)]["v"] == 0
        return log
    both(case)
