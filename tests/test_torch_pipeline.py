"""The port's execution-unit pipeline (``ydb_tpu_torch/datashard/
pipeline.py``) against the reference's: the 3 cases of
``tests/test_pipeline.py``.

Each case runs through both packages and makes the reference test's
assertions on each; every operation's unit, status, dependencies, unit
trace, plan step and error, and the rows read back, must be equal
between the two. Tolerance: none."""

import types

import pytest

from ydb_tpu import dtypes as rdt
from ydb_tpu.datashard import pipeline as rpipe
from ydb_tpu.datashard import shard as rshard
from ydb_tpu.engine.blobs import MemBlobStore as RStore

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.datashard import pipeline as tpipe
from ydb_tpu_torch.datashard import shard as tshard
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore


def _ns(dt, sh, pipe, Store):
    return types.SimpleNamespace(
        DataShard=sh.DataShard, RowOp=sh.RowOp,
        ExecutionPipeline=pipe.ExecutionPipeline, Status=pipe.Status,
        Unit=pipe.Unit, MemBlobStore=Store,
        SCHEMA=dt.schema(("id", dt.INT64), ("v", dt.INT64)))


PORT = _ns(tdt, tshard, tpipe, TStore)
REF = _ns(rdt, rshard, rpipe, RStore)


def both(case):
    got = case(PORT)
    assert got == case(REF)


def _shard(P):
    return P.DataShard("s0", P.SCHEMA, P.MemBlobStore(), pk_columns=("id",))


def op(o):
    return (o.op_id, o.unit.value, o.status.value, sorted(o.deps),
            list(o.trace), o.step, o.error, o.write_ids)


def _read(shard, key):
    return {k: r for page in shard.read(shard.snap, keys=[key])
            for k, r in page}


def test_conflicting_ops_wait_and_restart():
    def case(P):
        shard = _shard(P)
        p = P.ExecutionPipeline(shard, auto_plan=False)
        a = p.submit([P.RowOp((1,), {"id": 1, "v": 10}),
                      P.RowOp((2,), {"id": 2, "v": 20})])
        assert a.status is P.Status.WAITING and a.unit is P.Unit.WAIT_PLAN
        b = p.submit([P.RowOp((2,), {"id": 2, "v": 99})])
        assert b.status is P.Status.WAITING and b.unit is P.Unit.WAIT_DEPS
        assert b.deps == {a.op_id}
        c = p.submit([P.RowOp((7,), {"id": 7, "v": 70})])
        assert c.unit is P.Unit.WAIT_PLAN and "wait_deps" in c.trace
        assert p.in_flight == 3
        log = [op(a), op(b), op(c)]
        p.plan(a.op_id)
        assert a.status is P.Status.DONE and a.step is not None
        assert b.unit is P.Unit.WAIT_PLAN
        assert b.trace.count("wait_deps") == 2  # parked + restarted
        p.plan(b.op_id)
        p.plan(c.op_id)
        assert b.status is P.Status.DONE and c.status is P.Status.DONE
        assert b.step > a.step
        rows = _read(shard, (2,))
        assert rows[(2,)]["v"] == 99
        return log + [op(a), op(b), op(c), rows, p.in_flight]
    both(case)


def test_abort_releases_waiters():
    def case(P):
        shard = _shard(P)
        p = P.ExecutionPipeline(shard, auto_plan=False)
        lock = shard.acquire_lock()
        for _page in shard.read(shard.snap, keys=[(1,)], lock_id=lock):
            pass
        a = p.submit([P.RowOp((1,), {"id": 1, "v": 1})], lock_id=lock)
        b = p.submit([P.RowOp((1,), {"id": 1, "v": 2})])
        assert b.status is P.Status.WAITING
        shard._break_locks((1,))
        with pytest.raises(ValueError) as e:
            p.plan(999)  # unknown op refuses
        p.plan(a.op_id)
        assert a.status is P.Status.ABORTED and "lock" in a.error
        assert b.unit is P.Unit.WAIT_PLAN
        p.plan(b.op_id)
        assert b.status is P.Status.DONE
        rows = _read(shard, (1,))
        assert rows[(1,)]["v"] == 2
        return [str(e.value), op(a), op(b), rows]
    both(case)


def test_full_trace_and_autoplan():
    def case(P):
        shard = _shard(P)
        p = P.ExecutionPipeline(shard)  # auto_plan
        o = p.submit([P.RowOp((5,), {"id": 5, "v": 5})])
        assert o.status is P.Status.DONE
        assert o.trace == ["check", "build_deps", "wait_deps", "build_tx",
                           "prepare", "wait_plan", "execute", "complete"]
        bad = p.submit([P.RowOp((6,), {"id": 6, "nope": 1})])
        assert bad.status is P.Status.ABORTED and \
            "unknown column" in bad.error
        return [op(o), op(bad), _read(shard, (5,))]
    both(case)
