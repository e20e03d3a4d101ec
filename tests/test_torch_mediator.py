"""The port's mediator time cast (``ydb_tpu_torch/tx/mediator.py``)
against the reference's: the 2 cases of ``tests/test_mediator.py``.

Each case runs through both packages and makes the reference test's
assertions on each; the steps every time cache reports, and the scan at
a cached snapshot, must be equal between the two. Tolerance: none."""

import threading
import types

import numpy as np
import pytest

from ydb_tpu import dtypes as rdt
from ydb_tpu.engine.blobs import MemBlobStore as RStore
from ydb_tpu.ssa.ops import Agg as RAgg
from ydb_tpu.ssa.program import AggSpec as RAggSpec
from ydb_tpu.ssa.program import GroupByStep as RGroupBy
from ydb_tpu.ssa.program import Program as RProgram
from ydb_tpu.tx import mediator as rmed
from ydb_tpu.tx.coordinator import Coordinator as RCoord
from ydb_tpu.tx.sharded import ShardedTable as RSharded

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore
from ydb_tpu_torch.ssa.ops import Agg as TAgg
from ydb_tpu_torch.ssa.program import AggSpec as TAggSpec
from ydb_tpu_torch.ssa.program import GroupByStep as TGroupBy
from ydb_tpu_torch.ssa.program import Program as TProgram
from ydb_tpu_torch.tx import mediator as tmed
from ydb_tpu_torch.tx.coordinator import Coordinator as TCoord
from ydb_tpu_torch.tx.sharded import ShardedTable as TSharded


def _ns(dt, Store, Agg, AggSpec, GroupBy, Program, med, Coord, Sharded,
        table_kw):
    return types.SimpleNamespace(
        MemBlobStore=Store, Mediator=med.Mediator,
        NodeTimeCache=med.NodeTimeCache, Coordinator=Coord,
        SCHEMA=dt.schema(("id", dt.INT64, False), ("v", dt.INT64)),
        COUNT=Program((GroupBy(keys=(), aggs=(
            AggSpec(Agg.COUNT_ALL, None, "n"),)),)),
        table=lambda *a, **kw: Sharded(*a, **kw, **table_kw))


PORT = _ns(tdt, TStore, TAgg, TAggSpec, TGroupBy, TProgram, tmed, TCoord,
           TSharded, {"device": "cpu"})
REF = _ns(rdt, RStore, RAgg, RAggSpec, RGroupBy, RProgram, rmed, RCoord,
          RSharded, {})


def both(case):
    got = case(PORT)
    assert got == case(REF)


def test_time_caches_follow_commits_and_reads_are_consistent():
    def case(P):
        coord = P.Coordinator(P.MemBlobStore())
        med = P.Mediator(coord)
        cache_a, cache_b = med.register(), med.register()
        t = P.table("t", P.SCHEMA, P.MemBlobStore(), coord, n_shards=2,
                    pk_column="id", upsert=True)
        obs = [cache_a.read_snapshot(), coord.read_snapshot()]
        assert obs[0] == obs[1]
        t.insert({"id": np.arange(10, dtype=np.int64),
                  "v": np.ones(10, dtype=np.int64)})
        step1 = coord.read_snapshot()
        assert cache_a.read_snapshot() == step1
        assert cache_b.read_snapshot() == step1
        res = t.scan(P.COUNT, snap=cache_a.read_snapshot())
        n = int(res.cols["n"][0][0])
        assert n == 10
        late = med.register()
        assert late.read_snapshot() == step1
        return obs + [step1, n, late.read_snapshot()]
    both(case)


def test_wait_for_blocks_until_barrier_passes():
    def case(P):
        coord = P.Coordinator()
        med = P.Mediator(coord)
        cache = med.register()
        target = coord.read_snapshot() + 1
        got = []
        th = threading.Thread(
            target=lambda: got.append(cache.wait_for(target, timeout=10)))
        th.start()
        step = coord.background_plan()
        th.join(timeout=10)
        assert not th.is_alive()
        assert got and got[0] >= target and step >= target
        with pytest.raises(TimeoutError) as e:
            P.NodeTimeCache().wait_for(5, timeout=0.1)
        return [target, step, got, str(e.value)]
    both(case)
