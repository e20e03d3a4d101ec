"""The port's quoter gate (``ydb_tpu_torch/runtime/quoter.py`` and
``Cluster.quoter``), session pool (``kqp/proxy.py``) and table backup
(``engine/backup.py``) against the reference's.

Mirrors ``tests/test_stats_quoter.py::test_quoter_throttles_requests``,
the two cases of ``tests/test_proxy_volatile.py`` and
``tests/test_backup_cache.py::test_backup_roundtrip_with_reshard``, each
through both packages with the same clock and data: the same admitted
and throttled statements and ``throttled`` counter, the same pool
statistics, the same commit steps, and the same backup part blobs and
manifest (bytes equal). A backup either package exported imports in the
other, into a different shard count. Tolerance: none."""

import json
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.engine import backup as rbackup
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.kqp.proxy import ProxyBusyError as RProxyBusyError
from ydb_tpu.kqp.proxy import SessionPool as RSessionPool
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.runtime.quoter import Quoter as RQuoter
from ydb_tpu.runtime.quoter import ThrottledError as RThrottledError
from ydb_tpu.ssa.ops import Agg as RAgg
from ydb_tpu.ssa.program import AggSpec as RAggSpec
from ydb_tpu.ssa.program import GroupByStep as RGroupByStep
from ydb_tpu.ssa.program import Program as RProgram
from ydb_tpu.tx.coordinator import Coordinator as RCoordinator
from ydb_tpu.tx.sharded import ShardedTable as RShardedTable

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch import interop
from ydb_tpu_torch.engine import backup
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.kqp.proxy import ProxyBusyError, SessionPool
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.runtime.quoter import Quoter, ThrottledError
from ydb_tpu_torch.ssa.ops import Agg
from ydb_tpu_torch.ssa.program import AggSpec, GroupByStep, Program
from ydb_tpu_torch.tx.coordinator import Coordinator
from ydb_tpu_torch.tx.sharded import ShardedTable


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def _kv(c):
    s = c.session()
    s.execute("create table kv (k bigint not null, v bigint, "
              "primary key (k))")
    s.execute("insert into kv (k, v) values (1, 10), (2, 20), (3, 30)")
    return s


# ---------------- tests/test_stats_quoter.py ----------------

def test_quoter_throttles_requests():
    got = []
    for c, make, throttled in ((RCluster(), RQuoter, RThrottledError),
                               (Cluster(device="cpu"), Quoter,
                                ThrottledError)):
        clock = [0.0]
        q = make(clock=lambda: clock[0])
        q.configure("kqp", rate=1000.0, burst=1000.0)
        q.configure("kqp/requests", rate=1.0, burst=2.0)
        s = _kv(c)
        c.quoter = q
        seen = []
        for step in (0.0, 0.0, 0.0, 1.0, 0.0):
            clock[0] += step
            try:
                seen.append(int(s.execute(
                    "select count(*) as n from kv").cols["n"][0][0]))
            except throttled as e:
                seen.append(str(e))
        # hierarchical: parent exhaustion throttles the child
        q.configure("kqp", rate=0.0, burst=0.0)
        clock[0] += 10.0
        seen.append(q.try_acquire("kqp/requests"))
        seen.append(q.describe("kqp/requests"))
        seen.append(q.wait_time("kqp/requests"))
        seen.append(c.counters.group(kind="throttled").counter(
            "queries").value)
        c.quoter = None
        seen.append(c.session().execute(
            "select count(*) as n from kv").num_rows)
        got.append(seen)
    assert got[1] == got[0]
    assert got[1][:5] == [3, 3, "request rate limit exceeded", 3,
                          "request rate limit exceeded"]
    assert got[1][5] is False and got[1][8] == 2


# ---------------- tests/test_proxy_volatile.py ----------------

def test_session_pool_reuses_and_caps():
    got = []
    for c, make, busy in ((RCluster(), RSessionPool, RProxyBusyError),
                          (Cluster(device="cpu"), SessionPool,
                           ProxyBusyError)):
        pool = make(c, max_sessions=2)
        pool.execute("create table kv (k bigint not null, v bigint, "
                     "primary key (k))")
        pool.execute("insert into kv (k, v) values (1, 10)")
        r = pool.execute("select count(*) as n from kv")
        seen = [int(r.cols["n"][0][0]), pool.live, pool.idle,
                dict(pool.stats)]
        s1, s2 = pool.acquire(), pool.acquire()
        with pytest.raises(busy):
            pool.acquire()
        pool.release(s1)
        pool.release(s2)
        assert pool.execute("select count(*) as n from kv") is not None
        got.append(seen + [dict(pool.stats), pool.live, pool.idle])
    assert got[1] == got[0]
    assert got[1][:3] == [1, 1, 1] and got[1][3]["reused"] >= 2


class _Shard:
    def __init__(self, fail_prepare=False):
        self.fail_prepare = fail_prepare
        self.committed_at = None
        self.aborted = False

    def prepare(self, args):
        if self.fail_prepare:
            raise RuntimeError("nope")
        return args

    def commit_at(self, token, step):
        self.committed_at = step

    def abort(self, args):
        self.aborted = True


def test_volatile_single_shard_commit():
    got = []
    for make in (RCoordinator, Coordinator):
        coord = make()
        s = _Shard()
        res = coord.commit([s], [["w1"]])
        seen = [res.committed, res.step, s.committed_at,
                coord.read_snapshot()]
        bad = _Shard(fail_prepare=True)
        res = coord.commit([bad], [["w2"]])
        seen += [res.committed, bad.aborted, res.step,
                 coord.read_snapshot()]
        got.append(seen)
    assert got[1] == got[0]
    committed, step, at, snap, ok2, aborted, step2, snap2 = got[1]
    assert committed and at == step == snap
    assert not ok2 and aborted and snap2 < step2


# ---------------- tests/test_backup_cache.py ----------------

def _schema(dt):
    return dt.schema(("id", dt.INT64, False), ("v", dt.INT64),
                     ("tag", dt.STRING))


def _count(prog_cls, groupby, spec, agg):
    return prog_cls((groupby(keys=(), aggs=(
        spec(agg.COUNT_ALL, None, "n"), spec(agg.SUM, "v", "s"))),))


REF = dict(schema=_schema(rdt), table=RShardedTable, coord=RCoordinator,
           store=RMemBlobStore, backup=rbackup,
           count=_count(RProgram, RGroupByStep, RAggSpec, RAgg), kw={})
PORT = dict(schema=_schema(tdt), table=ShardedTable, coord=Coordinator,
            store=MemBlobStore, backup=backup,
            count=_count(Program, GroupByStep, AggSpec, Agg),
            kw={"device": "cpu"})


def _loaded(k):
    t = k["table"]("t", k["schema"], k["store"](),
                   k["coord"](k["store"]()), n_shards=3, pk_column="id",
                   upsert=True, **k["kw"])
    t.insert({"id": np.arange(200, dtype=np.int64),
              "v": np.arange(200, dtype=np.int64),
              "tag": [b"a" if i % 2 else b"b" for i in range(200)]})
    # upsert half the keys: backup must carry the LOGICAL rows
    t.insert({"id": np.arange(0, 200, 2, dtype=np.int64),
              "v": np.full(100, 1000, dtype=np.int64),
              "tag": [b"c"] * 100})
    return t


def _scan(t, k):
    res = t.scan(k["count"])
    return int(res.cols["n"][0][0]), int(res.cols["s"][0][0])


WANT_S = sum(1000 if i % 2 == 0 else i for i in range(200))


def test_backup_roundtrip_with_reshard():
    got = []
    for k in (REF, PORT):
        t = _loaded(k)
        dest = k["store"]()
        man = k["backup"].export_table(t, dest, "t_backup")
        kw = dict(k["kw"])
        t2 = k["backup"].import_table(dest, "t_backup", k["store"](),
                                      k["coord"](k["store"]()),
                                      n_shards=5, **kw)
        counted = _scan(t2, k)
        t.insert({"id": np.array([999], dtype=np.int64),
                  "v": np.array([1], dtype=np.int64), "tag": [b"z"]})
        man2 = k["backup"].export_table(t, dest, "t_backup2",
                                        snap=man["snapshot"])
        got.append((man, counted, man2["rows"],
                    k["backup"].read_manifest(dest, "t_backup"),
                    {b: bytes(dest.get(b)) for b in dest.list("")},
                    len(t2.shards), t2.dicts["tag"].get(b"c") is not None))
    assert got[1] == got[0]
    man, counted, rows2, read, _blobs, shards, has_c = got[1]
    assert man["rows"] == 200 and read["pk_column"] == "id"
    assert counted == (200, WANT_S) and rows2 == 200
    assert shards == 5 and has_c


def _to_reference(store):
    out = RMemBlobStore()
    for b in store.list(""):
        out.put(b, bytes(store.get(b)))
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_backup_imports_in_the_other_package(writer):
    """A backup one package exported imports in the other, into 4 shards
    instead of 3, with the same logical rows and dictionary."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    t = _loaded(w)
    dest = w["store"]()
    man = w["backup"].export_table(t, dest, "bk")
    moved = (interop.blob_store_from_reference(dest) if writer == "ref"
             else _to_reference(dest))
    assert r["backup"].read_manifest(moved, "bk") == json.loads(
        json.dumps(man))
    assert r["backup"].schema_from_json(man["schema"]) == r["schema"]
    t2 = r["backup"].import_table(moved, "bk", r["store"](),
                                  r["coord"](r["store"]()), n_shards=4,
                                  **r["kw"])
    assert len(t2.shards) == 4
    assert _scan(t2, r) == (200, WANT_S)
    assert list(t2.dicts["tag"].values) == list(t.dicts["tag"].values)
