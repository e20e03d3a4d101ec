"""The port's state plane against the reference's: ``tablet/localdb.py``,
``tablet/executor.py``, ``scheme/shard.py`` (``SchemeShardCore``, ACLs
included), ``tx/coordinator.py`` (the durable plan-step clock) and
``tx/sharded.py`` (``_fnv_route`` bits, insert, scan, reshard, TTL).

The same operations run through both packages, each over its own
``MemBlobStore``. Tolerance: none. Reads must be equal, the blobs each
package writes must be equal byte for byte (same keys, same bytes), and
each package must boot from a store the other wrote. Scans hold
integers exactly."""

import numpy as np
import pytest

from ydb_tpu import dtypes as rdt
from ydb_tpu.engine.blobs import MemBlobStore as RStore
from ydb_tpu.engine.shard import ShardConfig as RShardConfig
from ydb_tpu.scheme.model import TableDescription as RDesc
from ydb_tpu.scheme.shard import SchemeError as RSchemeError
from ydb_tpu.scheme.shard import SchemeShardCore as RCore
from ydb_tpu.ssa import Agg as RAgg
from ydb_tpu.ssa import AggSpec as RAggSpec
from ydb_tpu.ssa import GroupByStep as RGroupBy
from ydb_tpu.ssa.program import Program as RProgram
from ydb_tpu.tablet.executor import TabletExecutor as RExec
from ydb_tpu.tablet.localdb import LocalDb as RLocalDb
from ydb_tpu.tablet.localdb import TableStore as RTableStore
from ydb_tpu.tx import Coordinator as RCoord
from ydb_tpu.tx import ShardedTable as RSharded
from ydb_tpu.tx.sharded import _fnv_route as r_route

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch import interop
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore
from ydb_tpu_torch.engine.shard import ShardConfig as TShardConfig
from ydb_tpu_torch.scheme.model import TableDescription as TDesc
from ydb_tpu_torch.scheme.shard import SchemeError as TSchemeError
from ydb_tpu_torch.scheme.shard import SchemeShardCore as TCore
from ydb_tpu_torch.tablet.executor import TabletExecutor as TExec
from ydb_tpu_torch.tablet.localdb import LocalDb as TLocalDb
from ydb_tpu_torch.tablet.localdb import TableStore as TTableStore
from ydb_tpu_torch.tx import Coordinator as TCoord
from ydb_tpu_torch.tx import ShardedTable as TSharded
from ydb_tpu_torch.tx.sharded import _fnv_route as t_route


def blobs(store) -> dict:
    return {k: bytes(store.get(k)) for k in store.list("")}


# ---------------- LocalDb ----------------

def _localdb_ops(Table, Db):
    t = Table("t", memtable_limit=4)
    out = []
    for i in range(12):
        t.put((i % 5, f"k{i}"), {"v": i}, version=i + 1)
        if i % 3 == 2:
            t.put((i % 5, f"k{i - 1}"), None, version=i + 1)
    out.append(list(t.range()))
    out.append(list(t.range(lo=(1,), hi=(3,), version=6)))
    out.append([t.get((k % 5, f"k{k}"), version=v)
                for k in range(12) for v in (3, 9, None)])
    out.append((t.n_parts, t.bloom_negatives()))
    t.compact(keep_after=8)
    out.append(list(t.range()))
    out.append(t.dump())
    db = Db()
    db.apply([("a", (1, "x"), {"v": 1}), ("b", (2,), {"w": 9})], version=4)
    db.apply([("a", (1, "x"), None), ("a", (3, "y"), {"v": 3})], version=6)
    out.append(db.dump())
    db2 = Db.load(db.dump())
    out.append([db2.table("a").get((1, "x"), version=5),
                db2.table("a").get((1, "x")), list(db2.table("a").range())])
    return out


def test_localdb_matches_reference():
    assert _localdb_ops(TTableStore, TLocalDb) == \
        _localdb_ops(RTableStore, RLocalDb)


# ---------------- TabletExecutor ----------------

def _executor_run(Exec, store):
    ex = Exec("t1", store)
    for i in range(40):
        ex.run(lambda txc, i=i: txc.put("kv", (i % 7,), {"v": i}))
        if i % 9 == 8:
            ex.run(lambda txc, i=i: txc.erase("kv", ((i + 1) % 7,)))
    ex.checkpoint()
    for i in range(5):
        ex.run(lambda txc, i=i: txc.put("kv", (100 + i,), {"v": -i}))
    return ex


def _state(ex) -> tuple:
    return (ex.version, ex.generation, list(ex.db.table("kv").range()))


def test_executor_blobs_and_cross_boot():
    rs, ts = RStore(), TStore()
    rex = _executor_run(RExec, rs)
    tex = _executor_run(TExec, ts)
    assert _state(tex) == _state(rex)
    assert blobs(ts) == blobs(rs)
    # each package boots the tablet the other wrote
    t_from_r = TExec.boot("t1", interop.blob_store_from_reference(rs))
    r_from_t = RExec.boot("t1", ts)
    assert _state(t_from_r) == _state(RExec.boot("t1", rs))
    assert _state(r_from_t)[2] == _state(tex)[2]


@pytest.mark.parametrize("Exec", [TExec, RExec], ids=["port", "ref"])
def test_executor_generation_fencing(Exec):
    """The reference's fencing cases, on both packages: a zombie leader's
    writes never outrank its successor's, and its checkpoint is refused."""
    store = TStore() if Exec is TExec else RStore()
    ex = Exec("t3", store)
    ex.run(lambda txc: txc.put("kv", ("k",), {"v": "old"}))
    new = Exec.boot("t3", store)
    new.run(lambda txc: txc.put("kv", ("k",), {"v": "new"}))
    ex.run(lambda txc: txc.put("kv", ("k",), {"v": "zombie"}))
    assert Exec.boot("t3", store).db.table("kv").get(("k",)) == \
        {"v": "new"}
    fenced = __import__(Exec.__module__, fromlist=["FencedError"])
    with pytest.raises(fenced.FencedError):
        for i in range(Exec.SNAP_EVERY + 1):
            ex.run(lambda txc, i=i: txc.put("kv", (f"z{i}",), {"v": i}))
    again = Exec.boot("t3", store)
    assert again.db.table("kv").get(("k",)) == {"v": "new"}
    assert again.db.table("kv").get(("z0",)) is None


# ---------------- SchemeShardCore ----------------

def _desc(Desc, dt, path, pk="id"):
    schema = dt.schema(("id", dt.INT64, False), ("name", dt.STRING),
                       ("amount", dt.decimal(2)))
    return Desc(path=path, schema=schema, primary_key=(pk,), n_shards=3)


def _scheme_ops(Core, Exec, Desc, dt, Err, store):
    core = Core(Exec.boot("schemeshard", store))
    log = []

    def attempt(fn):
        try:
            out = fn()
            log.append(("ok", out.to_json() if hasattr(out, "to_json")
                        else out))
        except Err as e:
            log.append(("error", str(e)))

    attempt(lambda: core.mkdir("/app"))
    attempt(lambda: core.create_table(_desc(Desc, dt, "/app/events")))
    attempt(lambda: core.create_table(_desc(Desc, dt, "/app/events")))
    attempt(lambda: core.create_table(_desc(Desc, dt, "/nodir/t")))
    attempt(lambda: core.create_table(_desc(Desc, dt, "/app/bad", "nope")))
    attempt(lambda: core.mkdir("/app/events/sub"))
    attempt(lambda: core.alter_table(
        "/app/events", add_columns=[dt.Field("extra", dt.DOUBLE, True)]))
    attempt(lambda: core.alter_table(
        "/app/events", add_columns=[dt.Field("x", dt.INT32, False)]))
    attempt(lambda: core.alter_table("/app/events", drop_columns=["id"]))
    attempt(lambda: core.alter_table("/app/events",
                                     drop_columns=["extra"]))
    attempt(lambda: core.create_table(_desc(Desc, dt, "/app/gone")))
    attempt(lambda: core.drop_table("/app/gone",
                                    trash_prefixes=["gone/0/"]))
    attempt(lambda: core.grant("/app", "alice", ["read"]))
    attempt(lambda: core.grant("/app/events", "bob", ["write", "ddl"]))
    attempt(lambda: core.revoke("/app/events", "bob", ["ddl"]))
    attempt(lambda: core.revoke("/app", "nobody", ["read"]))
    attempt(lambda: core.reshard_table("/app/events", 5, 1))
    log.append(("kind", core.kind("/app"), core.kind("/app/events")))
    log.append(("children", core.children("/"), core.children("/app")))
    log.append(("describe", core.describe("/app/events").to_json()))
    log.append(("ops", core.operations_log()))
    log.append(("trash", core.trash()))
    log.append(("acl", core.acl_enabled(), core.access_list("/app"),
                core.access_list("/app/events")))
    log.append(("access", [core.check_access(s, p, perm)
                           for s in ("alice", "bob", "carol")
                           for p in ("/app", "/app/events")
                           for perm in ("read", "write", "ddl")]))
    return log


def test_scheme_shard_matches_reference_and_reboots():
    rs, ts = RStore(), TStore()
    want = _scheme_ops(RCore, RExec, RDesc, rdt, RSchemeError, rs)
    got = _scheme_ops(TCore, TExec, TDesc, tdt, TSchemeError, ts)
    assert got == want
    assert blobs(ts) == blobs(rs)
    # reboot: the port's schemeshard on either package's store
    for store in (ts, interop.blob_store_from_reference(rs)):
        core = TCore(TExec.boot("schemeshard", store))
        assert [d.to_json() for d in core.list_tables()] == \
            [d.to_json() for d in RCore(RExec.boot(
                "schemeshard", rs)).list_tables()]
        assert core.check_access("bob", "/app/events", "write")
        assert not core.check_access("bob", "/app/events", "ddl")


# ---------------- Coordinator ----------------

class _Participant:
    """A commit participant that records what it was told."""

    def __init__(self, fail=False):
        self.fail = fail
        self.log = []

    def prepare(self, arg):
        if self.fail:
            raise RuntimeError("prepare refused")
        self.log.append(("prepare", arg))
        return arg

    def commit_at(self, arg, step):
        self.log.append(("commit", arg, step))

    def abort(self, arg):
        self.log.append(("abort", arg))


def _coordinator_ops(Coord, store):
    c = Coord(store, reserve=4)
    out = []
    for i in range(10):
        ps = [_Participant(), _Participant()]
        r = c.commit(ps, [i, i + 100])
        out.append((r.step, r.committed, [p.log for p in ps]))
        out.append(c.background_plan())
    bad = [_Participant(), _Participant(fail=True)]
    r = c.commit(bad, [1, 2])
    out.append((r.committed, bad[0].log))
    out.append((c.last_step, c.read_snapshot()))
    return out


def test_coordinator_durable_clock_matches_reference():
    rs, ts = RStore(), TStore()
    want = _coordinator_ops(RCoord, rs)
    got = _coordinator_ops(TCoord, ts)
    assert got == want
    assert blobs(ts) == blobs(rs)
    # a reboot resumes past every step either package reserved
    for store in (ts, interop.blob_store_from_reference(rs)):
        t2 = TCoord(store, start_step=0, reserve=4)
        r2 = RCoord(rs if store is not ts else RStore(), start_step=0,
                    reserve=4)
        assert t2.read_snapshot() >= want[-1][0]
        if store is not ts:
            assert t2.plan() == r2.plan()


# ---------------- ShardedTable ----------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 16])
def test_fnv_route_bits(n_shards):
    rng = np.random.default_rng(n_shards)
    keys = np.concatenate([
        rng.integers(-2**62, 2**62, 5000, dtype=np.int64),
        np.arange(-50, 50, dtype=np.int64)])
    np.testing.assert_array_equal(t_route(keys, n_shards),
                                  r_route(keys, n_shards))


_COLS = (("k", "INT64", 0, False), ("ts", "DATE", 0, False),
         ("v", "INT64", 0, True), ("s", "STRING", 0, True))


def _rows(rng, lo, n):
    words = [b"alpha", b"beta", b"gamma", b"delta"]
    return {"k": np.arange(lo, lo + n, dtype=np.int64),
            "ts": rng.integers(100, 200, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int64),
            "s": [words[i] for i in rng.integers(0, 4, n)]}


def _sharded_run(Sharded, Coord, Store, dt, Config, program, device):
    rng = np.random.default_rng(7)
    schema = dt.schema(("k", dt.INT64, False), ("ts", dt.DATE, False),
                       ("v", dt.INT64), ("s", dt.STRING))
    store = Store()
    kw = {} if device is None else {"device": device}
    t = Sharded("t", schema, store, Coord(), n_shards=3, pk_column="k",
                ttl_column="ts",
                config=Config(compact_portion_threshold=2), **kw)
    steps = []
    for i in range(4):
        rows = _rows(rng, i * 500, 500)
        val = {"v": rng.random(500) > 0.1}
        steps.append(t.insert(rows, val).step)
    out = {"steps": steps,
           "portions": [len(s.visible_portions()) for s in t.shards]}
    scan_kw = {} if device is None else {}
    out["scan"] = _cols(t.scan(program, **scan_kw))
    out["scan_at_2"] = _cols(t.scan(program, snap=steps[1]))
    out["background"] = t.run_background(ttl_cutoff=150)
    out["after_ttl"] = _cols(t.scan(program))
    out["gen"] = t.reshard(5)
    out["after_reshard"] = _cols(t.scan(program))
    out["reshard_portions"] = sum(len(s.visible_portions())
                                  for s in t.shards)
    out["route"] = [len(s.shard_id) for s in t.shards]
    out["dict"] = list(t.dicts["s"].values)
    return out


def _cols(res) -> dict:
    return {n: (np.asarray(v).tolist(), np.asarray(ok).tolist())
            for n, (v, ok) in res.cols.items()}


def test_sharded_table_matches_reference():
    program = RProgram((RGroupBy(keys=("s",), aggs=(
        RAggSpec(RAgg.COUNT_ALL, None, "n"),
        RAggSpec(RAgg.SUM, "v", "sv"),
        RAggSpec(RAgg.MIN, "ts", "lo"))),))
    want = _sharded_run(RSharded, RCoord, RStore, rdt, RShardConfig,
                        program, None)
    got = _sharded_run(TSharded, TCoord, TStore, tdt, TShardConfig,
                       interop.program_from_reference(program), "cpu")
    assert got == want
    assert sum(want["after_ttl"]["n"][0]) < sum(want["scan"]["n"][0])
    assert want["after_reshard"] == want["after_ttl"]
