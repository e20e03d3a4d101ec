"""The port's tablet plane (``ydb_tpu_torch/tablet/statestorage.py``,
``hive.py``, ``pipe.py``, with the executor and the local DB) against the
reference's.

Each of the 11 cases of ``tests/test_tablet.py`` runs once through each
package with the same seeded values (numpy, seed per case): the local
DB's reads, the executor's generations and versions, and on a 4-node
``SimRuntime`` every message the client probe received (classes by
name, fields by value, actor ids as pairs), then every blob of the two
stores, byte for byte. The reference's own assertions run on both sides.
Tolerance: none."""

import dataclasses
import json

import numpy as np
import pytest

from ydb_tpu.engine import blobs as rblobs
from ydb_tpu.runtime import actors as ractors
from ydb_tpu.runtime import test_runtime as rsim
from ydb_tpu.tablet import executor as rexecutor
from ydb_tpu.tablet import hive as rhive
from ydb_tpu.tablet import localdb as rlocaldb
from ydb_tpu.tablet import pipe as rpipe
from ydb_tpu.tablet import statestorage as rss

from ydb_tpu_torch.engine import blobs
from ydb_tpu_torch.runtime import actors
from ydb_tpu_torch.runtime import test_runtime as sim
from ydb_tpu_torch.tablet import executor
from ydb_tpu_torch.tablet import hive
from ydb_tpu_torch.tablet import localdb
from ydb_tpu_torch.tablet import pipe
from ydb_tpu_torch.tablet import statestorage as ss


@dataclasses.dataclass
class Kit:
    name: str
    blobs: object
    actors: object
    sim: object
    executor: object
    hive: object
    localdb: object
    pipe: object
    ss: object


KITS = (Kit("ref", rblobs, ractors, rsim, rexecutor, rhive, rlocaldb, rpipe,
            rss),
        Kit("port", blobs, actors, sim, executor, hive, localdb, pipe, ss))


def plain(obj):
    """Messages as comparable values: dataclasses as (class name,
    fields), tuples and lists element-wise."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            plain(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(plain(v) for v in obj)
    return obj


def store_blobs(store) -> dict:
    return {b: bytes(store.get(b)) for b in store.list("")}


def both(scenario, seed):
    """``scenario(kit, rng)`` through each package; equal outputs."""
    outs = [scenario(k, np.random.default_rng(seed)) for k in KITS]
    assert outs[0] == outs[1]
    return outs[1]


# ---------- LocalDb ----------

def test_localdb_mvcc_versions():
    def run(k, rng):
        x1, x2 = (int(v) for v in rng.integers(0, 1000, 2))
        t = k.localdb.TableStore("t")
        t.put(("a",), {"x": x1}, version=1)
        t.put(("a",), {"x": x2}, version=5)
        out = [t.get(("a",)), t.get(("a",), version=1),
               t.get(("a",), version=4)]
        t.put(("a",), None, version=7)  # erase
        out += [t.get(("a",)), t.get(("a",), version=6)]
        assert out == [{"x": x2}, {"x": x1}, {"x": x1}, None, {"x": x2}]
        return out

    both(run, 1)


def test_localdb_range_and_compact():
    def run(k, rng):
        vals = [int(v) for v in rng.integers(0, 1000, 5)]
        t = k.localdb.TableStore("t")
        for i in range(5):
            t.put((i,), {"v": vals[i]}, version=1)
        t.put((2,), {"v": 22}, version=3)
        t.put((3,), None, version=3)
        rows = list(t.range(lo=(1,), hi=(4,)))
        assert rows == [((1,), {"v": vals[1]}), ((2,), {"v": 22})]
        rows_old = list(t.range(lo=(1,), hi=(4,), version=2))
        assert rows_old == [((1,), {"v": vals[1]}), ((2,), {"v": vals[2]}),
                            ((3,), {"v": vals[3]})]
        t.compact(keep_after=3)
        assert (3,) not in t._chains  # tombstone fully collected
        return rows, rows_old, t.get((2,)), t.get((3,)), t.dump()

    both(run, 2)


def test_localdb_dump_load_roundtrip():
    def run(k, rng):
        v, w = (int(x) for x in rng.integers(0, 1000, 2))
        db = k.localdb.LocalDb()
        db.apply([("t", (1, "a"), {"v": v}), ("u", (2,), {"w": w})],
                 version=4)
        db.apply([("t", (1, "a"), None)], version=6)
        dump = db.dump()
        db2 = k.localdb.LocalDb.load(json.loads(json.dumps(dump)))
        out = [db2.table("t").get((1, "a")),
               db2.table("t").get((1, "a"), version=5),
               db2.table("u").get((2,))]
        assert out == [None, {"v": v}, {"w": w}]
        return out, dump

    both(run, 3)


# ---------- executor ----------

def put_tx(k, table, key, row):
    class PutTx(k.executor.Transaction):
        def __init__(self):
            self.completed = False

        def execute(self, txc, tablet):
            txc.put(table, key, row)

        def complete(self, tablet):
            self.completed = True

    return PutTx()


def test_executor_commit_boot_replay():
    def run(k, rng):
        vals = [int(v) for v in rng.integers(0, 1 << 30, 10)]
        store = k.blobs.MemBlobStore()
        ex = k.executor.TabletExecutor("t1", store)
        for i in range(10):
            tx = ex.execute(put_tx(k, "kv", (i,), {"v": vals[i]}))
            assert tx.completed
        # cold boot on a "different node": same store, fresh executor
        ex2 = k.executor.TabletExecutor.boot("t1", store)
        assert ex2.generation == ex.generation + 1
        rows = [ex2.db.table("kv").get((i,)) for i in range(10)]
        assert rows == [{"v": v} for v in vals]
        assert ex2.version == ex.version
        return ex2.generation, ex2.version, rows, store_blobs(store)

    both(run, 4)


def test_executor_checkpoint_truncates_log():
    def run(k, rng):
        vals = [int(v) for v in rng.integers(0, 1000, 6)]
        store = k.blobs.MemBlobStore()
        ex = k.executor.TabletExecutor("t2", store)
        for i in range(5):
            ex.execute(put_tx(k, "kv", (i,), {"v": vals[i]}))
        assert len(store.list("tablet/t2/log/")) == 5
        ex.checkpoint()
        assert store.list("tablet/t2/log/") == []
        ex.execute(put_tx(k, "kv", (99,), {"v": vals[5]}))
        ex3 = k.executor.TabletExecutor.boot("t2", store)
        rows = [ex3.db.table("kv").get((99,)), ex3.db.table("kv").get((0,))]
        assert rows == [{"v": vals[5]}, {"v": vals[0]}]
        return rows, store_blobs(store)

    both(run, 5)


def test_executor_generation_fencing():
    def run(k, rng):
        store = k.blobs.MemBlobStore()
        ex = k.executor.TabletExecutor("t3", store)
        ex.execute(put_tx(k, "kv", ("k",), {"v": "old"}))
        # a new leader boots (gen+1) and writes
        new_leader = k.executor.TabletExecutor.boot("t3", store)
        new_leader.execute(put_tx(k, "kv", ("k",), {"v": "new"}))
        # zombie old leader keeps appending to its lower generation
        ex.execute(put_tx(k, "kv", ("k",), {"v": "zombie"}))
        # next boot follows the highest-generation chain only
        ex2 = k.executor.TabletExecutor.boot("t3", store)
        assert ex2.db.table("kv").get(("k",)) == {"v": "new"}
        return ex2.generation, ex2.version, store_blobs(store)

    both(run, 6)


def test_executor_zombie_checkpoint_is_fenced():
    def run(k, rng):
        store = k.blobs.MemBlobStore()
        ex = k.executor.TabletExecutor("t4", store)
        ex.execute(put_tx(k, "kv", ("k",), {"v": "old"}))
        new_leader = k.executor.TabletExecutor.boot("t4", store)
        new_leader.execute(put_tx(k, "kv", ("k",), {"v": "new"}))
        # the fenced-out leader keeps committing, enough to trigger its
        # automatic checkpoint, which must be refused, not written
        with pytest.raises(k.executor.FencedError):
            for i in range(k.executor.TabletExecutor.SNAP_EVERY + 1):
                ex.execute(put_tx(k, "kv", (f"z{i}",), {"v": i}))
        ex2 = k.executor.TabletExecutor.boot("t4", store)
        rows = [ex2.db.table("kv").get(("k",)),
                ex2.db.table("kv").get(("z0",))]
        assert rows == [{"v": "new"}, None]
        return rows, store_blobs(store)

    both(run, 7)


def test_executor_boot_skips_zombie_tainted_snapshot():
    def run(k, rng):
        store = k.blobs.MemBlobStore()
        ex = k.executor.TabletExecutor("t5", store)
        ex.execute(put_tx(k, "kv", ("k",), {"v": "old"}))
        new_leader = k.executor.TabletExecutor.boot("t5", store)
        new_leader.execute(put_tx(k, "kv", ("k",), {"v": "new"}))
        # a zombie snapshot that raced past the fence check, written
        # the way a stale checkpoint would have been
        zsnap = {
            "gen": ex.generation,
            "version": new_leader.version + 5,  # includes zombie writes
            "log_index": ex.log_index,
            "db": ex.db.dump(),
        }
        store.put(
            f"tablet/t5/snap/{zsnap['gen']:08d}.{zsnap['version']:012d}",
            json.dumps(zsnap).encode())
        ex2 = k.executor.TabletExecutor.boot("t5", store)
        assert ex2.db.table("kv").get(("k",)) == {"v": "new"}
        return ex2.generation, store_blobs(store)

    both(run, 8)


def test_localdb_parts_bloom_and_compaction():
    def run(k, rng):
        vals = [int(v) for v in rng.integers(0, 1 << 20, 350)]
        t = k.localdb.TableStore("t", memtable_limit=100)
        for i in range(350):  # 3 auto-freezes + live memtable
            t.put((i,), {"v": vals[i]}, version=i + 1)
        assert t.n_parts == 3
        out = [t.get((i,)) for i in (0, 99, 100, 250, 349)]
        assert out == [{"v": vals[i]} for i in (0, 99, 100, 250, 349)]
        assert all(t.get((i,)) is None for i in range(400, 600))
        assert t.bloom_negatives() > 0
        t.put((5,), {"v": 999}, version=500)
        t.put((6,), None, version=501)
        out += [t.get((5,)), t.get((5,), version=400), t.get((6,)),
                t.get((6,), version=400), t.bloom_negatives()]
        got = [key[0] for key, _r in t.range((3,), (9,))]
        assert got == [3, 4, 5, 7, 8]  # 6 tombstoned
        dump = t.dump()
        t2 = k.localdb.TableStore.load("t", json.loads(json.dumps(dump)))
        assert t2.get((5,), version=400) == {"v": vals[5]}
        t.compact(keep_after=502)
        assert t.n_parts == 0
        assert len(t._full_chain((5,))) == 1  # shadowed version pruned
        return out, got, dump, t.get((5,)), t.get((6,))

    both(run, 9)


# ---------- cluster: state storage + hive + pipes ----------

def counter_tablet(k):
    class CounterTablet(k.hive.TabletActor):
        def handle(self, message, reply_to):
            if message[0] == "add":
                amount = message[1]

                class Tx(k.executor.Transaction):
                    def execute(self, txc, tablet):
                        row = txc.get("c", ("v",)) or {"n": 0}
                        txc.put("c", ("v",), {"n": row["n"] + amount})

                self.executor.execute(Tx())
                self.send(reply_to, ("added", self.tablet_id))
            elif message[0] == "get":
                row = self.executor.db.table("c").get(("v",)) or {"n": 0}
                self.send(reply_to, ("value", row["n"], self.self_id.node))

    return CounterTablet


def probe(k):
    class Probe(k.actors.Actor):
        def __init__(self):
            super().__init__()
            self.inbox = []

        def receive(self, message, sender):
            self.inbox.append(message)

    return Probe()


def cluster(k):
    rt = k.sim.SimRuntime(n_nodes=4)
    store = k.blobs.MemBlobStore()
    replicas = [rt.system(n).register(k.ss.StateStorageReplica())
                for n in (1, 2, 3)]
    proxies = {n: rt.system(n).register(k.ss.StateStorageProxy(replicas))
               for n in rt.nodes}
    hive_id = rt.system(1).register(k.hive.Hive())
    agents = {n: rt.system(n).register(k.hive.LocalAgent(
        store, proxies[n], {"counter": counter_tablet(k)}, hive=hive_id))
        for n in (2, 3, 4)}
    rt.dispatch()
    return rt, store, proxies, hive_id, agents


def test_hive_creates_and_pipe_routes():
    def run(k, rng):
        amounts = [int(v) for v in rng.integers(1, 100, 2)]
        rt, store, proxies, hive_id, _agents = cluster(k)
        p = probe(k)
        probe_id = rt.system(1).register(p)
        rt.system(1).send(hive_id, k.hive.CreateTablet("cnt-1", "counter"),
                          sender=probe_id)
        rt.dispatch()
        created = [m for m in p.inbox
                   if isinstance(m, k.hive.TabletCreated)]
        assert len(created) == 1
        pipe_id = rt.system(1).register(
            k.pipe.PipeClient("cnt-1", proxies[1], probe_id))
        for amount in amounts:
            rt.system(1).send(pipe_id, k.pipe.PipeSend(("add", amount)))
        rt.system(1).send(pipe_id, k.pipe.PipeSend(("get",)))
        rt.dispatch()
        values = [m for m in p.inbox
                  if isinstance(m, tuple) and m[0] == "value"]
        assert values and values[-1][1] == sum(amounts)
        return plain(p.inbox), store_blobs(store)

    both(run, 10)


def test_hive_reboots_tablet_after_node_death():
    def run(k, rng):
        amount = int(rng.integers(1, 1000))
        rt, store, proxies, hive_id, agents = cluster(k)
        p = probe(k)
        probe_id = rt.system(1).register(p)
        rt.system(1).send(hive_id, k.hive.CreateTablet("cnt-2", "counter"),
                          sender=probe_id)
        rt.dispatch()
        home = [m for m in p.inbox
                if isinstance(m, k.hive.TabletCreated)][0].node
        pipe_id = rt.system(1).register(
            k.pipe.PipeClient("cnt-2", proxies[1], probe_id))
        rt.system(1).send(pipe_id, k.pipe.PipeSend(("add", amount)))
        rt.dispatch()

        # kill the hosting node; the hive's ping loop detects and reboots
        rt.system(home).send(agents[home], k.hive.KillNode())
        rt.dispatch()
        rt.system(1).send(pipe_id, k.pipe.PipeSend(("get",)))

        def got_value():
            return any(isinstance(m, tuple) and m[0] == "value"
                       for m in p.inbox)

        assert rt.run_until(got_value, max_iterations=200)
        value_msg = [m for m in p.inbox
                     if isinstance(m, tuple) and m[0] == "value"][-1]
        assert value_msg[1] == amount   # state recovered from the store
        assert value_msg[2] != home     # now on a different node
        return plain(p.inbox), home, store_blobs(store)

    both(run, 11)
