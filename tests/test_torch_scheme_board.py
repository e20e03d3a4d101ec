"""The port's scheme board (``ydb_tpu_torch/scheme/board.py``) and
``SchemeShardTablet`` (``scheme/shard.py``) against the reference's.

``test_scheme_board_propagation`` and
``test_board_stale_update_cannot_resurrect_drop`` of
``tests/test_scheme.py`` run once through each package: every cache's
resolved descriptions and every replica's entries equal. A
``SchemeShardTablet`` booted by a ``Hive`` on a 3-node ``SimRuntime``
takes DDL over a ``PipeClient``: the same replies, the same board
caches on two nodes, the same stored blobs, in both packages. State
carried across: a schema written by either package's tablet boots in
the other's ``SchemeShardCore``. Tolerance: none."""

import dataclasses

import pytest

from ydb_tpu import dtypes as rdtypes
from ydb_tpu.engine import blobs as rblobs
from ydb_tpu.runtime import actors as ractors
from ydb_tpu.runtime import test_runtime as rsim
from ydb_tpu.scheme import board as rboard
from ydb_tpu.scheme import model as rmodel
from ydb_tpu.scheme import shard as rshard
from ydb_tpu.tablet import executor as rexecutor
from ydb_tpu.tablet import hive as rhive
from ydb_tpu.tablet import pipe as rpipe
from ydb_tpu.tablet import statestorage as rss

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine import blobs
from ydb_tpu_torch.runtime import actors
from ydb_tpu_torch.runtime import test_runtime as sim
from ydb_tpu_torch.scheme import board
from ydb_tpu_torch.scheme import model
from ydb_tpu_torch.scheme import shard
from ydb_tpu_torch.tablet import executor
from ydb_tpu_torch.tablet import hive
from ydb_tpu_torch.tablet import pipe
from ydb_tpu_torch.tablet import statestorage as ss


@dataclasses.dataclass
class Kit:
    name: str
    dtypes: object
    blobs: object
    actors: object
    sim: object
    board: object
    model: object
    shard: object
    executor: object
    hive: object
    pipe: object
    ss: object


KITS = {"ref": Kit("ref", rdtypes, rblobs, ractors, rsim, rboard, rmodel,
                   rshard, rexecutor, rhive, rpipe, rss),
        "port": Kit("port", dtypes, blobs, actors, sim, board, model, shard,
                    executor, hive, pipe, ss)}


def store_blobs(store) -> dict:
    return {b: bytes(store.get(b)) for b in store.list("")}


def core(k, store=None):
    store = store or k.blobs.MemBlobStore()
    return k.shard.SchemeShardCore(
        k.executor.TabletExecutor.boot("schemeshard", store)), store


def desc(k, path, n_shards=2):
    return k.model.TableDescription(
        path=path,
        schema=k.dtypes.schema(("id", k.dtypes.INT64),
                               ("v", k.dtypes.STRING)),
        primary_key=("id",),
        n_shards=n_shards,
    )


def both(run):
    outs = [run(k) for k in KITS.values()]
    assert outs[0] == outs[1]
    return outs[1]


def test_scheme_board_propagation():
    def run(k):
        rt = k.sim.SimRuntime(n_nodes=3)
        replica = rt.system(1).register(k.board.SchemeBoardReplica())
        cache2 = k.board.SchemeCache(replica)
        cache3 = k.board.SchemeCache(replica)
        rt.system(2).register(cache2)
        rt.system(3).register(cache3)
        rt.dispatch()

        c, _ = core(k)
        # populator edge: the schemeshard's listeners push into the board
        c.listeners.append(lambda p, d, v: rt.system(1).send(
            replica, k.board.BoardPublish(p, d, v)))
        c.create_table(desc(k, "/t"))
        rt.dispatch()
        seen = [cache2.resolve("/t"), cache3.resolve("/t")]
        assert seen[0]["primary_key"] == ["id"]
        assert seen[1]["primary_key"] == ["id"]

        c.alter_table(
            "/t", add_columns=[k.dtypes.Field("w", k.dtypes.INT32, True)])
        rt.dispatch()
        seen.append(cache2.resolve("/t"))
        assert any(col[0] == "w" for col in seen[-1]["schema"])

        # a late subscriber gets a snapshot
        cache_late = k.board.SchemeCache(replica)
        rt.system(2).register(cache_late)
        rt.dispatch()
        seen.append(cache_late.resolve("/t"))
        assert seen[-1] is not None

        c.drop_table("/t")
        rt.dispatch()
        assert cache2.resolve("/t") is None
        assert cache_late.resolve("/t") is None
        return seen, cache3.entries, rt.system(1).actor(replica).entries

    both(run)


def test_board_stale_update_cannot_resurrect_drop():
    def run(k):
        rep = k.board.SchemeBoardReplica()
        rep.system = None
        sent = []
        rep.send = lambda t, m: sent.append(m)
        c, _ = core(k)
        versions = []
        c.listeners.append(lambda p, d, v: versions.append((p, d, v)))
        c.create_table(desc(k, "/t"))
        c.alter_table(
            "/t", add_columns=[k.dtypes.Field("w", k.dtypes.INT32, True)])
        c.drop_table("/t")
        (p1, d1, v1), (p2, d2, v2), (p3, d3, v3) = versions
        assert v1 < v2 < v3 and d3 is None
        # delivered out of order: create, drop, then the STALE alter
        applied = [rep._apply(k.board.BoardPublish(p1, d1, v1)),
                   rep._apply(k.board.BoardPublish(p3, d3, v3)),
                   rep._apply(k.board.BoardPublish(p2, d2, v2))]
        assert applied == [True, True, False]
        assert rep.entries["/t"][0] is None   # still deleted
        return versions, rep.entries, sent

    both(run)


def ddl(k, table_json):
    """The DDL a pipe client sends, in the tablet's message shape."""
    return [("mkdir", "/app"), ("create_table", table_json),
            ("create_table", table_json),           # exists: an error
            ("alter_table", "/app/t", [("w", "int32")], []),
            ("describe", "/app/t"), ("children", "/app"),
            ("alter_table", "/app/t", [], ["w"]),
            ("mkdir", "/app/t/sub"),                # not a dir: an error
            ("drop_table", "/app/t"), ("describe", "/app/t"),
            ("frobnicate",)]


def tablet_cluster(k, store):
    """3 nodes: state storage and the hive on 1, agents on 2 and 3, a
    board replica on 1 with a cache on each of 2 and 3."""
    rt = k.sim.SimRuntime(n_nodes=3)
    rep = rt.system(1).register(k.ss.StateStorageReplica())
    proxies = {n: rt.system(n).register(k.ss.StateStorageProxy([rep]))
               for n in rt.nodes}
    replica = rt.system(1).register(k.board.SchemeBoardReplica())
    caches = [k.board.SchemeCache(replica) for _ in (2, 3)]
    for n, cache in zip((2, 3), caches):
        rt.system(n).register(cache)

    def make(tablet_id, ex):
        t = k.shard.SchemeShardTablet(tablet_id, ex)
        t.board = replica
        return t

    hive_id = rt.system(1).register(k.hive.Hive())
    for n in (2, 3):
        rt.system(n).register(k.hive.LocalAgent(
            store, proxies[n], {"schemeshard": make}, hive=hive_id))
    rt.dispatch()
    return rt, proxies, hive_id, caches


def test_scheme_shard_tablet_over_a_pipe():
    def run(k):
        store = k.blobs.MemBlobStore()
        rt, proxies, hive_id, caches = tablet_cluster(k, store)

        class Probe(k.actors.Actor):
            got: list

            def receive(self, message, sender):
                self.got.append(message)

        p = Probe()
        p.got = []
        pid = rt.system(1).register(p)
        rt.system(1).send(hive_id, k.hive.CreateTablet(
            "schemeshard", "schemeshard"), sender=pid)
        rt.dispatch()
        cli = rt.system(1).register(
            k.pipe.PipeClient("schemeshard", proxies[1], pid))
        for m in ddl(k, desc(k, "/app/t").to_json()):
            rt.system(1).send(cli, k.pipe.PipeSend(m))
        rt.dispatch()
        replies = p.got[1:]
        assert [r[0] for r in replies] == [
            "ok", "ok", "error", "ok", "ok", "ok", "ok", "error", "ok",
            "ok", "error"]
        assert replies[4][1]["schema_version"] == 2
        assert replies[5] == ("ok", ["/app/t"])
        assert replies[9] == ("ok", None)
        assert caches[0].entries == caches[1].entries
        assert caches[0].resolve("/app/t") is None
        return replies, caches[0].entries, store_blobs(store)

    both(run)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_schema_boots_across_packages(tmp_path, writer):
    """A schema written by one package's ``SchemeShardTablet`` (through
    a hive and a pipe, on a ``DirBlobStore``) boots in the other's
    ``SchemeShardCore`` with the same tree, descriptions and operation
    log, and the next DDL there takes the next version."""
    w = KITS[writer]
    rt, proxies, hive_id, _caches = tablet_cluster(
        w, w.blobs.DirBlobStore(str(tmp_path)))
    rt.system(1).send(hive_id, w.hive.CreateTablet(
        "schemeshard", "schemeshard"))
    rt.dispatch()
    sink = rt.system(1).register(w.actors.Actor())
    rt.system(1).actor(sink).receive = lambda m, s: None
    cli = rt.system(1).register(
        w.pipe.PipeClient("schemeshard", proxies[1], sink))
    for m in ddl(w, desc(w, "/app/t").to_json())[:4] + [
            ("create_table", desc(w, "/app/u", 4).to_json())]:
        rt.system(1).send(cli, w.pipe.PipeSend(m))
    rt.dispatch()
    wcore, _ = core(w, w.blobs.DirBlobStore(str(tmp_path)))
    want = (wcore.children("/app"), wcore.describe("/app/t").to_json(),
            wcore.describe("/app/u").to_json(), wcore.operations_log())

    r = KITS["port" if writer == "ref" else "ref"]
    rcore, _ = core(r, r.blobs.DirBlobStore(str(tmp_path)))
    got = (rcore.children("/app"), rcore.describe("/app/t").to_json(),
           rcore.describe("/app/u").to_json(), rcore.operations_log())
    assert got == want
    assert got[1]["schema_version"] == 2 and got[2]["n_shards"] == 4
    versions = []
    rcore.listeners.append(lambda p, d, v: versions.append(v))
    rcore.drop_table("/app/u")
    assert versions == [len(want[3]) + 1]
