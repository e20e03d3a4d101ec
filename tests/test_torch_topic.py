"""The port's topics and changefeeds (``ydb_tpu_torch/common.py``,
``topic/pq.py``, ``topic/topic.py``, ``RowTable.drain_changes_to`` and
the changefeed DDL of ``kqp/session.py``) against the reference's.

Each of the 10 cases of ``tests/test_topic.py`` runs through both
packages: the same return values, offsets, messages and counts; where a
partition runs on a manual clock, every blob of the two stores is the
same bytes. Added: ``fnv1a_64`` bit for bit over random keys, a
partition and a changefeed topic written by the reference that boot in
the port, and the reverse, with the same offsets, messages and consumer
offsets. Tolerance: none."""

import json
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.common import fnv1a_64 as rfnv
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.topic.pq import Partition as RPartition
from ydb_tpu.topic.topic import Topic as RTopic

from ydb_tpu_torch.common import fnv1a_64
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.topic.pq import Partition
from ydb_tpu_torch.topic.topic import Topic

from conftest import Clock


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


#: (label, Partition, Topic, MemBlobStore, Cluster factory)
KITS = (("ref", RPartition, RTopic, RMemBlobStore,
         lambda **kw: RCluster(**kw)),
        ("port", Partition, Topic, MemBlobStore,
         lambda **kw: Cluster(device="cpu", **kw)))


def _blobs(store) -> dict:
    return {b: bytes(store.get(b)) for b in store.list("")}


def _both(case):
    """``case(Partition, Topic, MemBlobStore, make_cluster)`` once per
    package; the two results equal."""
    out = [case(*kit[1:]) for kit in KITS]
    assert out[0] == out[1]
    return out[1]


def _msgs(msgs):
    return [(m["offset"], m["data"], m.get("key"), m.get("seqno"),
             m.get("producer")) for m in msgs]


def test_fnv1a_64_bit_parity():
    rng = np.random.default_rng(11)
    keys = ["", "k0", "key-ü", json.dumps([1, "a"])]
    keys += [bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8))
             for n in rng.integers(0, 40, size=300)]
    keys += ["".join(chr(int(c)) for c in rng.integers(32, 0x2FF, size=12))
             for _ in range(100)]
    for k in keys:
        assert fnv1a_64(k) == rfnv(k), k


def test_partition_write_read_offsets():
    def case(P, _T, Mem, _C):
        store = Mem()
        p = P("t/0", store, now=Clock(5.0))
        offs = p.write([{"data": "a"}, {"data": "b"}, {"data": "c"}])
        return offs, p.head_offset, _msgs(p.read(1)), _blobs(store)

    offs, head, msgs, _ = _both(case)
    assert offs == [0, 1, 2] and head == 3
    assert [(m[0], m[1]) for m in msgs] == [(1, "b"), (2, "c")]


def test_producer_seqno_dedup():
    def case(P, _T, Mem, _C):
        store = Mem()
        p = P("t/1", store, now=Clock(1.0))
        got = [p.write([{"data": "a"}], producer="w1", first_seqno=1),
               p.write([{"data": "a"}], producer="w1", first_seqno=1),
               p.write([{"data": "b"}], producer="w1", first_seqno=2),
               p.write([{"data": "z"}], producer="w2", first_seqno=1)]
        return got, [m["data"] for m in p.read(0)], _blobs(store)

    got, data, _ = _both(case)
    assert got == [[0], [-1], [1], [2]] and data == ["a", "b", "z"]


def test_port_per_message_seqnos_dedup_as_one_write_each():
    """``Partition.write(seqnos=...)`` (a port addition) keeps the rows
    and dedup of one reference write per message."""
    ref, port = RPartition("t/s", RMemBlobStore()), Partition(
        "t/s", MemBlobStore())
    seqs = [3, 7, 8, 20]
    for s in seqs:
        ref.write([{"data": f"m{s}", "ts": 1.0}], producer="cdc/x",
                  first_seqno=s)
    assert port.write([{"data": f"m{s}", "ts": 1.0} for s in seqs],
                      producer="cdc/x", seqnos=seqs) == [0, 1, 2, 3]
    # a redelivery that overlaps the shipped seqnos: only 21 lands
    assert port.write([{"data": "d", "ts": 1.0}, {"data": "m21", "ts": 1.0}],
                      producer="cdc/x", seqnos=[8, 21]) == [-1, 4]
    ref.write([{"data": "d", "ts": 1.0}], producer="cdc/x", first_seqno=8)
    ref.write([{"data": "m21", "ts": 1.0}], producer="cdc/x",
              first_seqno=21)
    assert _msgs(port.read(0)) == _msgs(ref.read(0))
    with pytest.raises(ValueError):
        port.write([{"data": "x"}], producer="p", seqnos=[1, 2])


def test_consumer_commit_and_retention():
    def case(P, _T, Mem, _C):
        store = Mem()
        p = P("t/2", store, now=Clock(0.0))
        p.write([{"data": str(i), "ts": float(i)} for i in range(10)])
        p.commit("c1", 4)
        p.commit("c2", 8)
        got = [p.committed("c1"), p.vacuum(), p.tail_offset,
               p.read(0)[0]["offset"], p.vacuum(older_than_ts=7.0),
               p.tail_offset, p.vacuum(keep_offsets=1), p.tail_offset,
               [m["offset"] for m in p.read(0)]]
        return got, _blobs(store)

    got, _ = _both(case)
    assert got == [4, 4, 4, 4, 3, 7, 2, 9, [9]]


def test_partition_survives_reboot():
    def case(P, _T, Mem, _C):
        store = Mem()
        p = P("t/3", store, now=Clock(2.0))
        p.write([{"data": "x"}], producer="w", first_seqno=5)
        p.commit("c", 1)
        p2 = P("t/3", store, now=Clock(3.0))
        return (p2.head_offset, p2.committed("c"),
                p2.write([{"data": "x"}], producer="w", first_seqno=5),
                _blobs(store))

    head, committed, again, _ = _both(case)
    assert (head, committed, again) == (1, 1, [-1])


def test_topic_key_routing_and_read_session():
    def case(_P, T, Mem, _C):
        t = T("events", Mem(), n_partitions=3, now=Clock(9.0))
        placed = [t.write(f"m{i}", key=f"k{i % 5}") for i in range(30)]
        r = t.reader("c1")
        batch = r.read_batch()
        r.commit_batch(batch)
        return (placed, [t.partition_for(f"k{i}") for i in range(5)],
                [(m["partition"], m["offset"], m["data"]) for m in batch],
                r.read_batch())

    placed, routes, batch, after = _both(case)
    assert len(batch) == 30 and after == []
    assert all(p == routes[i % 5] for i, (p, _o) in enumerate(placed))


def _events(c, topic, consumer="app"):
    return [(m["partition"], m["offset"], json.loads(m["data"]))
            for m in c.topics[topic].reader(consumer).read_batch()]


def _strip_steps(events):
    """Change events with the commit step taken out (each cluster's
    coordinator numbers its own steps): equal across packages."""
    return [(p, o, {k: v for k, v in e.items() if k != "step"})
            for p, o, e in events]


def test_changefeed_end_to_end():
    def case(_P, _T, _M, C):
        c = C()
        s = c.session()
        s.execute("CREATE TABLE acc (id int64, v int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 2, changefeed = on)")
        s.execute("INSERT INTO acc VALUES (1, 10), (2, 20)")
        s.execute("UPDATE acc SET v = 11 WHERE id = 1")
        s.execute("DELETE FROM acc WHERE id = 2")
        shipped = c.run_background()["cdc_shipped"]
        events = _events(c, "acc_changefeed")
        by_key = {}
        for _p, _o, e in events:
            by_key.setdefault(tuple(e["key"]), []).append(e)
        ins1, upd1 = by_key[(1,)]
        steps_ordered = ins1["step"] < upd1["step"]
        return (shipped, _strip_steps(events), steps_ordered,
                c.run_background()["cdc_shipped"],
                len(c.topics["acc_changefeed"].reader("b").read_batch()))

    shipped, events, ordered, again, n_b = _both(case)
    assert shipped == 4 and ordered and again == 0 and n_b == 4
    by_key = {}
    for _p, _o, e in events:
        by_key.setdefault(tuple(e["key"]), []).append(e)
    ins1, upd1 = by_key[(1,)]
    assert ins1["old"] is None and ins1["new"]["v"] == 10
    assert upd1["old"]["v"] == 10 and upd1["new"]["v"] == 11
    _ins2, del2 = by_key[(2,)]
    assert del2["new"] is None and del2["old"]["v"] == 20


def test_changefeed_crash_between_ship_and_ack_is_exactly_once():
    def case(_P, _T, _M, C):
        c = C()
        s = c.session()
        s.execute("CREATE TABLE t (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 1, changefeed = on)")
        s.execute("INSERT INTO t VALUES (1)")
        t = c.tables["t"]
        topic = c.topics["t_changefeed"]
        shard = t.shards[0]
        changes = shard.pending_changes()
        t.drain_changes_to(topic)
        for ch in changes:
            p = topic.partition_for(json.dumps(ch["key"]))
            topic.partitions[p].write(
                [{"data": "dup"}], producer=f"cdc/{shard.shard_id}",
                first_seqno=ch["seq"])
        return [m["offset"] for m in topic.reader("x").read_batch()]

    assert _both(case) == [0]  # producer dedup swallowed the redelivery


def test_changefeed_survives_reboot():
    def case(_P, _T, Mem, C):
        store = Mem()
        c = C(store=store)
        s = c.session()
        s.execute("CREATE TABLE t (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, changefeed = on)")
        s.execute("INSERT INTO t VALUES (1)")
        c2 = C(store=store)
        shipped = c2.run_background()["cdc_shipped"]
        return shipped, _strip_steps(_events(c2, "t_changefeed", "r"))

    shipped, events = _both(case)
    assert shipped == 1 and len(events) == 1 and events[0][2]["key"] == [1]


def test_cdc_old_image_within_one_commit():
    def case(_P, _T, _M, C):
        c = C()
        s = c.session()
        s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 1, changefeed = on)")
        s.execute("INSERT INTO t VALUES (1, 10), (1, 20)")
        c.run_background()
        return _strip_steps(_events(c, "t_changefeed", "r"))

    events = [e for _p, _o, e in _both(case)]
    assert events[0]["old"] is None and events[0]["new"]["v"] == 10
    assert events[1]["old"]["v"] == 10 and events[1]["new"]["v"] == 20


def test_drop_column_strip_emits_no_cdc_events():
    def case(_P, _T, _M, C):
        c = C()
        s = c.session()
        s.execute("CREATE TABLE t (id int64, secret int64, "
                  "PRIMARY KEY (id)) WITH (store = row, changefeed = on)")
        s.execute("INSERT INTO t VALUES (1, 42)")
        first = c.run_background()["cdc_shipped"]
        s.execute("ALTER TABLE t DROP COLUMN secret")
        return first, c.run_background()["cdc_shipped"]

    assert _both(case) == (1, 0)  # no phantom updates


def test_drop_table_drops_its_changefeed():
    def case(_P, _T, Mem, C):
        store = Mem()
        c = C(store=store)
        s = c.session()
        s.execute("CREATE TABLE t (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 2, changefeed = on)")
        s.execute("INSERT INTO t VALUES (1), (2)")
        c.run_background()
        s.execute("DROP TABLE t")
        return (sorted(c.topics), store.list("tablet/pq/"),
                sorted(C(store=store).topics))

    assert _both(case) == ([], [], [])


# ---------------- state carried across packages ----------------

def _copy_store(src, dst):
    for b in src.list(""):
        dst.put(b, src.get(b))
    return dst


def _partition_state(p):
    return (p.head_offset, p.tail_offset, _msgs(p.read(0, limit=1000)),
            {c: p.committed(c) for c in ("c1", "c2")})


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_partition_written_by_one_package_boots_in_the_other(writer):
    """A partition with producer seqnos, consumer commits and a vacuumed
    tail, written by ``writer``, boots in the other package with the
    same offsets, messages and commits, and keeps deduplicating."""
    wp, rp = ((RPartition, Partition) if writer == "ref"
              else (Partition, RPartition))
    store = RMemBlobStore() if writer == "ref" else MemBlobStore()
    p = wp("t/x", store, now=Clock(4.0))
    for i in range(0, 200, 20):
        p.write([{"data": f"m{j}", "key": f"k{j % 3}"}
                 for j in range(i, i + 20)], producer="w", first_seqno=i + 1)
    p.commit("c1", 50)
    p.commit("c2", 120)
    p.vacuum()
    want = _partition_state(p)
    copy = _copy_store(store, MemBlobStore() if writer == "ref"
                       else RMemBlobStore())
    back = rp("t/x", copy, now=Clock(5.0))
    assert _partition_state(back) == want
    assert back.write([{"data": "again"}], producer="w",
                      first_seqno=200) == [-1]
    assert back.write([{"data": "new"}], producer="w",
                      first_seqno=201) == [200]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_changefeed_topic_written_by_one_package_boots_in_the_other(writer):
    """A changefeed table and its topic written by ``writer`` (shipped
    in part, a consumer commit in place) boot in the other package's
    Cluster: the same topic, offsets, messages and committed offset,
    and the changes still queued ship there."""
    make = [k[4] for k in KITS]
    wc, rc = (make if writer == "ref" else make[::-1])
    store = RMemBlobStore() if writer == "ref" else MemBlobStore()
    c = wc(store=store)
    s = c.session()
    s.execute("CREATE TABLE acc (id int64, v int64, PRIMARY KEY (id)) "
              "WITH (store = row, shards = 2, changefeed = on)")
    s.execute("INSERT INTO acc VALUES " + ", ".join(
        f"({i}, {i * 10})" for i in range(40)))
    assert c.run_background()["cdc_shipped"] == 40
    topic = c.topics["acc_changefeed"]
    r = topic.reader("app")
    first = r.read_batch(limit_per_partition=5)
    r.commit_batch(first)
    s.execute("UPDATE acc SET v = 1 WHERE id = 3")  # queued, not shipped
    want = [(m["partition"], m["offset"], m["data"])
            for m in topic.reader("all").read_batch(1000)]
    copy = _copy_store(store, MemBlobStore() if writer == "ref"
                       else RMemBlobStore())
    b = rc(store=copy)
    bt = b.topics["acc_changefeed"]
    assert [len(p_.read(0, 1000)) for p_ in bt.partitions] == \
        [len(p_.read(0, 1000)) for p_ in topic.partitions]
    assert [(m["partition"], m["offset"], m["data"])
            for m in bt.reader("all").read_batch(1000)] == want
    assert [p_.committed("app") for p_ in bt.partitions] == \
        [p_.committed("app") for p_ in topic.partitions]
    assert b.run_background()["cdc_shipped"] == 1
    tail = [json.loads(m["data"]) for m in bt.reader("all").read_batch(1000)
            if (m["partition"], m["offset"], m["data"]) not in set(want)]
    assert [(e["key"], e["old"]["v"], e["new"]["v"]) for e in tail] == \
        [([3], 30, 1)]


def test_tablet_counters_walk_topic_partitions():
    """``obs.tablet_counters`` over a cluster with a changefeed: each
    partition is a ``pq/`` tablet, as in the reference, and the ``pq``
    aggregate counts one a shard. The port ships a shard's changes for a
    partition in one write, so its partitions commit fewer transactions
    for the same messages."""
    from ydb_tpu.obs import tablet_counters as rtc

    from ydb_tpu_torch.obs import tablet_counters as tc

    out = []
    for mod, (_l, _P, _T, _M, make) in zip((rtc, tc), KITS):
        c = make()
        s = c.session()
        s.execute("CREATE TABLE t (id int64, PRIMARY KEY (id)) "
                  "WITH (store = row, shards = 3, changefeed = on)")
        s.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i})" for i in range(30)))
        c.run_background()
        rows = [r for r in mod.collect(c) if r["type"] == "pq"]
        agg = mod.aggregate(c)["pq"]
        assert agg["tablets"] == 3
        assert agg["tx_committed"] == sum(r["tx_committed"] for r in rows)
        out.append(([r["tablet_id"] for r in rows],
                    [p.head_offset for p in c.topics["t_changefeed"]
                     .partitions], agg["tx_committed"]))
    (rids, rheads, rcommits), (ids, heads, commits) = out
    assert ids == rids == [f"pq/t_changefeed/{i}" for i in range(3)]
    assert heads == rheads and sum(heads) == 30
    assert 0 < commits <= 9 < rcommits == 30


def _erase_in_batches(store_cls):
    """5,000 rows, then erased 1,000 at a time: the memtable freezes a
    second part on the way. Returns the first visible key after each."""
    t = store_cls("changes")
    v = 0
    for k in range(5000):
        v += 1
        t.put((k,), {"x": k}, v)
    firsts = []
    for lo in range(0, 4000, 1000):
        v += 1
        for k, _row in list(t.range(hi=(lo + 1000,))):
            t.put(k, None, v)
        firsts.append(next(iter(t.range()))[0][0])
    return firsts, t.n_parts


def test_erased_rows_stay_erased_across_frozen_parts():
    """A scan over two frozen parts merges each key's chains newest
    first, so a row erased after the first freeze stays erased (the
    reference's scan tags every part with the last part's priority and
    resurrects it: ROADMAP.md queue C). Through a changefeed: 5,000
    changes in one shard ship once."""
    from ydb_tpu.tablet.localdb import TableStore as RTableStore

    from ydb_tpu_torch.tablet.localdb import TableStore

    assert _erase_in_batches(TableStore) == ([1000, 2000, 3000, 4000], 2)
    assert _erase_in_batches(RTableStore) == ([1000, 2000, 3000, 0], 2)
    c = Cluster(device="cpu")
    s = c.session()
    s.execute("CREATE TABLE t (id BIGINT NOT NULL, PRIMARY KEY (id)) "
              "WITH (store = row, shards = 1, changefeed = on)")
    ids = np.arange(5000, dtype=np.int64)
    assert c.tables["t"].insert({"id": ids}).committed
    shipped = []
    while shipped[-1:] != [0]:
        shipped.append(c.run_background()["cdc_shipped"])
    assert shipped == [1000] * 5 + [0]
    topic = c.topics["t_changefeed"]
    keys = sorted(json.loads(m["data"])["key"][0]
                  for m in topic.reader("r").read_batch(10_000))
    assert keys == list(range(5000))
