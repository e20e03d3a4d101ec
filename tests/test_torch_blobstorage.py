"""The port's blob groups (``ydb_tpu_torch/blobstorage``: the erasure codec,
``VDisk``, ``GroupInfo``, ``DSProxy`` and ``GroupBlobStore``) against the
reference's ``ydb_tpu/blobstorage``.

Mirrors ``tests/test_blobstorage.py`` case by case: each body runs once over
the reference's classes and once over the port's, on the same inputs (numpy
generators of the same seeds), and returns what it observed (bytes read,
errors raised, parts placed, SQL answers); the two records must be equal,
bytes bit for bit. Then the state both packages share: erasure parts byte
for byte for every species, a group's part stores written by either package
read through the other's ``DSProxy`` (on memory here, on PDisk files in
``tests/test_torch_pdisk_lsm.py``), and a ``Cluster`` persisted on a
reference group rebooted in the port with equal answers, degraded included.
"""

import itertools
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.blobstorage import erasure as r_erasure
from ydb_tpu.blobstorage import group as r_group
from ydb_tpu.blobstorage.proxy_store import GroupBlobStore as RGroupBlobStore
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.kqp.session import Cluster as RCluster

from ydb_tpu_torch import interop
from ydb_tpu_torch.blobstorage import erasure as t_erasure
from ydb_tpu_torch.blobstorage import group as t_group
from ydb_tpu_torch.blobstorage.proxy_store import GroupBlobStore
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.kqp.session import Cluster

REF = types.SimpleNamespace(
    ErasureCodec=r_erasure.ErasureCodec, DSProxy=r_group.DSProxy,
    GroupInfo=r_group.GroupInfo, VDisk=r_group.VDisk,
    hash_rotation=r_group.hash_rotation, GroupBlobStore=RGroupBlobStore,
    cluster=lambda store: RCluster(store=store))
PORT = types.SimpleNamespace(
    ErasureCodec=t_erasure.ErasureCodec, DSProxy=t_group.DSProxy,
    GroupInfo=t_group.GroupInfo, VDisk=t_group.VDisk,
    hash_rotation=t_group.hash_rotation, GroupBlobStore=GroupBlobStore,
    cluster=lambda store: Cluster(store=store, device="cpu"))

PAYLOADS = [b"", b"x", b"hello world", bytes(range(256)) * 37,
            np.random.default_rng(5).bytes(10000)]


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C): a stand-in sends its GROUP BYs to its scatter
    tier, as the other port tests do."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def _both(body):
    """``body`` over the reference and over the port: equal records."""
    want, got = body(REF), body(PORT)
    assert got == want
    return got


def _outcome(fn):
    """What ``fn()`` returned, or the type of what it raised."""
    try:
        return ("ok", fn())
    except (ValueError, KeyError, IOError) as e:
        return ("raised", type(e).__name__)


# ---------------- tests/test_blobstorage.py ----------------

@pytest.mark.parametrize("species", ["none", "mirror3", "block42"])
def test_erasure_roundtrip(species):
    def body(P):
        codec = P.ErasureCodec(species)
        out = []
        for data in PAYLOADS:
            parts = codec.encode(data)
            assert len(parts) == codec.total_parts
            full = {i: p for i, p in enumerate(parts)}
            assert codec.decode(full, len(data)) == data
            out.append(parts)
        return out
    _both(body)


def test_block42_recovers_any_two_lost_parts():
    def body(P):
        codec = P.ErasureCodec("block42")
        data = np.random.default_rng(1).bytes(5000)
        parts = codec.encode(data)
        for lost in itertools.combinations(range(6), 2):
            have = {i: p for i, p in enumerate(parts) if i not in lost}
            assert codec.decode(have, len(data)) == data
        for lost1 in range(6):
            have = {i: p for i, p in enumerate(parts) if i != lost1}
            assert codec.decode(have, len(data)) == data
        with pytest.raises(ValueError):
            codec.decode({i: parts[i] for i in (0, 4, 5)}, len(data))
        return parts
    _both(body)


def test_mirror3_recovers_two_lost():
    def body(P):
        codec = P.ErasureCodec("mirror3")
        parts = codec.encode(b"important")
        got = codec.decode({2: parts[2]}, len(b"important"))
        assert got == b"important"
        return parts, got
    _both(body)


def test_reconstruct_part_matches_original():
    def body(P):
        codec = P.ErasureCodec("block42")
        data = np.random.default_rng(2).bytes(3000)
        parts = codec.encode(data)
        out = []
        for idx in range(6):
            have = {i: p for i, p in enumerate(parts) if i != idx}
            out.append(codec.reconstruct_part(have, idx, len(data)))
            assert out[-1] == parts[idx]
        return out
    _both(body)


def test_dsproxy_put_get_with_disks_down():
    def body(P):
        group = P.GroupInfo(1, "block42")
        proxy = P.DSProxy(group)
        blobs = {f"blob/{i}": np.random.default_rng(i).bytes(100 + i * 37)
                 for i in range(20)}
        for bid, data in blobs.items():
            proxy.put(bid, data)
        group.disks[1].down = True
        group.disks[4].down = True
        for bid, data in blobs.items():
            assert proxy.get(bid) == data
        assert sorted(proxy.list("blob/")) == sorted(blobs)
        group.disks[0].down = True
        third = {bid: _outcome(lambda bid=bid: proxy.get(bid))
                 for bid in blobs}
        for bid, (kind, got) in third.items():
            assert kind == "raised" or got == blobs[bid]
        assert sum(k == "raised" for k, _ in third.values()) > 0
        return third
    _both(body)


def test_dsproxy_write_quorum():
    def body(P):
        group = P.GroupInfo(2, "block42")
        proxy = P.DSProxy(group)
        group.disks[0].down = True
        group.disks[1].down = True
        proxy.put("b1", b"still ok with 4/6")
        assert proxy.get("b1") == b"still ok with 4/6"
        group.disks[2].down = True
        with pytest.raises(IOError) as e:
            proxy.put("b2", b"3/6 is below quorum")
        return str(e.value), proxy.list("")
    _both(body)


def test_self_heal_rebuilds_dead_disk():
    def body(P):
        group = P.GroupInfo(3, "block42")
        proxy = P.DSProxy(group)
        blobs = {f"x/{i}": bytes([i]) * (50 + i) for i in range(30)}
        for bid, data in blobs.items():
            proxy.put(bid, data)
        group.disks[2].down = True
        rebuilt = proxy.self_heal(2)
        assert rebuilt > 0
        group.disks[0].down = True
        group.disks[5].down = True
        for bid, data in blobs.items():
            assert proxy.get(bid) == data
        return rebuilt, [d.disk_id for d in group.disks]
    _both(body)


def test_full_sql_cluster_on_erasure_coded_storage():
    def body(P):
        group = P.GroupInfo(7, "block42")
        store = P.GroupBlobStore(P.DSProxy(group))
        c = P.cluster(store)
        s = c.session()
        s.execute("CREATE TABLE t (id int64, name string, PRIMARY KEY (id)) "
                  "WITH (shards = 2)")
        s.execute("INSERT INTO t VALUES (1, 'a'), (2, 'b'), (3, 'c')")
        group.disks[0].down = True
        group.disks[3].down = True
        s.execute("INSERT INTO t VALUES (4, 'd')")
        out = [list(s.execute("SELECT count(*) AS n FROM t").column("n"))]
        assert out[0] == [4]
        c2 = P.cluster(store)
        out.append(list(c2.session().execute(
            "SELECT id FROM t ORDER BY id").column("id")))
        assert out[-1] == [1, 2, 3, 4]
        proxy = store.proxy
        out.append([proxy.self_heal(0), proxy.self_heal(3)])
        group.disks[1].down = True
        group.disks[4].down = True
        res = c2.session().execute("SELECT id, name FROM t ORDER BY id")
        out.append(list(res.column("id")))
        assert out[-1] == [1, 2, 3, 4]
        out.append(c2.health())
        return out
    _both(body)


def test_failed_overwrite_keeps_previous_version():
    def body(P):
        group = P.GroupInfo(11, "block42")
        proxy = P.DSProxy(group)
        proxy.put("doc", b"version one")
        for i in range(3):
            group.disks[i].down = True
        with pytest.raises(IOError):
            proxy.put("doc", b"version two")
        for i in range(3):
            group.disks[i].down = False
        assert proxy.get("doc") == b"version one"
        proxy.put("doc", b"version three")
        assert proxy.get("doc") == b"version three"
        return proxy._seqs("doc")
    _both(body)


def test_mirror3_put_requires_all_replicas_placed():
    def body(P):
        group = P.GroupInfo(12, "mirror3")
        proxy = P.DSProxy(group)
        group.disks[0].down = True
        proxy.put("m", b"data")
        placed = []
        for disk in group.disks:
            if disk.down:
                continue
            for part in range(3):
                placed += [(disk.disk_id, part, v)
                           for v in disk.list_parts(part, prefix="m@")]
        assert len(placed) == 3
        assert proxy.get("m") == b"data"
        return placed
    _both(body)


def test_failed_put_rolls_back_and_self_heal_skips_garbage():
    def body(P):
        group = P.GroupInfo(9, "block42")
        proxy = P.DSProxy(group)
        proxy.put("good", b"fine")
        for i in range(3):
            group.disks[i].down = True
        with pytest.raises(IOError):
            proxy.put("partial", b"should roll back")
        for i in range(3):
            group.disks[i].down = False
        assert not proxy.exists("partial")
        rebuilt = proxy.self_heal(4)
        assert rebuilt >= 1
        assert proxy.get("good") == b"fine"
        return rebuilt
    _both(body)


def test_rejoined_disk_resyncs_in_background():
    def body(P):
        g = P.GroupInfo(7)
        p = P.DSProxy(g)
        for i in range(6):
            p.put(f"pre{i}", b"old-%d" % i * 40)
        g.disks[2].down = True
        for i in range(8):
            p.put(f"mid{i}", b"during-%d" % i * 40)
        p.put("pre0", b"overwritten" * 40)
        p.delete("pre1")
        g.disks[2].down = False
        moved = p.resync()
        assert moved > 0
        n = len(g.disks)
        for i in range(8):
            bid = f"mid{i}"
            vid = p._vid(bid, p._seqs(bid)[0])
            rot = P.hash_rotation(bid, n)
            for part in range(p.codec.total_parts):
                if g.disks[(part + rot) % n] is g.disks[2]:
                    assert g.disks[2].has_part(vid, part), (bid, part)
        assert not g.disks[2].list_parts(P.DSProxy.META_PART, prefix="pre1@")
        assert len(g.disks[2].list_parts(P.DSProxy.META_PART,
                                         prefix="pre0@")) <= 1
        g.disks[4].down = True
        g.disks[5].down = True
        for i in range(6):
            if i == 1:
                continue
            want = (b"overwritten" * 40 if i == 0 else b"old-%d" % i * 40)
            assert p.get(f"pre{i}") == want
        for i in range(8):
            assert p.get(f"mid{i}") == b"during-%d" % i * 40
        return moved, p.sync_log, p.watermark
    _both(body)


# ---------------- the state both packages share ----------------

def test_parts_byte_identical_for_every_species():
    """Every species encodes the same bytes in both packages; every
    decodable loss pattern decodes and rebuilds the same bytes."""
    rng = np.random.default_rng(16)
    payloads = PAYLOADS + [rng.bytes(n) for n in (3, 4, 5, 4097, 65_537)]
    for species in ("none", "mirror3", "block42"):
        rc, tc = REF.ErasureCodec(species), PORT.ErasureCodec(species)
        assert (tc.total_parts, tc.data_parts, tc.max_lost) == \
            (rc.total_parts, rc.data_parts, rc.max_lost)
        for data in payloads:
            parts = tc.encode(data)
            assert parts == rc.encode(data), (species, len(data))
            for k in range(tc.max_lost + 1):
                for lost in itertools.combinations(range(len(parts)), k):
                    have = {i: p for i, p in enumerate(parts)
                            if i not in lost}
                    assert tc.decode(have, len(data)) == \
                        rc.decode(have, len(data)) == data
                    for idx in lost if species != "none" else ():
                        assert tc.reconstruct_part(have, idx, len(data)) \
                            == parts[idx]
    with pytest.raises(ValueError):
        PORT.ErasureCodec("raid5")


def _history(P, group):
    """Puts, an overwrite, a delete and writes with two disks down."""
    proxy = P.DSProxy(group)
    rng = np.random.default_rng(21)
    for i in range(12):
        proxy.put(f"h/{i}", rng.bytes(50 + 97 * i))
    proxy.put("h/3", b"again" * 30)
    proxy.delete("h/4")
    group.disks[1].down = group.disks[5].down = True
    proxy.put("h/20", rng.bytes(999))
    proxy.put("h/0", b"during the outage")
    group.disks[1].down = group.disks[5].down = False
    return proxy


def _blobs(proxy):
    return {b: proxy.get(b) for b in proxy.list("")}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_group_written_by_one_package_reads_in_the_other(writer):
    """The same history through both packages leaves the same keys and
    bytes on every disk; the writer's part stores, copied into the other
    package's stores, read the same blobs through its DSProxy, with two
    disks down, and after its resync."""
    rp = _history(REF, REF.GroupInfo(5, "block42"))
    tp = _history(PORT, PORT.GroupInfo(5, "block42"))
    for rd, td in zip(rp.group.disks, tp.group.disks):
        keys = rd.backing.list("")
        assert td.backing.list("") == keys
        assert all(td.backing.get(k) == rd.backing.get(k) for k in keys)
    src, dst = (rp, PORT) if writer == "reference" else (tp, REF)
    if writer == "reference":
        copies = [interop.blob_store_from_reference(d.backing)
                  for d in src.group.disks]
    else:
        copies = []
        for d in src.group.disks:
            mem = RMemBlobStore()
            for k in d.backing.list(""):
                mem.put(k, d.backing.get(k))
            copies.append(mem)
    group = dst.GroupInfo(5, "block42", [
        dst.VDisk(d.disk_id, backing=b)
        for d, b in zip(src.group.disks, copies)])
    proxy = dst.DSProxy(group)
    want = _blobs(src)
    assert sorted(want) == [f"h/{i}" for i in (0, 1, 10, 11, 2, 20, 3, 5,
                                               6, 7, 8, 9)]
    assert _blobs(proxy) == want
    # the outage's handoff parts doubled up on live disks: one more disk
    # down still reads; after the reader's self-heal (which repatriates
    # them, as the writer's does) any two disks may go
    group.disks[0].down = True
    assert _blobs(proxy) == want
    group.disks[0].down = False
    assert proxy.self_heal(1, dst.VDisk("d1-new")) == src.self_heal(
        1, type(src.group.disks[0])("d1-new"))
    group.disks[0].down = group.disks[3].down = True
    assert _blobs(proxy) == want
    group.disks[0].down = group.disks[3].down = False
    assert _blobs(src) == want


def _cluster_history(c):
    s = c.session()
    s.execute("CREATE TABLE t (id int64, name string, v double, "
              "PRIMARY KEY (id)) WITH (shards = 2)")
    rng = np.random.default_rng(31)
    rows = ", ".join(f"({i}, 'n{i % 7}', {float(x)!r})"
                     for i, x in enumerate(rng.normal(size=40)))
    s.execute(f"INSERT INTO t VALUES {rows}")
    s.execute("CREATE TABLE kv (k int64, v int64, PRIMARY KEY (k)) "
              "WITH (store = row, shards = 2)")
    s.execute("INSERT INTO kv VALUES (1, 10), (2, 20), (3, 30)")
    s.execute("UPDATE kv SET v = v + 1 WHERE k = 2")


QUERIES = ("SELECT name, count(*) AS n, sum(v) AS s FROM t GROUP BY name "
           "ORDER BY name",
           "SELECT id, name FROM t WHERE id >= 30 ORDER BY id",
           "SELECT k, v FROM kv ORDER BY k")


def _answers(c):
    s = c.session()
    out = []
    for sql in QUERIES:
        res = s.execute(sql)
        out.append({f.name: res.column(f.name) for f in res.schema.fields})
    return out


def _same_answers(got, want):
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if np.asarray(w[k]).dtype.kind == "f":
                np.testing.assert_allclose(np.asarray(g[k], dtype=float),
                                           np.asarray(w[k], dtype=float),
                                           rtol=1e-12)
            else:
                assert list(g[k]) == list(w[k]), k


def test_cluster_persisted_on_reference_group_reboots_in_port():
    """A reference Cluster writes its whole database (portions, tablet
    WALs, scheme, dictionaries) onto a reference block-4-2 group; the
    disks' part stores copied into port stores boot a port Cluster over
    a port group that answers as the reference does, healthy and with two
    disks down; a port INSERT while degraded reads back."""
    rgroup = REF.GroupInfo(7, "block42")
    ref = REF.cluster(REF.GroupBlobStore(REF.DSProxy(rgroup)))
    _cluster_history(ref)
    want = _answers(ref)
    disks = [PORT.VDisk(d.disk_id,
                        backing=interop.blob_store_from_reference(d.backing))
             for d in rgroup.disks]
    group = PORT.GroupInfo(7, "block42", disks)
    port = PORT.cluster(PORT.GroupBlobStore(PORT.DSProxy(group)))
    _same_answers(_answers(port), want)
    group.disks[0].down = group.disks[3].down = True
    rgroup.disks[0].down = rgroup.disks[3].down = True
    port = PORT.cluster(PORT.GroupBlobStore(PORT.DSProxy(group)))
    _same_answers(_answers(port), want)
    assert port.health() == ref.health()
    assert port.health()["status"] == "DEGRADED"
    for c in (ref, port):
        c.session().execute("INSERT INTO t VALUES (100, 'late', 0.5)")
    _same_answers(_answers(port), _answers(ref))
