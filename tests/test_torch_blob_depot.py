"""The port's BlobDepot (``ydb_tpu_torch/blobstorage/blob_depot.py``) against
the reference's.

Mirrors ``tests/test_blob_depot.py`` (8 cases): each body runs over the
reference's classes and over the port's (each over its own tablet executor
and ``MemBlobStore``) on the same inputs and returns what it observed; the
records must be equal, and so must the backends' keys and bytes after it.
Then a PQ partition over a reference ``DepotBlobStore`` boots in the port.
"""

import types

import pytest

from ydb_tpu.blobstorage import blob_depot as r_depot
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.topic.pq import Partition as RPartition

from ydb_tpu_torch import interop
from ydb_tpu_torch.blobstorage import blob_depot as t_depot
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.topic.pq import Partition

REF = types.SimpleNamespace(BlobDepot=r_depot.BlobDepot,
                            DepotBlobStore=r_depot.DepotBlobStore,
                            MemBlobStore=RMemBlobStore, Partition=RPartition)
PORT = types.SimpleNamespace(BlobDepot=t_depot.BlobDepot,
                             DepotBlobStore=t_depot.DepotBlobStore,
                             MemBlobStore=MemBlobStore, Partition=Partition)


def _contents(be):
    return {k: be.get(k) for k in be.list("")}


def _both(body):
    """``body(P, backend)`` over both packages: equal records and equal
    backends after."""
    out, stores = [], []
    for P in (REF, PORT):
        be = P.MemBlobStore()
        out.append(body(P, be))
        stores.append(_contents(be))
    assert out[1] == out[0]
    assert stores[1] == stores[0]
    return out[1]


def _crash_after_trash_mark(d, name):
    """The index drops ``name`` and trash-marks its payload; the physical
    delete never runs."""
    def fn(txc):
        row = txc.get("names", (name,))
        txc.erase("names", (name,))
        d._dec_locked(txc, row["digest"])
    d.executor.run(fn)


def test_dedup_and_refcounted_delete():
    def body(P, be):
        d = P.BlobDepot("d1", be)
        payload = b"x" * 1000
        d.put("a", payload)
        d.put("b", payload)
        d.put("c", b"different")
        st = [d.stats()]
        assert st[0]["names"] == 3 and st[0]["payloads"] == 2
        assert st[0]["logical_bytes"] == 2009
        assert st[0]["physical_bytes"] == 1009
        d.delete("a")
        assert d.get("b") == payload
        d.delete("b")
        assert not any(k.startswith("depot/d1/data/")
                       and b"x" * 10 in be.get(k)
                       for k in be.list("depot/d1/data/"))
        with pytest.raises(KeyError):
            d.get("a")
        assert d.get("c") == b"different"
        st.append(d.stats())
        return st
    _both(body)


def test_overwrite_moves_reference_and_sweeps():
    def body(P, be):
        d = P.BlobDepot("d2", be)
        d.put("k", b"v1")
        phys_before = set(be.list("depot/d2/data/"))
        d.put("k", b"v2")
        assert d.get("k") == b"v2"
        st = d.stats()
        assert st["names"] == 1 and st["payloads"] == 1
        phys_after = set(be.list("depot/d2/data/"))
        assert len(phys_after) == 1 and phys_after != phys_before
        return sorted(phys_after), st
    _both(body)


def test_gc_resurrection_safe():
    def body(P, be):
        d = P.BlobDepot("d3", be)
        d.put("a", b"payload")
        _crash_after_trash_mark(d, "a")
        d.put("b", b"payload")
        swept = d.collect_garbage()
        assert swept == 0
        assert d.get("b") == b"payload"
        return swept, d.stats()
    _both(body)


def test_depot_reboot():
    def body(P, be):
        d = P.BlobDepot("d4", be)
        d.put("a", b"one")
        d.put("b", b"two")
        d2 = P.BlobDepot("d4", be)
        assert d2.get("a") == b"one" and d2.get("b") == b"two"
        assert d2.stats()["names"] == 2
        d2.delete("a")
        with pytest.raises(KeyError):
            d2.get("a")
        return d2.names(), d2.stats()
    _both(body)


def test_boot_sweeps_crash_trash():
    def body(P, be):
        d = P.BlobDepot("d7", be)
        d.put("a", b"doomed")
        _crash_after_trash_mark(d, "a")
        assert be.list("depot/d7/data/")
        d2 = P.BlobDepot("d7", be)
        assert be.list("depot/d7/data/") == []
        assert d2.stats()["payloads"] == 0
        return d2.stats()
    _both(body)


def test_decommit_never_touches_sibling_depots():
    def body(P, be):
        d_a = P.BlobDepot("da", be)
        d_a.put("x", b"payload-a")
        d_b = P.BlobDepot("db", be)
        assert d_b.decommit("") == 0
        assert d_a.get("x") == b"payload-a"
        return d_a.stats(), d_b.stats()
    _both(body)


def test_decommit_absorbs_direct_blobs():
    def body(P, be):
        be.put("legacy/1", b"aaa")
        be.put("legacy/2", b"bbb")
        be.put("legacy/3", b"aaa")
        d = P.BlobDepot("d5", be)
        absorbed = d.decommit("legacy/")
        assert absorbed == 3
        assert be.list("legacy/") == []
        assert d.get("legacy/1") == b"aaa" and d.get("legacy/2") == b"bbb"
        assert d.stats()["payloads"] == 2
        return absorbed, d.names("legacy/"), d.stats()
    _both(body)


def test_tablet_runs_over_depot_adapter():
    def body(P, be):
        store = P.DepotBlobStore(P.BlobDepot("vg", be))
        p = P.Partition("pq0", store, now=lambda: 1000.0)
        offs = p.write([{"data": f"m{i}"} for i in range(5)])
        assert offs == list(range(5))
        p2 = P.Partition("pq0", store, now=lambda: 1000.0)
        msgs = [m["data"] for m in p2.read(0, limit=10)]
        assert msgs == [f"m{i}" for i in range(5)]
        return offs, msgs, sorted(store.list(""))
    _both(body)


def test_partition_over_reference_depot_boots_in_port():
    """A PQ partition written over a reference ``DepotBlobStore`` boots
    in the port from a copy of the backend: same messages and offsets,
    and the port's writes go on at the next offset."""
    be = RMemBlobStore()
    rstore = REF.DepotBlobStore(REF.BlobDepot("vg", be))
    rp = REF.Partition("pq0", rstore)
    rp.write([{"data": f"m{i}"} for i in range(7)])
    rp.write([{"data": "x"}], producer="w", first_seqno=1)
    depot = PORT.BlobDepot("vg", interop.blob_store_from_reference(be))
    tp = PORT.Partition("pq0", PORT.DepotBlobStore(depot))
    assert tp.read(0, limit=20) == rp.read(0, limit=20)
    assert depot.stats() == rstore.depot.stats()
    # the producer's seqno dedup carried over too
    assert tp.write([{"data": "x"}], producer="w", first_seqno=1) == \
        rp.write([{"data": "x"}], producer="w", first_seqno=1)
    assert tp.write([{"data": "y"}]) == rp.write([{"data": "y"}]) == [8]
