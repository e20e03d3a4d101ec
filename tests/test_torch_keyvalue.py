"""The port's KeyValue tablet (``ydb_tpu_torch/tablet/keyvalue.py``)
against the reference's.

The 4 cases of ``tests/test_keyvalue.py`` run once through each package
with the same seeded values (numpy, seed per case): every return value
equal, and after each command every blob of the two stores the same
bytes, spilled value blobs (``<tablet>/kvblob/``) and the executor's
redo and snapshot blobs alike. The ``KeyValueActor`` serves the same
commands through a ``PipeClient`` with equal replies. State carried
across: a volume written by either package, inline and spilled, on a
``DirBlobStore``, boots and reads back in the other, as a bare tablet
and through each package's gRPC server over a ``Cluster``. Tolerance:
none."""

import sys
import types

import grpc
import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.api import client as rclient
from ydb_tpu.api import server as rserver
from ydb_tpu.engine import blobs as rblobs
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.runtime import actors as ractors
from ydb_tpu.runtime import test_runtime as rsim
from ydb_tpu.tablet import hive as rhive
from ydb_tpu.tablet import keyvalue as rkeyvalue
from ydb_tpu.tablet import pipe as rpipe
from ydb_tpu.tablet import statestorage as rss

from ydb_tpu_torch import interop
from ydb_tpu_torch.api import client, server
from ydb_tpu_torch.engine import blobs
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.runtime import actors
from ydb_tpu_torch.runtime import test_runtime as sim
from ydb_tpu_torch.tablet import hive
from ydb_tpu_torch.tablet import keyvalue
from ydb_tpu_torch.tablet import pipe
from ydb_tpu_torch.tablet import statestorage as ss

KITS = {"ref": (rkeyvalue, rblobs), "port": (keyvalue, blobs)}


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def store_blobs(store) -> dict:
    return {b: bytes(store.get(b)) for b in store.list("")}


def values(seed: int, n: int, big: int) -> list[bytes]:
    """``n`` seeded values of 1-64 bytes, then ``big`` that spill."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, int(rng.integers(1, 65)),
                        dtype=np.uint8).tobytes() for _ in range(n)]
    out += [rng.integers(0, 256, keyvalue.INLINE_LIMIT + 1 + 97 * i,
                         dtype=np.uint8).tobytes() for i in range(big)]
    return out


class Twin:
    """One tablet per package, each command applied to both: equal
    results, and the two stores byte-equal after it."""

    def __init__(self, tablet_id="kv1"):
        self.stores = {k: m[1].MemBlobStore() for k, m in KITS.items()}
        self.kv = {k: m[0].KeyValueTablet(tablet_id, self.stores[k])
                   for k, m in KITS.items()}

    def __getattr__(self, name):
        def call(*args, **kw):
            out = {k: getattr(kv, name)(*args, **kw)
                   for k, kv in self.kv.items()}
            assert out["ref"] == out["port"], name
            assert (store_blobs(self.stores["ref"])
                    == store_blobs(self.stores["port"])), name
            return out["port"]
        return call

    def blob_count(self, prefix="kv1/kvblob/") -> int:
        n = {k: len(s.list(prefix)) for k, s in self.stores.items()}
        assert n["ref"] == n["port"]
        return n["port"]

    def reboot(self, tablet_id="kv1"):
        self.kv = {k: KITS[k][0].KeyValueTablet.boot(tablet_id, s)
                   for k, s in self.stores.items()}


def test_write_read_range_rename_delete():
    v = values(1, 3, 0)
    kv = Twin()
    kv.write("a", v[0])
    kv.write("b", v[1])
    kv.write("c", v[2])
    assert kv.read("b") == v[1]
    assert kv.read("nope") is None
    assert kv.read_range("a", "c") == [("a", v[0]), ("b", v[1])]
    assert kv.rename("b", "bb")
    assert kv.read("b") is None and kv.read("bb") == v[1]
    assert not kv.rename("ghost", "x")
    assert kv.delete_range("a", "c") == 2  # a, bb
    assert kv.read("a") is None
    assert kv.read("c") == v[2]


def test_large_values_spill_and_gc():
    big = values(2, 0, 1)[0]
    kv = Twin()
    kv.write("big", big)
    assert kv.blob_count() == 1
    assert kv.read("big") == big
    # overwrite drops the old blob AFTER commit
    kv.write("big", b"small now")
    assert kv.blob_count() == 0
    assert kv.read("big") == b"small now"
    # copy duplicates spilled blobs (single-owner refs)
    kv.write("big", big)
    kv.copy_range("big", "bih", prefix_to="copy/")
    assert kv.blob_count() == 2
    assert kv.read("copy/big") == big
    kv.delete_range("big", "bih")
    assert kv.blob_count() == 1  # the copy's blob survives
    assert kv.read("copy/big") == big


def test_self_rename_and_copy_overwrite_blob_lifecycle():
    big, other = values(3, 0, 2)
    kv = Twin()
    kv.write("a", big)
    assert kv.rename("a", "a")  # a no-op must NOT free the blob
    assert kv.read("a") == big
    assert kv.blob_count() == 1
    # copy over an existing spilled destination releases its old blob
    kv.write("c/a", other)
    kv.copy_range("a", "b", prefix_to="c/")
    assert kv.read("c/a") == big
    assert kv.blob_count() == 2  # a's + c/a's fresh copy


def test_reboot_recovers_state_and_blob_seq():
    small, big = values(4, 1, 1)
    kv = Twin()
    kv.write("k", small)
    kv.write("big", big)
    kv.rename("k", "k2")
    kv.reboot()
    assert kv.read("k2") == small
    assert kv.read("k") is None
    assert kv.read("big") == big
    # the new generation's spilled blobs cannot collide with old ones
    kv.write("big2", big)
    assert kv.blob_count() == 2
    assert kv.read("big2") == big


def test_keyvalue_actor_over_a_pipe():
    """``KeyValueActor`` booted by a ``Hive`` on a 3-node ``SimRuntime``,
    driven through a ``PipeClient``: the same replies and stored blobs
    in both packages."""
    v = values(5, 2, 1)
    outs = []
    for kvm, blm, hvm, ssm, ppm, sm, am in (
            (rkeyvalue, rblobs, rhive, rss, rpipe, rsim, ractors),
            (keyvalue, blobs, hive, ss, pipe, sim, actors)):
        rt = sm.SimRuntime(n_nodes=3)
        store = blm.MemBlobStore()
        rep = rt.system(1).register(ssm.StateStorageReplica())
        proxies = {n: rt.system(n).register(ssm.StateStorageProxy([rep]))
                   for n in rt.nodes}
        hive_id = rt.system(1).register(hvm.Hive())
        for n in (2, 3):
            rt.system(n).register(hvm.LocalAgent(
                store, proxies[n], {"kv": kvm.KeyValueActor}, hive=hive_id))
        rt.dispatch()

        class Probe(am.Actor):
            got: list

            def receive(self, message, sender):
                self.got.append(message)

        p = Probe()
        p.got = []
        pid = rt.system(1).register(p)
        rt.system(1).send(hive_id, hvm.CreateTablet("kvt", "kv"), sender=pid)
        rt.dispatch()
        cli = rt.system(1).register(ppm.PipeClient("kvt", proxies[1], pid))
        for m in (kvm.KvWrite("a", v[0]), kvm.KvWrite("b", v[1]),
                  kvm.KvWrite("c", v[2]), kvm.KvRead("c"),
                  kvm.KvRange(None, None, 2), kvm.KvRename("a", "a"),
                  kvm.KvRename("a", "z"), kvm.KvCopyRange("b", "d", "x/"),
                  kvm.KvDeleteRange("b", "c"), kvm.KvRange(),
                  "bogus"):
            rt.system(1).send(cli, ppm.PipeSend(m))
        rt.dispatch()
        got = [m if m[0] != "error" else ("error",) for m in p.got[1:]]
        outs.append((got, store_blobs(store)))
    assert outs[0] == outs[1]
    got = outs[1][0]
    assert got[3] == ("value", v[2]) and got[-1][0] == "error"
    assert got[-2] == ("range", [("c", v[2]), ("x/b", v[1]),
                                 ("x/c", v[2]), ("z", v[0])])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_volume_boots_across_packages(tmp_path, writer):
    """A volume written by one package's tablet on a ``DirBlobStore``,
    inline and spilled values, renamed and copied, boots and reads back
    in the other, which then writes on in its own generation."""
    reader = "port" if writer == "ref" else "ref"
    v = values(6, 8, 3)
    wkv, wbl = KITS[writer]
    kv = wkv.KeyValueTablet("kvx", wbl.DirBlobStore(str(tmp_path)))
    for i, val in enumerate(v):
        kv.write(f"k{i:02d}", val)
    kv.rename("k00", "r00")
    kv.copy_range("k08", "k10", prefix_to="cp/")
    kv.delete_range("k03", "k05")
    want = kv.read_range()

    rkv, rbl = KITS[reader]
    other = rkv.KeyValueTablet.boot("kvx", rbl.DirBlobStore(str(tmp_path)))
    assert other.executor.generation == kv.executor.generation + 1
    assert other.read_range() == want
    assert [other.read(k) for k, _ in want] == [val for _, val in want]
    other.write("k09", b"over")  # drops the spilled k09 after commit
    other.write("new", v[-1])
    back = wkv.KeyValueTablet.boot("kvx", wbl.DirBlobStore(str(tmp_path)))
    assert back.read("k09") == b"over" and back.read("new") == v[-1]
    spilled = sorted(back.store.list("kvx/kvblob/"))
    assert len(spilled) == 5  # k08, k10, cp/k08, cp/k09, new
    assert spilled[-1].endswith(f"{other.executor.generation:08x}00000000")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_server_volume_boots_across_packages(tmp_path, writer):
    """A volume written through one package's gRPC server over a
    ``Cluster`` reads back through the other package's server: the port
    writes on a ``DirBlobStore`` that the reference reopens; the
    reference, whose service creates no volume on a directory store
    (ROADMAP.md queue C), writes on a ``MemBlobStore`` that
    ``interop.blob_store_from_reference`` carries into the port."""
    v = values(7, 4, 2)

    def serve(side, store):
        cl = (RCluster(store=store) if side == "ref"
              else Cluster(store=store, device="cpu"))
        srv_mod, cli_mod = ((rserver, rclient) if side == "ref"
                            else (server, client))
        srv, port = srv_mod.make_server(cl, port=0)
        srv.start()
        return cl, srv, cli_mod.Driver(f"127.0.0.1:{port}")

    def close(side, cl, srv, drv):
        drv.close()
        srv.stop(0)
        srv.request_proxy.close()
        if side == "port":
            cl.stop()

    store = (rblobs.MemBlobStore() if writer == "ref"
             else blobs.DirBlobStore(str(tmp_path)))
    node = serve(writer, store)
    try:
        kv = node[2].keyvalue_client()
        kv.create_volume("xv")
        for i, val in enumerate(v):
            kv.write("xv", f"k{i}", val)
        kv.rename("xv", "k0", "z0")
        want = kv.list_range("xv")
    finally:
        close(writer, *node)
    reader = "port" if writer == "ref" else "ref"
    store = (interop.blob_store_from_reference(store) if writer == "ref"
             else rblobs.DirBlobStore(str(tmp_path)))
    node = serve(reader, store)
    try:
        kv = node[2].keyvalue_client()
        assert kv.list_range("xv") == want
        assert kv.read("xv", "k5") == v[5]
        api_error = (rclient if reader == "ref" else client).ApiError
        with pytest.raises(api_error):
            kv.create_volume("xv")  # the registry came across too
        kv.drop_volume("xv")
        assert store.list("kv/volumes/") == []
        assert store.list("kvvol/xv/kvblob/") == []  # spilled blobs freed
    finally:
        close(reader, *node)


def test_volumes_on_a_directory_store(tmp_path):
    """The port's service creates volumes on a ``DirBlobStore``; the
    reference's registry probe raises there (``FileNotFoundError`` is
    not the ``KeyError`` it catches), so its CreateVolume fails."""
    for side, cl in (("port", Cluster(store=blobs.DirBlobStore(
            str(tmp_path / "p")), device="cpu")),
                     ("ref", RCluster(store=rblobs.DirBlobStore(
                         str(tmp_path / "r"))))):
        srv_mod, cli_mod = ((rserver, rclient) if side == "ref"
                            else (server, client))
        srv, port = srv_mod.make_server(cl, port=0)
        srv.start()
        drv = cli_mod.Driver(f"127.0.0.1:{port}")
        try:
            kv = drv.keyvalue_client()
            if side == "port":
                kv.create_volume("dv")
                kv.write("dv", "k", b"v")
                assert kv.read("dv", "k") == b"v"
                with pytest.raises(client.ApiError, match="no volume"):
                    kv.read("dv2", "k")
            else:
                with pytest.raises(grpc.RpcError, match="No such file"):
                    kv.create_volume("dv")
        finally:
            drv.close()
            srv.stop(0)
            srv.request_proxy.close()
            if side == "port":
                cl.stop()
