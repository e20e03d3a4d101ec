"""The port's node broker and tenant pool
(``ydb_tpu_torch/runtime/nodebroker.py``) against the reference's.

The 4 cases of ``tests/test_nodebroker.py`` run once through each
package on the same manual clock: every ``NodeInfo``, resolution, expiry
list and slot count equal, and the brokers' stores byte-equal. The
discovery case runs two live actor systems per package, each with its
own ``Interconnect`` on loopback, found through the broker alone; every
wait there is bounded by a deadline. State carried across: a node table
written by either package reboots in the other's broker. Tolerance:
none."""

import dataclasses
import time

import pytest

from conftest import Clock

from ydb_tpu.engine import blobs as rblobs
from ydb_tpu.runtime import actors as ractors
from ydb_tpu.runtime import interconnect as rinterconnect
from ydb_tpu.runtime import nodebroker as rnodebroker

from ydb_tpu_torch.engine import blobs
from ydb_tpu_torch.runtime import actors
from ydb_tpu_torch.runtime import interconnect
from ydb_tpu_torch.runtime import nodebroker

KITS = {"ref": (rnodebroker, rblobs, ractors, rinterconnect),
        "port": (nodebroker, blobs, actors, interconnect)}


def store_blobs(store) -> dict:
    return {b: bytes(store.get(b)) for b in store.list("")}


def plain(obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.astuple(obj)
    if isinstance(obj, list):
        return [plain(v) for v in obj]
    return obj


def both(run):
    outs = [run(*k) for k in KITS.values()]
    assert outs[0] == outs[1]
    return outs[1]


def test_register_renew_expire():
    def run(nbm, blm, _am, _icm):
        clock = Clock(1000.0)
        store = blm.MemBlobStore()
        nb = nbm.NodeBroker(store, lease_s=30, now=clock)
        a = nb.register("10.0.0.1", 19001)
        b = nb.register("10.0.0.2", 19001)
        assert a.node_id == 1024 and b.node_id == 1025
        assert nb.resolve(1025) == ("10.0.0.2", 19001)
        # the same endpoint re-registers -> the same id
        a2 = nb.register("10.0.0.1", 19001)
        assert a2.node_id == a.node_id
        clock.t += 20
        ext = nb.extend(a.node_id)
        clock.t += 15  # b's lease (30 s) lapsed; a extended at +20
        dead = nb.tick()
        assert dead == [b.node_id]
        live = nb.nodes()
        assert [n.node_id for n in live] == [a.node_id]
        assert live[0].epoch == 2  # bumped on expiry
        c = nb.register("10.0.0.3", 19001)
        assert c.node_id == 1025  # the freed id is reused
        with pytest.raises(KeyError):
            nb.extend(4096)
        return (plain([a, b, a2, c]), ext, dead, plain(live),
                store_blobs(store))

    both(run)


def test_broker_reboot_keeps_registrations():
    def run(nbm, blm, _am, _icm):
        store = blm.MemBlobStore()
        clock = Clock(1000.0)
        nb = nbm.NodeBroker(store, lease_s=300, now=clock)
        a = nb.register("h1", 1)
        nb2 = nbm.NodeBroker(store, lease_s=300, now=clock)
        assert nb2.resolve(a.node_id) == ("h1", 1)
        b = nb2.register("h2", 2)
        assert b.node_id == a.node_id + 1
        return plain([a, b]), plain(nb2.nodes()), store_blobs(store)

    both(run)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_node_table_reboots_across_packages(tmp_path, writer):
    """Registrations, an expiry and its epoch written by one package's
    broker on a ``DirBlobStore`` reboot in the other's."""
    clock = Clock(500.0)
    wnb, wbl = KITS[writer][:2]
    nb = wnb.NodeBroker(wbl.DirBlobStore(str(tmp_path)), lease_s=60,
                        now=clock)
    ids = [nb.register(f"10.1.0.{i}", 2000 + i, tenant=f"/Root/t{i % 2}")
           for i in range(5)]
    clock.t += 40
    nb.extend(ids[1].node_id)
    clock.t += 30
    assert nb.tick() == [i.node_id for i in ids if i is not ids[1]]
    want = plain(nb.nodes())

    rnb, rbl = KITS["port" if writer == "ref" else "ref"][:2]
    nb2 = rnb.NodeBroker(rbl.DirBlobStore(str(tmp_path)), lease_s=60,
                         now=clock)
    assert plain(nb2.nodes()) == want
    assert nb2.resolve(ids[1].node_id) == ("10.1.0.1", 2001)
    again = nb2.register("10.1.0.1", 2001, tenant="/Root/x")
    assert again.node_id == ids[1].node_id and again.epoch == 2
    assert nb2.register("10.9.0.9", 9).node_id == 1024  # freed id


def test_dynamic_peer_discovery_end_to_end():
    """Two actor systems find each other through the broker alone."""

    def run(nbm, blm, am, icm):
        class Echo(am.Actor):
            def receive(self, message, sender):
                if message[0] == "ping":
                    self.send(sender, ("pong", message[1]))

        class Collector(am.Actor):
            def __init__(self):
                super().__init__()
                self.got = []

            def receive(self, message, sender):
                self.got.append(message)

        nb = nbm.NodeBroker(blm.MemBlobStore(), lease_s=300)
        sys_a = am.ActorSystem(node=0)
        sys_b = am.ActorSystem(node=0)
        ic_a = icm.Interconnect(sys_a, listen_port=0)
        ic_b = icm.Interconnect(sys_b, listen_port=0)
        try:
            a = nb.register("127.0.0.1", ic_a.port)
            b = nb.register("127.0.0.1", ic_b.port)
            sys_a.node = a.node_id
            sys_b.node = b.node_id
            sys_b.register(Echo())  # ActorId(b, 1)
            coll = Collector()
            sys_a.register(coll)  # ActorId(a, 1)
            nb.connect_peers(ic_a)
            nb.connect_peers(ic_b)
            assert set(ic_a.peers) == {b.node_id}
            sys_a.send(am.ActorId(b.node_id, 1), ("ping", 7),
                       sender=am.ActorId(a.node_id, 1))
            deadline = time.monotonic() + 10
            while not coll.got and time.monotonic() < deadline:
                ic_b.pump(0.05)
                ic_a.pump(0.05)
            assert coll.got == [("pong", 7)]
            return coll.got, a.node_id, b.node_id
        finally:
            ic_a.close()
            ic_b.close()

    both(run)


def test_tenant_pool_slots():
    def run(nbm, _blm, _am, _icm):
        tp = nbm.TenantPool(slots=4)
        out = [tp.claim("/Root/a", 3), tp.claim("/Root/b", 2),
               tp.claim("/Root/b", 1), tp.free_slots()]
        assert out == [True, False, True, 0]
        tp.release("/Root/a", 2)
        out += [tp.free_slots(), tp.tenants()]
        assert out[-2:] == [2, {"/Root/a": 1, "/Root/b": 1}]
        tp.release("/Root/a")
        tp.release("/Root/ghost", 3)
        assert "/Root/a" not in tp.tenants()
        return out, tp.tenants()

    both(run)
