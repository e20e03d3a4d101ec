"""The port's async replication (``ydb_tpu_torch/replication.py``)
against the reference's: the 2 cases of ``tests/test_replication.py``,
each through a reference source and replica ``Cluster`` and a port pair
on the CPU, with the same changes applied, the same counts and the same
replica rows, equal to the source's. Tolerance: none."""

import sys
import types

import pytest

import ydb_tpu.ssa
from ydb_tpu import replication as rreplication
from ydb_tpu.kqp.session import Cluster as RCluster

from ydb_tpu_torch import replication
from ydb_tpu_torch.kqp.session import Cluster


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


#: (replication module, Cluster factory) of each package
KITS = ((rreplication, RCluster),
        (replication, lambda: Cluster(device="cpu")))


def _pair(make):
    src, dst = make(), make()
    ss, ds = src.session(), dst.session()
    ss.execute("CREATE TABLE acc (id int64, v int64, PRIMARY KEY (id)) "
               "WITH (store = row, shards = 2, changefeed = on)")
    ds.execute("CREATE TABLE acc (id int64, v int64, PRIMARY KEY (id)) "
               "WITH (store = row, shards = 2)")
    return src, ss, dst, ds


def _rows(s):
    r = s.execute("select id, v from acc order by id")
    return list(zip((int(x) for x in r.column("id")),
                    (int(x) for x in r.column("v"))))


def _both(case):
    out = [case(*kit) for kit in KITS]
    assert out[0] == out[1]
    return out[1]


def test_replica_follows_source():
    def case(rep, make):
        src, ss, dst, ds = _pair(make)
        ss.execute("INSERT INTO acc VALUES (1, 10), (2, 20), (3, 30)")
        ss.execute("UPDATE acc SET v = 11 WHERE id = 1")
        ss.execute("DELETE FROM acc WHERE id = 2")
        n1 = rep.replicate_once(src.tables["acc"],
                                src.topics["acc_changefeed"],
                                dst.tables["acc"])
        first = (_rows(ds), _rows(ss))
        ss.execute("INSERT INTO acc VALUES (4, 40)")
        ss.execute("UPDATE acc SET v = 31 WHERE id = 3")
        n2 = rep.replicate_once(src.tables["acc"],
                                src.topics["acc_changefeed"],
                                dst.tables["acc"])
        return n1, first, n2, _rows(ds), _rows(ss)

    n1, (r1, s1), n2, r2, s2 = _both(case)
    assert n1 == 5 and r1 == s1 == [(1, 11), (3, 30)]
    assert n2 == 2 and r2 == s2 == [(1, 11), (3, 31), (4, 40)]


def test_replication_is_idempotent_on_redelivery():
    def case(rep, make):
        src, ss, dst, ds = _pair(make)
        ss.execute("INSERT INTO acc VALUES (1, 10), (2, 20)")
        ss.execute("DELETE FROM acc WHERE id = 2")
        topic = src.topics["acc_changefeed"]
        src.tables["acc"].drain_changes_to(topic)
        r = rep.Replicator(topic, dst.tables["acc"], consumer="r")
        applied = [r.poll()]
        before = _rows(ds)
        for part in topic.partitions:
            part.commit("r", 0)
        applied.append(r.poll())
        return applied, before, _rows(ds)

    applied, before, after = _both(case)
    # a commit below the committed offset is a stale ack the partition
    # ignores (no rewind), so the second pass applies nothing in either
    assert applied == [3, 0] and after == before == [(1, 10)]
