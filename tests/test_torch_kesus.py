"""The port's Kesus tablet and SequenceShard (``ydb_tpu_torch/tablet/
kesus.py``) and SQL sequences (``CREATE`` / ``DROP SEQUENCE``,
``nextval`` in INSERT, ``ydb_tpu_torch/kqp/session.py``) against the
reference's.

Each case of ``tests/test_kesus.py`` runs through both packages on the
same clock: every return value, description and error equal, and after
it every blob of the two stores the same bytes (the tablets' redo and
snapshot blobs). The four cases of ``tests/test_sql_sequences.py`` run
through a reference and a port ``Cluster``: the same ids, the same
errors. State carried across: Kesus semaphores and sessions, and
sequences both bare and behind a ``Cluster``, written by either package
boot in the other, holds as they were and next values above every
value handed out. Tolerance: none."""

import sys
import threading
import types

import pytest

import ydb_tpu.ssa
from ydb_tpu.engine.blobs import DirBlobStore as RDirBlobStore
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.sql.planner import PlanError as RPlanError
from ydb_tpu.tablet import kesus as rkesus

from ydb_tpu_torch import interop
from ydb_tpu_torch.engine.blobs import DirBlobStore, MemBlobStore
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.sql.planner import PlanError
from ydb_tpu_torch.tablet import kesus

from conftest import Clock


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C); the stand-in keeps its GROUP BYs on the
    scatter tier, as the other port tests do."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


#: (package label, kesus module, its MemBlobStore)
KITS = (("ref", rkesus, RMemBlobStore), ("port", kesus, MemBlobStore))


def _blobs(store) -> dict:
    return {b: bytes(store.get(b)) for b in store.list("")}


def _run(ops):
    """``ops(k, store, clock)`` once per package; returns equal."""
    outs, stores = [], []
    for _label, mod, store_cls in KITS:
        store = store_cls()
        outs.append(ops(mod, store, Clock(100.0)))
        stores.append(_blobs(store))
    assert outs[1] == outs[0]
    assert stores[1] == stores[0]
    return outs[1]


def _caught(fn):
    try:
        return ("ok", fn())
    except (KeyError, ValueError) as e:
        return ("error", type(e).__name__, str(e))


# ---------------- tests/test_kesus.py ----------------

def test_semaphore_acquire_release_and_waiters():
    def ops(m, store, clock):
        k = m.KesusTablet("k1", store, now=clock)
        s1, s2, s3 = (k.attach_session() for _ in range(3))
        k.create_semaphore("res", limit=2)
        out = [k.acquire(s1, "res"), k.acquire(s2, "res"),
               k.acquire(s3, "res", timeout_s=0),
               k.acquire(s3, "res", timeout_s=60), k.describe("res"),
               k.release(s1, "res"), k.describe("res")]
        return out, (s1, s2, s3)

    out, (s1, s2, s3) = _run(ops)
    assert out[:4] == [True, True, False, False]
    assert set(out[4]["owners"]) == {s1, s2} and out[4]["waiters"] == [s3]
    assert out[5] == [s3]
    assert set(out[6]["owners"]) == {s2, s3} and out[6]["waiters"] == []


def test_counting_semaphore_respects_counts():
    def ops(m, store, clock):
        k = m.KesusTablet("k2", store, now=clock)
        s1, s2 = k.attach_session(), k.attach_session()
        k.create_semaphore("slots", limit=10)
        return [k.acquire(s1, "slots", count=7),
                k.acquire(s2, "slots", count=4), k.release(s1, "slots"),
                k.acquire(s2, "slots", count=4)]

    assert _run(ops) == [True, False, [], True]


def test_ephemeral_lock_lifecycle():
    def ops(m, store, clock):
        k = m.KesusTablet("k3", store, now=clock)
        s1, s2 = k.attach_session(), k.attach_session()
        out = [k.acquire(s1, "mylock", ephemeral=True),
               k.acquire(s2, "mylock", ephemeral=True)]
        k.release(s1, "mylock")
        out.append(_caught(lambda: k.describe("mylock")))
        out.append(k.acquire(s2, "mylock", ephemeral=True))
        return out

    out = _run(ops)
    assert out[:2] == [True, False] and out[2][:2] == ("error", "KeyError")
    assert out[3] is True


def test_session_expiry_releases_holds():
    def ops(m, store, clock):
        k = m.KesusTablet("k4", store, now=clock)
        s1 = k.attach_session(timeout_s=10)
        s2 = k.attach_session(timeout_s=1000)
        k.create_semaphore("res", limit=1)
        out = [k.acquire(s1, "res"), k.acquire(s2, "res", timeout_s=60)]
        clock.t += 50  # s1 deadline passes
        out += [k.tick(), k.describe("res")["owners"]]
        return out, (s1, s2)

    out, (s1, s2) = _run(ops)
    assert out == [True, False, [s1], {s2: 1}]


def test_ping_extends_session():
    def ops(m, store, clock):
        k = m.KesusTablet("k5", store, now=clock)
        s1 = k.attach_session(timeout_s=10)
        clock.t += 8
        out = [k.ping_session(s1)]
        clock.t += 8  # past the original deadline, inside the new one
        out.append(k.tick())
        clock.t += 5
        out.append(k.tick())
        return out, s1

    out, s1 = _run(ops)
    assert out == [True, [], [s1]]


def test_kesus_reboots_with_state():
    def ops(m, store, clock):
        k = m.KesusTablet("k6", store, now=clock)
        s1 = k.attach_session(timeout_s=1000)
        k.create_semaphore("res", limit=3)
        out = [k.acquire(s1, "res", count=2)]
        k2 = m.KesusTablet("k6", store, now=clock)  # reboot
        d = k2.describe("res")
        out.append((d["owners"], d["limit"]))
        k2.release(s1, "res")
        s2 = k2.attach_session()
        out += [s2 > s1, k2.acquire(s2, "res", count=3)]
        return out, s1

    out, s1 = _run(ops)
    assert out == [True, ({s1: 2}, 3), True, True]


def test_tick_never_promotes_a_co_dying_session():
    def ops(m, store, clock):
        k = m.KesusTablet("kr1", store, now=clock)
        s1 = k.attach_session(timeout_s=10)
        s2 = k.attach_session(timeout_s=10)
        k.create_semaphore("sem", limit=1)
        out = [k.acquire(s1, "sem"), k.acquire(s2, "sem", timeout_s=1000)]
        clock.t += 50  # both sessions lapse together
        out += [k.tick(), k.describe("sem")]
        return out, (s1, s2)

    out, (s1, s2) = _run(ops)
    assert out[:3] == [True, False, sorted([s1, s2])]
    assert out[3]["owners"] == {} and out[3]["waiters"] == []


def test_lapsed_waiter_is_never_promoted():
    def ops(m, store, clock):
        k = m.KesusTablet("kr2", store, now=clock)
        s1 = k.attach_session(timeout_s=10_000)
        s2 = k.attach_session(timeout_s=10_000)
        k.create_semaphore("sem", limit=1)
        out = [k.acquire(s1, "sem"), k.acquire(s2, "sem", timeout_s=5)]
        clock.t += 50  # waiter lapsed (sessions still alive)
        out += [k.release(s1, "sem"), k.describe("sem")["owners"],
                k.acquire(s1, "sem", timeout_s=5),
                k.describe("sem")["owners"],
                k.acquire(s2, "sem", timeout_s=5)]
        clock.t += 50
        k.tick()
        out.append(k.describe("sem")["waiters"])
        return out, s1

    out, s1 = _run(ops)
    assert out == [True, False, [], {}, True, {s1: 1}, False, []]


def test_delete_semaphore_clears_stale_waiters():
    def ops(m, store, clock):
        k = m.KesusTablet("kr3", store, now=clock)
        s1, s2 = k.attach_session(), k.attach_session()
        k.create_semaphore("x", limit=0)
        out = [k.acquire(s1, "x", timeout_s=10_000)]
        k.delete_semaphore("x")
        k.create_semaphore("x", limit=5)
        out += [k.acquire(s2, "x"), k.release(s2, "x"),
                k.describe("x")["owners"]]
        return out

    assert _run(ops) == [False, True, [], {}]


def test_retried_acquire_does_not_duplicate_waiter():
    def ops(m, store, clock):
        k = m.KesusTablet("kr4", store, now=clock)
        s1, s2, s3 = (k.attach_session() for _ in range(3))
        k.create_semaphore("sem", limit=1)
        out = [k.acquire(s1, "sem"), k.acquire(s2, "sem", timeout_s=60),
               k.acquire(s2, "sem", timeout_s=60),  # client retry
               k.acquire(s3, "sem", timeout_s=60),
               k.describe("sem")["waiters"], k.release(s1, "sem"),
               k.release(s2, "sem")]
        return out, (s2, s3)

    out, (s2, s3) = _run(ops)
    assert out == [True, False, False, False, [s2, s3], [s2], [s3]]


def test_ephemeral_erase_clears_unpromotable_waiters():
    def ops(m, store, clock):
        k = m.KesusTablet("kr5", store, now=clock)
        s1, s2, s3 = (k.attach_session() for _ in range(3))
        return [k.acquire(s1, "L", ephemeral=True),
                k.acquire(s2, "L", count=2, timeout_s=1000),
                k.release(s1, "L"), k.acquire(s3, "L", ephemeral=True),
                k.describe("L")["waiters"], k.release(s3, "L")]

    assert _run(ops) == [True, False, [], True, [], []]


def test_sequence_descending():
    def ops(m, store, clock):
        seq = m.SequenceShard("sd", store)
        seq.create_sequence("down", start=100, increment=-1, cache=10)
        return [seq.next_val("down") for _ in range(12)]

    assert _run(ops) == list(range(100, 88, -1))


def test_sequence_durable_ranges():
    def ops(m, store, clock):
        seq = m.SequenceShard("s1", store)
        seq.create_sequence("ids", start=1, cache=5)
        got = [seq.next_val("ids") for _ in range(7)]
        seq2 = m.SequenceShard("s1", store)  # reboot: the range burns
        return got, seq2.next_val("ids"), seq2.next_val("ids")

    assert _run(ops) == ([1, 2, 3, 4, 5, 6, 7], 11, 12)


def test_sequence_increment_and_missing():
    def ops(m, store, clock):
        seq = m.SequenceShard("s2", store)
        seq.create_sequence("even", start=0, increment=2, cache=3)
        return ([seq.next_val("even") for _ in range(4)],
                _caught(lambda: seq.next_val("nope")),
                _caught(lambda: seq.create_sequence("even")),
                _caught(lambda: seq.create_sequence("z", increment=0)),
                _caught(lambda: seq.create_sequence("z", cache=0)))

    got, missing, dup, zero, nocache = _run(ops)
    assert got == [0, 2, 4, 6] and missing[:2] == ("error", "KeyError")
    assert dup[:2] == zero[:2] == nocache[:2] == ("error", "ValueError")


# ---------------- tests/test_sql_sequences.py ----------------

def _pair():
    return RCluster(), Cluster(device="cpu")


def _ids(out, col="id"):
    return [int(x) for x in out.cols[col][0]]


def _err(session, sql):
    try:
        session.execute(sql)
    except Exception as e:  # noqa: BLE001 - compared by the caller
        return type(e).__name__, str(e)
    return None


def test_create_and_nextval_in_insert():
    got = []
    for c in _pair():
        s = c.session()
        s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id))")
        s.execute("CREATE SEQUENCE ids START 100 CACHE 5")
        s.execute("INSERT INTO t VALUES (nextval('ids'), 1), "
                  "(nextval('ids'), 2)")
        s.execute("INSERT INTO t VALUES (nextval('ids'), 3)")
        out = _ids(s.execute("SELECT id, v FROM t ORDER BY id"))
        errs = [_err(s, sql) for sql in (
            "CREATE SEQUENCE ids",
            "INSERT INTO t VALUES (nextval('nope'), 0)",
            "INSERT INTO t VALUES (nextval(id), 0)",
            "INSERT INTO t VALUES (nextval(), 0)",
            "CREATE SEQUENCE bad CACHE 0")]
        got.append((out, errs))
    assert got[1] == got[0]
    out, errs = got[1]
    assert out == [100, 101, 102]
    assert [e[0] for e in errs] == ["ValueError", "KeyError", "PlanError",
                                    "PlanError", "ValueError"]
    assert "literal" in errs[2][1] and "cache" in errs[4][1]


def test_concurrent_nextval_never_duplicates():
    for c in _pair():
        s = c.session()
        s.execute("CREATE SEQUENCE cs START 1 CACHE 3")
        got, lock = [], threading.Lock()

        def worker():
            for _ in range(25):
                v = c.sequences.next_val("cs")
                with lock:
                    got.append(v)

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert sorted(got) == list(range(1, 101))


def test_sequence_survives_reboot_without_repeats():
    got = []
    for c, make in zip(_pair(), (RCluster, lambda store: Cluster(
            store=store, device="cpu"))):
        s = c.session()
        s.execute("CREATE TABLE t (id int64, PRIMARY KEY (id))")
        s.execute("CREATE SEQUENCE sq START 1 CACHE 4")
        s.execute("INSERT INTO t VALUES (nextval('sq')), (nextval('sq'))")
        s2 = (make(store=c.store) if make is RCluster
              else make(c.store)).session()  # reboot: cached range burned
        s2.execute("INSERT INTO t VALUES (nextval('sq'))")
        got.append(_ids(s2.execute("SELECT id FROM t ORDER BY id")))
    assert got[1] == got[0] == [1, 2, 5]


def test_drop_sequence():
    got = []
    for c in _pair():
        s = c.session()
        s.execute("CREATE SEQUENCE gone")
        s.execute("DROP SEQUENCE gone")
        s.execute("CREATE TABLE t (id int64, PRIMARY KEY (id))")
        err = _err(s, "INSERT INTO t VALUES (nextval('gone'))")
        s.execute("CREATE SEQUENCE gone START 7")  # name reusable
        s.execute("INSERT INTO t VALUES (nextval('gone'))")
        got.append((err, _ids(s.execute("SELECT id FROM t"))))
    assert got[1] == got[0]
    assert got[1][0][0] == "KeyError" and got[1][1] == [7]


# ---------------- state carried across ----------------

def _to_reference(store):
    out = RMemBlobStore()
    for b in store.list(""):
        out.put(b, bytes(store.get(b)))
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_kesus_state_boots_in_the_other_package(writer):
    """Semaphores, holds, waiters and sessions one package wrote are
    held as before in the other, which keeps serving them."""
    w, r = (rkesus, kesus) if writer == "ref" else (kesus, rkesus)
    clock = Clock(100.0)
    store = RMemBlobStore() if writer == "ref" else MemBlobStore()
    k = w.KesusTablet("kx", store, now=clock)
    s1 = k.attach_session(timeout_s=1000)
    s2 = k.attach_session(timeout_s=1000)
    k.create_semaphore("res", limit=3, data="payload")
    assert k.acquire(s1, "res", count=2)
    assert not k.acquire(s2, "res", count=2, timeout_s=500)
    assert k.acquire(s1, "lock", ephemeral=True)
    seq = w.SequenceShard("sx", store)
    seq.create_sequence("ids", start=10, cache=4)
    handed = [seq.next_val("ids") for _ in range(6)]
    moved = (interop.blob_store_from_reference(store) if writer == "ref"
             else _to_reference(store))
    k2 = r.KesusTablet("kx", moved, now=clock)
    for name in ("res", "lock"):
        assert k2.describe(name) == k.describe(name)
    assert k2.release(s1, "res") == [s2]  # the waiter is promoted
    assert k2.describe("res")["owners"] == {s2: 2}
    assert k2.attach_session() == s2 + 1
    nxt = r.SequenceShard("sx", moved).next_val("ids")
    assert nxt > max(handed) and nxt == 18


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cluster_sequences_boot_in_the_other_package(writer, tmp_path):
    """A Cluster's sequences on a DirBlobStore: the other package's
    Cluster boots from the same directory and hands out values above
    every value the writer handed out; DROP SEQUENCE is durable."""
    root = str(tmp_path / "db")
    make_w, make_r = ((lambda: RCluster(store=RDirBlobStore(root))),
                      (lambda: Cluster(store=DirBlobStore(root),
                                       device="cpu")))
    if writer == "port":
        make_w, make_r = make_r, make_w
    c = make_w()
    s = c.session()
    s.execute("CREATE TABLE t (id int64, v int64, PRIMARY KEY (id)) "
              "WITH (store = row)")
    s.execute("CREATE SEQUENCE sq START 1 CACHE 8")
    s.execute("CREATE SEQUENCE gone")
    for i in range(3):
        s.execute(f"INSERT INTO t VALUES (nextval('sq'), {i})")
    s.execute("DROP SEQUENCE gone")
    c2 = make_r()
    s2 = c2.session()
    s2.execute("INSERT INTO t VALUES (nextval('sq'), 9)")
    ids = _ids(s2.execute("SELECT id FROM t ORDER BY id"))
    assert ids == [1, 2, 3, 9]
    err = _err(s2, "INSERT INTO t VALUES (nextval('gone'), 0)")
    assert err is not None and err[0] == "KeyError"
    with pytest.raises((PlanError, RPlanError)):
        s2.execute("INSERT INTO t VALUES (nextval(v), 0)")
