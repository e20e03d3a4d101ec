"""The port's thread and leak sanitizers against the reference's:
``ydb_tpu_torch/analysis/sanitizer.py`` and ``leaksan.py`` run the same
scripted access and handle sequences as ``ydb_tpu/analysis/sanitizer.py``
and ``leaksan.py``, and must end with the same error names
(``RaceError`` / ``LeakError`` / none). Added for the port: the device
locks of ``ydb_tpu_torch/device.py`` (``capture_lock`` tracked always,
``work_lock`` reporting its shared and exclusive holds), and the leak
handles of the port's Cluster, batcher, scan share, rm, front door,
spiller and pgwire drain at statement end and at ``Cluster.stop``.

Tolerance: none (error names and counts compare exactly)."""

import threading

import numpy as np
import pytest

from ydb_tpu.analysis import leaksan as r_leaksan
from ydb_tpu.analysis import sanitizer as r_san

from ydb_tpu_torch import device as tdevice
from ydb_tpu_torch.analysis import leaksan as t_leaksan
from ydb_tpu_torch.analysis import sanitizer as t_san


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts and ends with both packages' sanitizers
    unpinned and their state cleared."""
    for m in (r_leaksan, t_leaksan):
        m.set_force(None)
        m.reset()
    for m in (r_san, t_san):
        m.reset_states()
    yield
    for m in (r_leaksan, t_leaksan):
        m.set_force(None)
        m.reset()
    for m in (r_san, t_san):
        m.reset_states()


def _on_thread(fn):
    """Run ``fn`` on a fresh thread; the exception it raised (or None)."""
    out = []

    def wrap():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - returned
            out.append(e)

    t = threading.Thread(target=wrap)
    t.start()
    t.join(timeout=30)
    return out[0] if out else None


def _outcome(fn):
    """The error name ``fn`` ends with, or None."""
    try:
        err = fn()
    except BaseException as e:  # noqa: BLE001 - compared by name
        err = e
    return None if err is None else type(err).__name__


# ---------------- scripted tsan sequences ----------------


def _unguarded_writes(san):
    with san.activate():
        d = san.share({}, "toy.racy")

        def w():
            d["w"] = 1
        err = _on_thread(w)
        if err is not None:
            return err
        d["main"] = 2


def _guarded_writes(san):
    with san.activate():
        lk = san.make_lock("toy.lock")
        d = san.share({}, "toy.guarded")

        def w():
            with lk:
                d["w"] = 1
        err = _on_thread(w)
        if err is not None:
            return err
        with lk:
            d["main"] = 2


def _reads_only(san):
    with san.activate():
        d = san.share({"k": 1}, "toy.reads")
        err = _on_thread(lambda: d.get("k"))
        if err is not None:
            return err
        return None if "k" in d and len(d) == 1 else AssertionError()


def _heap_token_unguarded(san):
    import heapq

    with san.activate():
        heap: list = []
        tok = san.token("toy.heap")

        def push():
            san.note(tok, "heappush")
            heapq.heappush(heap, 1)
        err = _on_thread(push)
        if err is not None:
            return err
        san.note(tok, "heappop")
        heapq.heappop(heap)


def _condition_guarded(san):
    with san.activate():
        cv = san.make_condition("toy.cv")
        box = san.share([], "toy.box")

        def producer():
            with cv:
                box.append(1)
                cv.notify_all()
        err = _on_thread(producer)
        if err is not None:
            return err
        with cv:
            with cv:  # re-entered: an RLock-backed condition
                cv.wait_for(lambda: len(box) > 0, timeout=5)
                box.append(2)


def _lock_dropped_on_one_side(san):
    with san.activate():
        lk = san.make_lock("toy.half")
        d = san.share({}, "toy.half.map")

        def w():
            with lk:
                d["w"] = 1
        err = _on_thread(w)
        if err is not None:
            return err
        d["main"] = 2  # no lock here: the candidate lockset empties


def _inactive_is_plain(san):
    d = san.share({}, "toy.off")
    lk = san.make_lock("toy.off.lock")
    if type(d) is not dict or isinstance(lk, san.TrackedLock):
        return AssertionError("disarmed factories must be plain")
    err = _on_thread(lambda: d.update(a=1))
    if err is not None:
        return err
    d["b"] = 2


TSAN_SCRIPTS = {
    "unguarded_writes": (_unguarded_writes, "RaceError"),
    "guarded_writes": (_guarded_writes, None),
    "reads_only": (_reads_only, None),
    "heap_token_unguarded": (_heap_token_unguarded, "RaceError"),
    "condition_guarded": (_condition_guarded, None),
    "lock_dropped_on_one_side": (_lock_dropped_on_one_side, "RaceError"),
    "inactive_is_plain": (_inactive_is_plain, None),
}


@pytest.mark.parametrize("name", sorted(TSAN_SCRIPTS))
def test_tsan_script_same_error_name(name):
    script, want = TSAN_SCRIPTS[name]
    ref = _outcome(lambda: script(r_san))
    port = _outcome(lambda: script(t_san))
    assert ref == port == want, (ref, port)


def test_race_reports_are_recorded():
    """A race raised on a worker thread stays in ``reports()`` even when
    the thread's caller swallows it (the port's addition)."""
    assert _outcome(lambda: _unguarded_writes(t_san)) == "RaceError"
    with t_san.activate():
        d = t_san.share({}, "toy.reported")
        _on_thread(lambda: d.update(a=1))
        assert _outcome(lambda: d.update(b=2)) == "RaceError"
        assert t_san.reports() and "toy.reported" in t_san.reports()[0]
    assert t_san.reports() == []  # activate's exit resets


# ---------------- the device locks ----------------


def test_capture_lock_is_tracked():
    assert isinstance(tdevice.capture_lock, t_san.TrackedRLock)
    with tdevice.capture_lock:
        with tdevice.capture_lock:  # re-entrant
            assert "device.capture_lock" in t_san.held_locks()
    assert "device.capture_lock" not in t_san.held_locks()


def test_capture_lock_guards_a_shared_structure():
    with t_san.activate():
        d = t_san.share({}, "toy.capture")

        def w():
            with tdevice.capture_lock:
                d["w"] = 1
        assert _on_thread(w) is None
        with tdevice.capture_lock:
            d["main"] = 2


def test_work_lock_holds_are_reported():
    """Armed, every hold is reported; disarmed, none is (a gate check is
    the whole cost)."""
    wl = tdevice.work_lock
    with t_san.activate():
        with wl.shared():
            assert t_san.held_locks() == {"device.work_lock[shared]"}
            with wl.shared():
                pass
            assert "device.work_lock[shared]" in t_san.held_locks()
        assert not t_san.held_locks()
        with wl.exclusive():
            assert "device.work_lock" in t_san.held_locks()
        assert wl.try_exclusive()
        assert "device.work_lock" in t_san.held_locks()
        wl.release_exclusive()
        assert not t_san.held_locks()
    with wl.shared(), wl.exclusive():
        assert not t_san.held_locks()


def test_work_lock_shared_hold_does_not_guard_writes():
    """Two threads writing under shared holds race (readers exclude only
    the writer); under exclusive holds they do not."""
    wl = tdevice.DeviceWorkLock("toy.work")
    with t_san.activate():
        d = t_san.share({}, "toy.work.map")

        def shared_write():
            with wl.shared():
                d["w"] = 1
        assert _on_thread(shared_write) is None
        with wl.shared():
            assert _outcome(lambda: d.update(main=2)) == "RaceError"
    with t_san.activate():
        d = t_san.share({}, "toy.work.map2")

        def excl_write():
            with wl.exclusive():
                d["w"] = 1
        assert _on_thread(excl_write) is None
        with wl.exclusive():
            d["main"] = 2
        r = t_san.share({"k": 1}, "toy.work.reads")

        def shared_read():
            with wl.shared():
                return r.get("k")
        assert _on_thread(shared_read) is None
        with wl.shared():
            assert r["k"] == 1


# ---------------- scripted leaksan sequences ----------------


def _track_close(ls):
    with ls.activate():
        h = ls.track("conveyor.task", "q")
        if ls.counts() != {"conveyor.task": 1}:
            return AssertionError(ls.counts())
        ls.close(h)
        ls.close(h)  # idempotent
        ls.assert_drained(where="script")


def _leak(ls):
    with ls.activate():
        ls.track("rm.slot", "q1", owner="q1")
        ls.assert_drained(where="script")


def _owner_scoped(ls):
    with ls.activate():
        ls.track("session.active", "a", owner=1)
        h = ls.track("session.active", "b", owner=2)
        ls.close(h)
        ls.assert_drained(owner=2, where="owner 2")  # drained
        ls.assert_drained(owner=1, where="owner 1")  # raises


def _kinds_scoped(ls):
    with ls.activate():
        ls.track("dq.spill", "s/1")
        ls.assert_drained(kinds=("rm.slot",), where="rm only")


def _disarmed_is_free(ls):
    ls.set_force(False)
    try:
        if ls.track("conveyor.task", "q") is not None:
            return AssertionError("disarmed track returned a handle")
        ls.close(None)
        ls.assert_drained()
    finally:
        ls.set_force(None)


LEAK_SCRIPTS = {
    "track_close": (_track_close, None),
    "leak": (_leak, "LeakError"),
    "owner_scoped": (_owner_scoped, "LeakError"),
    "kinds_scoped": (_kinds_scoped, None),
    "disarmed_is_free": (_disarmed_is_free, None),
}


@pytest.mark.parametrize("name", sorted(LEAK_SCRIPTS))
def test_leaksan_script_same_error_name(name):
    script, want = LEAK_SCRIPTS[name]
    ref = _outcome(lambda: script(r_leaksan))
    port = _outcome(lambda: script(t_leaksan))
    assert ref == port == want, (ref, port)


def test_env_gates_are_the_ports(monkeypatch):
    monkeypatch.setenv("YDB_TPU_TORCH_LEAKSAN", "1")
    t_leaksan.refresh()
    assert t_leaksan.enabled()
    monkeypatch.setenv("YDB_TPU_TORCH_LEAKSAN", "0")
    t_leaksan.refresh()
    assert not t_leaksan.enabled()
    monkeypatch.setenv("YDB_TPU_TORCH_TSAN", "1")
    assert t_san.enabled()
    monkeypatch.setenv("YDB_TPU_TORCH_TSAN", "0")
    assert not t_san.enabled()


# ---------------- hooks in the port's modules ----------------


def test_spiller_blobs_are_tracked_and_drain():
    from ydb_tpu_torch.dq.spilling import Spiller

    with t_leaksan.activate():
        sp = Spiller(mem_quota_bytes=0)
        a = sp.put({"x": np.arange(4)})
        sp.put({"x": np.arange(4)})
        assert t_leaksan.counts() == {"dq.spill": 2}
        sp.get(a)
        assert t_leaksan.counts() == {"dq.spill": 1}
        sp.close()
        t_leaksan.assert_drained()


def test_rm_and_front_door_handles_drain():
    from ydb_tpu_torch.kqp.rm import ResourceManager
    from ydb_tpu_torch.serving.admission import FrontDoor
    from ydb_tpu_torch.serving.tenants import TenantRegistry

    with t_leaksan.activate():
        rm = ResourceManager(compute_slots=2)
        rm.acquire("q1")
        assert t_leaksan.counts() == {"rm.slot": 1}
        with pytest.raises(t_leaksan.LeakError):
            t_leaksan.assert_drained(owner="q1")
        rm.release("q1")
        door = FrontDoor(None, TenantRegistry())
        seat = door.admit("default", owner="q2")
        assert t_leaksan.counts() == {"serving.seat": 1}
        seat.release()
        t_leaksan.assert_drained()


def test_scanshare_flight_and_batch_seat_drain():
    from ydb_tpu_torch.engine.scanshare import ScanShare

    with t_leaksan.activate(), t_san.activate():
        share = ScanShare()
        seen = []

        def stage():
            seen.append(t_leaksan.counts())
            return "blk"
        assert share.get_or_stage(("k",), stage) == "blk"
        assert seen == [{"scanshare.flight": 1}]
        t_leaksan.assert_drained()


def test_cluster_statements_drain_and_stop_checks(tmp_path):
    """Statements through a port Cluster (its registry row per statement,
    the batcher, pgwire's connection handle) leave no handle behind, and
    ``Cluster.stop`` raises ``LeakError`` naming a survivor."""
    from ydb_tpu_torch.api.pgwire import PgWireServer
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.kqp.session import Cluster
    from test_pgwire import MiniPgClient

    with t_leaksan.activate(), t_san.activate():
        c = Cluster(store=MemBlobStore(), device="cpu")
        assert isinstance(c.active_queries, t_san.ShareProxy)
        s = c.session()
        s.execute("create table kv (k bigint not null, v bigint, "
                  "primary key (k))")
        s.execute("insert into kv values (1, 10), (2, 20)")
        assert s.execute("select sum(v) as s from kv").num_rows == 1
        assert t_leaksan.counts() == {}
        srv = PgWireServer(c, port=0).start()
        cl = MiniPgClient(srv.port)
        cl.query("select sum(v) as s from kv")
        assert t_leaksan.counts() == {"serving.conn": 1}
        cl.close()
        srv.stop()
        for _ in range(200):
            if not t_leaksan.counts():
                break
            threading.Event().wait(0.01)
        assert t_leaksan.counts() == {}
        c.stop()  # drained: no raise
        t_leaksan.track("rm.slot", "stray", owner="stray")
        with pytest.raises(t_leaksan.LeakError, match="rm.slot"):
            c.stop()
        t_leaksan.reset()
