"""The port's cross-query batched serving tier against the reference's:
``ydb_tpu_torch/kqp/batch.py`` (window gating, dedup against stacked
dispatch, deadline isolation inside a batch) and
``ydb_tpu_torch/engine/scanshare.py`` (single-flight staging), a mirror
of ``tests/test_batching.py:93-402`` on a port ``Cluster(device="cpu")``.

Tolerance: none. Every batched result must be bit-identical to the
serial path's (window 0), and the serial path's to the reference
Cluster's for the same SQL and data (integers, dictionary ids and
validity exact; the plans hold no floats but Q1's averages, which the
two packages compute alike to the last bit on the CPU).

Added for the port: two members over distinct host ``ColumnSource``s
must each get their own answer from one stacked dispatch (the serial
path's staging writes the plan's single static input block on CUDA, so
the batcher stages each member into a fresh block), on the CPU and, in
a ``cuda``-marked test, on the card; and a ``cuda``-marked test that
runs walk, DQ and fused statements on eight threads while another
thread captures a new plan (``device.work_lock``).

The leak-sanitizer drain of batch seats and staging flights is the
reference's (``tests/test_batching.py:402-435``). Deferred to its
ROADMAP.md queue A item: the sys-view batch columns and the EXPLAIN
ANALYZE batching line (sys views)."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from ydb_tpu.kqp.session import Cluster as RCluster

from ydb_tpu_torch.analysis import leaksan
from ydb_tpu_torch.chaos.deadline import StatementCancelled
from ydb_tpu_torch.engine.scanshare import ScanShare
from ydb_tpu_torch.kqp.batch import BatchDispatcher
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.workload import tpch

from test_sql import Q1_SQL, Q6_SQL


# ---------------- fixtures ----------------

def _lineitem_cluster(sf=0.002, make=None):
    """A Cluster holding TPC-H lineitem in three portions (the
    reference's loader, ``tests/test_batching.py:_lineitem_cluster``)."""
    from ydb_tpu_torch.scheme.model import type_to_str

    data = tpch.TpchData(sf=sf, seed=7)
    c = make() if make is not None else Cluster(device="cpu")
    s = c.session()
    schema = data.schema("lineitem")
    cols = ", ".join(f"{f.name} {type_to_str(f.type)}"
                     for f in schema.fields)
    s.execute(f"CREATE TABLE lineitem ({cols}, "
              f"PRIMARY KEY (l_orderkey)) WITH (shards = 1)")
    src = data.tables["lineitem"]
    t = c.tables["lineitem"]
    n = len(src["l_orderkey"])
    step = max(1, n // 3)
    for off in range(0, n, step):
        arrays = {}
        for f in schema.fields:
            v = src[f.name][off:off + step]
            if f.type.is_string:
                arrays[f.name] = [
                    bytes(x) for x in data.dicts[f.name].decode(
                        np.asarray(v, dtype=np.int32))]
            else:
                arrays[f.name] = v
        t.insert(arrays)
    c._invalidate_plans()
    return c


@pytest.fixture(scope="module")
def cluster():
    c = _lineitem_cluster()
    yield c
    c.stop()


@contextlib.contextmanager
def _armed(c, window_ms, max_batch=None):
    bt = c.batcher
    w0, m0 = bt.window_ms, bt.max_batch
    bt.window_ms = float(window_ms)
    if max_batch is not None:
        bt.max_batch = max_batch
    try:
        yield bt
    finally:
        bt.window_ms, bt.max_batch = w0, m0


def _same_result(a, b):
    assert list(a.schema.names) == list(b.schema.names)
    assert a.num_rows == b.num_rows
    for name in a.schema.names:
        av, aok = a.cols[name]
        bv, bok = b.cols[name]
        np.testing.assert_array_equal(np.asarray(av), np.asarray(bv),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(aok), np.asarray(bok),
                                      err_msg=f"{name} validity")


@pytest.mark.parametrize("sql", [Q1_SQL, Q6_SQL], ids=["q1", "q6"])
def test_serial_path_equals_reference_cluster(cluster, sql):
    ref = _lineitem_cluster(make=RCluster)
    _same_result(cluster.session().execute(sql), ref.session().execute(sql))


# ---------------- scan share (single-flight staging) ----------------

def test_scanshare_single_flight():
    share = ScanShare()
    staging = threading.Event()   # filler is inside stage_fn
    release = threading.Event()   # attacher is waiting on the flight
    calls = []

    def stage():
        calls.append(threading.get_ident())
        staging.set()
        assert release.wait(5.0)
        return {"block": 42}

    out = [None, None]
    t0 = threading.Thread(
        target=lambda: out.__setitem__(0, share.get_or_stage("k", stage)))
    t0.start()
    assert staging.wait(5.0)
    t1 = threading.Thread(
        target=lambda: out.__setitem__(1, share.get_or_stage("k", stage)))
    t1.start()
    while share.attached == 0:
        time.sleep(0.001)
    release.set()
    t0.join(5.0)
    t1.join(5.0)
    assert len(calls) == 1
    assert out[0] is out[1]
    assert share.snapshot() == {"staged": 1, "attached": 1,
                                "inflight": 0}


def test_scanshare_error_propagates_then_clears():
    share = ScanShare()
    staging = threading.Event()
    release = threading.Event()

    def boom():
        staging.set()
        assert release.wait(5.0)
        raise ValueError("staging fault")

    errs = [None, None]

    def fill():
        try:
            share.get_or_stage("k", boom)
        except ValueError as e:
            errs[0] = e

    def attach():
        try:
            share.get_or_stage("k", boom)
        except ValueError as e:
            errs[1] = e

    t0 = threading.Thread(target=fill)
    t0.start()
    assert staging.wait(5.0)
    t1 = threading.Thread(target=attach)
    t1.start()
    while share.attached == 0:
        time.sleep(0.001)
    release.set()
    t0.join(5.0)
    t1.join(5.0)
    assert errs[0] is not None and errs[1] is errs[0]
    assert share.get_or_stage("k", lambda: "ok") == "ok"
    assert share.staged == 1


def test_scanshare_key_none_stages_privately():
    share = ScanShare()
    calls = []
    for _ in range(2):
        share.get_or_stage(None, lambda: calls.append(1))
    assert len(calls) == 2
    assert share.snapshot() == {"staged": 0, "attached": 0,
                                "inflight": 0}


# ---------------- stacked / shared dispatch bit-identity ----------------

def _two_lineitem_dbs(device):
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database

    data = tpch.TpchData(sf=0.002, seed=11)
    schema = data.schema("lineitem")
    cols_a = data.tables["lineitem"]
    cols_b = dict(cols_a)
    cols_b["l_quantity"] = np.asarray(cols_a["l_quantity"]) * 2
    return [Database(sources={"lineitem": ColumnSource(c, schema,
                                                       data.dicts)},
                     dicts=data.dicts, device=device)
            for c in (cols_a, cols_b)]


def _same_block(x, y):
    xv, xok = x.to_numpy(), x.validity_numpy()
    yv, yok = y.to_numpy(), y.validity_numpy()
    for name in x.schema.names:
        np.testing.assert_array_equal(xok[name], yok[name])
        np.testing.assert_array_equal(
            np.where(xok[name], xv[name], 0),
            np.where(yok[name], yv[name], 0), err_msg=name)


def test_run_stacked_slices_match_run_shared():
    """Two members with DIFFERENT staged inputs stack into one dispatch;
    each slice is bit-identical to that member's own serial dispatch,
    and the two answers really differ."""
    from ydb_tpu_torch.plan.executor import _stage_fused_site
    from ydb_tpu_torch.plan.nodes import TableScan
    from ydb_tpu_torch.ssa import plan_fuse

    db_a, db_b = _two_lineitem_dbs("cpu")
    plan = TableScan("lineitem", program=tpch.q6_program())
    sig = plan_fuse.plan_signature(plan, db_a)
    assert sig is not None and sig.sites
    ida = BatchDispatcher._identity_vector(sig, db_a)
    assert ida == BatchDispatcher._identity_vector(sig, db_a)
    assert ida != BatchDispatcher._identity_vector(sig, db_b)

    fused = plan_fuse.build(sig, db_a)
    ia = {s.key: _stage_fused_site(s, db_a) for s in sig.sites}
    ib = {s.key: _stage_fused_site(s, db_b) for s in sig.sites}
    ra, ta = fused.run_shared(ia)
    assert not fused.overflowed(ta)
    rb, tb = fused.run_shared(ib)
    assert not fused.overflowed(tb)
    out, tt = fused.run_stacked([ia, ib])
    assert not fused.overflowed(tt)
    _same_block(plan_fuse.slice_member(out, 0), ra)
    _same_block(plan_fuse.slice_member(out, 1), rb)
    assert (ra.to_numpy()["revenue"][0]
            != rb.to_numpy()["revenue"][0])


def _distinct_source_members(device):
    """Two statements over distinct ColumnSources through one armed
    BatchDispatcher: one stacked dispatch, each member its own answer
    (equal to its serial run)."""
    from ydb_tpu_torch.plan import execute_plan, to_host
    from ydb_tpu_torch.plan.nodes import TableScan, Transform

    dbs = _two_lineitem_dbs(device)
    plan = Transform(TableScan("lineitem"), tpch.q6_program())
    want = [to_host(execute_plan(plan, db)) for db in dbs]
    bt = BatchDispatcher(window_ms=2000, max_batch=2)
    got = [None, None]
    errors = []

    def run(i):
        try:
            got[i] = to_host(bt.execute(plan, dbs[i]))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert bt.stacked_dispatches == 1 and bt.dedup_dispatches == 0
    for g, w in zip(got, want):
        _same_result(g, w)
    assert int(got[0].cols["revenue"][0][0]) != \
        int(got[1].cols["revenue"][0][0])


def test_distinct_source_members_get_their_own_answers():
    _distinct_source_members("cpu")


# ---------------- window gating ----------------

def test_window_zero_is_serial(cluster):
    s = cluster.session()
    assert not cluster.batcher.armed()
    s.execute(Q1_SQL)
    snap = cluster.batcher.snapshot()
    assert snap["batches"] == 0 and snap["solo"] == 0
    assert snap["scan_staged"] == 0
    assert s.last_profile.batch_size == 0
    assert s.last_profile.batch_id == 0


def test_solo_group_returns_to_serial_path(cluster):
    s = cluster.session()
    want = s.execute(Q1_SQL)
    with _armed(cluster, window_ms=30):
        got = s.execute(Q1_SQL)
    _same_result(got, want)
    snap = cluster.batcher.snapshot()
    assert snap["solo"] >= 1 and snap["batched_statements"] == 0
    assert s.last_profile.batch_size == 1
    assert s.last_profile.batch_wait_seconds >= 0.0


# ---------------- batched end-to-end ----------------

def test_batched_results_bit_identical(cluster):
    n = 4
    s0 = cluster.session()
    want = s0.execute(Q1_SQL)
    bt0 = cluster.batcher.snapshot()
    results = [None] * n
    errors = [None] * n
    profiles = [None] * n
    barrier = threading.Barrier(n)

    def work(i):
        s = cluster.session()
        barrier.wait()
        try:
            results[i] = s.execute(Q1_SQL)
            profiles[i] = s.last_profile
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors[i] = e

    with _armed(cluster, window_ms=500, max_batch=n):
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    assert errors == [None] * n
    for r in results:
        _same_result(r, want)
    snap = cluster.batcher.snapshot()
    assert snap["batches"] >= bt0["batches"] + 1
    assert snap["batched_statements"] >= bt0["batched_statements"] + 2
    assert snap["dedup_dispatches"] >= bt0["dedup_dispatches"] + 1
    assert snap["scan_staged"] >= bt0["scan_staged"] + 1
    batched = [p for p in profiles if p is not None and p.batch_size >= 2]
    assert batched, "no member profile recorded a batch seat"
    for p in batched:
        assert p.batch_id > 0
        assert p.shared_scan >= 1
        assert p.batch_execute_seconds >= 0.0
    cluster.run_background()
    g = cluster.counters.group(component="batching")
    assert g.counter("batches").value == snap["batches"]
    assert g.counter("batched_statements").value \
        == snap["batched_statements"]


def test_distinct_plans_never_share_a_batch(cluster):
    s0 = cluster.session()
    want = {Q1_SQL: s0.execute(Q1_SQL), Q6_SQL: s0.execute(Q6_SQL)}
    sqls = [Q1_SQL, Q6_SQL, Q1_SQL, Q6_SQL]
    results = [None] * len(sqls)
    errors = [None] * len(sqls)
    barrier = threading.Barrier(len(sqls))

    def work(i):
        s = cluster.session()
        barrier.wait()
        try:
            results[i] = s.execute(sqls[i])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors[i] = e

    with _armed(cluster, window_ms=400):
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(sqls))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    assert errors == [None] * len(sqls)
    for i, sql in enumerate(sqls):
        _same_result(results[i], want[sql])


# ---------------- deadline isolation inside a batch ----------------

def test_deadline_cancel_leaves_batchmates_intact(cluster):
    s0 = cluster.session()
    want = s0.execute(Q1_SQL)
    results = [None] * 3
    errors = [None] * 3
    started = threading.Event()

    def leader():
        s = cluster.session()
        started.set()
        try:
            results[0] = s.execute(Q1_SQL)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors[0] = e

    def doomed():
        s = cluster.session()
        try:
            results[1] = s.execute(Q1_SQL, timeout=0.12)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors[1] = e

    def survivor():
        s = cluster.session()
        try:
            results[2] = s.execute(Q1_SQL)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors[2] = e

    with _armed(cluster, window_ms=500, max_batch=8):
        t0 = threading.Thread(target=leader)
        t0.start()
        assert started.wait(5.0)
        time.sleep(0.05)
        t1 = threading.Thread(target=doomed)
        t1.start()
        t2 = threading.Thread(target=survivor)
        t2.start()
        for t in (t0, t1, t2):
            t.join(30.0)
    assert errors[0] is None and errors[2] is None
    assert isinstance(errors[1], StatementCancelled)
    _same_result(results[0], want)
    _same_result(results[2], want)


# ---------------- the device work lock ----------------

def test_work_lock_capture_waits_for_statements():
    """A capture takes ``device.work_lock`` exclusively: it waits for
    statements holding it shared, new statements wait for it, and a
    thread's own shared hold does not block its capture."""
    from ydb_tpu_torch.device import DeviceWorkLock

    lock = DeviceWorkLock()
    log = []
    holding = threading.Event()
    release = threading.Event()

    def reader():
        with lock.shared():
            holding.set()
            assert release.wait(5.0)
            log.append("reader done")

    def capturer():
        with lock.shared():
            assert not lock.try_exclusive()  # the reader holds it
            with lock.exclusive():
                log.append("capture")
                assert lock.try_exclusive()  # re-entrant
                lock.release_exclusive()
            with lock.shared():  # its own hold came back
                pass

    r = threading.Thread(target=reader)
    r.start()
    assert holding.wait(5.0)
    c = threading.Thread(target=capturer)
    c.start()
    time.sleep(0.05)
    assert log == []
    release.set()
    r.join(5.0)
    c.join(5.0)
    assert log == ["reader done", "capture"]
    assert lock.try_exclusive()
    lock.release_exclusive()


# ---------------- on the card ----------------

def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
def test_distinct_source_members_on_gpu():
    """On CUDA the serial path stages into the plan's single static input
    block; the batcher stages each member afresh, so each stacked member
    still gets its own answer."""
    _need_gpu()
    _distinct_source_members("cuda")


@pytest.mark.cuda
def test_concurrent_statements_during_capture_on_gpu():
    """Walk, DQ and fused statements on eight threads while a ninth
    captures a plan not seen before: every result equals its serial
    answer, and no capture is invalidated."""
    _need_gpu()
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database, execute_plan, to_host
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import Catalog, plan_select_full
    from ydb_tpu_torch.ssa import plan_fuse
    from ydb_tpu_torch.workload import clickbench
    from ydb_tpu_torch.workload.queries import TPCH

    data = tpch.TpchData(sf=0.01, seed=11)
    cb = clickbench.ClickBenchData(rows=20_000, seed=42)
    sources = {t: ColumnSource(c, data.schema(t), data.dicts)
               for t, c in data.tables.items()}
    db = Database(sources=sources, dicts=data.dicts, device="cuda")
    cdb = Database(sources={"hits": ColumnSource(
        cb.hits, clickbench.HITS_SCHEMA, cb.dicts)}, dicts=cb.dicts,
        device="cuda")
    cat = Catalog(schemas={t: data.schema(t) for t in data.tables},
                  primary_keys=dict(tpch.PRIMARY_KEYS), dicts=data.dicts)
    ccat = Catalog(schemas={"hits": clickbench.HITS_SCHEMA},
                   primary_keys={"hits": ("WatchID",)}, dicts=cb.dicts)
    stmts = {
        "walk": (plan_select_full(parse(TPCH["q1"]), cat).plan, db,
                 {"use_dq": False}),
        "dq": (plan_select_full(parse(TPCH["q3"]), cat).plan, db, {}),
        "fused": (plan_select_full(parse(clickbench.QUERIES["q33"]),
                                   ccat).plan, cdb, {}),
    }
    fresh = plan_select_full(parse(
        "select URL, count(*) as c from hits where RegionID <> 0 "
        "group by URL order by c desc, URL limit 12"), ccat).plan
    saved = plan_fuse.FUSE_FORCE

    def run(name):
        plan, d, kw = stmts[name]
        return to_host(execute_plan(plan, d, **kw))

    plan_fuse.FUSE_FORCE = None
    try:
        want = {k: run(k) for k in stmts}
        errors, got = [], []
        barrier = threading.Barrier(9)

        def worker(i):
            try:
                barrier.wait()
                for k in range(6):
                    name = list(stmts)[(i + k) % 3]
                    got.append((name, run(name)))
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)

        out = []

        def capturer():
            try:
                barrier.wait()
                out.append(to_host(execute_plan(fresh, cdb)))
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)] + [threading.Thread(target=capturer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errors, errors
        for name, res in got:
            _same_result(res, want[name])
        _same_result(out[0], to_host(execute_plan(fresh, cdb)))
    finally:
        plan_fuse.FUSE_FORCE = saved


# ---------------- leak sanitizer drain ----------------

def test_batched_path_drains_under_leaksan(cluster):
    """Batch seats and staging flights all close — including the seat
    abandoned by a deadline-cancelled member (the reference's
    ``tests/test_batching.py:402``)."""
    with leaksan.activate():
        n = 3
        errors = [None] * n
        barrier = threading.Barrier(n)

        def work(i):
            s = cluster.session()
            barrier.wait()
            try:
                s.execute(Q1_SQL, timeout=(0.1 if i == n - 1 else None))
            except StatementCancelled:
                pass  # expected for the doomed member
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors[i] = e

        with _armed(cluster, window_ms=400, max_batch=n):
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
        assert errors == [None] * n
        counts = leaksan.counts()
        assert counts.get("batch.member", 0) == 0
        assert counts.get("scanshare.flight", 0) == 0
        leaksan.assert_drained(
            kinds=("batch.member", "scanshare.flight"),
            where="after batched burst")
