"""The port's sync sanitizer (``ydb_tpu_torch/analysis/syncsan.py``): env
gate, torch seams patched only while armed and restored on disarm,
attribution across threads, warm budgets, the profile and EXPLAIN
ANALYZE surfaces, and the restated warm Q1/Q6 acceptance budget of
``tests/test_syncsan.py`` through a port ``Session`` on the CPU.

On the CPU "the device" is the CPU: a tensor becoming a host value
(``.item``, ``.tolist``, ``.numpy``) counts one D2H copy and one sync,
as the reference's CPU tests count ``np.asarray`` of a jax array; the
CUDA sync debug mode sees nothing here, so ``debug_syncs`` stays 0 and
the card's phase 11 (``chip_smoke.py``) reports it.

Tolerance: none (counts compare exactly)."""

import threading
import warnings

import numpy as np
import pytest
import torch

from ydb_tpu_torch.analysis import syncsan
from ydb_tpu_torch.obs import tracing

#: the reference's warm budget (tests/test_syncsan.py:20): blocking syncs
#: per warm statement; captures, builds and compiles must be 0
WARM_SYNC_BUDGET = 2


def _seams():
    return (torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
            torch.Tensor.cpu, torch.Tensor.to, torch.Tensor.cuda,
            torch.Tensor.copy_, torch.from_numpy, torch.as_tensor,
            torch.cuda.synchronize, torch.cuda.Event.synchronize,
            torch.cuda.Stream.synchronize, warnings.showwarning)


@pytest.fixture(autouse=True)
def _clean():
    """Unpin, drop budgets and restore every seam around each test (the
    tier-1 run shares worker processes between test files)."""
    before = _seams()
    syncsan.set_force(None)
    syncsan.clear_budget()
    syncsan.reset()
    yield
    syncsan.set_force(None)
    syncsan.clear_budget()
    syncsan.reset()
    assert _seams() == before


def test_disabled_is_a_noop():
    syncsan.set_force(False)
    assert syncsan.begin_statement("q") is None
    assert syncsan.end_statement(None) is None
    syncsan.discard(None)
    syncsan.count(compiles=1)
    assert not syncsan.installed()


def test_env_gate(monkeypatch):
    monkeypatch.setenv("YDB_TPU_TORCH_SYNCSAN", "1")
    assert syncsan.enabled()
    monkeypatch.setenv("YDB_TPU_TORCH_SYNCSAN", "0")
    assert not syncsan.enabled()
    syncsan.set_force(True)
    assert syncsan.enabled()  # pin beats env
    assert syncsan.installed()
    syncsan.set_force(None)
    assert not syncsan.installed()


def test_seams_restored_on_disarm():
    before = _seams()
    with syncsan.activate():
        assert torch.Tensor.item is not before[0]
        assert torch.from_numpy is not before[7]
        assert torch.cuda.synchronize is not before[9]
    assert _seams() == before


def test_seam_counters_attribute_to_statement():
    host = np.arange(8)
    with syncsan.activate():
        st = syncsan.begin_statement("q")
        t = torch.from_numpy(host)          # H2D (host data in)
        t.sum().item()                      # D2H + sync
        t.tolist()                          # D2H + sync
        torch.as_tensor(host)               # H2D
        t.cpu()                             # same device: nothing
        t.to(torch.int32)                   # a dtype change: nothing
        syncsan.count(compiles=1)
        snap = syncsan.end_statement(st)
    assert snap == {"h2d": 2, "d2h": 2, "syncs": 2, "debug_syncs": 0,
                    "captures": 0, "builds": 0, "compiles": 1}


def test_batched_fetch_counts_once():
    """``host_columns`` moves every column in one fetch: one D2H copy
    and one sync, however many tensors (the reference's one
    ``jax.device_get`` of a whole block)."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.blocks.block import TableBlock

    sch = dtypes.schema(("a", dtypes.INT64, False), ("b", dtypes.INT64))
    blk = TableBlock.from_numpy({"a": np.arange(5), "b": np.arange(5)},
                                sch, device="cpu")
    with syncsan.activate():
        st = syncsan.begin_statement("fetch")
        blk.host_columns()
        snap = syncsan.end_statement(st)
    assert (snap["d2h"], snap["syncs"]) == (1, 1)


def test_debug_mode_warning_counts_apart():
    """The CUDA sync debug mode's warnings go through the ``showwarning``
    hook to the warning thread's statement as ``debug_syncs``; other
    warnings pass through untouched."""
    with syncsan.activate():
        st = syncsan.begin_statement("q")
        warnings.showwarning(UserWarning(syncsan.SYNC_WARNING), UserWarning,
                             __file__, 1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            warnings.warn("unrelated")
        snap = syncsan.end_statement(st)
    assert snap["debug_syncs"] == 1 and snap["syncs"] == 0
    assert [str(w.message) for w in caught] == ["unrelated"]


def test_attribution_across_threads():
    """Each thread's statement gets only its own counts; a worker that
    inherited the statement's span (``tracing.wrap_current``) resolves
    through the trace-id registry; anything else is an orphan."""
    t = torch.arange(4)
    tracer = tracing.Tracer()
    with syncsan.activate():
        results = {}
        barrier = threading.Barrier(2)

        def statement(name, n):
            st = syncsan.begin_statement(name)
            barrier.wait()
            for _ in range(n):
                t.sum().item()
            results[name] = syncsan.end_statement(st)

        threads = [threading.Thread(target=statement, args=(f"s{n}", n))
                   for n in (1, 3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert results["s1"]["syncs"] == 1 and results["s3"]["syncs"] == 3

        with tracer.trace("query") as sp:
            st = syncsan.begin_statement("traced", trace_id=sp.trace_id,
                                         span=sp)
            with tracing.activate(sp):
                work = tracing.wrap_current(lambda: t.tolist())
            done = threading.Thread(target=work)
            syncsan._tls.stat = None  # only the registry resolves it
            done.start()
            done.join()
            syncsan._tls.stat = st
            snap = syncsan.end_statement(st)
        assert snap["syncs"] == 1
        assert sp.attrs["syncsan_syncs"] == 1

        orphan = threading.Thread(target=lambda: t.sum().item())
        orphan.start()
        orphan.join()
        assert syncsan.totals()["syncs"] == 1  # the orphan window


def test_warm_budget_enforced_past_warmup():
    t = torch.arange(4)
    with syncsan.activate(budget=syncsan.Budget(compiles=0, syncs=1,
                                                warmup=1)):
        st = syncsan.begin_statement("q")
        syncsan.count(captures=1, compiles=1)
        t.sum().item()
        t.sum().item()
        syncsan.end_statement(st)  # the free pass
        st = syncsan.begin_statement("q")
        t.sum().item()
        syncsan.end_statement(st)  # within budget
        for kind in ("captures", "builds", "compiles"):
            st = syncsan.begin_statement("q")
            syncsan.count(**{kind: 1})
            with pytest.raises(syncsan.SyncBudgetError, match=kind):
                syncsan.end_statement(st)
        st = syncsan.begin_statement("q")
        t.sum().item()
        t.sum().item()
        with pytest.raises(syncsan.SyncBudgetError, match="blocked"):
            syncsan.end_statement(st)


def test_sites_report_compiles():
    """``compile_program`` reports each call; a plan-cached statement
    compiles nothing the second time."""
    from ydb_tpu_torch.workload import tpch

    from ydb_tpu_torch.ssa.compiler import compile_program

    with syncsan.activate():
        st = syncsan.begin_statement("c")
        compile_program(tpch.q6_program(), tpch.LINEITEM_SCHEMA)
        assert syncsan.end_statement(st)["compiles"] == 1


# ---------------- the session surfaces ----------------


def _kv_cluster():
    from ydb_tpu_torch.kqp.session import Cluster

    c = Cluster(device="cpu")
    s = c.session()
    s.execute("create table kv (k bigint not null, v bigint, "
              "primary key (k))")
    s.execute("insert into kv values (1, 10), (2, 20), (3, 30)")
    return c


def test_profile_and_explain_analyze_surface():
    c = _kv_cluster()
    try:
        s = c.session()
        s.execute("select sum(v) as s from kv")
        assert s.last_profile.syncsan == {}  # disarmed: nothing
        with syncsan.activate():
            s.execute("select sum(v) as s from kv")
            prof = s.last_profile.syncsan
            assert set(prof) == set(syncsan.FIELDS)
            assert prof["syncs"] >= 1 and prof["d2h"] >= 1
            text = s.execute("explain analyze select sum(v) as s from kv")
            line = next(ln for ln in str(text).splitlines()
                        if ln.startswith("syncsan:"))
            assert "captures=" in line and "compiles=" in line
    finally:
        c.stop()


def test_budget_breach_is_a_statement_error():
    c = _kv_cluster()
    try:
        with syncsan.activate(budget=syncsan.Budget(compiles=0, syncs=0,
                                                    warmup=0)):
            s = c.session()
            with pytest.raises(syncsan.SyncBudgetError):
                s.execute("select sum(v) as s from kv")
            syncsan.clear_budget()
            # the session survives the breach
            out = s.execute("select sum(v) as s from kv")
            assert int(out.cols["s"][0][0]) == 60
    finally:
        c.stop()


def test_warm_q1_q6_zero_compiles_bounded_syncs():
    """The reference's acceptance budget restated for the port: warm
    TPC-H Q1/Q6 through a port ``Session`` make ZERO captures, kernel
    builds and ``compile_program`` calls and at most WARM_SYNC_BUDGET
    seam syncs — enforced by the sanitizer's own budget, so a regression
    raises SyncBudgetError out of ``execute`` here."""
    from test_torch_batching import _lineitem_cluster
    from test_sql import Q1_SQL, Q6_SQL

    c = _lineitem_cluster()
    budget = syncsan.Budget(compiles=0, syncs=WARM_SYNC_BUDGET, warmup=1)
    try:
        with syncsan.activate(budget=budget):
            for name, sql in (("q1", Q1_SQL), ("q6", Q6_SQL)):
                snaps = []
                for _ in range(3):
                    s = c.session()
                    s.execute(sql)
                    snaps.append(dict(s.last_profile.syncsan))
                cold, warm = snaps[0], snaps[1:]
                assert cold["compiles"] >= 1, (name, cold)
                for snap in warm:
                    assert snap["captures"] == snap["builds"] == \
                        snap["compiles"] == 0, (name, snap)
                    assert 1 <= snap["syncs"] <= WARM_SYNC_BUDGET, \
                        (name, snap)
                    assert snap["d2h"] == 1, (name, snap)  # one fetch
    finally:
        c.stop()
