"""The port's memory sanitizer (``ydb_tpu_torch/analysis/memsan.py``): env
gate, torch creators patched only while armed and restored on disarm,
charge/release ledgers, a dispatch's working set under ``seam()`` (the
torch analog of the reference's tracer exemption), attribution across
threads, budgets, the charging seams of the port's modules, the profile
and EXPLAIN ANALYZE surfaces and ``run_background``'s devmem counters,
and the restated warm Q1/Q6 acceptance budget of ``tests/test_memsan.py``
through a port ``Session`` on the CPU (there "the device" is the CPU).

Tolerance: none (bytes and counts compare exactly)."""

import threading

import numpy as np
import pytest
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import memsan
from ydb_tpu_torch.obs.tracing import Tracer
from ydb_tpu_torch.obs.tracing import activate as span_activate

#: the reference's warm peak budget (tests/test_memsan.py:27)
WARM_PEAK_BUDGET = 64 * 1024 * 1024


def _creators():
    return tuple(getattr(torch, n) for n in memsan._PATCH)


@pytest.fixture(autouse=True)
def _clean():
    before = _creators()
    memsan.set_force(None)
    memsan.clear_budget()
    memsan.reset()
    yield
    memsan.set_force(None)
    memsan.clear_budget()
    memsan.reset()
    assert _creators() == before


def test_disabled_is_a_noop():
    memsan.set_force(False)
    assert not memsan.armed()
    assert memsan.begin_statement("q") is None
    assert memsan.charge(10, "staging") is None
    memsan.release(None)
    with memsan.seam():
        pass
    assert not memsan.installed()


def test_env_gate(monkeypatch):
    monkeypatch.setenv("YDB_TPU_TORCH_MEMSAN", "1")
    assert memsan.enabled()
    monkeypatch.setenv("YDB_TPU_TORCH_MEMSAN", "0")
    assert not memsan.enabled()
    memsan.set_force(True)
    assert memsan.installed()
    memsan.set_force(None)
    assert not memsan.installed()


def test_creators_restored_on_disarm():
    before = _creators()
    with memsan.activate():
        assert torch.zeros is not before[0]
    assert _creators() == before


def test_unbudgeted_vs_seam_vs_compute():
    with memsan.activate():
        st = memsan.begin_statement("q")
        loose = torch.zeros(64, dtype=torch.int64)   # unbudgeted
        with memsan.seam():
            torch.ones(128)                          # seam: silent
        memsan.computing(torch.cat)([loose, loose])  # working set
        t = memsan.charge(100, "staging")
        memsan.release(t)
        memsan.release(t)  # idempotent
        snap = memsan.end_statement(st)
    assert snap["unbudgeted"] == 1
    assert snap["unbudgeted_bytes"] == 64 * 8
    assert snap["by_component"] == {"unbudgeted": 512, "staging": 100}
    assert snap["peak"] == 612 and snap["live"] == 512


def test_host_to_device_outside_a_seam_is_unbudgeted(monkeypatch):
    """The H2D seams (syncsan's patches, installed for memsan alone) note
    the device tensor they make: ``Tensor.to(device)`` (here the meta
    device stands in for CUDA), ``torch.as_tensor``, ``torch.tensor`` and
    ``torch.from_numpy`` onto the device outside a seam are unbudgeted,
    the same calls inside one are not — the reference's ``device_put``
    patch. Disarming restores every seam."""
    from ydb_tpu_torch.analysis import syncsan

    orig = (torch.Tensor.to, torch.as_tensor, torch.tensor,
            torch.from_numpy)
    host = np.arange(16, dtype=np.int32)
    with memsan.activate():
        assert syncsan.installed() and not syncsan.enabled()
        monkeypatch.setattr(memsan, "_device_type", "meta")
        monkeypatch.setattr(syncsan, "_device_type", "meta")
        st = memsan.begin_statement("q")
        torch.ones(8, dtype=torch.int64).to("meta")   # 64 bytes
        with memsan.seam():
            torch.ones(8).to(device="meta")            # seam: silent
        snap = memsan.end_statement(st)
        assert snap["unbudgeted"] == 1
        assert snap["unbudgeted_bytes"] == 64
        monkeypatch.setattr(memsan, "_device_type", "cpu")
        monkeypatch.setattr(syncsan, "_device_type", "cpu")
        st = memsan.begin_statement("q")
        torch.as_tensor(host)                          # 64 bytes
        torch.tensor([1, 2, 3, 4], dtype=torch.int64)  # 32 bytes
        torch.from_numpy(host)                         # 64 bytes
        torch.as_tensor(torch.zeros(2))  # already there: no copy
        with memsan.seam():
            torch.as_tensor(host)
            torch.tensor([5, 6])
        snap = memsan.end_statement(st)
    assert snap["unbudgeted"] == 4  # the zeros(2) creator included
    assert snap["unbudgeted_bytes"] == 64 + 32 + 64 + 8
    assert not syncsan.installed()
    assert (torch.Tensor.to, torch.as_tensor, torch.tensor,
            torch.from_numpy) == orig


@pytest.mark.cuda
def test_host_to_device_on_the_card_is_unbudgeted():
    """On the card: ``Tensor.to("cuda")``, ``.cuda()`` and
    ``torch.as_tensor(..., device="cuda")`` outside a seam are
    unbudgeted, inside one silent; a host-only ``torch.from_numpy`` is
    no device allocation."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    host = torch.arange(16, dtype=torch.int32)
    with memsan.activate():
        st = memsan.begin_statement("q")
        host.to("cuda")                                   # 64 bytes
        host.cuda()                                       # 64 bytes
        torch.as_tensor(np.zeros(4), device="cuda")       # 32 bytes
        torch.from_numpy(np.zeros(4))                     # host
        with memsan.seam():
            host.to("cuda")
            torch.tensor([1, 2], device="cuda")
        snap = memsan.end_statement(st)
    assert snap["unbudgeted"] == 3
    assert snap["unbudgeted_bytes"] == 64 + 64 + 32


def test_nbytes_of_walks_tensors_and_blocks():
    from ydb_tpu_torch.blocks.block import TableBlock

    sch = dtypes.schema(("a", dtypes.INT64, False), ("b", dtypes.INT32))
    blk = TableBlock.from_numpy({"a": np.arange(3), "b": np.arange(3)},
                                sch, capacity=8, device="cpu")
    # 8 x (8 + 1) + 8 x (4 + 1) data and validity, + the int32 length
    assert memsan.nbytes_of(blk) == 8 * 9 + 8 * 5 + 4
    assert memsan.nbytes_of({"x": [torch.zeros(2), 3]}) == 8


def test_trace_id_attribution_across_threads():
    with memsan.activate():
        tr = Tracer()
        root = tr.trace("query")
        st = memsan.begin_statement("q", trace_id=root.trace_id)

        def worker():
            with span_activate(root):
                memsan.charge(4096, "staging", owner="worker")

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        snap = memsan.end_statement(st)
        root.finish()
    assert snap["by_component"] == {"staging": 4096}


def test_unattributed_charges_land_in_orphans():
    with memsan.activate():
        torch.zeros(64)
        tot = memsan.totals()
    assert tot["unbudgeted"] >= 1 and tot["charges"] >= 1


def test_unbudgeted_alloc_raises_past_warmup():
    with memsan.activate(budget=memsan.Budget(warmup=1)):
        st = memsan.begin_statement("q")
        torch.zeros(32)
        memsan.end_statement(st)  # warmup: free pass
        st = memsan.begin_statement("q")
        torch.zeros(32)
        with pytest.raises(memsan.MemBudgetError, match="outside any"):
            memsan.end_statement(st)


def test_peak_budget_raises_and_names_components():
    with memsan.activate(budget=memsan.Budget(peak_bytes=100, warmup=0)):
        st = memsan.begin_statement("q")
        memsan.charge(200, "staging")
        with pytest.raises(memsan.MemBudgetError, match="peaked at"):
            memsan.end_statement(st)
        st = memsan.begin_statement("q")
        memsan.charge(999, "staging")
        memsan.discard(st)  # error path: no raise


# ---------------- the port's charging seams ----------------


def test_staging_seams_charge():
    from ydb_tpu_torch.blocks.block import (TableBlock, concat_blocks,
                                            device_aux)
    from ydb_tpu_torch.engine.staging import Stager

    sch = dtypes.schema(("a", dtypes.INT64, False))
    with memsan.activate():
        st = memsan.begin_statement("q")
        b = TableBlock.from_numpy({"a": np.arange(5)}, sch, device="cpu")
        Stager("cpu").from_numpy({"a": np.arange(5)}, {}, sch, 1024)
        concat_blocks([b, b])
        device_aux({"m": np.arange(4, dtype=np.int64)}, "cpu")
        snap = memsan.end_statement(st)
        assert memsan.component_totals()["staging"]["charges"] == 4
    assert snap["unbudgeted"] == 0
    # from_numpy, the stager's block (1024 rows), the 2-block concat
    # (1024 rows) and the 32-byte aux table
    assert snap["by_component"] == {
        "staging": memsan.nbytes_of(b) * 3 + 32}


def test_resident_promotion_charges_and_evictions_release():
    from ydb_tpu_torch.engine.resident import ResidentStore

    with memsan.activate():
        rs = ResidentStore("t", budget=1 << 20, device="cpu")
        cols = {"a": np.arange(1000, dtype=np.int64)}
        st = memsan.begin_statement("q")
        assert rs.promote(1, 1000, cols, None)
        snap = memsan.end_statement(st)
        assert snap["by_component"] == {"resident": 1000 * 9}
        assert snap["unbudgeted"] == 0
        rs.invalidate([1])
        comp = memsan.component_totals()["resident"]
        assert comp["live"] == 0 and comp["evictions"] == 1
        assert rs.promote(2, 1000, cols, None)
        rs.clear()
        assert memsan.component_totals()["resident"]["live"] == 0


def test_fused_plan_charges_dispatch_and_stack():
    """A fused plan on the CPU runs ``run_all`` under ``seam()``: its
    output is charged as ``dispatch``, a stacked batch's member copies as
    ``stack`` (released after the dispatch), nothing unbudgeted."""
    from test_torch_batching import _two_lineitem_dbs

    from ydb_tpu_torch.plan import executor
    from ydb_tpu_torch.plan.nodes import TableScan
    from ydb_tpu_torch.ssa import plan_fuse
    from ydb_tpu_torch.workload import tpch

    db = _two_lineitem_dbs("cpu")[0]
    plan = TableScan("lineitem", program=tpch.q6_program())
    sig = plan_fuse.plan_signature(plan, db)
    fp = plan_fuse.build(sig, db)
    inputs = {s.key: executor._stage_fused_site(s, db) for s in sig.sites}
    with memsan.activate():
        st = memsan.begin_statement("q")
        out, _ = fp.run(inputs)
        fp.run_stacked([inputs, inputs])
        snap = memsan.end_statement(st)
        comps = memsan.component_totals()
    assert snap["unbudgeted"] == 0
    assert comps["dispatch"]["charges"] == 2
    assert comps["stack"]["live"] == 0 and comps["stack"]["releases"] == 1
    assert memsan.nbytes_of(out) <= comps["dispatch"]["peak"]


# ---------------- the session surfaces ----------------


def _kv_cluster():
    from ydb_tpu_torch.kqp.session import Cluster

    c = Cluster(device="cpu")
    s = c.session()
    s.execute("create table dm (id bigint not null, v bigint, "
              "primary key (id))")
    s.execute("insert into dm values (1, 2), (2, 4)")
    return c


def test_profile_explain_analyze_and_counters():
    c = _kv_cluster()
    try:
        with memsan.activate():
            s = c.session()
            s.execute("select sum(v) as sv from dm")
            p = s.last_profile
            assert set(p.memsan) == {"peak", "live", "charges",
                                     "unbudgeted"}
            assert p.memsan["unbudgeted"] == 0 and p.memsan["charges"] >= 1
            txt = s.execute("explain analyze select sum(v) as sv from dm")
            assert "memsan:" in txt and "unbudgeted=" in txt
            stats = c.run_background()
            assert stats["devmem_peak_bytes"] == memsan.global_peak() > 0
            g = c.counters.group(component="devmem", pool="staging")
            assert g.counter("charges").value >= 1
    finally:
        c.stop()


def test_warm_q1_q6_zero_unbudgeted_within_peak_budget():
    """The reference's acceptance gate restated for the port: warm TPC-H
    Q1/Q6 through the full port session path under the armed sanitizer
    make zero unbudgeted device allocations and peak within
    WARM_PEAK_BUDGET — enforced inside the session's ``end_statement``,
    so a regression raises MemBudgetError out of ``execute`` here."""
    from test_sql import Q1_SQL, Q6_SQL
    from test_torch_batching import _lineitem_cluster

    budget = memsan.Budget(peak_bytes=WARM_PEAK_BUDGET, warmup=1)
    c = _lineitem_cluster()
    try:
        with memsan.activate(budget=budget):
            for name, sql in (("q1", Q1_SQL), ("q6", Q6_SQL)):
                snaps = []
                for _ in range(3):
                    s = c.session()
                    s.execute(sql)
                    snaps.append(dict(s.last_profile.memsan))
                cold, warm = snaps[0], snaps[1:]
                assert cold["charges"] >= 1, (name, cold)
                assert cold["unbudgeted"] == 0, (name, cold)
                for snap in warm:
                    assert snap["unbudgeted"] == 0, (name, snap)
                    assert snap["peak"] <= WARM_PEAK_BUDGET, (name, snap)
    finally:
        c.stop()
