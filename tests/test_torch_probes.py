"""The port's probe registry, ``StageTimer``, ``memory_stats``
(``ydb_tpu_torch/obs/probes.py``) and tablet counters
(``ydb_tpu_torch/obs/tablet_counters.py``) against the reference's.

Exact: the set of probe names a glob-attached session sees fire during
a shard commit and scan, and ``tablet_counters.collect`` / ``aggregate``
of a Cluster after the same statements, equal the reference's. Besides:
sessions attach and detach by glob with predicates, the registry's lock
is the always-on tracked one, a ``StageTimer`` charge lands on the
timeline, ``memory_stats()`` on the CPU has ``vmrss_mb`` and no device
keys (and starts no CUDA context), and the engine probes the port adds
(``resident.promote`` / ``resident.evict``, ``stats.aggregator.refresh``,
``kqp.plan_cache``, ``query.slow``, ``blob.retry``, ``chaos.fault``)
fire where the reference's do."""

import sys
import time
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.obs import probes as rprobes
from ydb_tpu.obs import tablet_counters as rtc

from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.obs import tablet_counters as tc
from ydb_tpu_torch.obs import timeline
from ydb_tpu_torch.obs.probes import (
    StageTimer,
    TraceSession,
    list_probes,
    memory_stats,
    probe,
)


@pytest.fixture(autouse=True)
def _pallas_stub(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def test_probe_sessions_collect_and_detach():
    p = probe("ttest.alpha")
    q = probe("ttest.beta")
    assert not p  # nothing attached: fire is near-free
    p.fire(x=1)
    with TraceSession("ttest.*") as sess:
        assert p and q
        p.fire(x=1)
        p.fire(x=2)
        q.fire(y=9)
    assert not p
    p.fire(x=3)  # not recorded
    assert sess.counts == {"ttest.alpha": 2, "ttest.beta": 1}
    assert list(sess.events) == [("ttest.alpha", {"x": 1}),
                                 ("ttest.alpha", {"x": 2}),
                                 ("ttest.beta", {"y": 9})]
    assert "ttest.alpha" in list_probes()
    assert probe("ttest.alpha") is p  # get-or-create


def test_probe_predicate_and_capacity():
    p = probe("ttest.gamma")
    with TraceSession("ttest.gamma", capacity=2,
                      predicate=lambda n, kw: kw["x"] > 5) as sess:
        for x in (1, 10, 11, 12):
            p.fire(x=x)
    assert sess.counts["ttest.gamma"] == 3
    assert [kw["x"] for _, kw in sess.events] == [11, 12]


def test_registry_lock_is_tracked():
    from ydb_tpu_torch.analysis import sanitizer
    from ydb_tpu_torch.obs import probes

    assert isinstance(probes._lock, sanitizer.TrackedLock)
    assert isinstance(probes._registry, sanitizer.ShareProxy)


def test_stage_timer_charges_land_on_the_timeline():
    t = StageTimer()
    prev = timeline.TIMELINE_FORCE
    timeline.TIMELINE_FORCE = True
    timeline.RING.clear()
    try:
        t.add("read", 0.25, morsel=3)
        with t.stage("compute"):
            time.sleep(0.002)
        evs = timeline.RING.events()
    finally:
        timeline.TIMELINE_FORCE = prev
        timeline.RING.clear()
    assert [(e.name, e.cat) for e in evs] == [("stage.read", "read"),
                                              ("stage.compute", "compute")]
    assert evs[0].end - evs[0].start == pytest.approx(0.25)
    assert evs[0].args == {"morsel": 3}
    snap = t.snapshot()
    assert snap["read"] == 0.25 and snap["compute"] >= 0.002
    assert snap["merge"] == snap["stage"] == 0.0


def test_memory_stats_on_the_cpu():
    import torch

    st = memory_stats()
    assert st["vmrss_mb"] > 0
    assert st["vmhwm_mb"] >= st["vmrss_mb"] * 0.5
    assert not any(k.startswith("device") for k in st)
    assert not torch.cuda.is_initialized()


def _shard_probe_names(pkg):
    """Probe names a ``*`` session sees fire over one shard's commit,
    scan and compaction in ``pkg``."""
    import importlib

    dtypes = importlib.import_module(f"{pkg}.dtypes")
    blobs = importlib.import_module(f"{pkg}.engine.blobs")
    shard_mod = importlib.import_module(f"{pkg}.engine.shard")
    probes = importlib.import_module(f"{pkg}.obs.probes")
    ssa = importlib.import_module(f"{pkg}.ssa")
    schema = dtypes.schema(("id", dtypes.INT64, False),
                           ("v", dtypes.INT64))
    kw = {"device": "cpu"} if pkg == "ydb_tpu_torch" else {}
    shard = shard_mod.ColumnShard(
        "probe_s", schema, blobs.MemBlobStore(), pk_column="id",
        upsert=True,
        config=shard_mod.ShardConfig(compact_portion_threshold=10 ** 9),
        **kw)
    prog = ssa.Program((ssa.GroupByStep(keys=(), aggs=(
        ssa.AggSpec(ssa.Agg.COUNT_ALL, None, "n"),)),))
    with probes.TraceSession("*") as sess:
        for base in (0, 5):
            wid = shard.write({"id": np.arange(base, base + 10,
                                               dtype=np.int64),
                               "v": np.ones(10, dtype=np.int64)})
            shard.commit([wid])
        out = shard.scan(prog)
        shard.config.compact_portion_threshold = 1
        shard.compact()
    scan = [kw for n, kw in sess.events if n == "columnshard.scan"][0]
    return sess.counts, scan, int(out.cols["n"][0][0])


def test_shard_probes_fire_as_in_the_reference():
    got, gscan, gn = _shard_probe_names("ydb_tpu_torch")
    want, wscan, wn = _shard_probe_names("ydb_tpu")
    assert set(got) == set(want)
    assert dict(got) == dict(want)
    assert {"columnshard.commit", "columnshard.scan",
            "columnshard.scan.stages", "columnshard.scan.pruning",
            "columnshard.compact"} <= set(got)
    assert gscan == wscan
    assert gn == wn == 15


def _ddl(c):
    s = c.session()
    s.execute("CREATE TABLE kv (k Int64 NOT NULL, v Int64, "
              "PRIMARY KEY (k)) WITH (shards = 2)")
    s.execute("CREATE TABLE kw (k Int64 NOT NULL, w Utf8, "
              "PRIMARY KEY (k)) WITH (shards = 3)")
    s.execute("INSERT INTO kv VALUES (1, 10), (2, 20), (3, 30)")
    s.execute("DROP TABLE kw")
    return s


def test_tablet_counters_equal_reference():
    from ydb_tpu.kqp.session import Cluster as RCluster

    port, ref = Cluster(device="cpu"), RCluster()
    try:
        _ddl(port)
        _ddl(ref)
        assert tc.collect(port) == rtc.collect(ref)
        got = tc.aggregate(port)
        assert got == rtc.aggregate(ref)
        assert got and all(v["tablets"] >= 1 for v in got.values())
        assert tc.aggregate(port, tc.collect(port)) == got
        assert tc.tablet_type("ds/7/1") == rtc.tablet_type("ds/7/1") == "ds"
    finally:
        port.stop()
        ref.stop()


def test_session_probes_plan_cache_and_slow(monkeypatch):
    c = Cluster(device="cpu")
    try:
        s = c.session()
        s.execute("CREATE TABLE kv (k Int64 NOT NULL, v Int64, "
                  "PRIMARY KEY (k)) WITH (shards = 1)")
        s.execute("INSERT INTO kv VALUES (1, 10), (2, 20)")
        with TraceSession("kqp.plan_cache") as pc:
            s.execute("SELECT sum(v) AS s FROM kv")
            s.execute("SELECT sum(v) AS s FROM kv")
        assert [kw for _, kw in pc.events] == [{"hit": False},
                                              {"hit": True}]
        monkeypatch.setenv("YDB_TPU_TORCH_SLOW_QUERY_SECONDS", "0.5")
        with TraceSession("query.slow") as slow:
            tok = c._register_active("SELECT slow", time.monotonic() - 2.0)
            try:
                assert c.check_slow_queries() == 1
                assert c.check_slow_queries() == 0  # latched
            finally:
                c._unregister_active(tok)
        assert slow.counts["query.slow"] == 1
        _, params = slow.events[0]
        assert params["elapsed"] >= 0.5 and params["sql"] == "SELECT slow"
        with TraceSession("stats.aggregator.refresh") as st:
            c.run_background()
        assert st.counts["stats.aggregator.refresh"] >= 1
        assert {kw["table"] for _, kw in st.events} == {"kv"}
    finally:
        c.stop()


def test_resident_promote_and_evict_probes():
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.engine import resident as resident_mod
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard
    from ydb_tpu_torch.ssa import Agg, AggSpec, GroupByStep, Program

    schema = dtypes.schema(("id", dtypes.INT64, False),
                           ("val", dtypes.INT64))
    prev = resident_mod.RESIDENT_FORCE
    resident_mod.RESIDENT_FORCE = True
    try:
        shard = ColumnShard("pres", schema, MemBlobStore(),
                            pk_column="id", device="cpu")
        # a budget of one portion (100 rows x 2 columns x 9 bytes): the
        # second promotion evicts the first
        shard.resident._budget = 1800
        for base in (0, 100):
            shard.commit([shard.write({
                "id": np.arange(base, base + 100, dtype=np.int64),
                "val": np.arange(100, dtype=np.int64)})])
        prog = Program((GroupByStep(keys=(), aggs=(
            AggSpec(Agg.SUM, "val", "s"),)),))
        with TraceSession("resident.*") as sess:
            for _ in range(3):
                shard.scan(prog)
            shard.resident.drain()
        assert sess.counts["resident.promote"] >= 1
        assert sess.counts["resident.evict"] >= 1
        promote = [kw for n, kw in sess.events if n == "resident.promote"]
        assert set(promote[0]) == {"store", "portion", "nbytes", "evicted"}
    finally:
        resident_mod.RESIDENT_FORCE = prev


def test_retry_and_fault_probes():
    from ydb_tpu_torch import chaos
    from ydb_tpu_torch.chaos import retry
    from ydb_tpu_torch.obs import tracing

    chaos.CHAOS_FORCE = True
    chaos.install(chaos.Scenario(seed=1, sites={
        "blob.get": {"kind": "io_error", "budget": 1}}))
    probe("blob.retry")
    probe("chaos.fault")
    try:
        tr = tracing.Tracer()
        root = tr.trace("q")
        with TraceSession("*") as sess, tracing.activate(root):
            calls = []

            def read():
                calls.append(1)
                if chaos.hit("blob.get", blob="b") is not None:
                    raise chaos.InjectedIOError("injected")
                return b"ok"

            pol = retry.RetryPolicy(base_delay=0.0, jitter=0.0)
            assert pol.call(read, site="blob.get") == b"ok"
        root.finish()
    finally:
        chaos.clear()
        chaos.CHAOS_FORCE = None
    assert sess.counts["chaos.fault"] == 1
    assert sess.counts["blob.retry"] == 1
    _, kw = next(e for e in sess.events if e[0] == "blob.retry")
    assert kw == {"site": "blob.get", "attempt": 1,
                  "error": "InjectedIOError"}
    assert root.attrs["retries"] == 1 and root.attrs["chaos_faults"] == 1
    assert len(calls) == 2


def test_reference_probe_api_is_mirrored():
    for name in ("Probe", "probe", "list_probes", "TraceSession",
                 "StageTimer", "memory_stats"):
        assert hasattr(rprobes, name)
    assert StageTimer.STAGES == rprobes.StageTimer.STAGES
