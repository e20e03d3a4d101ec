"""The port's data-movement timeline (``ydb_tpu_torch/obs/timeline.py``)
against the reference's (``ydb_tpu/obs/timeline.py``), and the hooks the
port threads into its engine.

Exact parity on the same inputs: ``merge_intervals``, ``union_seconds``,
``intersect_seconds``, ``occupancy_from_events``, ``export_chrome_trace``
and ``summary`` over one seeded event list (both round the same way;
the two modules' epochs are pinned equal), and ``movement_snapshot()``
after the same cold TPC-H Q1 over a ``MemBlobStore`` ColumnShard in each
package (``blob_read_bytes``, ``decoded_bytes``, ``staged_bytes``), on
the morsel pipeline and on the serialized path. Besides: the ring's
bound under concurrent writers, nothing recorded while the ring is off,
a warm statement's per-stage event sums equal to its profile stages
within 10% (the reference's acceptance tolerance), EXPLAIN ANALYZE's
``occupancy:`` line, conveyor wait/run intervals, the end-of-scan sync
taken only while the timeline is on, the spans earlier slices left out
(``ssa.compile``, ``shard.scan``, ``scan.producer``, ``dq.task``), the
``run_background`` export and the CLI demo on the CPU."""

import json
import sys
import threading
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.obs import timeline as rtl

from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.obs import timeline
from ydb_tpu_torch.obs.timeline import (
    Event,
    TimelineRing,
    export_chrome_trace,
    intersect_seconds,
    merge_intervals,
    occupancy_from_events,
    union_seconds,
)


@pytest.fixture(autouse=True)
def _pallas_stub(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


@pytest.fixture
def forced_timeline():
    """Timeline ON for the test, restored after (ring cleared both sides
    so other tests see a quiet ring)."""
    prev = timeline.TIMELINE_FORCE
    timeline.TIMELINE_FORCE = True
    timeline.RING.clear()
    yield timeline.RING
    timeline.TIMELINE_FORCE = prev
    timeline.RING.clear()


@pytest.fixture
def cluster():
    c = Cluster(device="cpu")
    s = c.session()
    s.execute("CREATE TABLE ev (id int64, v int64, "
              "PRIMARY KEY (id)) WITH (shards = 2)")
    for base in (0, 100, 200):
        vals = ", ".join(f"({base + i}, {(base + i) * 3})"
                         for i in range(8))
        s.execute(f"INSERT INTO ev VALUES {vals}")
    yield c
    c.stop()


# ---------- the ring ----------

def test_ring_bounds_and_order():
    r = TimelineRing(capacity=8, name="t_bounds")
    for i in range(20):
        r.record(f"e{i}", "read", float(i), float(i) + 0.5)
    assert (len(r), r.recorded, r.dropped) == (8, 20, 12)
    assert [e.name for e in r.events()] == [f"e{i}" for i in range(12, 20)]


def test_ring_concurrent_writers_stay_bounded():
    """Many threads on one small ring (a shortened switch interval): the
    bound holds, every retained slot is a complete Event, and the count
    equals the writes."""
    r = TimelineRing(capacity=64, name="t_conc")
    per_thread, n_threads = 500, 12
    start = threading.Barrier(n_threads)

    def writer(k):
        start.wait()
        for i in range(per_thread):
            r.record(f"w{k}.{i}", "read", float(i), float(i) + 1.0,
                     trace_id=k, args={"i": i})

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    assert r.recorded == per_thread * n_threads
    assert r.dropped == per_thread * n_threads - 64
    evs = r.events()
    assert len(evs) == 64
    for e in evs:
        assert isinstance(e, Event) and e.end > e.start
        assert e.args["i"] >= 0


def test_ring_clear_and_capacity_env(monkeypatch):
    r = TimelineRing(capacity=4, name="t_clear")
    r.record("a", "read", 0.0, 1.0)
    r.clear()
    assert len(r) == 0 and r.recorded == 0 and r.events() == []
    monkeypatch.setenv("YDB_TPU_TORCH_TIMELINE_EVENTS", "33")
    assert TimelineRing(name="t_env").capacity == 33


def test_disabled_ring_records_nothing(monkeypatch):
    monkeypatch.delenv("YDB_TPU_TORCH_TIMELINE", raising=False)
    prev = timeline.TIMELINE_FORCE
    timeline.TIMELINE_FORCE = None
    try:
        assert not timeline.timeline_enabled()
        before = timeline.RING.recorded
        timeline.record("x", "read", 0.0, 1.0)
        with timeline.event("y", "decode"):
            pass
        assert timeline.RING.recorded == before
        timeline.TIMELINE_FORCE = False
        monkeypatch.setenv("YDB_TPU_TORCH_TIMELINE", "1")
        assert not timeline.timeline_enabled()  # FORCE wins over env
        timeline.TIMELINE_FORCE = None
        assert timeline.timeline_enabled()
        monkeypatch.setenv("YDB_TPU_TORCH_TIMELINE", "off")
        assert not timeline.timeline_enabled()
    finally:
        timeline.TIMELINE_FORCE = prev


def test_disabled_statement_records_nothing(cluster):
    s = cluster.session()
    q = "SELECT id, sum(v) AS sv FROM ev GROUP BY id ORDER BY id"
    prev = timeline.TIMELINE_FORCE
    timeline.TIMELINE_FORCE = False
    try:
        before = timeline.RING.recorded
        s.execute(q)
        assert timeline.RING.recorded == before
        assert s.last_profile.stage_occupancy == {}
    finally:
        timeline.TIMELINE_FORCE = prev


# ---------- exact parity of the math and the export ----------

CATS = ("read", "merge", "stage", "compute", "blob.read", "decode",
        "span", "conveyor.wait", "conveyor.run", "dispatch")


def _events(mod, n=400, seed=17):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = float(rng.random() * 5.0)
        d = float(rng.exponential(0.05)) if i % 9 else 0.0
        out.append(mod.Event(f"ev{i % 13}", CATS[int(rng.integers(
            len(CATS)))], s, s + d, int(rng.integers(1, 4)),
            int(rng.integers(0, 3)), {"i": i} if i % 2 else {}))
    return out


def test_interval_math_equals_reference():
    assert merge_intervals([(0, 1), (2, 3), (0.5, 2.5)]) == [(0, 3)]
    assert union_seconds([(0, 1), (2, 3)]) == 2
    assert intersect_seconds([(0, 2)], [(1, 3)]) == 1
    assert intersect_seconds([(0, 1)], [(2, 3)]) == 0
    evs = _events(timeline)
    ivs = [(e.start, e.end) for e in evs]
    a, b = ivs[::2], ivs[1::2]
    assert merge_intervals(ivs) == rtl.merge_intervals(ivs)
    assert union_seconds(ivs) == rtl.union_seconds(ivs)
    assert intersect_seconds(a, b) == rtl.intersect_seconds(a, b)


@pytest.mark.parametrize("wall", [None, 7.5])
def test_occupancy_equals_reference(wall):
    got = occupancy_from_events(_events(timeline), wall)
    assert got == rtl.occupancy_from_events(_events(rtl), wall)
    assert "movement|compute" in got["overlap"]
    assert "span" not in got["busy"]


def test_occupancy_fixtures():
    serial = [Event("r", "read", 0.0, 1.0, 1, 1, {}),
              Event("c", "compute", 1.0, 2.0, 1, 1, {})]
    occ = occupancy_from_events(serial)
    assert occ["fraction"]["read"] == 0.5
    assert occ["overlap"] == {"compute|read": 0.0,
                              "movement|compute": 0.0}
    over = [Event("r1", "read", 0.0, 1.5, 1, 1, {}),
            Event("r2", "read", 1.0, 2.0, 2, 1, {}),
            Event("c", "compute", 1.0, 3.0, 3, 1, {})]
    occ = occupancy_from_events(over)
    assert occ["busy"]["read"] == 2.0
    assert occ["overlap"]["movement|compute"] == 0.5


def _filled(mod, name):
    r = mod.TimelineRing(capacity=300, name=name)
    for e in _events(mod):
        r.record(e.name, e.cat, e.start, e.end, e.trace_id, e.args)
    return r


def test_chrome_trace_and_summary_equal_reference(monkeypatch):
    monkeypatch.setattr(timeline, "_EPOCH", 1.25)
    monkeypatch.setattr(rtl, "_EPOCH", 1.25)
    monkeypatch.setattr(timeline, "TIMELINE_FORCE", True)
    monkeypatch.setattr(rtl, "TIMELINE_FORCE", True)
    r, rr = _filled(timeline, "t_par"), _filled(rtl, "t_par")
    assert export_chrome_trace(ring=r) == rtl.export_chrome_trace(ring=rr)
    evs = _events(timeline)[:50]
    assert (export_chrome_trace(evs, ring=r)
            == rtl.export_chrome_trace(_events(rtl)[:50], ring=rr))
    saved = (timeline.movement_snapshot(), rtl.movement_snapshot())
    try:
        for mod in (timeline, rtl):
            mod.reset_movement()
            mod.add_bytes("blob_read_bytes", 123)
            mod.add_bytes("staged_bytes", 7)
        assert timeline.summary(r) == rtl.summary(rr)
        assert timeline.summary(r)["dropped"] == 100
    finally:
        for mod, snap in zip((timeline, rtl), saved):
            mod.reset_movement()
            for k, v in snap.items():
                mod.add_bytes(k, v)


def test_chrome_trace_schema_round_trip():
    r = TimelineRing(capacity=16, name="t_chrome")
    r.record("stage.read", "read", 1.0, 2.0, trace_id=7,
             args={"bytes": 10})
    r.record("plan.dispatch", "dispatch", 2.0, 2.5)
    trace = json.loads(json.dumps(export_chrome_trace(ring=r)))
    assert trace["displayTimeUnit"] == "ms"
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    meta = [e for e in trace["traceEvents"] if e["ph"] == "M"]
    assert len(xs) == 2 and meta
    for e in xs:
        assert set(e) >= {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
    read = next(e for e in xs if e["name"] == "stage.read")
    assert read["args"] == {"bytes": 10, "trace_id": 7}
    assert read["dur"] == pytest.approx(1e6)


# ---------- movement counters: the same bytes as the reference ----------

def _cold_q1_movement(pkg, pipeline):
    """movement_snapshot() after one cold Q1 over a fresh MemBlobStore
    shard of ``pkg`` (``ydb_tpu`` or ``ydb_tpu_torch``)."""
    import importlib

    blobs = importlib.import_module(f"{pkg}.engine.blobs")
    shard_mod = importlib.import_module(f"{pkg}.engine.shard")
    ss = importlib.import_module(f"{pkg}.engine.stream_sched")
    tl = importlib.import_module(f"{pkg}.obs.timeline")
    tpch = importlib.import_module(f"{pkg}.workload.tpch")
    data = tpch.TpchData(sf=0.005, seed=5)
    kw = {"device": "cpu"} if pkg == "ydb_tpu_torch" else {}
    shard = shard_mod.ColumnShard(
        "mv", tpch.LINEITEM_SCHEMA, blobs.MemBlobStore(),
        dicts=data.dicts,
        config=shard_mod.ShardConfig(compact_portion_threshold=10 ** 9,
                                     scan_block_rows=1 << 13,
                                     portion_chunk_rows=1 << 12), **kw)
    li = data.tables["lineitem"]
    half = len(li["l_orderkey"]) // 2
    for sl in (slice(0, half), slice(half, None)):  # two portions
        shard.commit([shard.write({k: v[sl] for k, v in li.items()})])
    prev, saved = ss.PIPELINE_FORCE, tl.movement_snapshot()
    ss.PIPELINE_FORCE = pipeline
    tl.reset_movement()
    try:
        out = shard.scan(tpch.q1_program())
        return tl.movement_snapshot(), out
    finally:
        ss.PIPELINE_FORCE = prev
        tl.reset_movement()
        for k, v in saved.items():
            tl.add_bytes(k, v)


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serialized"])
def test_cold_q1_movement_equals_reference(pipeline):
    got, gout = _cold_q1_movement("ydb_tpu_torch", pipeline)
    want, wout = _cold_q1_movement("ydb_tpu", pipeline)
    assert set(got) == {"blob_read_bytes", "decoded_bytes",
                        "staged_bytes"}
    assert got == want
    assert got["blob_read_bytes"] > 0 and got["staged_bytes"] > 0
    assert gout.num_rows == wout.num_rows == 4


# ---------- end to end through a Cluster ----------

def test_warm_query_busy_matches_stage_seconds(forced_timeline, cluster):
    s = cluster.session()
    q = "SELECT id, sum(v) AS sv FROM ev GROUP BY id ORDER BY id"
    s.execute(q)  # warm: compile + cache fill
    forced_timeline.clear()
    s.execute(q)
    p = s.last_profile
    assert p is not None and p.stage_occupancy
    evs = [e for e in forced_timeline.events() if e.trace_id == p.trace_id]
    assert evs, "no ring events attributed to the query"
    checked = 0
    for stage, total in p.stages.items():
        if total <= 0:
            continue
        ev_sum = sum(e.end - e.start for e in evs if e.cat == stage)
        assert ev_sum == pytest.approx(total, rel=0.1), stage
        checked += 1
    assert checked >= 2
    occ = p.stage_occupancy
    assert 0 < occ["wall_seconds"] <= (p.seconds or 1.0) * 1.1
    assert "movement|compute" in occ["overlap"]
    for v in occ["overlap"].values():
        assert 0.0 <= v <= 1.0
    cats = {e.cat for e in evs}
    assert {"span", "blob.read", "decode", "stage", "compute"} <= cats
    mv = timeline.movement_snapshot()
    assert mv.get("blob_read_bytes", 0) > 0
    assert mv.get("decoded_bytes", 0) > 0


def test_explain_analyze_prints_occupancy(forced_timeline, cluster):
    s = cluster.session()
    text = s.execute("EXPLAIN ANALYZE SELECT sum(v) AS sv FROM ev")
    line = next(ln for ln in str(text).splitlines()
                if ln.startswith("occupancy:"))
    assert "movement|compute=" in line


def test_run_background_exports_conveyor_and_movement(cluster):
    s = cluster.session()
    s.execute("SELECT sum(v) AS sv FROM ev")
    cluster.run_background()
    snap = cluster.counters.snapshot()
    conveyor = [k for k in snap if "component=conveyor" in k]
    assert any(k.startswith("submitted") for k in conveyor)
    movement = [k for k in snap if "component=movement" in k]
    assert any(k.startswith("blob_read_bytes") for k in movement)
    prom = cluster.counters.encode_prometheus()
    assert 'component="movement"' in prom


def test_conveyor_records_wait_and_run(forced_timeline):
    from ydb_tpu_torch.runtime.conveyor import Conveyor

    cv = Conveyor(workers=2)
    try:
        hs = [cv.submit("scan", lambda: 1) for _ in range(6)]
        assert [h.wait(5) for h in hs] == [1] * 6
        st = cv.queue_stats()
        assert (st["submitted"], st["completed"], st["depth"]) == (6, 6, 0)
    finally:
        cv.shutdown()
    evs = forced_timeline.events()
    waits = [e for e in evs if e.cat == "conveyor.wait"]
    runs = [e for e in evs if e.cat == "conveyor.run"]
    assert len(waits) == len(runs) == 6
    assert {e.name for e in waits} == {"scan.wait"}
    assert all(e.args == {"queue": "scan"} for e in runs)


def test_end_of_scan_sync_only_while_timeline_on(monkeypatch):
    from ydb_tpu_torch.engine import scan
    from ydb_tpu_torch.engine.scan import ColumnSource, ScanExecutor
    from ydb_tpu_torch.workload import tpch

    calls = []
    monkeypatch.setattr(scan, "_settle", lambda out: calls.append(out))
    data = tpch.TpchData(sf=0.002, seed=5)
    src = ColumnSource(data.tables["lineitem"], tpch.LINEITEM_SCHEMA,
                       data.dicts)
    ex = ScanExecutor(tpch.q1_program(), src, block_rows=1 << 12,
                      device="cpu")
    prev = timeline.TIMELINE_FORCE
    try:
        timeline.TIMELINE_FORCE = False
        ex.run_stream(src.blocks(1 << 12, ex.read_cols, device="cpu"))
        assert calls == []
        timeline.TIMELINE_FORCE = True
        ex.run_stream(src.blocks(1 << 12, ex.read_cols, device="cpu"))
        assert len(calls) == 1
    finally:
        timeline.TIMELINE_FORCE = prev
        timeline.RING.clear()


def test_dropped_spans_are_back(forced_timeline):
    """``ssa.compile``, ``shard.scan`` and ``scan.producer`` under a
    profiled shard scan; ``dq.task`` under a profiled DQ statement;
    every finished span is also a ``span`` interval in the ring."""
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
    from ydb_tpu_torch.obs import profile as profile_mod
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    data = tpch.TpchData(sf=0.002, seed=5)
    shard = ColumnShard(
        "sp", tpch.LINEITEM_SCHEMA, MemBlobStore(), dicts=data.dicts,
        config=ShardConfig(scan_block_rows=1 << 12,
                           portion_chunk_rows=1 << 11), device="cpu")
    shard.commit([shard.write(dict(data.tables["lineitem"]))])
    with profile_mod.profiled("q1") as h:
        shard.scan(tpch.q1_program())
    names = {sp["name"] for sp in h.profile.spans}
    assert {"ssa.compile", "shard.scan"} <= names
    ring_spans = {e.name for e in forced_timeline.events()
                  if e.cat == "span"}
    assert {"ssa.compile", "shard.scan"} <= ring_spans
    assert h.profile.stage_occupancy
    assert h.profile.compile_seconds > 0

    c = Cluster(device="cpu")
    try:
        s = c.session()
        for name in ("orders", "customer", "lineitem"):
            sch = data.schema(name)
            from ydb_tpu_torch.scheme.model import type_to_str

            cols = ", ".join(f"{f.name} {type_to_str(f.type)}"
                             for f in sch.fields)
            pk = {"orders": "o_orderkey", "customer": "c_custkey",
                  "lineitem": "l_orderkey"}[name]
            s.execute(f"CREATE TABLE {name} ({cols}, PRIMARY KEY ({pk}))"
                      f" WITH (shards = 1)")
            src = data.tables[name]
            c.tables[name].insert({
                f.name: ([bytes(x) for x in data.dicts[f.name].decode(
                    np.asarray(src[f.name], dtype=np.int32))]
                    if f.type.is_string else src[f.name])
                for f in sch.fields})
        c._invalidate_plans()
        s.execute(TPCH["q3"])
        names = {sp["name"] for sp in s.last_profile.spans}
        assert {"dq", "dq.task"} <= names
    finally:
        c.stop()


def test_producer_span_crosses_the_pool():
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.engine.reader import stream_blocks
    from ydb_tpu_torch.obs import tracing

    schema = dtypes.schema(("a", dtypes.INT64))
    payloads = [({"a": np.arange(100, dtype=np.int64)},
                 {"a": np.ones(100, dtype=bool)})] * 3
    tr = tracing.Tracer()
    root = tr.trace("q")
    with tracing.activate(root):
        blocks = list(stream_blocks(iter(payloads), ("a",), schema, 128,
                                    device="cpu"))
    root.finish()
    assert len(blocks) == 3
    spans = tr.spans_for(root.trace_id)
    prod = [sp for sp in spans if sp.name == "scan.producer"]
    assert len(prod) == 1 and prod[0].attrs["blocks"] == 3
    assert prod[0].attrs["thread"] != threading.get_ident()


def test_cli_demo_on_cpu(tmp_path, capsys):
    out = tmp_path / "trace.json"
    prev = timeline.TIMELINE_FORCE
    try:
        assert timeline.main(["--device", "cpu", "--sf", "0.002",
                              "--iters", "1", "--out", str(out)]) == 0
    finally:
        timeline.TIMELINE_FORCE = prev
        timeline.RING.clear()
    trace = json.loads(out.read_text())
    cats = {e.get("cat") for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"read", "stage", "compute", "decode", "span"} <= cats
    assert "overlap:" in capsys.readouterr().out
