"""The port's chaos plane (``ydb_tpu_torch/chaos``) against the
reference's (``ydb_tpu/chaos``), and every chaos site the port threads
through its engine.

Seeded replay: the same ``Scenario`` gives the same ``to_json()`` text,
the same ``(fired, kind)`` sequence per site over 1,000 ``hit()`` calls
and the same ``counters_snapshot()`` after the same single-threaded call
sequence in both packages (exact). Faulted statements: ``blob.get``,
``blob.get_range`` (``io_error`` and ``torn``) and ``resident.lookup``
faults leave the port's results bit-identical to its unfaulted results
and to the reference's on the same data (integers, dictionary strings
and validity bit for bit; floats within the reference's rtol 1e-12);
``fuse.trace`` falls back to the walk; ``session.admit`` and
``serving.admit`` raise the reference's typed errors; ``conveyor.task``
``drop`` / ``delay`` / ``worker_death``; the seeded deadline scenario
under the leak sanitizer."""

import sys
import threading
import time
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import chaos as rchaos
from ydb_tpu.kqp.rm import OverloadedError as ROverloadedError

from ydb_tpu_torch import chaos
from ydb_tpu_torch.chaos.deadline import StatementCancelled
from ydb_tpu_torch.kqp.rm import OverloadedError
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.runtime.conveyor import Conveyor, shared_conveyor

AGG_SQL = ("SELECT k % 5 AS g, SUM(v) AS sv, COUNT(*) AS n FROM kv "
           "GROUP BY k % 5 ORDER BY g")


@pytest.fixture(autouse=True)
def _chaos_off_after(monkeypatch):
    """Both planes disarmed and gate-closed around every test; the
    reference's Pallas module (which does not import with this jax,
    ROADMAP.md queue C) stubbed so its GROUP BYs take the scatter
    tier."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)
    for mod in (chaos, rchaos):
        mod.clear()
        mod.CHAOS_FORCE = None
    yield
    for mod in (chaos, rchaos):
        mod.clear()
        mod.CHAOS_FORCE = None


def _armed(mod, scenario_kwargs):
    mod.CHAOS_FORCE = True
    mod.install(mod.Scenario(**scenario_kwargs))


def _host(t):
    """An OracleTable of either package as comparable host values."""
    out = {}
    for f in t.schema.fields:
        v, ok = t.cols[f.name]
        ok = np.asarray(ok, dtype=bool)
        v = np.asarray(v)
        out[f.name] = (f.type.is_floating, np.where(ok, v, 0), ok)
    return list(t.schema.names), t.num_rows, out


def _same(got, want):
    gn, gr, gc = _host(got)
    wn, wr, wc = _host(want)
    assert (gn, gr) == (wn, wr)
    for name, (fl, gv, gok) in gc.items():
        _, wv, wok = wc[name]
        np.testing.assert_array_equal(gok, wok, err_msg=name)
        if fl:
            np.testing.assert_allclose(gv, wv, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=name)


def _kv(cluster, n=300):
    s = cluster.session()
    s.execute("CREATE TABLE kv (k Int64 NOT NULL, v Int64, "
              "PRIMARY KEY (k)) WITH (shards = 2)")
    t = cluster.tables["kv"]
    for off in range(0, n, n // 3):  # several portions per shard
        ks = list(range(off, min(n, off + n // 3)))
        t.insert({"k": ks, "v": [k * 7 for k in ks]})
    cluster._invalidate_plans()
    return s


@pytest.fixture(scope="module")
def ref_kv():
    """A reference Cluster holding ``kv`` and its session (module-scoped:
    one reference compile for the file)."""
    from ydb_tpu.kqp.session import Cluster as RCluster

    c = RCluster()
    yield c, _kv(c)
    c.stop()


@pytest.fixture
def ref_agg(ref_kv):
    """The reference's unfaulted AGG_SQL answer."""
    return ref_kv[1].execute(AGG_SQL)


# ---------- gates, seeded replay, scenario DSL ----------

def test_gate_closed_by_default(monkeypatch):
    monkeypatch.delenv("YDB_TPU_TORCH_CHAOS", raising=False)
    assert not chaos.chaos_enabled()
    with pytest.raises(RuntimeError):
        chaos.install(chaos.Scenario(seed=1, sites={
            "blob.get": {"kind": "io_error"}}))
    assert not chaos.armed()
    assert chaos.hit("blob.get") is None
    assert chaos.counters_snapshot() == {}


def test_env_gate_and_force(monkeypatch):
    monkeypatch.setenv("YDB_TPU_TORCH_CHAOS", "1")
    assert chaos.chaos_enabled()
    chaos.CHAOS_FORCE = False  # the in-process pin beats the env
    assert not chaos.chaos_enabled()
    chaos.CHAOS_FORCE = True
    assert chaos.chaos_enabled()


SCENARIOS = [
    {"seed": 42, "sites": {
        "blob.get_range": {"kind": "io_error", "p": 0.05},
        "mesh.dispatch": {"kind": "device_lost", "budget": 1},
        "conveyor.task": {"kind": "delay", "p": 0.1, "latency": 0.001}}},
    {"seed": 7, "sites": {
        "blob.get": {"kind": "torn", "p": 0.5, "budget": 17},
        "resident.lookup": {"kind": "io_error", "p": 0.3},
        "session.admit": {"kind": "overload", "p": 0.02}}},
    {"seed": 0xFFFFFFFF, "sites": {
        "serving.admit": {"kind": "delay", "p": 0.15},
        "fuse.trace": {"kind": "io_error"}}},
]


@pytest.mark.parametrize("spec", SCENARIOS, ids=lambda s: str(s["seed"]))
def test_scenario_json_equals_reference(spec, tmp_path):
    sc, rsc = chaos.Scenario(**spec), rchaos.Scenario(**spec)
    assert sc.to_json() == rsc.to_json()
    back = chaos.Scenario.from_json(rsc.to_json())
    assert back.to_json() == sc.to_json()
    f = tmp_path / "scenario.json"
    f.write_text(sc.to_json())
    assert chaos.Scenario.from_file(str(f)).to_json() == sc.to_json()


def test_noisy_neighbor_copy_equals_reference():
    import os

    import ydb_tpu.chaos as rpkg

    import ydb_tpu_torch.chaos as tpkg

    def path(pkg):
        return os.path.join(os.path.dirname(pkg.__file__),
                            "noisy_neighbor.json")

    assert (chaos.Scenario.from_file(path(tpkg)).to_json()
            == rchaos.Scenario.from_file(path(rpkg)).to_json())


def _fire_seq(mod, spec, n=1000):
    _armed(mod, spec)
    try:
        out = {}
        for site in sorted(spec["sites"]):
            seq = []
            for _ in range(n):
                f = mod.hit(site)
                seq.append((f is not None, f.kind if f else None,
                            f.latency if f else None))
            out[site] = seq
        return out
    finally:
        mod.clear()


@pytest.mark.parametrize("spec", SCENARIOS, ids=lambda s: str(s["seed"]))
def test_fault_sequence_replays_reference(spec):
    got = _fire_seq(chaos, spec)
    assert got == _fire_seq(rchaos, spec)
    assert got == _fire_seq(chaos, spec)  # the seed IS the schedule
    assert any(f for seq in got.values() for f, _, _ in seq)


def test_sites_draw_independent_streams():
    both = chaos.Scenario(seed=9, sites={
        "blob.get": {"kind": "io_error", "p": 0.5},
        "conveyor.task": {"kind": "drop", "p": 0.5}})
    one = chaos.Scenario(seed=9, sites={
        "blob.get": {"kind": "io_error", "p": 0.5}})

    def seq(sc):
        pt = sc.build_points()["blob.get"]
        return [pt.roll() is not None for _ in range(50)]

    assert seq(both) == seq(one)


def test_budget_caps_fires():
    p = chaos.FaultPoint("blob.get", "io_error", p=1.0, budget=3)
    assert sum(p.roll() is not None for _ in range(10)) == 3
    assert p.stats() == {"kind": "io_error", "p": 1.0, "budget": 3,
                         "hits": 10, "fired": 3}


def _call_sequence(mod, retry_mod):
    _armed(mod, SCENARIOS[1])
    try:
        for i in range(200):
            mod.hit("blob.get", blob=f"b{i}")
            mod.hit("resident.lookup", portion=i)
            if i % 7 == 0:
                mod.hit("session.admit")
        mod.note_fallback("resident.lookup")
        mod.note_fallback("fuse.trace")
        mod.note_fallback("resident.lookup")
        retry_mod.note_retry("blob.get_range", 1, OSError("x"))
        retry_mod.note_retry("blob.get", 2, EOFError("y"))
        return mod.counters_snapshot()
    finally:
        mod.clear()


def test_counters_snapshot_equals_reference():
    from ydb_tpu.chaos import retry as rretry

    from ydb_tpu_torch.chaos import retry as tretry

    got = _call_sequence(chaos, tretry)
    assert got == _call_sequence(rchaos, rretry)
    assert got["fallbacks"] == {"resident.lookup": 2, "fuse.trace": 1}
    assert got["retries"] == {"blob.get_range": 1, "blob.get": 1}


def test_fault_surfaces_on_probe_and_span():
    from ydb_tpu_torch.obs import tracing
    from ydb_tpu_torch.obs.probes import TraceSession

    _armed(chaos, {"seed": 1, "sites": {
        "blob.get": {"kind": "io_error", "budget": 2}}})
    with TraceSession("chaos.fault") as ts:
        tr = tracing.Tracer()
        root = tr.trace("q")
        with tracing.activate(root):
            assert chaos.hit("blob.get", blob="x") is not None
            chaos.hit("blob.get", blob="y")
            assert chaos.hit("blob.get") is None  # budget spent
        root.finish()
    assert ts.counts["chaos.fault"] == 2
    assert ts.events[0] == ("chaos.fault", {"site": "blob.get",
                                            "kind": "io_error",
                                            "blob": "x"})
    assert root.attrs["chaos_faults"] == 2
    assert root.attrs["chaos_last"] == "blob.get:io_error"


# ---------- faulted statements: blob reads ----------

@pytest.mark.parametrize("kind,p,budget", [("io_error", 0.6, 6),
                                           ("torn", 1.0, 2)])
def test_blob_get_range_faults_heal(kind, p, budget, ref_agg):
    c = Cluster(device="cpu")
    s = _kv(c)
    want = s.execute(AGG_SQL)
    _armed(chaos, {"seed": 21, "sites": {
        "blob.get_range": {"kind": kind, "p": p, "budget": budget}}})
    got = s.execute(AGG_SQL)
    snap = chaos.counters_snapshot()
    assert snap["sites"]["blob.get_range"]["fired"] > 0
    assert sum(snap["retries"].values()) > 0  # retries healed them
    _same(got, want)
    _same(got, ref_agg)
    c.stop()


def _legacy_blob(mod):
    """A legacy single-npz portion blob (no header): its read takes the
    whole-blob ``blob.get`` path."""
    rng = np.random.default_rng(3)
    cols = {"a": rng.integers(0, 1 << 40, 300).astype(np.int64),
            "b": rng.random(300)}
    valid = {"a": np.ones(300, dtype=bool), "b": rng.random(300) > 0.1}
    return mod._pack_chunk(cols, valid, 0, 300)


@pytest.mark.parametrize("kind", ["io_error", "torn"])
def test_blob_get_faults_heal(kind):
    """Whole-blob reads (a legacy single-npz portion) under ``blob.get``
    faults. ``io_error`` heals by retry in both packages; a ``torn`` read
    heals in the port, whose retry re-fetches the blob, while the
    reference's retry decodes the same torn bytes again and fails
    (ROADMAP.md queue C)."""
    from ydb_tpu.engine import blobs as rblobs
    from ydb_tpu.engine import portion as rportion

    from ydb_tpu_torch.engine import blobs, portion

    data = _legacy_blob(portion)
    assert data == _legacy_blob(rportion)
    results = {}
    for label, mod, bmod, pmod in (("port", chaos, blobs, portion),
                                   ("ref", rchaos, rblobs, rportion)):
        store = bmod.MemBlobStore()
        store.put("legacy", data)
        want = pmod.PortionChunkReader(store, "legacy").read_chunk(0)
        _armed(mod, {"seed": 5, "sites": {
            "blob.get": {"kind": kind, "budget": 2}}})
        try:
            if label == "ref" and kind == "torn":
                import zipfile

                with pytest.raises(zipfile.BadZipFile):
                    pmod.PortionChunkReader(store, "legacy").read_chunk(0)
                continue
            got = pmod.PortionChunkReader(store, "legacy").read_chunk(0)
            assert mod.counters_snapshot()["sites"]["blob.get"][
                "fired"] == 2
        finally:
            mod.clear()
        for part in (0, 1):
            assert got[part].keys() == want[part].keys()
            for k in got[part]:
                np.testing.assert_array_equal(got[part][k], want[part][k])
        results[label] = got
    if kind == "torn":
        return
    for part in (0, 1):
        for k in results["port"][part]:
            np.testing.assert_array_equal(results["port"][part][k],
                                          results["ref"][part][k])


def test_blob_put_io_error_is_typed():
    from ydb_tpu_torch.engine.blobs import DirBlobStore

    _armed(chaos, {"seed": 1, "sites": {"blob.put": {"kind": "io_error",
                                                     "budget": 1}}})
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        st = DirBlobStore(d)
        with pytest.raises(chaos.InjectedIOError):
            st.put("x", b"1")
        assert isinstance(chaos.InjectedIOError("e"), OSError)
        st.put("x", b"1")
        assert st.get("x") == b"1"


# ---------- fallbacks: resident -> staged host, fused -> walk ----------

def test_resident_lookup_fault_degrades_to_host():
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.analysis import memsan
    from ydb_tpu_torch.engine import resident as resident_mod
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard
    from ydb_tpu_torch.ssa import Agg, AggSpec, GroupByStep, Program

    schema = dtypes.schema(("id", dtypes.INT64, False),
                           ("val", dtypes.INT64))
    prev = resident_mod.RESIDENT_FORCE
    resident_mod.RESIDENT_FORCE = True
    try:
        shard = ColumnShard("chres", schema, MemBlobStore(),
                            pk_column="id", device="cpu")
        shard.commit([shard.write({
            "id": np.arange(200, dtype=np.int64),
            "val": np.arange(200, dtype=np.int64) * 3})])
        shard.resident.drain()
        assert shard.resident.snapshot()["portions"] == 1
        prog = Program((GroupByStep(keys=(), aggs=(
            AggSpec(Agg.SUM, "val", "s"),
            AggSpec(Agg.COUNT_ALL, None, "n"))),))
        want = shard.scan(prog)
        hits0 = shard.resident.hits
        shard.scan(prog)
        assert shard.resident.hits > hits0  # the baseline IS resident
        _armed(chaos, {"seed": 2, "sites": {
            "resident.lookup": {"kind": "io_error", "p": 1.0}}})
        misses0 = shard.resident.misses
        with memsan.activate():
            st = memsan.begin_statement("faulted")
            got = shard.scan(prog)
            snap = memsan.end_statement(st, enforce=False)
        assert snap["unbudgeted"] == 0
        assert shard.resident.misses > misses0
        assert chaos.counters_snapshot()["fallbacks"][
            "resident.lookup"] >= 1
        _same(got, want)
        assert int(got.cols["s"][0][0]) == 3 * 199 * 200 // 2
    finally:
        resident_mod.RESIDENT_FORCE = prev
    # the reference's shard over the same rows answers the same
    from ydb_tpu import dtypes as rdt
    from ydb_tpu import ssa as rssa
    from ydb_tpu.engine.blobs import MemBlobStore as RMem
    from ydb_tpu.engine.shard import ColumnShard as RShard

    rshard = RShard("chres", rdt.schema(("id", rdt.INT64, False),
                                        ("val", rdt.INT64)),
                    RMem(), pk_column="id")
    rshard.commit([rshard.write({
        "id": np.arange(200, dtype=np.int64),
        "val": np.arange(200, dtype=np.int64) * 3})])
    _same(got, rshard.scan(rssa.Program((rssa.GroupByStep(keys=(), aggs=(
        rssa.AggSpec(rssa.Agg.SUM, "val", "s"),
        rssa.AggSpec(rssa.Agg.COUNT_ALL, None, "n"))),))))


def test_fuse_trace_fault_falls_back_to_walk(ref_agg):
    from ydb_tpu_torch.plan import executor

    c = Cluster(device="cpu")
    s = _kv(c)
    want = s.execute(AGG_SQL)
    answered = []
    orig = executor._execute_plan_fused

    def spy(plan, db):
        out = orig(plan, db)
        answered.append(out is not None)
        return out

    executor._execute_plan_fused = spy
    try:
        _armed(chaos, {"seed": 11, "sites": {
            "fuse.trace": {"kind": "io_error", "budget": 1}}})
        got = s.execute(AGG_SQL)
        again = s.execute(AGG_SQL)  # budget spent: fusion answers
    finally:
        executor._execute_plan_fused = orig
    assert answered == [False, True]
    assert chaos.counters_snapshot()["fallbacks"]["fuse.trace"] == 1
    _same(got, want)
    _same(again, want)
    _same(got, ref_agg)
    c.stop()


# ---------- admission sites: typed errors as in the reference ----------

def test_session_admit_overload_typed(ref_kv, ref_agg):
    c = Cluster(device="cpu")
    s = _kv(c)
    spec = {"seed": 8, "sites": {
        "session.admit": {"kind": "overload", "budget": 1}}}
    _armed(chaos, spec)
    with pytest.raises(OverloadedError) as e:
        s.execute(AGG_SQL)
    _armed(rchaos, spec)
    with pytest.raises(ROverloadedError) as re:
        ref_kv[1].execute(AGG_SQL)
    assert str(e.value) == str(re.value) == (
        "statement shed at admission (injected)")
    assert s.last_profile.error_reason == "overloaded"
    assert ref_kv[1].last_profile.error_reason == "overloaded"
    _same(s.execute(AGG_SQL), ref_agg)  # budget spent: admitted
    c.stop()


def test_serving_admit_overload_typed():
    from ydb_tpu import serving as rserving
    from ydb_tpu.kqp.session import Cluster as RCluster

    from ydb_tpu_torch import serving

    errors = {}
    for label, mod, cmod, cl in (
            ("port", chaos, serving, Cluster(device="cpu")),
            ("ref", rchaos, rserving, RCluster())):
        door = cmod.install(cl)
        _armed(mod, {"seed": 3, "sites": {
            "serving.admit": {"kind": "overload", "budget": 1}}})
        try:
            with pytest.raises(Exception) as e:
                door.admit("gold")
            errors[label] = (type(e.value).__name__, str(e.value))
            seat = door.admit("gold")  # budget spent: a seat
            seat.release()
            errors[label + "_shed"] = door.snapshot()["gold"]["shed"]
        finally:
            mod.clear()
            cl.stop()
    assert errors["port"] == errors["ref"] == (
        "OverloadedError", "tenant pool 'gold' overloaded (injected)")
    assert errors["port_shed"] == errors["ref_shed"]


# ---------- conveyor.task ----------

def test_conveyor_task_drop_surfaces_error():
    conv = Conveyor(workers=1)
    try:
        _armed(chaos, {"seed": 3, "sites": {
            "conveyor.task": {"kind": "drop", "budget": 1}}})
        h = conv.submit("bg", lambda: 42)
        with pytest.raises(chaos.ChaosError, match="injected task drop"):
            h.wait(timeout=5.0)
        chaos.clear()
        assert conv.submit("bg", lambda: 42).wait(timeout=5.0) == 42
    finally:
        conv.shutdown()


def test_conveyor_delay_fault_just_slows():
    conv = Conveyor(workers=1)
    try:
        _armed(chaos, {"seed": 3, "sites": {
            "conveyor.task": {"kind": "delay", "budget": 1,
                              "latency": 0.02}}})
        t0 = time.perf_counter()
        assert conv.submit("bg", lambda: 7).wait(timeout=5.0) == 7
        assert time.perf_counter() - t0 >= 0.02
    finally:
        conv.shutdown()


def test_conveyor_worker_death_respawns_pool():
    from ydb_tpu_torch.analysis import leaksan, sanitizer

    with sanitizer.activate(), leaksan.activate():
        conv = Conveyor(workers=2)
        try:
            _armed(chaos, {"seed": 3, "sites": {
                "conveyor.task": {"kind": "worker_death", "budget": 1}}})
            h = conv.submit("bg", lambda: 1)
            with pytest.raises(chaos.ChaosError,
                               match="injected worker death"):
                h.wait(timeout=5.0)
            chaos.clear()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if sum(t.is_alive() for t in conv._threads) == 2:
                    break
                time.sleep(0.01)
            assert sum(t.is_alive() for t in conv._threads) == 2
            hs = [conv.submit("bg", lambda i=i: i * i) for i in range(4)]
            assert [h.wait(timeout=5.0) for h in hs] == [0, 1, 4, 9]
            conv.wait_idle(timeout=5.0)
            assert conv.queue_stats()["depth"] == 0
            assert leaksan.counts() == {}
            assert sanitizer.reports() == []
        finally:
            conv.shutdown()


def test_worker_death_never_strands_device_locks():
    """A worker whose task would take ``device.capture_lock`` or a shared
    hold on ``device.work_lock`` dies before the body runs: a capture
    after it finds both free."""
    from ydb_tpu_torch.device import capture_lock, work_lock

    conv = Conveyor(workers=1)
    try:
        _armed(chaos, {"seed": 3, "sites": {
            "conveyor.task": {"kind": "worker_death", "budget": 1}}})

        def device_work():
            with work_lock.shared(), capture_lock:
                return 1

        h = conv.submit("scan_prefetch", device_work)
        with pytest.raises(chaos.ChaosError):
            h.wait(timeout=5.0)
        assert conv.submit("scan_prefetch", device_work).wait(
            timeout=5.0) == 1
        assert work_lock.try_exclusive()
        work_lock.release_exclusive()
        assert capture_lock.acquire(timeout=1.0)
        capture_lock.release()
    finally:
        conv.shutdown()


# ---------- counters export, deadlines under the leak sanitizer ----------

def test_chaos_and_movement_exported_by_run_background():
    c = Cluster(device="cpu")
    s = _kv(c)
    _armed(chaos, {"seed": 13, "sites": {
        "blob.get_range": {"kind": "io_error", "p": 0.5, "budget": 2}}})
    s.execute(AGG_SQL)
    c.run_background()
    snap = c.counters.snapshot()
    fired = [v for k, v in snap.items()
             if k.startswith("fired|") and "component=chaos" in k]
    assert fired and max(fired) > 0
    assert any(k.startswith("blob_read_bytes|")
               and "component=movement" in k for k in snap)
    c.stop()


def _tpch_cluster(sf=0.002):
    from ydb_tpu_torch.scheme.model import type_to_str
    from ydb_tpu_torch.workload import tpch

    data = tpch.TpchData(sf=sf, seed=7)
    c = Cluster(device="cpu")
    s = c.session()
    pks = {"lineitem": "l_orderkey", "orders": "o_orderkey",
           "customer": "c_custkey"}
    for tname, pk in pks.items():
        schema = data.schema(tname)
        cols = ", ".join(f"{f.name} {type_to_str(f.type)}"
                         for f in schema.fields)
        s.execute(f"CREATE TABLE {tname} ({cols}, "
                  f"PRIMARY KEY ({pk})) WITH (shards = 1)")
        src = data.tables[tname]
        t = c.tables[tname]
        n = len(src[pk])
        step = max(1, n // 3)
        for off in range(0, n, step):  # 3 commits -> 3 portions
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
    return c, s


def test_deadline_scenario_under_leaksan():
    """The seeded acceptance scenario of the reference's
    ``test_chaos.py``, less its mesh device loss (ROADMAP.md queue A
    item 13): blob-read faults at p=0.05 and a fifth of TPC-H Q1/Q3/Q6
    statements past their deadline. Survivors equal the unfaulted
    answers, every cancelled statement is a typed ``StatementCancelled``
    with ``error_reason == "cancelled"``, and nothing leaks: the
    conveyor drains, promotion flights all land, every tracked handle
    is gone at ``Cluster.stop``."""
    from ydb_tpu_torch.analysis import leaksan
    from ydb_tpu_torch.engine import resident as resident_mod
    from ydb_tpu_torch.workload.queries import TPCH

    queries = {k: TPCH[k] for k in ("q1", "q3", "q6")}
    with leaksan.activate():
        c, s = _tpch_cluster()
        want = {k: s.execute(q) for k, q in queries.items()}
        _armed(chaos, {"seed": 42, "sites": {
            "blob.get_range": {"kind": "io_error", "p": 0.05}}})
        cancelled = stmt = 0
        for _round in range(2):
            for name, sql in queries.items():
                stmt += 1
                c.scan_block_cache.clear()  # cold: reads cross the faults
                if stmt % 5 == 0:  # a fifth past their deadline
                    with pytest.raises(StatementCancelled):
                        s.execute(sql, timeout=0.0)
                    cancelled += 1
                    assert s.last_profile.error_reason == "cancelled"
                    assert s.last_profile.error == 1
                else:
                    _same(s.execute(sql, timeout=60.0), want[name])
        assert cancelled == 1
        assert chaos.counters_snapshot()["sites"]["blob.get_range"][
            "hits"] > 0
        chaos.clear()
        shared_conveyor().wait_idle(timeout=30.0)
        qs = shared_conveyor().queue_stats()
        assert qs["depth"] == 0 and qs["active"] == 0
        prev = resident_mod.RESIDENT_FORCE
        resident_mod.RESIDENT_FORCE = True
        try:
            for _ in range(2):  # cross PROMOTE_HEAT on every portion
                for sql in queries.values():
                    s.execute(sql)
            promoted = 0
            for t in c.tables.values():
                for sh in t.shards:
                    sh.resident.drain()
                    snap = sh.resident.snapshot()
                    promoted += snap["promotions"]
                    assert snap["inflight"] == 0
            assert promoted > 0
        finally:
            resident_mod.RESIDENT_FORCE = prev
        shared_conveyor().wait_idle(timeout=30.0)
        c.stop()  # raises LeakError when a handle outlived it
        assert leaksan.counts() == {}, leaksan.counts()


def test_concurrent_hits_count_exactly():
    """Rolls from many threads: every hit counted, budget never
    exceeded (the per-point lock)."""
    _armed(chaos, {"seed": 5, "sites": {
        "blob.get": {"kind": "io_error", "p": 0.5, "budget": 40}}})
    fired = []

    def work():
        n = 0
        for _ in range(500):
            n += chaos.hit("blob.get") is not None
        fired.append(n)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    st = chaos.counters_snapshot()["sites"]["blob.get"]
    assert st["hits"] == 4000 and st["fired"] == sum(fired) == 40
