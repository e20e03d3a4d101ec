"""The port's device-resident column tier (engine/resident.py) on the
CPU, its budget forced on: promotion and eviction lifecycle,
invalidation across compaction/TTL rewrites, mid-stream resident/host
fallback equality, the YDB_TPU_TORCH_RESIDENT=0 A/B switch, concurrent
scans during promotion, and the single-flight DeviceBlockCache fill —
the Cluster-free cases of ``tests/test_resident.py`` against
``ydb_tpu_torch`` (its sysview, viewer and span cases wait for their
ROADMAP.md queue A items; its thread-sanitizer stress of the resident
store is mirrored here)."""

import threading

import numpy as np
import pytest

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine import resident as resident_mod
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.engine.resident import ResidentStore
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.ssa import Agg, AggSpec, Call, Col, FilterStep, GroupByStep, Op
from ydb_tpu_torch.ssa.program import Program, lit

SCHEMA = dtypes.schema(
    ("id", dtypes.INT64, False),
    ("ts", dtypes.DATE, False),
    ("tag", dtypes.STRING),
    ("val", dtypes.INT64),
)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port's entry points default to CUDA; these tests ask for the
    CPU."""
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


@pytest.fixture(autouse=True)
def _restore_force():
    yield
    resident_mod.RESIDENT_FORCE = None


def _shard(upsert=False, **cfg):
    return ColumnShard(
        "rshard", SCHEMA, MemBlobStore(),
        pk_column="id", ttl_column="ts", upsert=upsert,
        config=ShardConfig(**cfg) if cfg else None,
    )


def _write(shard, ids, ts=None, vals=None):
    n = len(ids)
    cols = shard.encode_strings({
        "id": np.asarray(ids, dtype=np.int64),
        "ts": np.asarray(ts if ts is not None else [100] * n,
                         dtype=np.int32),
        "tag": [b"x"] * n,
        "val": np.asarray(vals if vals is not None else ids,
                          dtype=np.int64),
    })
    return shard.write(cols)


def _agg_prog():
    return Program((
        GroupByStep(keys=(), aggs=(
            AggSpec(Agg.SUM, "val", "s"),
            AggSpec(Agg.COUNT_ALL, None, "n"),
        )),
    ))


def _sum_n(shard, snap=None):
    out = shard.scan(_agg_prog(), snap)
    return int(out.cols["s"][0][0]), int(out.cols["n"][0][0])


def test_eager_promotion_at_commit():
    resident_mod.RESIDENT_FORCE = True
    shard = _shard()
    shard.commit([_write(shard, list(range(100)))])
    shard.resident.drain()
    snap = shard.resident.snapshot()
    assert snap["portions"] == 1 and snap["promotions"] == 1
    assert snap["bytes"] > 0
    # the FIRST scan is already served from the resident tier
    assert _sum_n(shard) == (sum(range(100)), 100)
    assert shard.resident.hits >= 1 and shard.resident.misses == 0


def test_heat_driven_promotion():
    # commit while the tier is off: nothing promoted eagerly
    resident_mod.RESIDENT_FORCE = False
    shard = _shard()
    shard.commit([_write(shard, list(range(50)))])
    resident_mod.RESIDENT_FORCE = True
    assert shard.resident.snapshot()["portions"] == 0
    # first host-path scan: heat 1, below threshold
    assert _sum_n(shard) == (sum(range(50)), 50)
    shard.resident.drain()
    assert shard.resident.snapshot()["portions"] == 0
    # second scan crosses PROMOTE_HEAT: async promotion via blob loader
    _sum_n(shard)
    shard.resident.drain()
    snap = shard.resident.snapshot()
    assert snap["portions"] == 1 and snap["promotions"] == 1
    hits0 = shard.resident.hits
    assert _sum_n(shard) == (sum(range(50)), 50)
    assert shard.resident.hits > hits0


def test_eviction_order_zskips_then_cold(monkeypatch):
    """Victims: zone-pruned-away portions first, then coldest by
    (heat, LRU tick) — and the budget bounds resident bytes."""
    store = ResidentStore("evict-test", budget=10 ** 9)
    a = np.arange(1000, dtype=np.int64)
    v = np.ones(1000, dtype=bool)
    for pid in (1, 2, 3):
        assert store.promote(pid, 1000, {"c": a}, {"c": v})
    per = store.snapshot()["bytes"] // 3
    # portion 2: zone maps keep pruning it away -> zero resident value
    store.note_pruned(2)
    # portion 1: hottest by access
    store.lookup(1, ("c",))
    store.lookup(1, ("c",))
    store.lookup(3, ("c",))
    # shrink the budget to fit two portions: 2 must go first
    store._budget = per * 2 + 1
    assert store.promote(9, 1000, {"c": a}, {"c": v}) or True
    with store._lock:
        assert 2 not in store._info
    # shrink to one portion: of (1, 3, 9), the coldest goes; 1 stays
    store._budget = per + 1
    store.lookup(1, ("c",))  # force an over-budget evict pass
    with store._lock:
        store._evict_to_budget_locked(store._budget)
        assert 1 in store._info
        assert store._nbytes <= per + 1
    assert store.snapshot()["evictions"] >= 2
    # a portion larger than the whole valve spills, never pins
    store._budget = 10
    assert not store.promote(7, 1000, {"c": a}, {"c": v})
    assert store.snapshot()["spills"] == 1


def test_budget_env_valve(monkeypatch):
    resident_mod.RESIDENT_FORCE = True
    shard = _shard()
    monkeypatch.setenv("YDB_TPU_TORCH_RESIDENT_BYTES", "0")
    assert not shard.resident.enabled()
    monkeypatch.setenv("YDB_TPU_TORCH_RESIDENT_BYTES", "1048576")
    assert shard.resident.enabled()
    assert shard.resident.budget() == 1048576
    monkeypatch.setenv("YDB_TPU_TORCH_RESIDENT_BYTES", "junk")
    assert not shard.resident.enabled()


def test_invalidation_across_compaction_and_gc():
    resident_mod.RESIDENT_FORCE = True
    shard = _shard(compact_portion_threshold=10 ** 9)
    shard.commit([_write(shard, [1, 2, 3], vals=[10, 20, 30])])
    shard.commit([_write(shard, [4], vals=[40])])
    shard.resident.drain()
    assert shard.resident.snapshot()["portions"] == 2
    old_pids = {m.portion_id for m in shard.visible_portions()}
    shard.compact()
    shard.resident.drain()  # compaction output promotes eagerly
    # old portions still resident: old-snapshot readers keep hitting
    # them until GC proves no snapshot can name them
    assert shard.resident.snapshot()["portions"] == 3
    shard.gc_blobs(keep_snap=shard.snap)
    with shard.resident._lock:
        assert not (old_pids & set(shard.resident._info))
    assert shard.resident.snapshot()["invalidations"] >= 2
    # post-GC scans serve the new portion, correct rows
    assert _sum_n(shard) == (100, 4)


def test_no_stale_reads_after_ttl():
    resident_mod.RESIDENT_FORCE = True
    shard = _shard(compact_portion_threshold=10 ** 9)
    shard.commit([_write(shard, [1, 2], ts=[10, 10], vals=[5, 5])])
    shard.commit([_write(shard, [3, 4], ts=[999, 999], vals=[7, 7])])
    shard.resident.drain()
    assert _sum_n(shard) == (24, 4)
    shard.evict_ttl(cutoff=100)
    # resident arrays of the expired portion must not leak into reads
    assert _sum_n(shard) == (14, 2)
    shard.gc_blobs(keep_snap=shard.snap)
    assert _sum_n(shard) == (14, 2)


def test_mid_stream_resident_host_fallback_equality():
    """Some portions resident, some not: the mixed stream must produce
    exactly the all-host results (row order included)."""
    resident_mod.RESIDENT_FORCE = True
    shard = _shard()
    shard.commit([_write(shard, list(range(0, 300)))])      # promoted
    shard.resident.drain()
    resident_mod.RESIDENT_FORCE = False
    shard.commit([_write(shard, list(range(300, 500)))])    # host-only
    shard.commit([_write(shard, list(range(500, 900)))])    # host-only
    resident_mod.RESIDENT_FORCE = True
    shard.commit([_write(shard, list(range(900, 1000)))])   # promoted
    shard.resident.drain()
    assert shard.resident.snapshot()["portions"] == 2
    prog = Program((
        FilterStep(Call(Op.GE, Col("val"), lit(100))),
        GroupByStep(keys=(), aggs=(
            AggSpec(Agg.SUM, "val", "s"),
            AggSpec(Agg.COUNT_ALL, None, "n"),
            AggSpec(Agg.MIN, "id", "lo"),
            AggSpec(Agg.MAX, "id", "hi"),
        )),
    ))
    hits0 = shard.resident.hits
    on = shard.scan(prog)
    assert shard.resident.hits > hits0
    resident_mod.RESIDENT_FORCE = False
    off = shard.scan(prog)
    for name in on.cols:
        a, aok = (np.asarray(x) for x in on.cols[name])
        b, bok = (np.asarray(x) for x in off.cols[name])
        assert np.array_equal(aok, bok)
        assert np.array_equal(np.where(aok, a, 0), np.where(bok, b, 0))


def test_resident_off_bit_identity(monkeypatch):
    """YDB_TPU_TORCH_RESIDENT=0 restores the pre-tier scan path exactly."""
    outs = {}
    for label, env in (("on", "1"), ("off", "0")):
        monkeypatch.setenv("YDB_TPU_TORCH_RESIDENT", env)
        shard = _shard()
        shard.commit([_write(shard, list(range(500)))])
        shard.commit([_write(shard, list(range(500, 800)))])
        shard.resident.drain()
        assert shard.resident.enabled() == (env == "1")
        outs[label] = shard.scan(_agg_prog())
    for name in outs["on"].cols:
        a, aok = (np.asarray(x) for x in outs["on"].cols[name])
        b, bok = (np.asarray(x) for x in outs["off"].cols[name])
        assert np.array_equal(aok, bok)
        assert np.array_equal(np.where(aok, a, 0), np.where(bok, b, 0))


def test_upsert_merged_clusters_stay_on_host_path():
    """K-way dedup merges rewrite rows: those clusters must bypass the
    resident tier, and results must match the tier-off scan."""
    resident_mod.RESIDENT_FORCE = True
    shard = _shard(upsert=True)
    shard.commit([_write(shard, [1, 2, 3], vals=[10, 20, 30])])
    shard.commit([_write(shard, [2, 3, 4], vals=[21, 31, 41])])
    shard.resident.drain()
    on = _sum_n(shard)
    resident_mod.RESIDENT_FORCE = False
    assert _sum_n(shard) == on == (10 + 21 + 31 + 41, 4)


def test_resident_scan_attribution():
    resident_mod.RESIDENT_FORCE = True
    shard = _shard()
    shard.commit([_write(shard, list(range(100)))])
    shard.resident.drain()
    shard.scan(_agg_prog())
    assert shard.last_scan_resident == {"portions": 1, "rows": 100}


def test_concurrent_scans_during_promotion():
    """Scans racing heat-driven promotions: every result exact."""
    resident_mod.RESIDENT_FORCE = True
    shard = _shard()
    shard.commit([_write(shard, list(range(200)))])
    want = (sum(range(200)), 200)
    errs: list = []
    stop = threading.Event()

    def scanner():
        try:
            while not stop.is_set():
                if _sum_n(shard) != want:
                    errs.append("mismatch")
                    return
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))

    threads = [threading.Thread(target=scanner) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        # churn: repeated invalidate + re-promotion under scans
        for _ in range(5):
            shard.resident.clear()
            _sum_n(shard)
            _sum_n(shard)
            shard.resident.drain()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errs
    assert shard.resident.snapshot()["portions"] >= 0


def test_concurrent_scans_during_promotion_tsan():
    """The same race under the thread sanitizer (the reference's
    ``tests/test_resident.py:304``): no lockset violation on the resident
    store's tracked maps, every result exact."""
    from ydb_tpu_torch.analysis import sanitizer

    with sanitizer.activate():
        resident_mod.RESIDENT_FORCE = True
        shard = _shard()
        shard.commit([_write(shard, list(range(200)))])
        want = (sum(range(200)), 200)
        errs: list = []
        stop = threading.Event()

        def scanner():
            try:
                while not stop.is_set():
                    if _sum_n(shard) != want:
                        errs.append("mismatch")
                        return
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))

        threads = [threading.Thread(target=scanner) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for _ in range(5):
                shard.resident.clear()
                _sum_n(shard)
                _sum_n(shard)
                shard.resident.drain()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not errs, errs
        assert not sanitizer.reports(), sanitizer.reports()

def test_blockcache_single_flight():
    """Two concurrent misses on one key: exactly one fill runs; the
    other serves the cached entry after waiting."""
    from ydb_tpu_torch.engine.blockcache import DeviceBlockCache

    class _Col:
        data = np.zeros(64, dtype=np.int64)
        validity = np.ones(64, dtype=bool)

    class _Blk:
        columns = {"c": _Col()}

    cache = DeviceBlockCache(budget=1 << 20)
    fills = []
    gate = threading.Event()
    done: list = []

    def make_blocks():
        fills.append(1)
        gate.wait(10)
        return iter([_Blk()])

    def run():
        done.append(len(list(cache.stream(("k",), make_blocks))))

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    # let every thread reach the flight gate, then release the filler
    import time as _time

    _time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert done == [1, 1, 1, 1]
    assert len(fills) == 1  # single flight: one decode for 4 scans
    assert cache.flight_waits >= 1
    assert cache.hits >= 3


def test_blockcache_flight_released_on_abandoned_stream():
    """A filler whose consumer abandons the stream mid-way must still
    release the flight so later scans are not wedged."""
    from ydb_tpu_torch.engine.blockcache import DeviceBlockCache

    class _Col:
        data = np.zeros(8, dtype=np.int64)
        validity = np.ones(8, dtype=bool)

    class _Blk:
        columns = {"c": _Col()}

    cache = DeviceBlockCache(budget=1 << 20)
    g = cache.stream(("k",), lambda: iter([_Blk(), _Blk()]))
    next(g)
    g.close()  # abandon mid-stream
    with cache._lock:
        assert ("k",) not in cache._flights
    # the next scan fills normally (no 30s wait)
    assert len(list(cache.stream(("k",), lambda: iter([_Blk()])))) == 1


def test_bounded_under_sustained_ingest_and_scan(monkeypatch):
    """Sustained ingest+scan stress: resident bytes never exceed the
    valve; spills/evictions absorb the pressure."""
    resident_mod.RESIDENT_FORCE = True
    monkeypatch.setenv("YDB_TPU_TORCH_RESIDENT_BYTES", str(64 << 10))
    shard = _shard()
    total = 0
    for i in range(12):
        ids = list(range(i * 500, (i + 1) * 500))
        shard.commit([_write(shard, ids)])
        total += len(ids)
        _sum_n(shard)
        shard.resident.drain()
        assert shard.resident.nbytes <= 64 << 10
    snap = shard.resident.snapshot()
    assert snap["evictions"] + snap["spills"] > 0
    assert _sum_n(shard)[1] == total
