"""The port's column statistics on the CPU: sketch error bounds and merge
algebra, zone-map semantics + portion header round-trips (v0/v1), scan
pruning bit-identity (incl. the upsert shadow hazard and the
filter-skip fast path), the StatisticsAggregator's refresh, cost-model
tier choice, SQL scans over a sharded table with pruning on and off,
and the DQ build-side selection — the Cluster-free cases of
``tests/test_stats.py`` against ``ydb_tpu_torch``, with the Cluster
cases restated over ``MultiShardStreamSource`` (the aggregator's
snapshot store, the sysviews and the viewer come with the session
plane)."""

import numpy as np
import pytest

from ydb_tpu_torch import dtypes
from ydb_tpu_torch import stats as stats_mod
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.engine.portion import (
    PortionChunkReader,
    PortionMeta,
    column_stats,
    read_portion_blob,
    write_portion_blob,
)
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.ssa import Agg, AggSpec, Call, Col, FilterStep, GroupByStep, Op
from ydb_tpu_torch.ssa.program import DictPredicate, Program, ProjectStep, lit
from ydb_tpu_torch.stats.aggregator import StatisticsAggregator
from ydb_tpu_torch.stats.sketch import ColumnSketch, CountMinSketch, HyperLogLog
from ydb_tpu_torch.stats import cost, zonemap
from ydb_tpu_torch.stats.zonemap import Pred


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port's entry points default to CUDA; these tests ask for the
    CPU."""
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


@pytest.fixture
def stats_on():
    stats_mod.STATS_FORCE = True
    yield
    stats_mod.STATS_FORCE = None


def _force(flag):
    stats_mod.STATS_FORCE = flag


# ---------------- sketches ----------------


def test_hll_ndv_relative_error_across_distributions():
    rng = np.random.default_rng(7)
    cases = {
        "uniform": rng.integers(0, 20000, 100_000),
        "all_distinct": np.arange(50_000),
        "all_equal": np.zeros(50_000, dtype=np.int64),
        "skewed": rng.zipf(1.3, 100_000) % 100_000,
        "floats": rng.normal(size=30_000).round(3),
    }
    for name, vals in cases.items():
        h = HyperLogLog()
        h.add_many(vals)
        true = len(np.unique(vals))
        rel = abs(h.estimate() - true) / max(true, 1)
        assert rel < 0.10, f"{name}: rel err {rel:.3f} (true {true})"


def test_cms_error_bounds_on_skewed_data():
    rng = np.random.default_rng(3)
    vals = rng.zipf(1.5, 100_000) % 5000
    c = CountMinSketch()
    c.add_many(vals)
    counts = np.bincount(vals)
    eps_bound = int(np.e / c.width * len(vals)) + 1
    for v in list(range(20)) + [4999]:
        true = int(counts[v]) if v < len(counts) else 0
        est = c.estimate(v)
        assert est >= true  # count-min never underestimates
        assert est <= true + eps_bound


def test_merge_associative_commutative_and_lossless():
    rng = np.random.default_rng(9)
    parts = [rng.integers(0, 5000, 30_000) for _ in range(3)]
    singles_h = []
    singles_c = []
    for p in parts:
        h, c = HyperLogLog(), CountMinSketch()
        h.add_many(p)
        c.add_many(p)
        singles_h.append(h)
        singles_c.append(c)
    a, b, c3 = singles_h
    left = a.merge(b).merge(c3)
    right = a.merge(b.merge(c3))
    swapped = c3.merge(a).merge(b)
    assert np.array_equal(left.registers, right.registers)
    assert np.array_equal(left.registers, swapped.registers)
    one = HyperLogLog()
    one.add_many(np.concatenate(parts))
    assert np.array_equal(left.registers, one.registers)  # lossless fold
    ca, cb, cc = singles_c
    assert np.array_equal(ca.merge(cb).merge(cc).table,
                          cc.merge(ca.merge(cb)).table)


def test_sketch_json_roundtrip():
    sk = ColumnSketch()
    sk.observe(np.asarray([1, 2, 2, 3]),
               np.asarray([True, True, True, False]))
    back = ColumnSketch.from_json(sk.to_json())
    assert back.rows == 4 and back.nulls == 1
    assert (back.vmin, back.vmax) == (1, 2)
    assert np.array_equal(back.hll.registers, sk.hll.registers)
    assert np.array_equal(back.cms.table, sk.cms.table)


# ---------------- zone maps + column_stats ----------------


def test_column_stats_dtype_aware():
    # floats keep float bounds (the old int() cast truncated them)
    fmin, fmax = column_stats(np.asarray([0.5, 2.25, -1.5]))
    assert (fmin, fmax) == (-1.5, 2.25)
    assert isinstance(fmin, float)
    # ints (dict ids, scaled decimals) stay ints
    imin, imax = column_stats(np.asarray([150, 25], dtype=np.int64))
    assert (imin, imax) == (25, 150) and isinstance(imin, int)
    # validity excludes NULL slots from the bounds
    vmin, vmax = column_stats(np.asarray([7, 99, 1]),
                              np.asarray([True, False, True]))
    assert (vmin, vmax) == (1, 7)
    assert column_stats(np.asarray([], dtype=np.int64)) == (None, None)


def test_match_zone_trichotomy():
    z = [10, 20, 0]
    assert zonemap.match_zone(z, Pred("c", "eq", 25)) == "none"
    assert zonemap.match_zone(z, Pred("c", "eq", 15)) == "some"
    assert zonemap.match_zone([15, 15, 0], Pred("c", "eq", 15)) == "all"
    assert zonemap.match_zone(z, Pred("c", "lt", 10)) == "none"
    assert zonemap.match_zone(z, Pred("c", "lt", 21)) == "all"
    assert zonemap.match_zone(z, Pred("c", "ge", 10)) == "all"
    assert zonemap.match_zone(z, Pred("c", "gt", 20)) == "none"
    assert zonemap.match_zone(z, Pred("c", "in", (1, 2))) == "none"
    assert zonemap.match_zone(z, Pred("c", "in", (15,))) == "some"
    # NULLs block 'all' (a NULL row fails every comparison) but not
    # 'none'
    zn = [10, 20, 3]
    assert zonemap.match_zone(zn, Pred("c", "ge", 5)) == "some"
    assert zonemap.match_zone(zn, Pred("c", "gt", 20)) == "none"
    # all-NULL zone: no row can match anything
    assert zonemap.match_zone([None, None, 8], Pred("c", "eq", 1)) == "none"
    # unknown zone / NaN bounds: always read
    assert zonemap.match_zone(None, Pred("c", "eq", 1)) == "some"
    assert zonemap.match_zone([float("nan"), float("nan"), 0],
                              Pred("c", "lt", 0)) == "some"
    assert zonemap.match_zone(z, Pred("c", "never")) == "none"


def test_extract_predicates_shapes():
    schema = dtypes.schema(("a", dtypes.INT64), ("b", dtypes.decimal(2)),
                           ("s", dtypes.STRING))
    from ydb_tpu_torch.blocks.dictionary import DictionarySet

    dicts = DictionarySet()
    d = dicts.for_column("s")
    d.add(b"x")
    d.add(b"y")
    prog = Program((
        FilterStep(Call(Op.AND,
                        Call(Op.GE, Col("a"), lit(5)),
                        Call(Op.GT, lit(9), Col("a")))),  # flipped: a < 9
        FilterStep(DictPredicate("s", "eq", b"y")),
        FilterStep(Call(Op.IN_SET, Col("a"), lit(1), lit(2))),
        GroupByStep(("a",), (AggSpec(Agg.COUNT_ALL, None, "n"),)),
        # after the group-by: must NOT become a pruning predicate
        FilterStep(Call(Op.GE, Col("n"), lit(1))),
    ))
    preds, full = zonemap.extract_predicates(prog, schema, dicts)
    got = {(p.column, p.op, p.value) for p in preds}
    assert got == {("a", "ge", 5), ("a", "lt", 9), ("s", "eq", 1),
                   ("a", "in", (1, 2))}
    assert full == {0, 1, 2}
    # decimal literals land in the column's scaled physical domain
    prog2 = Program((FilterStep(Call(Op.GE, Col("b"),
                                     lit(3.5, dtypes.DOUBLE))),))
    (p,), _ = zonemap.extract_predicates(prog2, schema)
    assert p.value == 350.0
    # a column shadowed by an assign no longer describes stored bytes
    from ydb_tpu_torch.ssa.program import AssignStep

    prog3 = Program((
        AssignStep("a", Call(Op.ADD, Col("a"), lit(1))),
        FilterStep(Call(Op.GE, Col("a"), lit(5))),
    ))
    preds3, full3 = zonemap.extract_predicates(prog3, schema)
    assert preds3 == [] and full3 == set()
    # an absent dictionary literal is provably constant-false
    prog4 = Program((FilterStep(DictPredicate("s", "eq", b"zzz")),))
    (p4,), _ = zonemap.extract_predicates(prog4, schema, dicts)
    assert p4.op == "never"


# ---------------- portion headers: v0 + v1 round-trip ----------------


def _cols(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    cols = {
        "pk": np.arange(n, dtype=np.int64),
        "f": rng.normal(size=n),
        "d": rng.integers(0, 10**4, n).astype(np.int64),
    }
    validity = {"d": rng.random(n) > 0.1}
    return cols, validity


def test_header_v1_zones_and_v0_compat():
    store = MemBlobStore()
    cols, validity = _cols()
    write_portion_blob(store, "b1", cols, validity, chunk_rows=256,
                       pk_column="pk")
    rd = PortionChunkReader(store, "b1")
    assert rd.version == 1
    meta = rd.chunk_meta(0)
    assert meta["pk_min"] == 0 and meta["pk_max"] == 255
    z = meta["zones"]
    assert z["pk"][:2] == [0, 255]
    assert isinstance(z["f"][0], float)  # dtype-aware, not int-cast
    assert z["d"][2] > 0  # null counts recorded
    # v0 write (stats off) reads identically, just without zones
    write_portion_blob(store, "b0", cols, validity, chunk_rows=256,
                       pk_column="pk", stats=False)
    rd0 = PortionChunkReader(store, "b0")
    assert rd0.version == 0
    assert "zones" not in rd0.chunk_meta(0)
    c1, v1 = read_portion_blob(store, "b1")
    c0, v0 = read_portion_blob(store, "b0")
    for name in cols:
        assert np.array_equal(c1[name], c0[name])
        assert np.array_equal(v1.get(name, True), v0.get(name, True))


def test_portion_meta_json_roundtrip_with_and_without_zones():
    m = PortionMeta(1, "b", 10, commit_snap=2,
                    zones={"a": [1, 5, 0]})
    back = PortionMeta.from_json(m.to_json())
    assert back.zones == {"a": [1, 5, 0]}
    # v0 metadata (pre-stats checkpoints) still loads
    legacy = {"portion_id": 1, "blob_id": "b", "num_rows": 10,
              "commit_snap": 2}
    assert PortionMeta.from_json(legacy).zones is None


# ---------------- shard scan pruning ----------------


SCHEMA = dtypes.schema(
    ("id", dtypes.INT64, False),
    ("ts", dtypes.INT64, False),
    ("val", dtypes.INT64),
)


def _shard(upsert=False, chunk_rows=128):
    return ColumnShard(
        "s1", SCHEMA, MemBlobStore(), pk_column="id", upsert=upsert,
        config=ShardConfig(compact_portion_threshold=10**9,
                           portion_chunk_rows=chunk_rows))


def _fill(shard, commits=4, per=512, seed=1):
    rng = np.random.default_rng(seed)
    for c in range(commits):
        base = c * per
        shard.commit([shard.write(
            {"id": (base + np.arange(per)).astype(np.int64),
             "ts": (base + np.arange(per)).astype(np.int64),
             "val": rng.integers(0, 100, per).astype(np.int64)},
            {"val": rng.random(per) > 0.05},
        )])
    return commits * per


def _table(res):
    order = np.argsort(np.asarray(res.column(res.schema.names[0])))
    out = {}
    for name, (v, ok) in res.cols.items():
        v, ok = np.asarray(v), np.asarray(ok)
        out[name] = (np.where(ok, v, 0)[order], ok[order])
    return out


def _assert_same(a, b):
    ta, tb = _table(a), _table(b)
    assert set(ta) == set(tb)
    for name in ta:
        assert np.array_equal(ta[name][0], tb[name][0]), name
        assert np.array_equal(ta[name][1], tb[name][1]), name


def test_selective_scan_prunes_and_stays_bit_identical():
    shard = _shard()
    n = _fill(shard)
    prog = Program((
        FilterStep(Call(Op.AND,
                        Call(Op.GE, Col("ts"), lit(n // 2)),
                        Call(Op.LT, Col("ts"), lit(n // 2 + 100)))),
        GroupByStep((), (AggSpec(Agg.COUNT_ALL, None, "n"),
                         AggSpec(Agg.SUM, "val", "s"),
                         AggSpec(Agg.MIN, "ts", "lo"))),
    ))
    _force(True)
    try:
        on = shard.scan(prog)
        p = dict(shard.last_scan_pruning)
    finally:
        _force(None)
    _force(False)
    try:
        off = shard.scan(prog)
        p_off = dict(shard.last_scan_pruning)
    finally:
        _force(None)
    _assert_same(on, off)
    assert int(np.asarray(on.column("n"))[0]) == 100
    # >= 2x fewer chunk reads on the <= 10% selectivity predicate
    assert p["chunks_read"] * 2 <= p_off["chunks_read"]
    assert p["chunks_skipped"] + p["portions_skipped"] > 0
    assert p_off["chunks_skipped"] == 0
    # cumulative counters surfaced for the sys view
    assert shard.pruning_totals["scans"] == 2


def test_filter_skip_fast_path_drops_proven_filters():
    shard = _shard()
    n = _fill(shard)
    # NOT NULL column predicate every row satisfies -> droppable
    prog = Program((
        FilterStep(Call(Op.GE, Col("ts"), lit(0))),
        GroupByStep((), (AggSpec(Agg.COUNT_ALL, None, "n"),)),
    ))
    _force(True)
    try:
        on = shard.scan(prog)
        p = dict(shard.last_scan_pruning)
    finally:
        _force(None)
    _force(False)
    try:
        off = shard.scan(prog)
    finally:
        _force(None)
    assert p["filters_dropped"] == 1
    assert p["chunks_fastpath"] == p["chunks_read"] > 0
    _assert_same(on, off)
    assert int(np.asarray(on.column("n"))[0]) == n
    # a NULLABLE column predicate must NOT be dropped (NULL rows fail
    # the filter even when the value bounds all match)
    prog2 = Program((
        FilterStep(Call(Op.GE, Col("val"), lit(0))),
        GroupByStep((), (AggSpec(Agg.COUNT_ALL, None, "n"),)),
    ))
    _force(True)
    try:
        on2 = shard.scan(prog2)
        p2 = dict(shard.last_scan_pruning)
    finally:
        _force(None)
    assert p2["filters_dropped"] == 0
    assert int(np.asarray(on2.column("n"))[0]) < n


def test_upsert_shadowing_defeats_naive_pruning():
    """A newer row version that FAILS the filter shadows an older
    version that passes: pruning the newer portion would resurrect the
    old row. The stats path must keep upsert results identical."""
    shard = _shard(upsert=True)
    ids = np.arange(64, dtype=np.int64)
    shard.commit([shard.write(
        {"id": ids, "ts": ids, "val": np.full(64, 10, dtype=np.int64)})])
    # overwrite the same PKs with values OUTSIDE the filter range
    shard.commit([shard.write(
        {"id": ids, "ts": ids, "val": np.full(64, 999, dtype=np.int64)})])
    prog = Program((
        FilterStep(Call(Op.LE, Col("val"), lit(50))),
        GroupByStep((), (AggSpec(Agg.COUNT_ALL, None, "n"),)),
    ))
    _force(True)
    try:
        on = shard.scan(prog)
    finally:
        _force(None)
    _force(False)
    try:
        off = shard.scan(prog)
    finally:
        _force(None)
    # newest-wins: every visible row has val=999, nothing matches
    assert int(np.asarray(on.column("n"))[0]) == 0
    _assert_same(on, off)


def test_visible_portions_value_preds_generalize_pk_path():
    shard = _shard()
    _fill(shard, commits=4, per=256)
    # PK special case still prunes (the legacy spelling)
    assert len(shard.visible_portions(pk_range=(900, None))) == 1
    # general value predicate on a non-PK column through zone maps
    kept = shard.visible_portions(preds=[Pred("ts", "ge", 900)])
    assert len(kept) == 1
    kept2 = shard.visible_portions(preds=[Pred("val", "gt", 10**9)])
    assert kept2 == []
    assert len(shard.visible_portions(preds=[Pred("c", "never")])) == 0


def test_v0_portions_scan_unpruned_but_correct(stats_on):
    """Portions written before zone maps (no meta.zones, v0 headers)
    must keep scanning correctly with stats enabled — conservative
    unpruned reads."""
    shard = _shard()
    n = _fill(shard, commits=2, per=256)
    for m in shard.visible_portions():
        m.zones = None  # simulate pre-stats metadata
    prog = Program((
        FilterStep(Call(Op.GE, Col("ts"), lit(n - 10))),
        GroupByStep((), (AggSpec(Agg.COUNT_ALL, None, "n"),)),
    ))
    assert int(np.asarray(shard.scan(prog).column("n"))[0]) == 10


def test_group_key_bounds_from_zones(stats_on):
    """Integer group keys gain exact dense-tier bounds from zone maps;
    results match the statless plan."""
    shard = _shard()
    rng = np.random.default_rng(5)
    for c in range(3):
        per = 300
        shard.commit([shard.write(
            {"id": (c * per + np.arange(per)).astype(np.int64),
             "ts": (c * per + np.arange(per)).astype(np.int64),
             "val": rng.integers(0, 7, per).astype(np.int64)})])
    prog = Program((
        GroupByStep(("val",), (AggSpec(Agg.COUNT_ALL, None, "n"),)),
    ))
    on = shard.scan(prog)
    _force(False)
    try:
        off = shard.scan(prog)
    finally:
        _force(True)
    _assert_same(on, off)
    assert int(np.asarray(on.column("n")).sum()) == 900


# ---------------- compiler: NDV tier choice + capacity ----------------


def test_group_est_demotes_dense_to_sorted_identically():
    from ydb_tpu_torch.blocks.block import TableBlock, device_aux
    from ydb_tpu_torch.ssa.compiler import compile_program

    rng = np.random.default_rng(2)
    schema = dtypes.schema(("a", dtypes.INT64), ("b", dtypes.INT64),
                           ("v", dtypes.INT64))
    n = 4096
    cols = {
        "a": rng.integers(0, 50, n).astype(np.int64),
        "b": (rng.integers(0, 50, n) // 10 * 10).astype(np.int64),
        "v": rng.integers(0, 100, n).astype(np.int64),
    }
    prog = Program((
        GroupByStep(("a", "b"), (AggSpec(Agg.SUM, "v", "s"),
                                 AggSpec(Agg.COUNT_ALL, None, "n"))),
    ))
    spaces = {"a": 50, "b": 50}
    blk = TableBlock.from_numpy(cols, schema, device="cpu")
    outs = {}
    for label, est in (("dense", None), ("sorted", 60.0)):
        cp = compile_program(prog, schema, key_spaces=spaces,
                             group_est=est)
        aux = device_aux(cp.aux, "cpu")
        outs[label] = cp.run(blk, aux)
    assert outs["dense"] is not None
    layouts = {}
    for label, est in (("dense", None), ("sorted", 60.0)):
        cp = compile_program(prog, schema, key_spaces=spaces,
                             group_est=est)
        layouts[label] = cp.group_layout[0]
    assert layouts["dense"] == "dense"
    assert layouts["sorted"] == "compact"  # NDV demoted the tier

    def rows(blk):
        m = int(blk.length)
        key = [np.asarray(blk.columns["a"].data[:m]),
               np.asarray(blk.columns["b"].data[:m])]
        order = np.lexsort((key[1], key[0]))
        return {n_: np.asarray(blk.columns[n_].data[:m])[order]
                for n_ in ("a", "b", "s", "n")}
    ra, rb = rows(outs["dense"]), rows(outs["sorted"])
    for name in ra:
        assert np.array_equal(ra[name], rb[name]), name


def test_choose_group_tier_matches_truth_on_bench_shapes():
    # kernelbench shape: 16 groups, HLL-estimated
    for true_groups in (7, 16, 512, 5000):
        vals = np.arange(true_groups)
        h = HyperLogLog()
        h.add_many(vals)
        assert cost.choose_group_tier(h.estimate()) == \
            cost.choose_group_tier(true_groups)


def test_cost_selectivity_and_group_count():
    st = cost.TableStats(rows=1000, columns={
        "a": cost.ColumnStats(ndv=100, nulls=0, rows=1000, vmin=0,
                              vmax=999),
        "b": cost.ColumnStats(ndv=10, nulls=100, rows=1000, vmin=0,
                              vmax=9),
    })
    assert cost.pred_selectivity(Pred("a", "eq", 5), st) == \
        pytest.approx(0.01)
    # band predicate intersects exactly instead of multiplying
    band = [Pred("a", "ge", 0), Pred("a", "lt", 100)]
    assert cost.conj_selectivity(band, st) == pytest.approx(0.1, rel=0.1)
    assert cost.pred_selectivity(Pred("c", "never"), st) == 0.0
    g = cost.estimate_group_count(("a", "b"), st)
    assert g == 1000  # capped by row count (100 * 11 > rows)
    assert cost.estimate_group_count(("b",), st) == 11  # NULL group


# ---------------- aggregator ----------------


def test_aggregator_refresh_ndv_and_forget():
    store = MemBlobStore()
    shard = ColumnShard("s1", SCHEMA, store, pk_column="id",
                        config=ShardConfig(
                            compact_portion_threshold=10**9,
                            portion_chunk_rows=128))
    rng = np.random.default_rng(4)
    for c in range(3):
        per = 500
        shard.commit([shard.write(
            {"id": (c * per + np.arange(per)).astype(np.int64),
             "ts": (c * per + np.arange(per)).astype(np.int64),
             "val": rng.integers(0, 200, per).astype(np.int64)},
            {"val": rng.random(per) > 0.1})])
    agg = StatisticsAggregator()
    st = agg.refresh_table("t", [shard])
    assert st.rows == 1500
    cs = st.columns["id"]
    assert abs(cs.ndv - 1500) / 1500 < 0.10
    assert st.columns["val"].nulls > 0
    assert st.columns["val"].vmin >= 0
    assert agg.table_stats("t") is st
    # incremental: second refresh recomputes nothing (portion cache)
    before = len(agg._portions)
    agg.refresh_table("t", [shard])
    assert len(agg._portions) == before
    agg.forget("t")
    assert agg.table_stats("t") is None


def test_drop_recreate_table_does_not_serve_stale_sketches():
    """A re-created same-name table reuses shard AND portion ids: the
    aggregator's per-portion sketch cache must not serve the dropped
    table's sketches as the new table's statistics (``forget`` with the
    shard ids purges them)."""
    sch = dtypes.schema(("a", dtypes.INT64, False), ("b", dtypes.INT64))

    def table(b):
        sh = ColumnShard("t/0", sch, MemBlobStore(), pk_column="a")
        sh.commit([sh.write({"a": np.arange(50, dtype=np.int64),
                             "b": np.asarray(b, dtype=np.int64)})])
        return sh

    agg = StatisticsAggregator()
    agg.refresh_table("t", [table([1] * 50)])  # b: 1 distinct value
    assert agg.table_stats("t").columns["b"].ndv == 1
    agg.forget("t", shard_ids=("t/0",))
    cs = agg.refresh_table("t", [table(range(50))]).columns["b"]
    assert abs(cs.ndv - 50) / 50 < 0.2, cs.ndv


def test_aggregator_steady_state_refresh_is_cached():
    """An unchanged portion set must serve the cached TableStats object
    (no re-merge) until a commit changes it."""
    store = MemBlobStore()
    shard = ColumnShard("s1", SCHEMA, store, pk_column="id",
                        config=ShardConfig(
                            compact_portion_threshold=10**9))
    shard.commit([shard.write(
        {"id": np.arange(10, dtype=np.int64),
         "ts": np.arange(10, dtype=np.int64),
         "val": np.arange(10, dtype=np.int64)})])
    agg = StatisticsAggregator()
    st1 = agg.refresh_table("t", [shard])
    assert agg.refresh_table("t", [shard]) is st1  # cached object
    shard.commit([shard.write(
        {"id": np.arange(10, 20, dtype=np.int64),
         "ts": np.arange(10, 20, dtype=np.int64),
         "val": np.arange(10, dtype=np.int64)})])
    st2 = agg.refresh_table("t", [shard])
    assert st2 is not st1 and st2.rows == 20


def test_aggregator_background_thread_lifecycle():
    import threading

    agg = StatisticsAggregator()
    fired = threading.Event()
    agg.start(0.01, fired.set)
    assert fired.wait(2.0)
    agg.stop()
    assert agg._thread is None


# ---------------- SQL path + sysviews ----------------


def test_sql_scan_pruning_bit_identical_over_shards():
    """SQL over a two-shard table served by a MultiShardStreamSource:
    the scan's filters prune portions by their zone maps, and the result
    is bit-identical with statistics on and off."""
    from ydb_tpu_torch.blocks.dictionary import DictionarySet
    from ydb_tpu_torch.engine.reader import MultiShardStreamSource
    from ydb_tpu_torch.plan import Database, execute_plan, to_host
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import Catalog, plan_select_full

    sch = dtypes.schema(("id", dtypes.INT64, False),
                        ("ts", dtypes.INT64, False),
                        ("tag", dtypes.STRING), ("val", dtypes.INT32))
    dicts = DictionarySet()
    shards = [ColumnShard(f"ev/{i}", sch, MemBlobStore(), pk_column="id",
                          dicts=dicts) for i in range(2)]
    for i in range(3):
        ids = np.arange(i * 100, i * 100 + 50, dtype=np.int64)
        cols = shards[0].encode_strings({
            "id": ids, "ts": ids,
            "tag": [f"t{j % 3}".encode() for j in range(50)],
            "val": np.arange(50, dtype=np.int32)})
        sh = shards[i % 2]
        sh.commit([sh.write(cols)])
    src = MultiShardStreamSource(shards, sch, dicts)
    db = Database({"ev": src}, dicts=dicts, device="cpu")
    cat = Catalog(schemas={"ev": sch}, primary_keys={"ev": ("id",)},
                  dicts=dicts)

    def run(q):
        pq = plan_select_full(parse(q), cat)
        return to_host(execute_plan(pq.plan, db))

    q = ("select tag, count(*) as n, sum(val) as sv from ev "
         "where ts >= 200 and ts < 230 group by tag order by tag")
    _force(True)
    try:
        on = run(q)
        view = executor_pruned(src, q, cat, db)
    finally:
        _force(None)
    _force(False)
    try:
        off = run(q)
    finally:
        _force(None)
    assert np.array_equal(np.asarray(on.column("n")),
                          np.asarray(off.column("n")))
    assert np.array_equal(np.asarray(on.column("sv")),
                          np.asarray(off.column("sv")))
    assert int(np.asarray(on.column("n")).sum()) == 30
    # the two portions of ts in [0, 150) are pruned away by their zones
    assert view.portions_skipped == 2
    # a dictionary-absent literal is constant-false end to end
    none = run("select count(*) as n from ev where tag = 'zzz'")
    assert int(np.asarray(none.column("n"))[0]) == 0


def executor_pruned(src, q, cat, db):
    """The pruned view the SQL scan of ``q`` reads."""
    from ydb_tpu_torch.plan import executor
    from ydb_tpu_torch.plan.nodes import TableScan
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full

    plan = plan_select_full(parse(q), cat).plan
    scan = next(n for n in executor._plan_nodes(plan)
                if isinstance(n, TableScan))
    return executor._pruned_source(src, scan.program, db)


# ---------------- DQ build-side selection ----------------


def test_dq_build_side_swap_from_estimates():
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.kqp.dq_lower import execute_plan_dq, plan_to_stages, \
        partition_source
    from ydb_tpu_torch.plan.nodes import ExpandJoin, TableScan, Transform
    from ydb_tpu_torch.runtime.actors import ActorSystem

    rng = np.random.default_rng(6)
    big_n, small_n = 4000, 64
    big = ColumnSource(
        {"k": rng.integers(0, 50, big_n).astype(np.int64),
         "x": rng.integers(0, 100, big_n).astype(np.int64)},
        dtypes.schema(("k", dtypes.INT64), ("x", dtypes.INT64)))
    small = ColumnSource(
        {"k": np.arange(small_n, dtype=np.int64) % 50,
         "y": np.arange(small_n, dtype=np.int64)},
        dtypes.schema(("k", dtypes.INT64), ("y", dtypes.INT64)))
    plan = Transform(
        ExpandJoin(
            TableScan("small", Program((ProjectStep(("k", "y")),))),
            TableScan("big", Program((ProjectStep(("k", "x")),))),
            ("k",), ("k",), ("k", "y"), ("x",)),
        Program((GroupByStep((), (AggSpec(Agg.COUNT_ALL, None, "n"),
                                  AggSpec(Agg.SUM, "x", "sx"),
                                  AggSpec(Agg.SUM, "y", "sy"))),)))

    def estimator(node):
        if isinstance(node, TableScan):
            return float(big_n if node.table == "big" else small_n)
        return None

    # with estimates + swap allowed, the big "build" becomes the probe
    stages = plan_to_stages(plan, estimator=estimator, allow_swap=True)
    join_stage = next(st for st in stages if st.join is not None)
    assert join_stage.join.probe_payload == ("x",)
    baseline = plan_to_stages(plan)
    base_join = next(st for st in baseline if st.join is not None)
    assert base_join.join.probe_payload == ("k", "y")

    sources = {"big": partition_source(big, 2),
               "small": partition_source(small, 2)}
    outs = {}
    for label, kw in (("plain", {}),
                      ("stats", {"estimator": estimator,
                                 "allow_swap": True})):
        outs[label] = execute_plan_dq(
            plan, sources, ActorSystem(node=1), **kw)
    for col in ("n", "sx", "sy"):
        assert np.array_equal(np.asarray(outs["plain"].column(col)),
                              np.asarray(outs["stats"].column(col))), col
