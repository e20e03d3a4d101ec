"""The port's ColumnShard storage path against the reference's, on the CPU.

The same writes, made from a numpy seed, go into a reference
``ydb_tpu.engine.shard.ColumnShard`` and a port ``ydb_tpu_torch`` one,
and the same programs scan both:

* TPC-H Q1, Q6 and ClickBench's ``GROUP BY URL`` (q33, 1,748 groups,
  the group-by tier of the two CUDA kernels) through ``shard.scan`` with
  the defaults (statistics, morsel pipeline and resident tier on; the
  resident budget forced on, as a CPU has none by default) and with each
  of the three off. Integers, dictionary ids and validity match bit for
  bit, floats within rtol 1e-12; the port's results are also identical
  across the four settings.
* Upsert dedup (``native.kway_merge`` and an overlapping-upsert scan),
  ``extract_predicates`` field by field, sketch and NDV values,
  ``estimate_plan_rows`` and ``plan_to_stages(estimator=...,
  allow_swap=True)``, and the
  portion metadata after compaction, TTL, ``gc_blobs`` and
  checkpoint + boot.
* TPC-H SQL over sharded tables: the eight tables at sf 0.01, seed 11,
  each split over two shards by primary-key range and served as a
  ``MultiShardStreamSource`` with a block cache, all 22 queries through the default routing (DQ takes one
  partition per shard) and through the walk, against the goldens.

The reference's GROUP BYs of more than 512 groups import its Pallas
module, which jax 0.9 cannot load; it is replaced for each test by a
stand-in whose ``enabled()`` is False, as the other port tests do.
"""

import dataclasses
import enum
import importlib
import sys
import types

import numpy as np
import pytest
import torch

import ydb_tpu.ssa
from test_torch_sql import GOLDEN, digest
from ydb_tpu_torch.workload.queries import TPCH

QUERIES = sorted(TPCH, key=lambda q: int(q[1:]))
SETTINGS = ("default", "stats_off", "pipeline_off", "resident_off")


def _mods(root: str) -> types.SimpleNamespace:
    names = ("dtypes", "native", "stats", "stats.zonemap", "stats.sketch",
             "stats.cost", "stats.aggregator", "engine.blobs",
             "engine.shard", "engine.reader", "engine.resident",
             "engine.stream_sched", "engine.blockcache", "engine.portion",
             "workload.tpch", "workload.clickbench", "blocks.dictionary",
             "ssa.program", "ssa.ops", "plan", "plan.executor",
             "kqp.dq_lower", "sql.parser", "sql.planner")
    ns = types.SimpleNamespace(root=root)
    for n in names:
        setattr(ns, n.replace(".", "_"),
                importlib.import_module(f"{root}.{n}"))
    return ns


REF = _mods("ydb_tpu")
PORT = _mods("ydb_tpu_torch")


def _stub_reference(mp):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    mp.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    mp.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


@pytest.fixture(autouse=True)
def stubbed(monkeypatch):
    _stub_reference(monkeypatch)
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small-tensor queries:
    the suite runs in several pytest-xdist workers that share the host's
    cores, and per-op thread pools there cost more than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(mp, setting: str) -> None:
    """Statistics, pipeline and resident tier as ``setting`` says, in
    both packages."""
    for P in (REF, PORT):
        mp.setattr(P.stats, "STATS_FORCE", setting != "stats_off")
        mp.setattr(P.engine_stream_sched, "PIPELINE_FORCE",
                   setting != "pipeline_off")
        mp.setattr(P.engine_resident, "RESIDENT_FORCE",
                   setting != "resident_off")


def assert_same(got, want, exact_floats=False, what=""):
    """Host columns: names, rows, validity and ints bit for bit; floats
    within rtol 1e-12 (bit for bit with ``exact_floats``)."""
    assert list(got.schema.names) == list(want.schema.names), what
    assert got.num_rows == want.num_rows, what
    for name in want.schema.names:
        gv, go = (np.asarray(x) for x in got.cols[name])
        wv, wo = (np.asarray(x) for x in want.cols[name])
        np.testing.assert_array_equal(go, wo, err_msg=f"{what} {name}")
        assert gv.dtype == wv.dtype, (what, name, gv.dtype, wv.dtype)
        if np.issubdtype(wv.dtype, np.floating) and not exact_floats:
            np.testing.assert_allclose(gv[wo], wv[wo], rtol=1e-12,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(gv[wo], wv[wo],
                                          err_msg=f"{what} {name}")


# ---------------- shard.scan parity: Q1, Q6, GROUP BY URL ----------------


def _shard(P, name, schema, dicts, cols, n_commits, **cfg):
    kw = {"device": "cpu"} if P is PORT else {}
    config = P.engine_shard.ShardConfig(
        compact_portion_threshold=10 ** 9, portion_chunk_rows=4096,
        scan_block_rows=8192, **cfg)
    sh = P.engine_shard.ColumnShard(name, schema, P.engine_blobs
                                    .MemBlobStore(), dicts=dicts,
                                    config=config, **kw)
    n = len(next(iter(cols.values())))
    step = -(-n // n_commits)
    for lo in range(0, n, step):
        sh.commit([sh.write({k: v[lo:lo + step] for k, v in cols.items()})])
    sh.resident.drain()
    return sh


@pytest.fixture(scope="module")
def shards():
    """Per package: a lineitem shard (sf 0.01, 4 portions) and a hits
    shard (20,000 rows, 3 portions), built with the resident tier forced
    on so every portion is promoted at commit."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _stub_reference(mp)
        for P in (REF, PORT):
            mp.setattr(P.engine_resident, "RESIDENT_FORCE", True)
        for label, P in (("ref", REF), ("port", PORT)):
            tp = P.workload_tpch.TpchData(sf=0.01, seed=42)
            cb = P.workload_clickbench.ClickBenchData(rows=20000, seed=42)
            out[label] = {
                "li": _shard(P, "li", P.workload_tpch.LINEITEM_SCHEMA,
                             tp.dicts, tp.tables["lineitem"], 4),
                "hits": _shard(P, "hits", P.workload_clickbench.HITS_SCHEMA,
                               cb.dicts, cb.hits, 3),
            }
    return out


def _q33(P):
    """ClickBench q33 as an SSA program (the port's
    ``clickbench.q33_program``, built from either package's classes)."""
    pr = P.ssa_program
    return pr.Program((
        pr.GroupByStep(("URL",), (pr.AggSpec(P.ssa_ops.Agg.COUNT_ALL, None,
                                             "c"),)),
        pr.SortStep(("c", "URL"), (True, False), limit=10),
    ))


PROGRAMS = {
    "q1": ("li", lambda P: P.workload_tpch.q1_program()),
    "q6": ("li", lambda P: P.workload_tpch.q6_program()),
    "q33_url": ("hits", _q33),
}

#: the port's default-setting result of each program, for bit identity
#: across settings
_PORT_DEFAULT: dict = {}


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("query", sorted(PROGRAMS))
def test_shard_scan_matches_reference(query, setting, shards, monkeypatch):
    _settings(monkeypatch, setting)
    table, make = PROGRAMS[query]
    got = [shards["port"][table].scan(make(PORT)) for _ in range(2)]
    want = shards["ref"][table].scan(make(REF))
    for g in got:
        assert_same(g, want, what=f"{query} {setting}")
    assert_same(got[1], got[0], exact_floats=True)
    port_shard = shards["port"][table]
    if setting != "resident_off":
        # every portion was promoted at commit: the scan read them all
        # from resident tensors
        assert port_shard.last_scan_resident["portions"] == \
            len(port_shard.visible_portions()) - \
            port_shard.last_scan_pruning["portions_skipped"]
    if query == "q33_url":
        # GROUP BY URL keys on a dictionary string: the dense tier over
        # 1,749 slots, the group-by tier of the two CUDA kernels
        layout = port_shard.last_scan_executor.partial.group_layout
        assert layout[0] == "dense" and layout[1] > 512, layout
    base = _PORT_DEFAULT.setdefault(query, got[0])
    assert_same(got[0], base, exact_floats=True, what=f"{query} {setting}")


def test_selective_scan_prunes_portions_and_matches_reference(
        shards, monkeypatch):
    """Q6 with an ``l_orderkey`` range: zone maps skip whole portions in
    both packages, with the same counters and the same answer."""
    _settings(monkeypatch, "default")

    def prog(P):
        from_ = P.workload_tpch.q6_program()
        pr = P.ssa_program
        keep = pr.FilterStep(pr.Call(P.ssa_ops.Op.LT, pr.Col("l_orderkey"),
                                     pr.lit(2000)))
        return pr.Program((keep,) + tuple(from_.steps))

    got = shards["port"]["li"].scan(prog(PORT))
    want = shards["ref"]["li"].scan(prog(REF))
    assert_same(got, want)
    assert shards["port"]["li"].last_scan_pruning == \
        shards["ref"]["li"].last_scan_pruning
    assert shards["port"]["li"].last_scan_pruning["portions_skipped"] > 0


# ---------------- upsert dedup ----------------


@pytest.mark.parametrize("dedup", [False, True])
def test_kway_merge_matches_reference(dedup):
    rng = np.random.default_rng(11)
    runs = [np.sort(rng.integers(0, 500, n)).astype(np.int64)
            for n in (0, 300, 1, 250, 400)]
    got = PORT.native.kway_merge(runs, dedup=dedup)
    want = REF.native.kway_merge(runs, dedup=dedup)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_upsert_scan_matches_reference():
    """Overlapping upserts (K-way newest-wins merge clusters), scanned
    and compacted, in both packages."""
    sch = {}
    outs = {}
    for label, P in (("ref", REF), ("port", PORT)):
        d = P.dtypes
        sch[label] = d.schema(("id", d.INT64, False), ("v", d.INT64),
                              ("w", d.DOUBLE))
        kw = {"device": "cpu"} if P is PORT else {}
        sh = P.engine_shard.ColumnShard(
            "u", sch[label], P.engine_blobs.MemBlobStore(), pk_column="id",
            upsert=True, config=P.engine_shard.ShardConfig(
                compact_portion_threshold=10 ** 9, portion_chunk_rows=64,
                max_portion_rows=256), **kw)
        rng = np.random.default_rng(5)
        for i in range(5):
            ids = rng.integers(0, 600, 300).astype(np.int64)
            sh.commit([sh.write({"id": ids,
                                 "v": np.full(300, i, dtype=np.int64),
                                 "w": rng.random(300)})])
        pr = P.ssa_program
        prog = pr.Program((pr.ProjectStep(("id", "v", "w")),))
        before = sh.scan(prog)
        sh.compact()
        outs[label] = (before, sh.scan(prog),
                       [m.to_json() for m in sh.visible_portions()])
    for g, w in zip(outs["port"][:2], outs["ref"][:2]):
        assert_same(g, w, exact_floats=True)
    assert outs["port"][2] == outs["ref"][2]


# ---------------- statistics ----------------


def _norm(obj):
    """A plain-value form of a dataclass tree (enums by name, numpy
    scalars as Python values), so both packages' objects compare."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # the port's JoinSpec has no fanout_hint: its join stages size
        # expand-join output exactly, with no first guess to carry
        return (type(obj).__name__, tuple(
            (f.name, _norm(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)
            if (type(obj).__name__, f.name) != ("JoinSpec", "fanout_hint")))
    if isinstance(obj, (tuple, list)):
        return tuple(_norm(v) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(_norm(v) for v in obj))
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, bytes):
        return obj
    return obj


def _pred_programs(P):
    pr, Op = P.ssa_program, P.ssa_ops.Op
    tp, cb = P.workload_tpch, P.workload_clickbench
    c, lit = pr.Col, pr.lit
    return {
        "q1": (tp.q1_program(), tp.LINEITEM_SCHEMA),
        "q6": (tp.q6_program(), tp.LINEITEM_SCHEMA),
        "q33": (_q33(P), cb.HITS_SCHEMA),
        "mixed": (pr.Program((
            pr.FilterStep(pr.Call(Op.GE, lit(3), c("l_linenumber"))),
            pr.FilterStep(pr.Call(Op.AND,
                                  pr.Call(Op.NE, c("l_quantity"), lit(0)),
                                  pr.Call(Op.LE, c("l_orderkey"),
                                          lit(900)))),
            pr.FilterStep(pr.DictPredicate("l_returnflag", "eq", b"R")),
            pr.FilterStep(pr.DictPredicate("l_shipmode", "in_set",
                                           (b"AIR", b"MAIL", b"NONE!"))),
            pr.GroupByStep(("l_linestatus",),
                           (pr.AggSpec(P.ssa_ops.Agg.COUNT_ALL, None,
                                       "n"),)),
        )), tp.LINEITEM_SCHEMA),
    }


@pytest.mark.parametrize("name", ["q1", "q6", "q33", "mixed"])
def test_extract_predicates_matches_reference(name):
    got, want = {}, {}
    for P, out in ((PORT, got), (REF, want)):
        tp = P.workload_tpch.TpchData(sf=0.001, seed=3)
        cb = P.workload_clickbench.ClickBenchData(rows=2000, seed=3)
        dicts = cb.dicts if name == "q33" else tp.dicts
        prog, sch = _pred_programs(P)[name]
        preds, full = P.stats_zonemap.extract_predicates(prog, sch, dicts)
        out["preds"] = _norm(preds)
        out["full"] = sorted(full)
        out["fp"] = P.stats_zonemap.preds_fingerprint(preds)
    assert got == want
    assert got["preds"] or name == "q33"


def test_sketches_and_ndv_match_reference():
    rng = np.random.default_rng(9)
    arrays = {
        "ints": rng.integers(0, 5000, 20000).astype(np.int64),
        "zipf": np.minimum(rng.zipf(1.3, 20000), 10 ** 6).astype(np.int64),
        "floats": np.round(rng.random(20000) * 100, 2),
        "ids": rng.integers(0, 40, 20000).astype(np.int32),
    }
    valid = rng.random(20000) > 0.1
    for name, a in arrays.items():
        sk = {}
        for label, P in (("ref", REF), ("port", PORT)):
            s = P.stats_sketch.ColumnSketch()
            s.observe(a[:10000], valid[:10000])
            s2 = P.stats_sketch.ColumnSketch()
            s2.observe(a[10000:], valid[10000:])
            m = s.merge(s2)
            sk[label] = (m.ndv, m.nulls, m.rows, m.vmin, m.vmax,
                         m.max_freq, m.to_json())
        assert sk["port"] == sk["ref"], name
        assert P.stats_zonemap.zone_of(a, valid) == \
            REF.stats_zonemap.zone_of(a, valid), name


def _sharded_tpch(P, sf, seed, n_shards=2, with_cache=True):
    """TPC-H with every table split over ``n_shards`` ColumnShards by
    primary-key range, served as MultiShardStreamSources; returns (data,
    Database, Catalog, shards by table)."""
    tp = P.workload_tpch
    data = tp.TpchData(sf=sf, seed=seed)
    kw = {"device": "cpu"} if P is PORT else {}
    sources, by_table = {}, {}
    for t, cols in data.tables.items():
        pk = tp.PRIMARY_KEYS[t][0]
        sch = data.schema(t)
        keys = cols[pk]
        cuts = np.quantile(keys, np.linspace(0, 1, n_shards + 1)[1:-1])
        part = np.searchsorted(cuts, keys, side="right")
        shs = []
        for i in range(n_shards):
            m = part == i
            sh = P.engine_shard.ColumnShard(
                f"{t}/{i}", sch, P.engine_blobs.MemBlobStore(),
                pk_column=pk, dicts=data.dicts,
                config=P.engine_shard.ShardConfig(
                    compact_portion_threshold=10 ** 9,
                    portion_chunk_rows=1 << 12), **kw)
            if m.any():
                sh.commit([sh.write({k: v[m] for k, v in cols.items()})])
            shs.append(sh)
        by_table[t] = shs
        sources[t] = P.engine_reader.MultiShardStreamSource(
            shs, sch, data.dicts, **kw)
    dbkw = {"device": "cpu"} if P is PORT else {}
    cache = P.engine_blockcache.DeviceBlockCache(budget=256 << 20) \
        if with_cache else None
    db = P.plan.Database(sources=sources, dicts=data.dicts,
                         block_cache=cache, **dbkw)
    cat = P.sql_planner.Catalog(
        schemas={t: data.schema(t) for t in data.tables},
        primary_keys=dict(tp.PRIMARY_KEYS), dicts=data.dicts)
    return data, db, cat, by_table


@pytest.fixture(scope="module")
def sharded_port():
    return _sharded_tpch(PORT, GOLDEN["sf"], GOLDEN["seed"])


def test_table_stats_and_plan_estimates_match_reference(sharded_port):
    """Aggregator TableStats over the same shards, ``estimate_plan_rows``
    of every node of the TPC-H join plans and ``plan_to_stages(estimator=
    ..., allow_swap=True)`` equal the reference's field by field."""
    with pytest.MonkeyPatch.context() as mp:
        _stub_reference(mp)
        ref = _sharded_tpch(REF, GOLDEN["sf"], GOLDEN["seed"],
                            with_cache=False)
    _, pdb, pcat, p_tables = sharded_port
    _, rdb, rcat, r_tables = ref
    p_stats = PORT.stats_aggregator.StatisticsAggregator().refresh_tables(
        p_tables)
    r_stats = REF.stats_aggregator.StatisticsAggregator().refresh_tables(
        r_tables)
    assert sorted(p_stats) == sorted(r_stats) == sorted(p_tables)
    for t in p_stats:
        assert p_stats[t].to_json() == r_stats[t].to_json(), t
    schemas_p = {t: s.schema for t, s in pdb.sources.items()}
    schemas_r = {t: s.schema for t, s in rdb.sources.items()}
    swapped = 0
    for name in ("q3", "q5", "q9", "q10", "q12", "q18", "q21"):
        ppq = PORT.sql_planner.plan_select_full(
            PORT.sql_parser.parse(TPCH[name]), pcat)
        rpq = REF.sql_planner.plan_select_full(
            REF.sql_parser.parse(TPCH[name]), rcat)

        def est_p(node):
            return PORT.stats_cost.estimate_plan_rows(
                node, p_stats, schemas_p)

        def est_r(node):
            return REF.stats_cost.estimate_plan_rows(
                node, r_stats, schemas_r)

        for pn, rn in zip(PORT.plan_executor._plan_nodes(ppq.plan),
                          REF.plan_executor._plan_nodes(rpq.plan)):
            assert est_p(pn) == est_r(rn), (name, type(pn).__name__)
        got = PORT.kqp_dq_lower.plan_to_stages(
            ppq.plan, n_tasks=2, estimator=est_p, allow_swap=True)
        want = REF.kqp_dq_lower.plan_to_stages(
            rpq.plan, n_tasks=2, estimator=est_r, allow_swap=True)
        assert _norm(got) == _norm(want), name
        plain = PORT.kqp_dq_lower.plan_to_stages(ppq.plan, n_tasks=2)
        swapped += _norm(got) != _norm(plain)
    assert swapped > 0  # the estimates swapped some build side


# ---------------- portion metadata through the shard's life ----------------


def _lifecycle(P, tmp_path):
    d = P.dtypes
    sch = d.schema(("id", d.INT64, False), ("ts", d.DATE, False),
                   ("tag", d.STRING), ("val", d.DOUBLE))
    store = P.engine_blobs.DirBlobStore(str(tmp_path / P.root))
    kw = {"device": "cpu"} if P is PORT else {}
    cfg = P.engine_shard.ShardConfig(compact_portion_threshold=10 ** 9,
                                     checkpoint_interval=5,
                                     portion_chunk_rows=50,
                                     max_portion_rows=300)
    sh = P.engine_shard.ColumnShard("life", sch, store, pk_column="id",
                                    ttl_column="ts", config=cfg, **kw)
    rng = np.random.default_rng(21)
    for i in range(6):
        ids = np.arange(i * 120, i * 120 + 120, dtype=np.int64)
        rng.shuffle(ids)
        cols = sh.encode_strings({
            "id": ids, "ts": (ids % 97).astype(np.int32),
            "tag": [f"t{k % 7}".encode() for k in ids],
            "val": rng.random(120)})
        sh.commit([sh.write(cols, {"val": rng.random(120) > 0.2})])
    states = {"written": [m.to_json() for m in sh.visible_portions()]}
    sh.compact()
    states["compacted"] = [m.to_json() for m in sh.visible_portions()]
    states["ttl"] = sh.evict_ttl(30)
    states["after_ttl"] = [m.to_json() for m in sh.visible_portions()]
    states["gc"] = sh.gc_blobs(keep_snap=sh.snap)
    states["blobs"] = sorted(store.list("life/portion/"))
    sh.checkpoint()
    booted = P.engine_shard.ColumnShard.boot(
        "life", sch, store, pk_column="id", ttl_column="ts", config=cfg,
        **kw)
    states["booted"] = [m.to_json() for m in booted.visible_portions()]
    states["snap"] = (sh.snap, booted.snap, booted.next_portion_id)
    pr = P.ssa_program
    states["scan"] = booted.scan(pr.Program((
        pr.ProjectStep(("id", "ts", "tag", "val")),)))
    return states


def test_portion_metadata_through_lifecycle_matches_reference(tmp_path):
    got = _lifecycle(PORT, tmp_path)
    want = _lifecycle(REF, tmp_path)
    assert_same(got.pop("scan"), want.pop("scan"), exact_floats=True)
    assert got == want
    assert got["booted"] == got["after_ttl"]
    assert got["gc"] > 0 and got["ttl"] > 0


# ---------------- TPC-H SQL over sharded tables ----------------


@pytest.mark.parametrize("routing", ["default", "walk"])
@pytest.mark.parametrize("name", QUERIES)
def test_sharded_tpch_sql_matches_golden(name, routing, sharded_port,
                                         monkeypatch):
    from ydb_tpu_torch.ssa import plan_fuse

    data, db, cat, _ = sharded_port
    use_dq = None
    if routing == "walk":
        monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
        use_dq = False

    def scalar_exec(plan, t):
        out = PORT.plan.to_host(PORT.plan.execute_plan(plan, db,
                                                       use_dq=use_dq))
        v, ok = out.cols[out.schema.names[0]]
        return v[0].item(), bool(ok[0])

    pq = PORT.sql_planner.plan_select_full(PORT.sql_parser.parse(TPCH[name]),
                                           cat, scalar_exec)
    res = PORT.plan.to_host(PORT.plan.execute_plan(pq.plan, db,
                                                   use_dq=use_dq))
    res.dict_aliases = pq.dict_aliases
    want = GOLDEN["queries"][name]
    assert res.num_rows == want["rows"], name
    assert digest(res, data.dicts) == want["sha"], name


def test_sharded_sources_partition_dq_by_shard(sharded_port):
    """DQ takes each shard's portion stream as one partition."""
    _, db, _, by_table = sharded_port
    parts = PORT.plan_executor._partition_for_dq(db.sources["lineitem"])
    assert [p.shard for p in parts] == by_table["lineitem"]
