"""Whole-plan fusion in the port (``ydb_tpu_torch/ssa/plan_fuse.py``), on
the CPU, where a fused plan runs its ``run_all`` eagerly.

The cases of ``tests/test_plan_fuse.py`` (EXPLAIN ANALYZE aside: the
port has no tracing yet): fused against the walk, bit for bit, for q3,
q1, q6 and the NULL-pattern join plus aggregate; an expand join that
overflows, grows and still matches; ``shape_class`` equal to the
reference's; a same-class cache hit and a different class that
rebuilds; UDF, oversized and missing tables not fusible; the
``YDB_TPU_TORCH_FUSE_PLAN`` gate. Beyond them: the 22 TPC-H goldens
through the fused path; the port's fused plans against the reference's
fused plans; ``run_stacked`` members against ``run_shared`` (the shape
of ``tests/test_batching.py``); ``fit_blocks`` against the reference's.
A test that captures CUDA graphs is marked ``cuda`` and runs on the card.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import sys
import types

import numpy as np
import pytest
import torch

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.blocks.block import TableBlock as RBlock
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.plan import Database as RDatabase
from ydb_tpu.plan import execute_plan as rexecute
from ydb_tpu.plan import to_host as rto_host
from ydb_tpu.workload import tpch as rtpch

from test_torch_sql import GOLDEN, assert_tables_equal, digest
from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.block import DEFAULT_CAPACITY_QUANTUM, TableBlock
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.plan import Database, execute_plan, executor, to_host
from ydb_tpu_torch.plan.nodes import (
    ExpandJoin,
    LookupJoin,
    TableScan,
    Transform,
)
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import Catalog, plan_select_full
from ydb_tpu_torch.ssa import plan_fuse
from ydb_tpu_torch.ssa.ops import Agg, Op
from ydb_tpu_torch.ssa.program import (
    AggSpec,
    AssignStep,
    Call,
    Col,
    GroupByStep,
    ProjectStep,
    Program,
    SortStep,
    UdfCall,
)
from ydb_tpu_torch.workload import tpch
from ydb_tpu_torch.workload.queries import TPCH

QUERIES = sorted(TPCH, key=lambda q: int(q[1:]))


@pytest.fixture(autouse=True)
def reference_stub(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def make_db(data, device="cpu") -> Database:
    return Database(
        sources={t: ColumnSource(c, data.schema(t), data.dicts)
                 for t, c in data.tables.items()},
        dicts=data.dicts, device=device)


@pytest.fixture(scope="module")
def tpch_db():
    data = tpch.TpchData(sf=0.002, seed=5)
    return make_db(data), data


@pytest.fixture
def answered(monkeypatch):
    """True for each statement whole-plan fusion answered, False for each
    it declined (the walk answered)."""
    seen = []
    real = executor._execute_plan_fused

    def spy(plan, db):
        out = real(plan, db)
        seen.append(out is not None)
        return out

    monkeypatch.setattr(executor, "_execute_plan_fused", spy)
    return seen


def run_ab(plan, db, monkeypatch):
    """Execute fused, then through the walk; returns (fused, walk) host
    tables."""
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    fused = to_host(execute_plan(plan, db, use_dq=False))
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
    walk = to_host(execute_plan(plan, db, use_dq=False))
    return fused, walk


def assert_identical(a, b):
    """Bit-identity: same schema, rows, validity and values (NULL slots
    compared as 0), positionally."""
    assert list(a.schema.names) == list(b.schema.names)
    assert a.num_rows == b.num_rows
    for name in a.schema.names:
        (av, ao), (bv, bo) = a.cols[name], b.cols[name]
        np.testing.assert_array_equal(ao, bo, err_msg=f"validity({name})")
        assert av.dtype == bv.dtype, name
        np.testing.assert_array_equal(np.where(ao, av, 0),
                                      np.where(bo, bv, 0), err_msg=name)


# ---------------- bit-identity with the walk ----------------


def test_q3_joins_topk_bit_identity(tpch_db, answered, monkeypatch):
    db, _ = tpch_db
    plan = tpch.q3_plan()
    assert plan_fuse.plan_signature(plan, db) is not None
    fused, walk = run_ab(plan, db, monkeypatch)
    assert answered == [True]
    assert fused.num_rows == 10
    assert_identical(fused, walk)


@pytest.mark.parametrize("name", ["q1", "q6"])
def test_single_table_aggregate_bit_identity(name, tpch_db, answered,
                                             monkeypatch):
    """Q1's SUM/AVG/COUNT battery + sort, Q6's global aggregate."""
    db, _ = tpch_db
    plan = Transform(TableScan("lineitem"),
                     getattr(tpch, f"{name}_program")())
    fused, walk = run_ab(plan, db, monkeypatch)
    assert answered == [True]
    assert fused.num_rows == (1 if name == "q6" else 4)
    assert_identical(fused, walk)


def null_tables(n=3000, seed=11):
    """Two tables with NULLs in group keys, aggregate inputs and join keys
    (a NULL key matches nothing), as numpy: (arrays, validity, fields)
    per table."""
    rng = np.random.default_rng(seed)
    t_cols = {
        "k": rng.integers(0, 7, n).astype(np.int64),
        "j": rng.integers(0, 50, n).astype(np.int64),
        "v": rng.integers(-100, 100, n).astype(np.int64),
    }
    t_valid = {
        "k": rng.random(n) > 0.1,
        "j": rng.random(n) > 0.15,
        "v": rng.random(n) > 0.2,
    }
    d_cols = {
        "dk": np.arange(50, dtype=np.int64),
        "w": rng.integers(0, 10, 50).astype(np.int64),
    }
    d_valid = {"dk": np.ones(50, bool), "w": rng.random(50) > 0.3}
    return {"t": (t_cols, t_valid, ("k", "j", "v")),
            "d": (d_cols, d_valid, ("dk", "w"))}


def null_db(device="cpu") -> Database:
    return Database(sources={
        name: ColumnSource(cols, dtypes.schema(
            *((f, dtypes.INT64) for f in fields)), validity=valid)
        for name, (cols, valid, fields) in null_tables().items()},
        device=device)


def null_plan(m):
    """The NULL-pattern LEFT join + grouped aggregate, built from the
    plan and program classes of module ``m`` (either package)."""
    return m.Transform(
        m.LookupJoin(
            probe=m.TableScan("t"), build=m.TableScan("d"),
            probe_keys=("j",), build_keys=("dk",),
            payload=("w",), kind="left",
        ),
        m.Program((
            m.AssignStep("vw", m.Call(m.Op.ADD, m.Col("v"), m.Col("w"))),
            m.GroupByStep(
                keys=("k",),
                aggs=(m.AggSpec(m.Agg.SUM, "vw", "s"),
                      m.AggSpec(m.Agg.AVG, "v", "a"),
                      m.AggSpec(m.Agg.COUNT, "w", "c"),
                      m.AggSpec(m.Agg.COUNT_ALL, None, "n")),
            ),
            m.SortStep(keys=("k",)),
        )))


def _port_classes():
    return types.SimpleNamespace(
        Transform=Transform, LookupJoin=LookupJoin, TableScan=TableScan,
        Program=Program, AssignStep=AssignStep, Call=Call, Op=Op, Col=Col,
        GroupByStep=GroupByStep, AggSpec=AggSpec, Agg=Agg,
        SortStep=SortStep)


def _reference_classes():
    from ydb_tpu.plan import nodes
    from ydb_tpu.ssa import ops, program

    return types.SimpleNamespace(
        Transform=nodes.Transform, LookupJoin=nodes.LookupJoin,
        TableScan=nodes.TableScan, Program=program.Program,
        AssignStep=program.AssignStep, Call=program.Call, Op=ops.Op,
        Col=program.Col, GroupByStep=program.GroupByStep,
        AggSpec=program.AggSpec, Agg=ops.Agg, SortStep=program.SortStep)


def test_null_patterns_join_agg_bit_identity(answered, monkeypatch):
    fused, walk = run_ab(null_plan(_port_classes()), null_db(), monkeypatch)
    assert answered == [True]
    # the NULL group key forms its own group; NULL-fed aggs stay NULL-aware
    assert fused.num_rows == 8
    assert_identical(fused, walk)


def expand_tables(seed=3, n_probe=500, n_build=4000):
    rng = np.random.default_rng(seed)
    return {
        "p": {"pk": rng.integers(0, 40, n_probe).astype(np.int64),
              "pv": rng.integers(0, 100, n_probe).astype(np.int64)},
        "b": {"bk": rng.integers(0, 40, n_build).astype(np.int64),
              "bv": rng.integers(0, 100, n_build).astype(np.int64)},
    }


def expand_db(device="cpu") -> Database:
    return Database(sources={
        t: ColumnSource(cols, dtypes.schema(
            *((n, dtypes.INT64) for n in cols)))
        for t, cols in expand_tables().items()}, device=device)


def expand_plan():
    """An expand join whose true fanout (~100) far exceeds its
    fanout_hint (1.0), under a grouped aggregate."""
    return Transform(
        ExpandJoin(
            probe=TableScan("p"), build=TableScan("b"),
            probe_keys=("pk",), build_keys=("bk",),
            probe_payload=("pk", "pv"), build_payload=("bv",),
            fanout_hint=1.0,
        ),
        Program((
            GroupByStep(keys=("pk",),
                        aggs=(AggSpec(Agg.SUM, "bv", "s"),
                              AggSpec(Agg.COUNT_ALL, None, "n"))),
            SortStep(keys=("pk",)),
        )))


def test_expand_join_overflow_grows_and_matches(answered, monkeypatch):
    """The fused dispatch overflows its static capacity, grows it and
    dispatches again over the same staged inputs: bit-identical to the
    walk, and the cached plan keeps the grown capacity."""
    db = expand_db()
    plan = expand_plan()
    sig = plan_fuse.plan_signature(plan, db)
    assert sig is not None
    fused, walk = run_ab(plan, db, monkeypatch)
    assert answered == [True]
    assert_identical(fused, walk)
    cached = db._compile_cache[sig.cache_key(db)]
    assert cached.grows == 1
    assert cached.expand_caps[0] > DEFAULT_CAPACITY_QUANTUM
    # a second statement fits the grown capacity: no further growth
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    assert_identical(to_host(execute_plan(plan, db, use_dq=False)), walk)
    assert cached.grows == 1


# ---------------- shape classes and the compile cache ----------------


def test_shape_class_matches_reference():
    from ydb_tpu.ssa import plan_fuse as rplan_fuse

    q = DEFAULT_CAPACITY_QUANTUM
    ns = sorted(set(
        [0, 1, 2, 1000, 1023, 1024, 1025, 8191, 8192, 8193, 10000, 60000,
         119968, 131071, 131072, 131073, 600858, 1 << 20, (1 << 20) + 1,
         59_998_494]
        + [int(x) for x in np.random.default_rng(0).integers(1, 1 << 26,
                                                             300)]))
    for n in ns:
        c = plan_fuse.shape_class(n)
        assert c == rplan_fuse.shape_class(n), n
        assert c >= max(n, 1) and c % q == 0
        if n > 8 * q:
            assert c <= n * 1.25 + q  # bounded dead padding
    assert plan_fuse.shape_class(8193) == plan_fuse.shape_class(10000)


def _fuse_keys(db):
    return [k for k in db._compile_cache
            if isinstance(k, tuple) and k and k[0] == "plan_fuse"]


def test_shape_class_cache_hit_on_same_class_data(monkeypatch):
    """Other data of the same shape classes reuses the cached FusedPlan:
    no rebuild, and the result still equals the walk's."""
    data = tpch.TpchData(sf=0.002, seed=5)
    db = make_db(data)
    plan = tpch.q3_plan()
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    first = to_host(execute_plan(plan, db, use_dq=False))
    assert len(_fuse_keys(db)) == 1
    cached = db._compile_cache[_fuse_keys(db)[0]]
    # same shape class, different rows AND values: slice a few hundred
    # rows off lineitem and shuffle the remainder
    li = data.tables["lineitem"]
    n = len(li["l_orderkey"])
    assert plan_fuse.shape_class(n) == plan_fuse.shape_class(n - 300)
    perm = np.random.default_rng(9).permutation(n - 300)
    db.sources["lineitem"] = ColumnSource(
        {k: v[:n - 300][perm] for k, v in li.items()},
        data.schema("lineitem"), data.dicts)
    second = to_host(execute_plan(plan, db, use_dq=False))
    assert _fuse_keys(db) == [_fuse_keys(db)[0]]
    assert db._compile_cache[_fuse_keys(db)[0]] is cached
    assert cached.fused_stages == 6
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
    walk = to_host(execute_plan(plan, db, use_dq=False))
    assert_identical(second, walk)
    assert first.num_rows == 10


def test_different_class_recompiles(monkeypatch):
    data = tpch.TpchData(sf=0.002, seed=5)
    db = make_db(data)
    plan = tpch.q3_plan()
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    execute_plan(plan, db, use_dq=False)
    li = data.tables["lineitem"]
    half = len(li["l_orderkey"]) // 2
    assert plan_fuse.shape_class(half) != plan_fuse.shape_class(2 * half)
    db.sources["lineitem"] = ColumnSource(
        {k: v[:half] for k, v in li.items()},
        data.schema("lineitem"), data.dicts)
    execute_plan(plan, db, use_dq=False)
    assert len(_fuse_keys(db)) == 2


# ---------------- what is not fusible ----------------


def test_udf_subtree_not_fusible_falls_back(tpch_db, answered, monkeypatch):
    db, _ = tpch_db
    plan = Transform(
        TableScan("lineitem", Program((
            ProjectStep(("l_orderkey", "l_quantity")),
        ))),
        Program((
            AssignStep("q2", UdfCall(
                "double", (Col("l_quantity"),), dtypes.INT64,
                lambda a: a * 2)),
            GroupByStep(keys=("l_orderkey",),
                        aggs=(AggSpec(Agg.SUM, "q2", "s"),)),
            SortStep(keys=("l_orderkey",), limit=20),
        )))
    assert plan_fuse.plan_signature(plan, db) is None
    # forcing fusion on still executes (the walk answers) and matches
    fused, walk = run_ab(plan, db, monkeypatch)
    assert answered == [False]
    assert_identical(fused, walk)


def test_oversized_table_not_fusible(tpch_db, monkeypatch):
    db, _ = tpch_db
    monkeypatch.setattr(plan_fuse, "FUSE_MAX_ROWS", 100)
    assert plan_fuse.plan_signature(tpch.q3_plan(), db) is None


def test_missing_table_not_fusible(tpch_db):
    db, _ = tpch_db
    plan = Transform(TableScan("no_such_table"),
                     Program((ProjectStep(("x",)),)))
    assert plan_fuse.plan_signature(plan, db) is None


def test_bare_table_scan_takes_the_walk(tpch_db, answered, monkeypatch):
    """A bare TableScan is one fragment already: the routing never sends
    it to fusion, as in the reference."""
    db, _ = tpch_db
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    plan = TableScan("lineitem", tpch.q6_program())
    assert plan_fuse.plan_signature(plan, db) is not None
    execute_plan(plan, db, use_dq=False)
    assert answered == []


# ---------------- env gate ----------------


def test_fuse_plan_env_gate(answered, monkeypatch):
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", None)
    monkeypatch.setenv("YDB_TPU_TORCH_FUSE_PLAN", "0")
    assert not plan_fuse.fusion_enabled()
    data = tpch.TpchData(sf=0.002, seed=5)
    db = make_db(data)
    plan = tpch.q3_plan()
    gated = to_host(execute_plan(plan, db, use_dq=False))
    assert answered == [] and not _fuse_keys(db)
    monkeypatch.setenv("YDB_TPU_TORCH_FUSE_PLAN", "1")
    assert plan_fuse.fusion_enabled()
    fused = to_host(execute_plan(plan, db, use_dq=False))
    assert answered == [True]
    assert db._compile_cache[_fuse_keys(db)[0]].fused_stages == 6
    assert_identical(fused, gated)


# ---------------- TPC-H goldens through fusion ----------------


@pytest.fixture(scope="module")
def golden_port():
    data = tpch.TpchData(sf=GOLDEN["sf"], seed=GOLDEN["seed"])
    catalog = Catalog(schemas={t: data.schema(t) for t in data.tables},
                      primary_keys=dict(tpch.PRIMARY_KEYS), dicts=data.dicts)
    return data, make_db(data), catalog


@pytest.mark.parametrize("name", QUERIES)
def test_tpch_query_through_fusion_matches_golden(name, golden_port,
                                                  answered, monkeypatch):
    """``use_dq=False`` with fusion on (the default): every statement,
    the scalar subqueries planning runs included, is answered by the
    fused path at sf 0.01, and matches the pinned golden."""
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", None)
    data, db, catalog = golden_port

    def scalar_exec(plan, t):
        out = to_host(execute_plan(plan, db, use_dq=False))
        v, ok = out.cols[out.schema.names[0]]
        return v[0].item(), bool(ok[0])

    pq = plan_select_full(parse(TPCH[name]), catalog, scalar_exec)
    res = to_host(execute_plan(pq.plan, db, use_dq=False))
    res.dict_aliases = pq.dict_aliases
    assert answered and all(answered), answered
    want = GOLDEN["queries"][name]
    assert res.num_rows == want["rows"], name
    assert digest(res, data.dicts) == want["sha"], name


# ---------------- the reference's fused path ----------------


def _ref_fused(plan, db, monkeypatch):
    from ydb_tpu.ssa import plan_fuse as rplan_fuse

    monkeypatch.setattr(rplan_fuse, "FUSE_FORCE", True)
    return rto_host(rexecute(plan, db, use_dq=False))


@pytest.mark.parametrize("case", ["q1", "q3", "nulls", "expand"])
def test_port_fused_matches_reference_fused(case, monkeypatch):
    """The same plan over the same numpy tables, fused in both packages:
    integers, dictionary ids and validity bit for bit, floats at rtol
    1e-12."""
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    if case in ("q1", "q3"):
        data = tpch.TpchData(sf=0.002, seed=5)
        rdata = rtpch.TpchData(sf=0.002, seed=5)
        db = make_db(data)
        rdb = RDatabase(sources={
            t: RSource(c, rdata.schema(t), rdata.dicts)
            for t, c in rdata.tables.items()}, dicts=rdata.dicts)
        if case == "q3":
            plan, rplan = tpch.q3_plan(), rtpch.q3_plan()
        else:
            from ydb_tpu.plan.nodes import TableScan as RScan
            from ydb_tpu.plan.nodes import Transform as RTransform

            plan = Transform(TableScan("lineitem"), tpch.q1_program())
            rplan = RTransform(RScan("lineitem"), rtpch.q1_program())
    elif case == "nulls":
        db = null_db()
        rdb = RDatabase(sources={
            name: RSource(cols, rdt.schema(
                *((f, rdt.INT64) for f in fields)), validity=valid)
            for name, (cols, valid, fields) in null_tables().items()})
        plan, rplan = null_plan(_port_classes()), null_plan(
            _reference_classes())
    else:
        from ydb_tpu.plan import nodes as rnodes
        from ydb_tpu.ssa import ops as rops
        from ydb_tpu.ssa import program as rprog

        db = expand_db()
        rdb = RDatabase(sources={
            t: RSource(cols, rdt.schema(*((n, rdt.INT64) for n in cols)))
            for t, cols in expand_tables().items()})
        plan = expand_plan()
        rplan = rnodes.Transform(
            rnodes.ExpandJoin(
                probe=rnodes.TableScan("p"), build=rnodes.TableScan("b"),
                probe_keys=("pk",), build_keys=("bk",),
                probe_payload=("pk", "pv"), build_payload=("bv",),
                fanout_hint=1.0),
            rprog.Program((
                rprog.GroupByStep(keys=("pk",), aggs=(
                    rprog.AggSpec(rops.Agg.SUM, "bv", "s"),
                    rprog.AggSpec(rops.Agg.COUNT_ALL, None, "n"))),
                rprog.SortStep(keys=("pk",)))))
    got = to_host(execute_plan(plan, db, use_dq=False))
    want = _ref_fused(rplan, rdb, monkeypatch)
    assert got.num_rows > 0
    assert_tables_equal(got, want, case)


# ---------------- stacked and shared dispatch ----------------


def test_run_stacked_slices_match_run_shared():
    """Two members with different staged inputs in one stacked dispatch:
    each slice equals that member's own ``run_shared``, the two answers
    really differ, and the members' blocks are left as they were."""
    data = tpch.TpchData(sf=0.002, seed=11)
    schema = data.schema("lineitem")
    cols_a = data.tables["lineitem"]
    cols_b = dict(cols_a)
    cols_b["l_quantity"] = np.asarray(cols_a["l_quantity"]) // 2
    db_a = Database(
        sources={"lineitem": ColumnSource(cols_a, schema, data.dicts)},
        dicts=data.dicts, device="cpu")
    db_b = Database(
        sources={"lineitem": ColumnSource(cols_b, schema, data.dicts)},
        dicts=data.dicts, device="cpu")
    plan = Transform(TableScan("lineitem"), tpch.q6_program())
    sig = plan_fuse.plan_signature(plan, db_a)
    assert sig is not None and sig.sites
    fused = plan_fuse.build(sig, db_a)
    ia = {s.key: executor._stage_fused_site(s, db_a, fused)
          for s in sig.sites}
    ib = {s.key: executor._stage_fused_site(s, db_b, fused)
          for s in sig.sites}
    before = {k: b.columns["l_quantity"].data.clone() for k, b in ib.items()}
    ra, ta = fused.run_shared(ia)
    rb, tb = fused.run_shared(ib)
    out, tt = fused.run_stacked([ia, ib])
    assert ta == tb == tt == []
    assert out.length.shape == (2,)
    a, b = to_host(ra), to_host(rb)
    assert a.cols["revenue"][0][0] != b.cols["revenue"][0][0]
    assert_identical(to_host(plan_fuse.slice_member(out, 0)), a)
    assert_identical(to_host(plan_fuse.slice_member(out, 1)), b)
    for k, blk in ib.items():
        assert torch.equal(blk.columns["l_quantity"].data, before[k])


def test_fit_blocks_matches_reference():
    rng = np.random.default_rng(4)
    sch, rsch = (m.schema(("a", m.INT64), ("b", m.INT32))
                 for m in (dtypes, rdt))
    parts = []
    for n, cap in ((700, 1024), (1500, 2048)):
        arrays = {"a": rng.integers(-50, 50, n).astype(np.int64),
                  "b": rng.integers(0, 9, n).astype(np.int32)}
        valid = {"a": rng.random(n) > 0.2, "b": rng.random(n) > 0.1}
        parts.append((arrays, valid, cap))
    from ydb_tpu.ssa import plan_fuse as rplan_fuse

    for capacity in (3072, 4096):
        got = plan_fuse.fit_blocks(
            [TableBlock.from_numpy(a, sch, v, capacity=c, device="cpu")
             for a, v, c in parts], capacity)
        want = rplan_fuse.fit_blocks(
            tuple(RBlock.from_numpy(a, rsch, v, capacity=c)
                  for a, v, c in parts), capacity)
        assert got.capacity == capacity == want.capacity
        assert int(got.length) == int(want.length) == 2200
        for name in ("a", "b"):
            np.testing.assert_array_equal(
                got.columns[name].validity.numpy(),
                np.asarray(want.columns[name].validity))
            np.testing.assert_array_equal(
                got.columns[name].data.numpy(),
                np.asarray(want.columns[name].data))


class _StreamSource:
    """A table that only streams blocks (as the storage tiers do), cut at
    ``block_rows`` whatever the caller asks."""

    def __init__(self, src: ColumnSource, block_rows: int):
        self.src, self.block_rows = src, block_rows
        self.schema, self.num_rows = src.schema, src.num_rows
        self.dicts = src.dicts

    def blocks(self, block_rows, columns=None, device=None):
        return self.src.blocks(self.block_rows, columns, device=device)


def test_streamed_source_stages_through_fit_blocks(tpch_db, answered,
                                                   monkeypatch):
    """A source that is not a ColumnSource stages by merging its streamed
    blocks (``fit_blocks``): q3 over lineitem in 1000-row blocks equals
    the walk."""
    db, data = tpch_db
    streamed = Database(
        sources={**db.sources,
                 "lineitem": _StreamSource(db.sources["lineitem"], 1000)},
        dicts=db.dicts, device="cpu")
    staged = []
    real = plan_fuse.fit_blocks

    def spy(blocks, capacity):
        staged.append(len(blocks))
        return real(blocks, capacity)

    monkeypatch.setattr(plan_fuse, "fit_blocks", spy)
    fused, walk = run_ab(tpch.q3_plan(), streamed, monkeypatch)
    assert answered == [True] and staged and staged[0] > 1
    assert_identical(fused, walk)
    assert_identical(fused, to_host(execute_plan(tpch.q3_plan(), db,
                                                 use_dq=False)))


def test_partial_slots_layout_not_ported():
    from ydb_tpu_torch.ssa.compiler import _compile_program

    with pytest.raises(NotImplementedError, match="partial_slots"):
        _compile_program(tpch.q1_program(), tpch.LINEITEM_SCHEMA,
                         partial_slots=True)


# ---------------- on the card ----------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q1", "q3", "q18"])
def test_fused_statement_is_one_graph_replay_on_gpu(name, monkeypatch):
    """On CUDA a fused statement is one replay of a captured graph: the
    first statement captures (once more after each expand overflow that
    grows a capacity), a warm one only replays, both equal the walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    data = tpch.TpchData(sf=0.01, seed=11)
    catalog = Catalog(schemas={t: data.schema(t) for t in data.tables},
                      primary_keys=dict(tpch.PRIMARY_KEYS), dicts=data.dicts)
    db = make_db(data, device="cuda")
    pq = plan_select_full(parse(TPCH[name]), catalog)
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    first = to_host(execute_plan(pq.plan, db, use_dq=False))
    (fused,) = [db._compile_cache[k] for k in _fuse_keys(db)]
    captures = 1 + fused.grows
    assert (fused.captures, fused.replays) == (captures, captures)
    warm = to_host(execute_plan(pq.plan, db, use_dq=False))
    assert (fused.captures, fused.replays) == (captures, captures + 1)
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
    walk = to_host(execute_plan(pq.plan, db, use_dq=False))
    assert_tables_equal(first, walk, name)
    assert_tables_equal(warm, walk, name)
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)
    edb = expand_db(device="cuda")
    grown = to_host(execute_plan(expand_plan(), edb, use_dq=False))
    (efused,) = [edb._compile_cache[k] for k in _fuse_keys(edb)]
    assert (efused.grows, efused.captures) == (1, 2)
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
    assert_identical(grown, to_host(execute_plan(expand_plan(), edb,
                                                 use_dq=False)))
