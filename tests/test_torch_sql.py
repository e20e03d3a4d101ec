"""The SQL path through the port's plan walk: parse -> plan ->
``execute_plan(..., use_dq=False)`` -> ``to_host`` in ``ydb_tpu_torch``,
on the CPU, with whole-plan fusion pinned off in both packages
(``plan_fuse.FUSE_FORCE = False``): the DQ stage graph, the default for
join-bearing plans, has its own tests in ``tests/test_torch_sql_dq.py``,
and fusion, the default for the rest, in ``tests/test_torch_plan_fuse.py``.

* All 22 TPC-H queries at sf 0.01, seed 11 against the pinned rows and
  sha256 digests of ``tests/golden_tpch.json`` (the digest as
  ``tests/test_tpch_sql.py`` computes it: floats rounded to 6 places).
* Column-for-column parity with the JAX package's plan walk
  (``execute_plan(..., use_dq=False)`` with whole-plan fusion off) for
  q3, q5, q13, q18 and q21: integers, dictionary ids and validity bit for
  bit, float64 at rtol 1e-12.
* Window functions through SQL (``rank() over``, against the reference
  walk) and the three rejected window forms with their errors.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import hashlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import ydb_tpu.ssa
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.plan import Database as RDatabase
from ydb_tpu.plan import execute_plan as rexecute
from ydb_tpu.plan import to_host as rto_host
from ydb_tpu.sql.parser import parse as rparse
from ydb_tpu.sql.planner import Catalog as RCatalog
from ydb_tpu.sql.planner import plan_select_full as rplan
from ydb_tpu.workload import tpch as rtpch

from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.plan import Database, execute_plan, to_host
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import (
    Catalog,
    PlanError,
    plan_select,
    plan_select_full,
)
from ydb_tpu_torch.ssa import plan_fuse as port_plan_fuse
from ydb_tpu_torch.workload import tpch
from ydb_tpu_torch.workload.queries import TPCH

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = json.load(open(os.path.join(HERE, "golden_tpch.json")))
SF, SEED = GOLDEN["sf"], GOLDEN["seed"]


@pytest.fixture(autouse=True)
def reference_walk(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)
    from ydb_tpu.ssa import plan_fuse

    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
    # the port's use_dq=False statements walk too (fusion has its own
    # tests in tests/test_torch_plan_fuse.py)
    monkeypatch.setattr(port_plan_fuse, "FUSE_FORCE", False)


@pytest.fixture(scope="module")
def port():
    data = tpch.TpchData(sf=SF, seed=SEED)
    db = Database(
        sources={t: ColumnSource(c, data.schema(t), data.dicts)
                 for t, c in data.tables.items()},
        dicts=data.dicts, device="cpu")
    catalog = Catalog(schemas={t: data.schema(t) for t in data.tables},
                      primary_keys=dict(tpch.PRIMARY_KEYS), dicts=data.dicts)
    return data, db, catalog


@pytest.fixture(scope="module")
def ref():
    data = rtpch.TpchData(sf=SF, seed=SEED)
    db = RDatabase(
        sources={t: RSource(c, data.schema(t), data.dicts)
                 for t, c in data.tables.items()},
        dicts=data.dicts)
    catalog = RCatalog(schemas={t: data.schema(t) for t in data.tables},
                       primary_keys=dict(rtpch.PRIMARY_KEYS),
                       dicts=data.dicts)
    return data, db, catalog


def run_port(sql, port, use_dq=False):
    """``sql`` through the port; the walk unless ``use_dq`` is None (the
    default routing) or True."""
    _, db, catalog = port

    def scalar_exec(plan, t):
        out = to_host(execute_plan(plan, db, use_dq=use_dq))
        v, ok = out.cols[out.schema.names[0]]
        assert len(v) == 1, f"scalar subquery returned {len(v)} rows"
        return v[0].item(), bool(ok[0])

    pq = plan_select_full(parse(sql), catalog, scalar_exec)
    res = to_host(execute_plan(pq.plan, db, use_dq=use_dq))
    res.dict_aliases = pq.dict_aliases
    return res


def run_ref(sql, ref):
    _, db, catalog = ref

    def scalar_exec(plan, t):
        out = rto_host(rexecute(plan, db, use_dq=False))
        v, ok = out.cols[out.schema.names[0]]
        return v[0].item(), bool(ok[0])

    pq = rplan(rparse(sql), catalog, scalar_exec)
    return rto_host(rexecute(pq.plan, db, use_dq=False))


def digest(out, dicts):
    """sha256 of a result as tests/test_tpch_sql.py pins it."""
    h = hashlib.sha256()
    for f in out.schema.fields:
        v, ok = out.cols[f.name]
        ok = np.asarray(ok, dtype=bool)
        h.update(f.name.encode())
        if f.type.is_string:
            src = out.dict_aliases.get(f.name, f.name)
            vals = [(x.decode("latin1") if okk else None)
                    for x, okk in zip(
                        dicts[src].decode(np.asarray(v, dtype=np.int32)),
                        ok)]
        elif f.type.is_floating:
            vals = [(round(float(x), 6) if okk else None)
                    for x, okk in zip(np.asarray(v), ok)]
        else:
            vals = [(int(x) if okk else None)
                    for x, okk in zip(np.asarray(v), ok)]
        h.update(json.dumps(vals).encode())
    return h.hexdigest()


def assert_tables_equal(got, want, what=""):
    """Same column names in order, rows, validity (bit-exact) and values:
    ints and dictionary ids exact, float64 rtol 1e-12."""
    assert list(got.schema.names) == list(want.schema.names), what
    assert got.num_rows == want.num_rows, what
    for name in want.schema.names:
        gv, go = got.cols[name]
        wv, wo = (np.asarray(x) for x in want.cols[name])
        np.testing.assert_array_equal(go, wo, err_msg=f"{what} validity {name}")
        assert gv.dtype == wv.dtype, (what, name, gv.dtype, wv.dtype)
        if np.issubdtype(wv.dtype, np.floating):
            np.testing.assert_allclose(gv[wo], wv[wo], rtol=1e-12,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(gv[wo], wv[wo],
                                          err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", sorted(TPCH, key=lambda q: int(q[1:])))
def test_tpch_query_matches_golden(name, port):
    res = run_port(TPCH[name], port)
    want = GOLDEN["queries"][name]
    assert res.num_rows == want["rows"], name
    assert digest(res, port[0].dicts) == want["sha"], (
        f"{name}: the port's result differs from the pinned golden")


@pytest.mark.parametrize("name", ["q3", "q5", "q13", "q18", "q21"])
def test_tpch_query_matches_reference_walk(name, port, ref):
    assert_tables_equal(run_port(TPCH[name], port), run_ref(TPCH[name], ref),
                        name)


@pytest.mark.parametrize("name", ["q1", "q3", "q13", "q18"])
def test_many_scan_blocks_match_reference_walk(name, port, ref, monkeypatch):
    """Scans cut into 8192-row blocks (per-block partial programs, their
    combine and final programs, the multi-block concat of filter-only
    scans) give the reference walk's results."""
    from ydb_tpu_torch.plan import executor

    monkeypatch.setattr(executor, "SCAN_BLOCK_ROWS", 8192)
    data, db, catalog = port
    fresh = Database(sources=db.sources, dicts=db.dicts, device="cpu")
    blocks = []
    real = executor.concat_blocks

    def spy(bs, *a, **k):
        blocks.append(len(bs))
        return real(bs, *a, **k)

    monkeypatch.setattr(executor, "concat_blocks", spy)
    from ydb_tpu_torch.engine import scan

    monkeypatch.setattr(scan, "concat_blocks", spy)
    got = run_port(TPCH[name], (data, fresh, catalog))
    assert_tables_equal(got, run_ref(TPCH[name], ref), name)
    assert max(blocks) > 1, blocks


@pytest.mark.parametrize("name", ["q1", "q13", "q18"])
def test_tables_held_as_tensors_match(name, port, monkeypatch):
    """Sources moved to the device with ``ColumnSource.to_device`` (here
    the CPU; the card in chip_smoke.py), scanned in 5000-row blocks whose
    tails need padding, give the golden results."""
    from ydb_tpu_torch.plan import executor

    monkeypatch.setattr(executor, "SCAN_BLOCK_ROWS", 5000)
    data, db, catalog = port
    resident = Database(
        sources={t: s.to_device("cpu") for t, s in db.sources.items()},
        dicts=db.dicts, device="cpu")
    assert isinstance(resident.sources["lineitem"].columns["l_tax"],
                      torch.Tensor)
    res = run_port(TPCH[name], (data, resident, catalog))
    want = GOLDEN["queries"][name]
    assert res.num_rows == want["rows"]
    assert digest(res, data.dicts) == want["sha"], name


@pytest.mark.parametrize("name", ["q3", "q5"])
def test_hand_built_join_plan_matches_reference_walk(name, port, ref):
    """The workload module's hand-built join plans (no SQL)."""
    got = to_host(execute_plan(getattr(tpch, f"{name}_plan")(), port[1],
                               use_dq=False))
    want = rto_host(rexecute(getattr(rtpch, f"{name}_plan")(), ref[1],
                             use_dq=False))
    assert_tables_equal(got, want, name)
    assert got.num_rows > 0


WINDOW_SQL = """
select l_orderkey, revenue, rank() over (order by revenue desc)
       as rnk
from (select l_orderkey,
             sum(l_extendedprice * (1.00 - l_discount)) as revenue
      from lineitem, orders
      where l_orderkey = o_orderkey
        and o_orderdate < date '1995-03-15'
      group by l_orderkey) r
order by rnk, l_orderkey
limit 10"""

PARTITIONED_WINDOW_SQL = """
select o_orderpriority, o_orderkey,
       dense_rank() over (partition by o_orderpriority
                          order by o_totalprice desc) as dr,
       row_number() over (partition by o_orderstatus
                          order by o_orderdate, o_orderkey) as rn
from orders
where o_orderdate < date '1993-01-01'
order by o_orderkey"""


@pytest.mark.parametrize("sql", [WINDOW_SQL, PARTITIONED_WINDOW_SQL],
                         ids=["rank_over_join", "partitioned_string_keys"])
def test_window_through_sql_matches_reference_walk(sql, port, ref):
    got = run_port(sql, port)
    assert_tables_equal(got, run_ref(sql, ref))
    assert got.num_rows > 0


def test_window_rank_through_sql_matches_numpy(port):
    """rank() over a join-bearing plan, against an independent numpy
    ranking (the reference's tests/test_sql.py case), through the default
    routing (the DQ stage graph: the window runs in the result stage's
    final program)."""
    data = port[0]
    out = run_port(WINDOW_SQL, port, use_dq=None)
    li, ords = data.tables["lineitem"], data.tables["orders"]
    cutoff = tpch._days("1995-03-15")
    keep = ords["o_orderdate"][li["l_orderkey"] - 1] < cutoff
    keys, inv = np.unique(li["l_orderkey"][keep], return_inverse=True)
    rev = np.zeros(len(keys), dtype=np.int64)
    np.add.at(rev, inv, (li["l_extendedprice"] * (100 - li["l_discount"]))
              [keep])
    order = np.lexsort((keys, -rev))[:10]
    want, rnk, prev = [], 0, None
    for i, j in enumerate(order):
        if rev[j] != prev:
            rnk = i + 1
        want.append((int(keys[j]), rnk))
        prev = rev[j]
    got = list(zip(np.asarray(out.cols["l_orderkey"][0]).tolist(),
                   np.asarray(out.cols["rnk"][0]).tolist()))
    assert got == want


@pytest.mark.parametrize("form", ["mixed_with_aggregate", "ranking_with_args",
                                  "nested"])
def test_rejected_window_forms(form, port):
    catalog = port[2]
    if form == "mixed_with_aggregate":
        with pytest.raises(PlanError, match="window functions cannot mix"):
            plan_select_full(parse(
                "select sum(l_quantity) as s, "
                "rank() over (order by l_orderkey) as r from lineitem"),
                catalog)
    elif form == "ranking_with_args":
        with pytest.raises(SyntaxError, match="no arguments"):
            parse("select rank(l_quantity) over (order by l_orderkey) as r"
                  " from lineitem")
        with pytest.raises(SyntaxError, match="no arguments"):
            parse("select dense_rank(distinct l_tax) over"
                  " (order by l_orderkey) as r from lineitem")
        parse("select row_number() over (order by l_orderkey) as r"
              " from lineitem")
    else:
        with pytest.raises(PlanError, match="top-level select items"):
            plan_select(parse(
                "select rank() over (order by l_orderkey) + 1 as r"
                " from lineitem"), catalog)
        with pytest.raises(PlanError, match="not allowed in WHERE"):
            plan_select(parse(
                "select l_orderkey from lineitem"
                " where rank() over (order by l_orderkey) < 5"), catalog)
        with pytest.raises(PlanError, match="not allowed in HAVING"):
            plan_select(parse(
                "select l_orderkey, sum(l_quantity) as s from lineitem"
                " group by l_orderkey"
                " having rank() over (order by l_orderkey) < 5"), catalog)


@pytest.mark.parametrize("name", ["q6", "q10"])
def test_use_dq_true_matches_walk(name, port):
    """``use_dq=True`` runs a join-bearing plan (q10) through the DQ stage
    graph and a join-free one (q6) through the walk; both give the walk's
    result."""
    assert_tables_equal(run_port(TPCH[name], port, use_dq=True),
                        run_port(TPCH[name], port), name)
