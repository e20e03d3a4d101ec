"""The port's session plane (``ydb_tpu_torch/kqp/session.py``) against the
reference's ``Cluster`` and ``Session``.

The same SQL runs through a reference ``Cluster()`` and a port
``Cluster(device="cpu")``: DDL, INSERT and UPSERT, SELECT with joins,
UDFs and scalar functions (the Cluster cases of ``tests/test_sql.py``,
``test_sql_functions.py`` and ``test_udf.py``), EXPLAIN text and the
typed errors. Tolerance: integers, dictionary strings and validity bit
for bit; floats within rtol 1e-12 (the reference's XLA divides as x *
(1/y), one ulp off an IEEE quotient); EXPLAIN text and error messages
equal.

Besides: the 22 TPC-H goldens through a port Cluster of 4 shards a
table (the pinned sha256 digests), plan-cache and compile-cache hits,
reboot from the same store (tables, shards, dictionaries, plan-step
clock, persisted statistics), a port Cluster booted from a reference
Cluster's store (``interop.blob_store_from_reference``) answering as the
reference does, the full composite primary key in the planner's
catalog, and the typed ``PlanError`` of what the port leaves out
(sequences and ``nextval``; UPDATE and DELETE of a column table raise the
reference's error now that the row store is ported)."""

import hashlib
import json
import os
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.sql.planner import PlanError as RPlanError

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch import interop
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.sql.planner import PlanError
from ydb_tpu_torch.workload import tpch
from ydb_tpu_torch.workload.queries import TPCH

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = json.load(open(os.path.join(HERE, "golden_tpch.json")))


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C): a stand-in sends its GROUP BYs of unknown or
    more than 512 groups to its scatter tier, as the other port tests
    do."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def _host(out):
    """A statement's result as comparable plain values."""
    if out is None or isinstance(out, str):
        return out
    if not isinstance(out, OracleTable) and hasattr(out, "committed"):
        return ("tx", bool(out.committed))
    if not hasattr(out, "schema"):
        return out
    cols = {}
    for f in out.schema.fields:
        v, ok = out.cols[f.name]
        ok = np.asarray(ok, dtype=bool).tolist()
        if f.type.is_string:
            vals = out.strings(f.name)
            cols[f.name] = ("s", [x if k else None
                                  for x, k in zip(vals, ok)])
        else:
            cols[f.name] = ("f" if f.type.is_floating else "i",
                            np.asarray(v).tolist(), ok)
    return ("table", list(out.schema.names), out.num_rows, cols)


def _same(got, want, sql):
    if not (isinstance(got, tuple) and got and got[0] == "table"):
        assert got == want, sql
        return
    assert got[:3] == want[:3], sql
    for name, g in got[3].items():
        w = want[3][name]
        assert g[0] == w[0], (sql, name)
        if g[0] == "f":
            assert g[2] == w[2], (sql, name, "validity")
            gv = [x for x, k in zip(g[1], g[2]) if k]
            wv = [x for x, k in zip(w[1], w[2]) if k]
            np.testing.assert_allclose(gv, wv, rtol=1e-12,
                                       err_msg=f"{sql} {name}")
        else:
            assert g == w, (sql, name)


def _run(session, sql):
    try:
        return _host(session.execute(sql))
    except Exception as e:  # noqa: BLE001 - compared below
        return ("error", type(e).__name__, str(e))


def _both(statements, n_shards=None, setup=None):
    """Each statement through a reference and a port Cluster; every
    result (or error) equal."""
    ref = RCluster(n_shards=n_shards)
    port = Cluster(n_shards=n_shards, device="cpu")
    if setup is not None:
        setup(ref, rdt)
        setup(port, tdt)
    rs, ps = ref.session(), port.session()
    for sql in statements:
        _same(_run(ps, sql), _run(rs, sql), sql)
    return ref, port


_EVENTS = [
    """create table events (id bigint not null, ts date not null,
       kind string, amount decimal(10, 2), primary key (id))""",
    """insert into events (id, ts, kind, amount) values
       (1, date '2024-01-01', 'buy', 10.50),
       (2, date '2024-01-02', 'sell', 3.25),
       (3, date '2024-01-02', 'buy', 1.00),
       (4, date '2024-02-01', 'buy', null)""",
    """select kind, count(*) as n, sum(amount) as total
       from events group by kind order by kind""",
    "insert into events values (5, date '2024-03-01', 'sell', 2.00)",
    """select kind, count(*) as n, sum(amount) as total
       from events group by kind order by kind""",
    "select id, amount from events where ts >= date '2024-01-02' "
    "order by id",
]

_FUNCS = [
    "CREATE TABLE t (id int64, name string, x int64, f double, d date, "
    "PRIMARY KEY (id))",
    "INSERT INTO t VALUES (1, '  Widget A ', 5, 2.0, date '2024-03-07'), "
    "(2, 'gadget-B', -7, 100.0, date '2024-11-30'), "
    "(3, 'THING c', 0, 0.5, date '2025-01-01')",
    "SELECT id, upper(name) AS u, lower(name) AS l, trim(name) AS t, "
    "replace(name, '-', '_') AS r, length(name) AS n FROM t ORDER BY id",
    "SELECT id, concat(trim(name), '!') AS bang, concat('<', name) AS tg "
    "FROM t ORDER BY id",
    "SELECT id FROM t WHERE starts_with(name, 'gadget')",
    "SELECT id FROM t WHERE ends_with(trim(name), 'c')",
    "SELECT id, sign(x) AS sg, abs(x) AS ax, log10(f) AS lg, "
    "power(f, 2) AS p2, greatest(x, 1) AS g, least(x, 1) AS le "
    "FROM t ORDER BY id",
    "SELECT id, extract(year from d) AS y, extract(month from d) AS m, "
    "extract(day from d) AS dd FROM t ORDER BY id",
    "SELECT length(name) AS n, count(*) AS c FROM t WHERE sign(x) >= 0 "
    "GROUP BY length(name) ORDER BY n",
    "SELECT id FROM t WHERE upper(trim(name)) = 'WIDGET A'",
    "SELECT greatest(name, name) AS g FROM t",
]

_JOINS = [
    "create table a (k bigint not null, ya bigint, primary key (k))",
    "create table b (k bigint not null, yb bigint, primary key (k))",
    "insert into a values (1, 10), (2, 20), (3, 30)",
    "insert into b values (1, 10), (2, 99)",
    "select a.k as k, yb from a left join b on a.k = b.k where ya = yb "
    "order by k",
    "select a.k as k from a left join b on a.k = b.k order by k",
    "select a.k from a left join b on a.k = b.k where a.ya = b.k",
    "select k, sum(ya) as t from a where k > 0 group by k "
    "order by t desc limit 5",
    "explain select k, sum(ya) as t from a where k > 0 group by k "
    "order by t desc limit 5",
    "explain select a.k, yb from a join b on a.k = b.k",
    "select count(*) as n from a where ya > (select min(yb) from b)",
]

_EXISTS = [
    "create table cu (id bigint not null, nm string, primary key (id))",
    "create table w (k bigint not null, cid bigint, primary key (k))",
    "create table ct (k bigint not null, cid bigint, primary key (k))",
    "insert into cu values (1,'a'),(2,'b'),(3,'c'),(4,'d')",
    "insert into w values (10, 1), (11, 3)",
    "insert into ct values (20, 2), (21, 3)",
    "select id from cu c where exists (select * from w where c.id = cid) "
    "or exists (select * from ct where c.id = cid) order by id",
    "select id from cu c where nm = 'd' or not exists "
    "(select * from w where c.id = cid) order by id",
]

_DDL = [
    "create table kv (k bigint not null, v bigint, primary key (k))",
    "create table kv (k bigint not null, primary key (k))",
    "create table sys_x (k bigint not null, primary key (k))",
    "create table o (k bigint not null, primary key (k)) with (shards = 0)",
    "create table o (k bigint not null, primary key (k)) with (bogus = 1)",
    "insert into kv values (1, 10), (2, 20)",
    "alter table kv add column extra double",
    "insert into kv values (3, 30, 1.5)",
    "select k, v, extra from kv order by k",
    "alter table kv drop column extra",
    "select * from kv order by k",
    "drop table kv",
    "select * from kv",
    "create table kv (k bigint not null, v bigint, primary key (k))",
    "insert into kv values (1, 111)",
    "select sum(v) as s from kv",
    "create table up (k bigint not null, v bigint, primary key (k)) "
    "with (upsert = on)",
    "insert into up values (1, 1), (2, 2)",
    "insert into up values (1, 100)",
    "select k, v from up order by k",
    "begin",
    "select count(*) as n from up",
    "commit",
    "insert into nope values (1)",
    "insert into up values (1)",
]


def _udfs(c, dt):
    c.register_udf("mix", lambda a, b: (a * 1000003 + b) % 97, dt.INT64)
    c.register_udf("halve", lambda a: a.astype(np.float64) / 2.0,
                   dt.DOUBLE)


_UDF = [
    "create table kv (k bigint not null, v bigint, primary key (k))",
    "insert into kv (k, v) values (1, 10), (2, 20), (3, 33)",
    "select k, mix(k, v) as m from kv order by k",
    "select k from kv where halve(v) > 9.0 order by k",
    "select sum(mix(k, v)) as t from kv",
    "select nosuch(k) from kv",
]


@pytest.mark.parametrize("statements,n_shards,setup", [
    (_EVENTS, 3, None), (_FUNCS, None, None), (_JOINS, 1, None),
    (_EXISTS, 1, None), (_DDL, 2, None), (_UDF, None, _udfs),
], ids=["end_to_end", "functions", "joins_explain", "exists", "ddl",
        "udfs"])
def test_statements_match_reference_cluster(statements, n_shards, setup):
    _both(statements, n_shards, setup)


def test_timestamp_parts_match_reference_cluster():
    us = (19789 * 86_400 + 13 * 3600 + 45 * 60 + 7) * 1_000_000
    _both(["CREATE TABLE ev (id int64, ts timestamp, PRIMARY KEY (id))",
           f"INSERT INTO ev VALUES (1, {us})",
           "SELECT extract(hour from ts) AS h, "
           "extract(minute from ts) AS m FROM ev",
           "CREATE TABLE dd (id int64, d date, PRIMARY KEY (id))",
           "INSERT INTO dd VALUES (1, date '2024-01-01')",
           "SELECT extract(hour from d) AS h FROM dd"])


# ---------------- what the port leaves out ----------------

@pytest.mark.parametrize("sql,what", [
    ("create table rt (k bigint not null, primary key (k)) "
     "with (store = row)", "row store"),
    ("update kv set v = 1 where k = 1", "row store"),
    ("delete from kv where k = 1", "row store"),
    ("create sequence s1", "sequences"),
    ("drop sequence s1", "sequences"),
    ("insert into kv values (nextval('s1'), 1)", "sequences"),
])
def test_left_out_statements_raise_typed_plan_error(sql, what):
    s = Cluster(device="cpu").session()
    s.execute("create table kv (k bigint not null, v bigint, "
              "primary key (k))")
    if what == "row store":
        # the row store is ported (ROADMAP.md queue A item 8): a row table
        # is created, and UPDATE / DELETE of the column table kv raise
        # the reference's typed error
        if sql.startswith("create"):
            s.execute(sql)
            assert s.cluster.tables["rt"].store_kind == "row"
        else:
            with pytest.raises(PlanError, match="need a row table"):
                s.execute(sql)
        return
    with pytest.raises(PlanError, match=what):
        s.execute(sql)


def test_insert_inside_transaction_is_refused_as_in_reference():
    stmts = ["create table kv (k bigint not null, v bigint, "
             "primary key (k))", "begin", "insert into kv values (1, 1)",
             "rollback", "select count(*) as n from kv"]
    _both(stmts)


# ---------------- caches ----------------

def test_plan_and_compile_cache_hits():
    c = Cluster(device="cpu")
    s = c.session()
    s.execute("create table kv (k bigint not null, v bigint, "
              "primary key (k))")
    s.execute("insert into kv values (1, 10), (2, 20), (3, 30)")
    sql = "select k, sum(v) as t from kv group by k order by k"
    s.execute(sql)
    assert (s.last_profile.plan_cache, s.last_profile.compile_cache) == \
        ("miss", "miss")
    s.execute(sql)
    assert (s.last_profile.plan_cache, s.last_profile.compile_cache) == \
        ("hit", "hit")
    assert c.counters.group(kind="compile_cache").counter("hit").value >= 1
    # an INSERT invalidates both (dictionaries and row counts bake in)
    s.execute("insert into kv values (4, 40)")
    out = s.execute(sql)
    assert s.last_profile.plan_cache == "miss"
    assert out.num_rows == 4
    # the bounded compile cache evicts LRU entries
    c._compile_cache.capacity = 1
    s.execute("select count(*) as n from kv where v > 15")
    assert len(c._compile_cache) <= 1


def test_explain_analyze_runs_and_annotates_the_plan():
    """EXPLAIN ANALYZE renders the same plan text as EXPLAIN, then the
    measured actuals of a real run: the compile-cache miss of the first
    run and the hit of the second, and the fused stages."""
    s = Cluster(device="cpu").session()
    s.execute("create table kv (k bigint not null, v bigint, "
              "primary key (k))")
    s.execute("insert into kv values (1, 10), (2, 20)")
    sql = "select k, sum(v) as t from kv group by k order by k"
    plan = s.execute("explain " + sql)
    first = s.execute("explain analyze " + sql)
    second = s.execute("explain analyze " + sql)
    assert first.startswith(plan) and "-- actuals --" in first
    assert "rows=2" in first and "compile_cache=miss" in first
    assert "compile_cache=hit" in second
    assert "fused_stages=2" in second


# ---------------- TPC-H goldens through a port Cluster ----------------

def _load_tpch(cluster, tp):
    s = cluster.session()
    for t, cols in tp.tables.items():
        schema = tp.schema(t)
        spec = ", ".join(
            f"{f.name} " + (f"decimal(18,{f.type.scale})"
                            if f.type.is_decimal else f.type.kind.value)
            + ("" if f.nullable else " not null") for f in schema.fields)
        s.execute(f"create table {t} ({spec}, primary key "
                  f"({', '.join(tpch.PRIMARY_KEYS[t])}))")
        for f in schema.fields:
            if f.type.is_string:
                cluster.dicts.for_column(f.name).encode(
                    list(tp.dicts[f.name].values))
        cluster.tables[t].insert(cols)
    cluster._invalidate_plans()
    return s


@pytest.fixture(scope="module")
def tpch_session():
    tp = tpch.TpchData(sf=GOLDEN["sf"], seed=GOLDEN["seed"])
    cluster = Cluster(n_shards=4, device="cpu")
    return _load_tpch(cluster, tp)


def _digest(out) -> str:
    h = hashlib.sha256()
    for f in out.schema.fields:
        v, ok = out.cols[f.name]
        ok = np.asarray(ok, dtype=bool)
        h.update(f.name.encode())
        if f.type.is_string:
            vals = [(x.decode("latin1") if k else None)
                    for x, k in zip(out.strings(f.name), ok)]
        elif f.type.is_floating:
            vals = [(round(float(x), 6) if k else None)
                    for x, k in zip(np.asarray(v), ok)]
        else:
            vals = [(int(x) if k else None)
                    for x, k in zip(np.asarray(v), ok)]
        h.update(json.dumps(vals).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(GOLDEN["queries"],
                                        key=lambda q: int(q[1:])))
def test_tpch_golden_through_port_cluster(tpch_session, name):
    out = tpch_session.execute(TPCH[name])
    want = GOLDEN["queries"][name]
    assert out.num_rows == want["rows"], name
    assert _digest(out) == want["sha"], name


def test_catalog_keeps_the_full_primary_key(tpch_session):
    """The planner reads lineitem's key as (l_orderkey, l_linenumber):
    with the reference's first-column key it would take a lookup join
    into lineitem on l_orderkey alone and drop rows (q3 above would
    miss its golden)."""
    c = tpch_session.cluster
    cat = c.catalog()
    assert cat.primary_keys["lineitem"] == ("l_orderkey", "l_linenumber")
    assert cat.primary_keys["orders"] == ("o_orderkey",)
    text = tpch_session.execute("explain " + TPCH["q3"])
    assert "LookupJoin[inner] ['o_orderkey'] = ['l_orderkey']" not in text


# ---------------- reboot ----------------

_REBOOT = [
    "create table ev (id bigint not null, kind string, v bigint, "
    "primary key (id)) with (shards = 3)",
    "insert into ev values (1, 'a', 10), (2, 'b', 20), (3, 'a', 30)",
    "insert into ev values (4, 'c', 40), (5, 'd', null)",
    "create table gone (k bigint not null, primary key (k))",
    "insert into gone values (1)",
    "drop table gone",
    "alter table ev add column w double",
    "insert into ev values (6, 'e', 60, 0.5)",
]
_REBOOT_READ = "select kind, count(*) as n, sum(v) as s, max(w) as mw " \
    "from ev group by kind order by kind"


def _state(c) -> dict:
    return {
        "tables": sorted(c.tables),
        "shards": {n: [s.shard_id for s in t.shards]
                   for n, t in c.tables.items()},
        "schema": {n: [(f.name, str(f.type), f.nullable)
                       for f in t.schema.fields]
                   for n, t in c.tables.items()},
        "dicts": {col: list(c.dicts[col].values)
                  for col in c.dicts.columns()},
        "clock": c.coordinator.read_snapshot(),
        "stats": {n: st.to_json() for n, st in c.stats.all_stats().items()},
    }


def test_port_cluster_reboots_from_its_store():
    store = MemBlobStore()
    c = Cluster(store=store, device="cpu")
    s = c.session()
    for sql in _REBOOT:
        s.execute(sql)
    c.run_background()  # statistics refresh, persisted
    before = _state(c)
    want = _host(s.execute(_REBOOT_READ))
    assert before["stats"]["ev"]["rows"] == 6
    c.stop()
    c2 = Cluster(store=store, device="cpu")
    after = _state(c2)
    assert after["clock"] >= before["clock"]
    before.pop("clock"), after.pop("clock")
    assert after == before
    _same(_host(c2.session().execute(_REBOOT_READ)), want, _REBOOT_READ)
    # the rebooted cluster keeps writing past every step it issued
    r = c2.session().execute("insert into ev values (7, 'a', 70, 1.0)")
    assert r.committed
    c2.stop()


def test_port_cluster_boots_from_reference_store():
    ref = RCluster()
    rs = ref.session()
    for sql in _REBOOT:
        rs.execute(sql)
    ref.run_background()
    want = _host(rs.execute(_REBOOT_READ))
    port = Cluster(store=interop.blob_store_from_reference(ref.store),
                   device="cpu")
    assert sorted(port.tables) == sorted(ref.tables)
    for name, t in ref.tables.items():
        assert [s.shard_id for s in port.tables[name].shards] == \
            [s.shard_id for s in t.shards]
        assert port.tables[name].schema.names == t.schema.names
    for col in ref.dicts.columns():
        assert list(port.dicts[col].values) == list(ref.dicts[col].values)
    assert port.coordinator.read_snapshot() >= \
        ref.coordinator.read_snapshot()
    assert {n: st.to_json() for n, st in port.stats.all_stats().items()} \
        == {n: st.to_json() for n, st in ref.stats.all_stats().items()}
    _same(_host(port.session().execute(_REBOOT_READ)), want, _REBOOT_READ)
    # and keeps serving writes with dictionary growth
    ps = port.session()
    ps.execute("insert into ev values (7, 'zz', 70, 1.0)")
    rs.execute("insert into ev values (7, 'zz', 70, 1.0)")
    _same(_host(ps.execute(_REBOOT_READ)), _host(rs.execute(_REBOOT_READ)),
          _REBOOT_READ)
    port.stop()


def test_cluster_raises_without_a_gpu_unless_told_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Cluster()


def test_reference_errors_are_plan_errors_on_both():
    s = Cluster(device="cpu").session()
    with pytest.raises(PlanError):
        s.execute("select * from missing")
    r = RCluster().session()
    with pytest.raises(RPlanError):
        r.execute("select * from missing")
