"""The row store through the port's SQL plane (``Cluster`` with
``WITH (store = row)`` tables) against the reference's ``Cluster``.

The same SQL runs through a reference ``Cluster()`` and a port
``Cluster(device="cpu")``: row-table DDL, INSERT, UPSERT, UPDATE and
DELETE, ALTER ADD/DROP COLUMN, reads and joins with column tables, a
GROUP BY over more than 512 groups (the reference's Pallas module
stubbed, so it takes its scatter tier), reshard and TTL. Tolerance:
integers, dictionary strings and validity bit for bit; floats within
rtol 1e-12 (the reference's XLA divides as x * (1/y)).

Besides: TPC-H q3, q4 and q13 with ``orders`` as a row table at sf 0.01
equal ``tests/golden_tpch.json``; a store written by either package over
a ``DirBlobStore`` boots in the other with the same rows, dictionary
ids and blobs; a statement builds a row table's source only when it
reads that table (answers equal to the eager build); sequences over row
tables answer as the reference's, and changefeeds raise a typed
``PlanError`` naming their ROADMAP item; row shards appear in
``tablet_counters.collect``."""

import hashlib
import json
import os
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.engine.blobs import DirBlobStore as RDirStore
from ydb_tpu.kqp.session import Cluster as RCluster

from ydb_tpu_torch.datashard.table import RowTable
from ydb_tpu_torch.engine.blobs import DirBlobStore, MemBlobStore
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.obs import tablet_counters
from ydb_tpu_torch.plan import Database, execute_plan, to_host
from ydb_tpu_torch.sql.planner import PlanError
from ydb_tpu_torch.workload import tpch
from ydb_tpu_torch.workload.queries import TPCH

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = json.load(open(os.path.join(HERE, "golden_tpch.json")))


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C): its GROUP BYs of more than 512 groups take the
    scatter tier."""
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
        return ("tx", bool(out.committed), out.step, out.error)
    cols = {}
    for f in out.schema.fields:
        v, ok = out.cols[f.name]
        ok = np.asarray(ok, dtype=bool).tolist()
        if f.type.is_string:
            cols[f.name] = ("s", [x if k else None
                                  for x, k in zip(out.strings(f.name), ok)])
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
            np.testing.assert_allclose(
                [x for x, k in zip(g[1], g[2]) if k],
                [x for x, k in zip(w[1], w[2]) if k], rtol=1e-12,
                err_msg=f"{sql} {name}")
        else:
            assert g == w, (sql, name)


def _run(session, sql):
    try:
        return _host(session.execute(sql))
    except Exception as e:  # noqa: BLE001 - compared below
        return ("error", type(e).__name__, str(e))


def _both(statements, ref=None, port=None):
    """Each statement through a reference and a port Cluster; every
    result (or error) equal. Returns the two clusters."""
    ref = ref if ref is not None else RCluster()
    port = port if port is not None else Cluster(device="cpu")
    rs, ps = ref.session(), port.session()
    for sql in statements:
        _same(_run(ps, sql), _run(rs, sql), sql)
    return ref, port


# ---------------- SQL parity ----------------

_ROW_DDL = ("create table acct (id bigint not null, owner string, "
            "bal bigint, rate double, opened date, primary key (id)) "
            "with (store = row, shards = 3)")

_DML = [
    _ROW_DDL,
    "insert into acct values (1, 'ann', 100, 0.5, date '2024-01-02'), "
    "(2, 'bob', 50, 1.25, date '2024-02-03'), "
    "(3, 'cy', null, null, null), (4, 'ann', 7, 2.0, date '2023-12-31')",
    "upsert into acct values (2, 'bob', 55, 1.5, date '2024-02-04')",
    "insert into acct values (5, 'dee', 1, 0.25, date '2024-03-01')",
    "select * from acct order by id",
    "update acct set bal = bal * 2 + 1 where owner = 'ann'",
    "update acct set rate = rate + 1.0, owner = 'zed' where id = 2",
    "update acct set bal = -3 where bal is null",
    "update acct set owner = 'nobody' where id = 99",
    "update acct set id = 9 where id = 1",
    "update acct set nope = 1",
    "select id, owner, bal, rate from acct order by id",
    "delete from acct where bal < 10",
    "delete from acct where id = 1234",
    "select count(*) as n, sum(bal) as s, min(opened) as d from acct",
    "alter table acct add column tag string",
    "update acct set tag = owner where id >= 2",
    "select id, tag from acct order by id",
    "alter table acct drop column rate",
    "alter table acct add column rate bigint",
    "select * from acct order by id",
    "create table facts (id bigint not null, amount bigint, kind string, "
    "primary key (id))",
    "insert into facts values (1, 10, 'x'), (2, 20, 'y'), (5, 30, 'x'), "
    "(7, 40, 'z')",
    "select a.id, a.owner, f.amount, f.kind from acct a join facts f "
    "on a.id = f.id order by a.id",
    "select f.kind, count(*) as n, sum(a.bal) as s from facts f "
    "left join acct a on a.id = f.id group by f.kind order by f.kind",
    "select owner from acct where id in (select id from facts) "
    "order by owner",
    "select id from acct where bal > (select avg(amount) from facts) "
    "order by id",
    "update facts set amount = 1 where id = 1",
    "delete from facts where id = 1",
    "begin",
    "insert into facts values (9, 9, 'q')",
    "rollback",
    "create table bad (k bigint not null, primary key (k)) "
    "with (store = row, upsert = on)",
    "create table bad (k bigint not null, primary key (k)) "
    "with (store = cube)",
    "drop table acct",
    "select * from acct",
]


def test_row_table_dml_matches_reference():
    ref, port = _both(_DML)
    assert sorted(port.tables) == sorted(ref.tables)
    for col in ref.dicts.columns():
        assert list(port.dicts[col].values) == list(ref.dicts[col].values)


def test_group_by_over_512_groups_matches_reference():
    """A row-table GROUP BY of 700 groups: the port's group-by kernel
    tier (its plain version on the CPU) against the reference's scatter
    tier."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 700, 3000)
    vals = rng.integers(-50, 50, 3000)
    rows = ", ".join(f"({i}, {k}, {v})" for i, (k, v) in
                     enumerate(zip(keys, vals)))
    _both(["create table g (id bigint not null, k bigint, v bigint, "
           "primary key (id)) with (store = row, shards = 4)",
           f"insert into g values {rows}",
           "select k, count(*) as n, sum(v) as s from g group by k "
           "order by k",
           "select k, sum(v) as s from g where v > 0 group by k "
           "order by s desc, k limit 20"])


def test_reshard_and_ttl_match_reference():
    stmts = ["create table ev (id bigint not null, at bigint, v bigint, "
             "primary key (id)) with (store = row, shards = 2, "
             "ttl_column = at)",
             "insert into ev values " + ", ".join(
                 f"({i}, {i * 10}, {i % 7})" for i in range(40))]
    ref, port = _both(stmts)
    for c in (ref, port):
        assert c.reshard_table("ev", 5) == 1
        t = c.tables["ev"]
        t.run_background(ttl_cutoff=150)
        c.run_background()
    assert [s.shard_id for s in port.tables["ev"].shards] == \
        [s.shard_id for s in ref.tables["ev"].shards]
    _both(["select count(*) as n, min(at) as lo, sum(v) as s from ev",
           "select id, v from ev where v = 3 order by id"], ref, port)
    for name in ("ev",):
        assert sorted(port.store.list(f"tablet/ds/{name}/")) == \
            sorted(ref.store.list(f"tablet/ds/{name}/"))


def test_secondary_index_through_cluster_matches_reference():
    stmts = ["create table u (id bigint not null, city string, v bigint, "
             "primary key (id)) with (store = row, shards = 3)",
             "insert into u values (1, 'ams', 1), (2, 'ber', 2), "
             "(3, 'ams', 3)"]
    ref, port = _both(stmts)
    out = []
    for c in (port, ref):
        t = c.tables["u"]
        t.add_index("by_city", "city")
        c.session().execute("insert into u values (4, 'ams', 4)")
        c.session().execute("update u set city = 'cdg' where id = 1")
        c.session().execute("delete from u where id = 3")
        out.append([sorted(t.lookup_index("by_city", x))
                    for x in (b"ams", b"ber", b"cdg")])
    assert out[0] == out[1] == [[(4,)], [(2,)], [(1,)]]


# ---------------- TPC-H goldens with orders as a row table ----------------

def _spell(f):
    return (f"decimal(18,{f.type.scale})" if f.type.is_decimal
            else f.type.kind.value) + ("" if f.nullable else " not null")


def load_tpch(cluster, tp, row_tables=("orders",), row_shards=4):
    """The TPC-H tables into ``cluster``: ``row_tables`` as row tables
    (their strings inserted as values), the rest as column tables (ids
    of the data's dictionaries, entered into the cluster's in order)."""
    s = cluster.session()
    for t, cols in tp.tables.items():
        schema = tp.schema(t)
        spec = ", ".join(f"{f.name} {_spell(f)}" for f in schema.fields)
        with_ = (f" with (store = row, shards = {row_shards})"
                 if t in row_tables else "")
        s.execute(f"create table {t} ({spec}, primary key "
                  f"({', '.join(tpch.PRIMARY_KEYS[t])})){with_}")
        for f in schema.fields:
            if f.type.is_string:
                d = cluster.dicts.for_column(f.name)
                src = tp.dicts[f.name].values
                if len(d) < len(src):
                    d.encode(list(src[len(d):]))
        if t in row_tables:
            cols = {k: (np.asarray(tp.dicts[k].values, dtype=object)[v]
                        if schema.field(k).type.is_string else v)
                    for k, v in cols.items()}
        cluster.tables[t].insert(cols)
    cluster._invalidate_plans()
    return s


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


@pytest.fixture(scope="module")
def tpch_rows():
    tp = tpch.TpchData(sf=GOLDEN["sf"], seed=GOLDEN["seed"])
    cluster = Cluster(n_shards=4, device="cpu")
    return load_tpch(cluster, tp)


@pytest.mark.parametrize("name", ["q3", "q4", "q13"])
def test_tpch_golden_with_orders_as_row_table(tpch_rows, name):
    assert isinstance(tpch_rows.cluster.tables["orders"], RowTable)
    out = tpch_rows.execute(TPCH[name])
    want = GOLDEN["queries"][name]
    assert out.num_rows == want["rows"], name
    assert _digest(out) == want["sha"], name


# ---------------- lazy row sources ----------------

def _spy(monkeypatch):
    calls = []
    real = RowTable.source_at

    def source_at(self, snap=None, columns=None):
        calls.append(self.name)
        return real(self, snap, columns)

    monkeypatch.setattr(RowTable, "source_at", source_at)
    return calls


def _eager(cluster, sql):
    """``sql`` over a Database whose every source was built up front (the
    reference's ``snapshot_db``)."""
    from ydb_tpu_torch.kqp.session import _merge_shard_sources

    snap = cluster.coordinator.read_snapshot()
    sources = {n: (t.source_at(snap) if isinstance(t, RowTable)
                   else _merge_shard_sources(t, snap))
               for n, t in cluster.tables.items()}
    p, aliases, _db = cluster.plan(sql)
    out = to_host(execute_plan(p, Database(sources=sources,
                                           dicts=cluster.dicts,
                                           device="cpu")))
    out.dicts = cluster.result_dicts(out.schema, aliases)
    return out


def test_statement_builds_only_the_row_sources_it_reads(tpch_rows,
                                                         monkeypatch):
    """A column-table statement in a cluster that holds a row table never
    walks it; a statement over the row table walks it once (fusion and
    batching probe with ``sources.get``); answers equal the eager
    build's."""
    c = tpch_rows.cluster
    calls = _spy(monkeypatch)
    for name, want_calls in (("q1", []), ("q6", []), ("q3", ["orders"]),
                             ("q13", ["orders"])):
        calls.clear()
        got = _host(tpch_rows.execute(TPCH[name]))
        assert calls == want_calls, name
        _same(got, _host(_eager(c, TPCH[name])), name)
    db = c.snapshot_db()
    assert "orders" in db.sources and "nope" not in db.sources
    assert calls == ["orders", "orders"]  # the eager build above, once
    assert db.sources.get("orders").num_rows == 15000
    assert db.sources.get("nope") is None
    assert calls == ["orders", "orders", "orders"]


def test_warm_row_statement_replays_its_fused_plan(tpch_rows):
    """The row table's source is fresh every statement, yet the second
    run of a statement over it hits the plan and compile caches (the
    fused plan's key holds schemas and shape classes, not the source)."""
    sql = ("select o_orderpriority, count(*) as n from orders "
           "group by o_orderpriority order by o_orderpriority")
    tpch_rows.execute(sql)
    out = tpch_rows.execute(sql)
    p = tpch_rows.last_profile
    assert (p.plan_cache, p.compile_cache) == ("hit", "hit")
    assert out.num_rows == 5


# ---------------- one store, two packages ----------------

_STORE_SQL = [
    "create table r (id bigint not null, name string, v bigint, "
    "primary key (id)) with (store = row, shards = 3)",
    "insert into r values (1, 'a', 10), (2, 'b', 20), (3, 'c', null)",
    "update r set name = 'zz', v = v + 1 where id = 1",
    "delete from r where id = 2",
    "create table c (id bigint not null, name string, primary key (id))",
    "insert into c values (1, 'b'), (3, 'new')",
    "alter table r add column w bigint",
    "insert into r values (4, 'new', 40, 400)",
]
_STORE_READ = ("select r.id, r.name, r.v, r.w, c.name as cn from r "
               "left join c on r.id = c.id order by r.id")


def _dicts(c):
    return {col: list(c.dicts[col].values) for col in c.dicts.columns()}


def _blobs(root):
    store = DirBlobStore(root)
    return {k: bytes(store.get(k)) for k in store.list("")}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_boots_in_the_other_package(tmp_path, writer):
    """A DirBlobStore written by one package (row and column tables,
    UPDATE, DELETE, ALTER) boots in the other: the same tables, rows,
    dictionary ids and plan-step clock; a write there is read back by
    the first package after its own reboot; both packages write the
    same blobs for the same statements."""
    roots = {k: str(tmp_path / k) for k in ("ref", "port", "shared")}
    makers = {"ref": lambda root: RCluster(store=RDirStore(root)),
              "port": lambda root: Cluster(store=DirBlobStore(root),
                                           device="cpu")}
    reader = "port" if writer == "ref" else "ref"
    for who in ("ref", "port"):
        s = makers[who](roots[who]).session()
        for sql in _STORE_SQL:
            s.execute(sql)
    port_blobs, ref_blobs = _blobs(roots["port"]), _blobs(roots["ref"])
    assert port_blobs.keys() == ref_blobs.keys()
    same = [k for k in ref_blobs
            if k.startswith(("tablet/ds/", "cluster/dicts/"))]
    assert same and any("/log/" in k for k in same)
    for k in same:
        assert port_blobs[k] == ref_blobs[k], k
    w = makers[writer](roots["shared"])
    ws = w.session()
    for sql in _STORE_SQL:
        ws.execute(sql)
    want = _host(ws.execute(_STORE_READ))
    r = makers[reader](roots["shared"])
    assert _dicts(r) == _dicts(w)
    assert r.coordinator.read_snapshot() >= w.coordinator.read_snapshot()
    _same(_host(r.session().execute(_STORE_READ)), want, _STORE_READ)
    rs = r.session()
    for sql in ("insert into r values (5, 'fifth', 5, 5)",
                "update r set name = 'b' where id = 3",
                "delete from r where id = 4"):
        assert rs.execute(sql).committed
    after = _host(rs.execute(_STORE_READ))
    back = makers[writer](roots["shared"])
    assert _dicts(back) == _dicts(r)
    _same(_host(back.session().execute(_STORE_READ)), after, _STORE_READ)


# ---------------- sequences, and what waits for later items ----------------

@pytest.mark.parametrize("sql,item", [
    ("create sequence s1", "item 10"),
    ("drop sequence s1", "item 10"),
    ("insert into kv values (nextval('s1'), 1)", "item 10"),
    ("create table cf (k bigint not null, primary key (k)) "
     "with (store = row, changefeed = on)", "item 11"),
])
def test_sequences_and_changefeeds_raise_typed_plan_error(sql, item):
    """Sequences are ported (ROADMAP.md queue A item 10, ``tablet/
    kesus.py``): each statement over a row table answers as the
    reference's, a missing sequence included. A changefeed still raises a
    typed ``PlanError`` naming item 11."""
    kv = ("create table kv (k bigint not null, v bigint, "
          "primary key (k)) with (store = row)")
    if item == "item 10":
        read = "select k, v from kv order by k"
        _both([kv, sql, read])  # before any CREATE SEQUENCE
        ref, port = _both([kv, "create sequence s1 start 5 cache 2", sql,
                           read, "insert into kv values (nextval('s1'), "
                           "2), (nextval('s1'), 3)", read])
        if sql.startswith("drop"):
            assert "s1" not in port.sequences._cache
        return
    s = Cluster(device="cpu").session()
    s.execute(kv)
    with pytest.raises(PlanError, match=item):
        s.execute(sql)
    assert "cf" not in s.cluster.tables


def test_changefeed_on_a_column_table_is_the_reference_error():
    _both(["create table cf (k bigint not null, primary key (k)) "
           "with (changefeed = on)"])


def test_row_shards_in_tablet_counters():
    c = Cluster(device="cpu")
    s = c.session()
    s.execute("create table r (id bigint not null, v bigint, "
              "primary key (id)) with (store = row, shards = 2)")
    s.execute("insert into r values (1, 1), (2, 2), (3, 3)")
    s.execute("update r set v = 0 where id = 2")
    rows = tablet_counters.collect(c)
    ds = [r for r in rows if r["type"] == "ds"]
    assert sorted(r["tablet_id"] for r in ds) == ["ds/r/0", "ds/r/1"]
    assert all(r["tx_committed"] > 0 for r in ds)
    agg = tablet_counters.aggregate(c, rows)
    assert agg["ds"]["tablets"] == 2
    assert agg["ds"]["tx_committed"] == sum(r["tx_committed"] for r in ds)


def test_row_table_store_reboots_in_port():
    """A port Cluster over a MemBlobStore reboots its row tables: rows,
    schema after ALTER and the clock; an interrupted DROP COLUMN strip
    (its marker left in the scheme) finishes at boot."""
    store = MemBlobStore()
    c = Cluster(store=store, device="cpu")
    s = c.session()
    s.execute("create table r (id bigint not null, a bigint, b bigint, "
              "primary key (id)) with (store = row)")
    s.execute("insert into r values (1, 1, 1), (2, 2, 2)")
    c.scheme.mark_strip("/r")  # a strip that a crash interrupted
    c.scheme.alter_table("/r", add_columns=[], drop_columns=["b"])
    raw = [row for sh in c.tables["r"].shards
           for page in sh.read(c.coordinator.read_snapshot())
           for _k, row in page]
    assert all("b" in row for row in raw)
    c2 = Cluster(store=store, device="cpu")
    assert not c2.scheme.pending_strips()
    raw = [row for sh in c2.tables["r"].shards
           for page in sh.read(c2.coordinator.read_snapshot())
           for _k, row in page]
    assert raw and all("b" not in row for row in raw)
    out = c2.session().execute("select * from r order by id")
    assert out.schema.names == ("id", "a")


# ---------------- key-pinned row DML ----------------

_PINNED = [
    ("update kv set v = v + 1 where id = 5", True),
    ("update kv set v = v * 2 where 7 = id and v > 0", True),
    ("delete from kv where id in (1, 2, 99)", True),
    ("update kv set v = -v where id = -3", True),
    ("update kv set v = 0 where id = 4 and id = 6", True),
    ("update kv set v = v + 100 where id = 8 or id = 9", False),
    ("delete from kv where v > 60", False),
    ("update kv set v = 1 where id not in (5, 7)", False),
]


@pytest.mark.parametrize("sql,pinned", _PINNED)
def test_key_pinned_row_dml_reads_only_its_rows(sql, pinned, monkeypatch):
    """A row UPDATE / DELETE whose WHERE pins the integer key reads those
    rows by point reads (``source_of_keys``), not by a walk of the table;
    the effects, commits and the table after are the reference's."""
    setup = ["create table kv (id bigint not null, v bigint, "
             "primary key (id)) with (store = row, shards = 3)",
             "insert into kv values " + ", ".join(
                 f"({i}, {i * 10})" for i in range(-5, 12))]
    ref, port = _both(setup)
    t = port.tables["kv"]
    calls = _spy(monkeypatch)
    before = t.pinned_reads
    _both([sql], ref, port)
    assert (t.pinned_reads - before, calls) == (
        (1, []) if pinned else (0, ["kv"]))
    _both(["select * from kv order by id"], ref, port)


# ---------------- the reused row source ----------------

def test_row_source_is_reused_until_a_commit_or_schema_change():
    """``source_at`` hands out its last source while the snapshot, the
    shards' commits and the schema are unchanged; a commit to the table,
    a snapshot that moved, or ADD COLUMN walks again, and every answer is
    the reference's."""
    stmts = ["create table r (id bigint not null, v bigint, "
             "primary key (id)) with (store = row, shards = 2)",
             "create table c (id bigint not null, primary key (id))",
             "insert into r values (1, 10), (2, 20), (3, 30)"]
    ref, port = _both(stmts)
    t = port.tables["r"]
    read = "select sum(v) as s, count(*) as n from r"
    steps = [(read, 1, 0), (read, 0, 1), (read, 0, 1),
             ("update r set v = v + 1 where id = 2", 0, 0),
             (read, 1, 0), (read, 0, 1),
             ("insert into c values (1)", 0, 0),   # the snapshot moves
             (read, 1, 0),
             ("alter table r add column w bigint", 0, 0),
             ("select * from r order by id", 1, 0)]
    for sql, walks, hits in steps:
        b, h = t.source_builds, t.source_hits
        _both([sql], ref, port)
        assert (t.source_builds - b, t.source_hits - h) == (walks, hits), sql
