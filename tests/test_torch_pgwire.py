"""The port's PostgreSQL wire front (``ydb_tpu_torch/api/pgwire.py``): a
mirror of ``tests/test_pgwire.py`` over a port ``Cluster(device="cpu")``
(the same from-the-spec minimal client drives the handshake,
simple-query results, errors, auth and the extended protocol), plus the
same statements sent to the reference's server and the port's: every
message after the handshake (RowDescription, DataRow, CommandComplete,
ErrorResponse, ReadyForQuery) must be equal byte for byte (float
values included, for arithmetic that rounds exactly)."""

import struct

import pytest

from ydb_tpu_torch.api.pgwire import PgWireServer
from ydb_tpu_torch.kqp.session import Cluster

from test_pgwire import MiniPgClient


@pytest.fixture
def server():
    cluster = Cluster(device="cpu")
    srv = PgWireServer(cluster).start()
    yield srv
    srv.stop()


def test_handshake_and_query_roundtrip(server):
    c = MiniPgClient(server.port, try_ssl=True)
    assert c.params["server_encoding"] == "UTF8"
    assert c.backend_key is not None

    _, _, tags, errors = c.query(
        "CREATE TABLE t (id int64, name string, amount decimal(10,2), "
        "d date, PRIMARY KEY (id))")
    assert not errors and tags == ["CREATE"]
    _, _, tags, errors = c.query(
        "INSERT INTO t VALUES (1, 'ann', 12.50, date '2026-01-05'), "
        "(2, 'bob', 0.75, date '2026-02-06'), (3, NULL, NULL, NULL)")
    assert not errors and tags == ["INSERT 0 0"]

    rows, cols, tags, errors = c.query(
        "SELECT id, name, amount, d FROM t ORDER BY id")
    assert not errors and tags == ["SELECT 3"]
    assert [(n, o) for n, o in cols] == [
        ("id", 20), ("name", 25), ("amount", 1700), ("d", 1082)]
    assert rows[0] == ["1", "ann", "12.50", "2026-01-05"]
    assert rows[1] == ["2", "bob", "0.75", "2026-02-06"]
    assert rows[2] == ["3", None, None, None]
    c.close()


def test_multi_statement_and_error_recovery(server):
    c = MiniPgClient(server.port)
    _, _, tags, errors = c.query(
        "CREATE TABLE kv (k int64, v int64, PRIMARY KEY (k)); "
        "INSERT INTO kv VALUES (1, 10); INSERT INTO kv VALUES (2, 20)")
    assert not errors and len(tags) == 3

    # error aborts the rest of the string but not the connection
    _, _, tags, errors = c.query("SELECT nope FROM kv; SELECT k FROM kv")
    assert errors and not tags
    rows, _, tags, errors = c.query("SELECT k, v FROM kv ORDER BY k")
    assert not errors and rows == [["1", "10"], ["2", "20"]]
    c.close()


def test_auth_required(server):
    server.auth_tokens = {"sesame"}
    with pytest.raises((RuntimeError, AssertionError)):
        MiniPgClient(server.port, password="wrong")
    c = MiniPgClient(server.port, password="sesame")
    _, _, tags, errors = c.query(
        "CREATE TABLE a (k int64, PRIMARY KEY (k))")
    assert not errors
    c.close()
    server.auth_tokens = None


def test_failed_dml_aborts_rest_of_query_string():
    """A DML that returns TxResult(committed=False) must send an error
    AND abort the remaining statements (pg simple-query semantics)."""
    from ydb_tpu_torch.tx.coordinator import TxResult

    executed = []

    class StubSession:
        def execute(self, sql):
            executed.append(sql)
            if "fail" in sql:
                return TxResult(1, 1, False, "lock conflict")
            return None

    class StubCluster:
        def session(self):
            return StubSession()

    srv = PgWireServer(StubCluster()).start()
    try:
        c = MiniPgClient(srv.port)
        _, _, tags, errors = c.query(
            "UPSERT fail; CREATE TABLE never_runs (k int64)")
        assert errors == ["lock conflict"] and not tags
        assert executed == ["UPSERT fail"]
        c.close()
    finally:
        srv.stop()


def _parse(c, name, query):
    c.send_raw(b"P", name.encode() + b"\x00" + query.encode()
               + b"\x00" + struct.pack("!H", 0))


def _bind(c, portal, stmt, params):
    body = portal.encode() + b"\x00" + stmt.encode() + b"\x00"
    body += struct.pack("!H", 1) + struct.pack("!H", 0)  # all text
    body += struct.pack("!H", len(params))
    for p in params:
        if p is None:
            body += struct.pack("!i", -1)
        else:
            b = str(p).encode()
            body += struct.pack("!i", len(b)) + b
    body += struct.pack("!H", 0)  # result formats: default
    c.send_raw(b"B", body)


def _collect_until_ready(c):
    msgs = []
    while True:
        t, body = c.read_message()
        msgs.append((t, body))
        if t == b"Z":
            return msgs


def test_extended_protocol_parameterized_flow(server):
    c = MiniPgClient(server.port)
    c.query("CREATE TABLE e (k int64, name string, PRIMARY KEY (k))")

    # Parse once, Bind/Execute twice with different parameters
    _parse(c, "ins", "INSERT INTO e VALUES ($1, $2)")
    for k, name in ((1, "ann"), (2, "bob's")):  # quote in the value
        _bind(c, "", "ins", [k, name])
        c.send_raw(b"E", b"\x00" + struct.pack("!i", 0))
    c.send_raw(b"S")
    types = [t for t, _ in _collect_until_ready(c)]
    assert types.count(b"1") == 1 and types.count(b"2") == 2
    assert types.count(b"C") == 2 and b"E" not in types

    # select it back through Describe + Execute
    _parse(c, "", "SELECT k, name FROM e WHERE k >= $1 ORDER BY k")
    _bind(c, "", "", [1])
    c.send_raw(b"D", b"P\x00")  # Describe portal -> RowDescription
    c.send_raw(b"E", b"\x00" + struct.pack("!i", 0))
    c.send_raw(b"S")
    msgs = _collect_until_ready(c)
    types = [t for t, _ in msgs]
    assert types.count(b"T") == 1  # exactly one RowDescription
    rows = [b for t, b in msgs if t == b"D"]
    assert len(rows) == 2
    # second row carries the escaped-quote string intact
    assert b"bob's" in rows[1]
    c.close()


def test_extended_protocol_errors_resync(server):
    c = MiniPgClient(server.port)
    # Execute of an unknown portal -> error, then resync on Sync
    c.send_raw(b"E", b"nope\x00" + struct.pack("!i", 0))
    t, body = c.read_message()
    assert t == b"E" and b"portal" in body
    c.send_raw(b"S")
    t, _ = c.read_message()
    assert t == b"Z"
    # binary parameters are rejected cleanly
    c.query("CREATE TABLE be (k int64, PRIMARY KEY (k))")
    _parse(c, "", "INSERT INTO be VALUES ($1)")
    t, _ = c.read_message()
    assert t == b"1"  # ParseComplete
    body = (b"\x00\x00" + struct.pack("!H", 1)
            + struct.pack("!H", 1)       # format 1 = binary
            + struct.pack("!H", 1)
            + struct.pack("!i", 4) + b"\x00\x00\x00\x07"
            + struct.pack("!H", 0))
    c.send_raw(b"B", body)
    t, body = c.read_message()
    assert t == b"E" and b"binary" in body
    c.send_raw(b"S")
    t, _ = c.read_message()
    assert t == b"Z"
    # simple protocol still healthy afterwards
    _, _, tags, errors = c.query("EXPLAIN SELECT k FROM be")
    assert not errors and tags == ["EXPLAIN"]
    c.close()


def test_param_substitution_is_injection_safe():
    """Placeholder-looking and quote-carrying parameter VALUES are
    inert data (code-review security regression)."""
    from ydb_tpu_torch.api.pgwire import _substitute_params

    sql = _substitute_params("INSERT INTO t VALUES ($1, $2)",
                             [b"x", b"$1"], [])
    assert sql == "INSERT INTO t VALUES ('x', '$1')"
    evil = b"a'; DROP TABLE t; --"
    sql = _substitute_params("INSERT INTO t VALUES ($1, $2)",
                             [evil, b"$1"], [])
    assert sql == ("INSERT INTO t VALUES "
                   "('a''; DROP TABLE t; --', '$1')")
    # $n inside a query string literal is untouched
    sql = _substitute_params("SELECT '$1 off' FROM t WHERE k = $1",
                             [b"7"], [])
    assert sql == "SELECT '$1 off' FROM t WHERE k = 7"
    # explicit text OID forces quoting of numeric-looking strings
    sql = _substitute_params("INSERT INTO t VALUES ($1)",
                             [b"42"], [25])
    assert sql == "INSERT INTO t VALUES ('42')"


def test_execute_row_limit_and_portal_suspension(server):
    c = MiniPgClient(server.port)
    c.query("CREATE TABLE big (k int64, PRIMARY KEY (k))")
    c.query("INSERT INTO big VALUES " + ", ".join(
        f"({i})" for i in range(10)))
    _parse(c, "", "SELECT k FROM big ORDER BY k")
    _bind(c, "p1", "", [])
    # fetch in pages of 4: 4 + 4 + 2
    for expect_suspend in (True, True, False):
        c.send_raw(b"E", b"p1\x00" + struct.pack("!i", 4))
        c.send_raw(b"H")
    c.send_raw(b"S")
    msgs = _collect_until_ready(c)
    types = [t for t, _ in msgs]
    assert types.count(b"s") == 2          # two suspensions
    assert types.count(b"D") == 10         # every row exactly once
    assert any(t == b"C" and b"SELECT 2" in b for t, b in msgs)
    # re-Execute after completion: zero rows, no duplicates
    _bind(c, "p2", "", [])
    c.send_raw(b"E", b"p2\x00" + struct.pack("!i", 0))
    c.send_raw(b"E", b"p2\x00" + struct.pack("!i", 0))
    c.send_raw(b"S")
    msgs = _collect_until_ready(c)
    assert [t for t, _ in msgs].count(b"D") == 10
    assert any(t == b"C" and b"SELECT 0" in b for t, b in msgs)
    c.close()


def test_param_substitution_order_and_null(server):
    c = MiniPgClient(server.port)
    c.query("CREATE TABLE p (k int64, a int64, b string, "
            "PRIMARY KEY (k))")
    # 10+ params: $10 must not be clobbered by $1's value
    cols = ", ".join(f"c{i} int64" for i in range(9))
    c.query(f"CREATE TABLE wide (k int64, {cols}, PRIMARY KEY (k))")
    placeholders = ", ".join(f"${i}" for i in range(1, 11))
    _parse(c, "", f"INSERT INTO wide VALUES ({placeholders})")
    _bind(c, "", "", [1, 10, 20, 30, 40, 50, 60, 70, 80, 90])
    c.send_raw(b"E", b"\x00" + struct.pack("!i", 0))
    c.send_raw(b"S")
    types = [t for t, _ in _collect_until_ready(c)]
    assert b"E" not in types
    rows, _, _, errors = c.query("SELECT c8 FROM wide WHERE k = 1")
    assert not errors and rows[0] == ["90"]  # $10's value, not $1's+0
    # NULL parameter
    _parse(c, "", "INSERT INTO p VALUES ($1, $2, $3)")
    _bind(c, "", "", [5, None, "x"])
    c.send_raw(b"E", b"\x00" + struct.pack("!i", 0))
    c.send_raw(b"S")
    assert b"E" not in [t for t, _ in _collect_until_ready(c)]
    rows, _, _, errors = c.query("SELECT a FROM p WHERE k = 5")
    assert not errors and rows[0] == [None]
    c.close()


def test_jdbc_shaped_describe_and_binary_results(server):
    """The JDBC driver handshake: Parse a named
    statement with a $1 parameter, Describe(statement) BEFORE Bind —
    expecting ParameterDescription with the declared oid AND the
    planned RowDescription — then Bind requesting BINARY results,
    Execute, and decode fixed-width network-order values."""
    c = MiniPgClient(server.port)
    c.query("CREATE TABLE j (id int64, name string, score double, "
            "flag bool, PRIMARY KEY (id))")
    c.query("INSERT INTO j VALUES (1, 'ann', 2.5, true), "
            "(2, 'bob', -0.25, false), (3, NULL, NULL, NULL)")

    # Parse named statement with one declared int8 ($1) parameter
    q = b"SELECT id, name, score, flag FROM j WHERE id >= $1 ORDER BY id"
    c.send_raw(b"P", b"stmt1\x00" + q + b"\x00"
               + struct.pack("!HI", 1, 20))
    # Describe(statement) before any Bind
    c.send_raw(b"D", b"Sstmt1\x00")
    c.send_raw(b"H")  # Flush
    t, body = c.read_message()
    assert t == b"1"  # ParseComplete
    t, body = c.read_message()
    assert t == b"t"  # ParameterDescription: one param, oid 20
    assert struct.unpack("!HI", body) == (1, 20)
    t, body = c.read_message()
    assert t == b"T", t  # RowDescription WITHOUT executing
    (ncols,) = struct.unpack("!H", body[:2])
    assert ncols == 4
    names, oids, off = [], [], 2
    for _ in range(ncols):
        end = body.index(b"\x00", off)
        names.append(body[off:end].decode())
        _tab, _att, oid, _tl, _tm, _fmt = struct.unpack(
            "!IhIhih", body[end + 1:end + 19])
        oids.append(oid)
        off = end + 19
    assert names == ["id", "name", "score", "flag"]
    assert oids == [20, 25, 701, 16]

    # Bind with param $1 = '1' (text) and ALL-BINARY results
    bind = (b"p1\x00stmt1\x00" + struct.pack("!H", 0)
            + struct.pack("!H", 1) + struct.pack("!I", 1) + b"1"
            + struct.pack("!HH", 1, 1))  # one code: binary for all
    c.send_raw(b"B", bind)
    c.send_raw(b"D", b"Pp1\x00")   # Describe(portal)
    c.send_raw(b"E", b"p1\x00" + struct.pack("!i", 0))
    c.send_raw(b"S")               # Sync
    rows = []
    fmts = None
    while True:
        t, body = c.read_message()
        if t == b"T":
            (nc,) = struct.unpack("!H", body[:2])
            fmts, off = [], 2
            for _ in range(nc):
                end = body.index(b"\x00", off)
                fmts.append(struct.unpack(
                    "!IhIhih", body[end + 1:end + 19])[5])
                off = end + 19
        elif t == b"D":
            (n,) = struct.unpack("!H", body[:2])
            off, row = 2, []
            for _ in range(n):
                (ln,) = struct.unpack("!i", body[off:off + 4])
                off += 4
                if ln == -1:
                    row.append(None)
                else:
                    row.append(body[off:off + ln])
                    off += ln
            rows.append(row)
        elif t == b"Z":
            break
    assert fmts == [1, 1, 1, 1]  # rowdesc advertises binary
    assert len(rows) == 3
    # binary decode: int8 BE, text bytes, float8 BE, bool byte
    assert struct.unpack("!q", rows[0][0])[0] == 1
    assert rows[0][1] == b"ann"
    assert struct.unpack("!d", rows[0][2])[0] == 2.5
    assert rows[0][3] == b"\x01"
    assert struct.unpack("!q", rows[1][0])[0] == 2
    assert struct.unpack("!d", rows[1][2])[0] == -0.25
    assert rows[1][3] == b"\x00"
    assert rows[2] == [struct.pack("!q", 3), None, None, None]
    c.close()


# ---------------- the reference's server and the port's, byte for byte ----

_EQUAL_BYTES_SQL = [
    "CREATE TABLE t (id int64, name string, amount decimal(10,2), "
    "d date, f double, PRIMARY KEY (id))",
    "INSERT INTO t VALUES (1, 'ann', 12.50, date '2026-01-05', 0.1), "
    "(2, 'bob', 0.75, date '2026-02-06', -2.5), (3, NULL, NULL, NULL, NULL)",
    "SELECT id, name, amount, d, f FROM t ORDER BY id",
    "SELECT name, count(*) AS n, sum(amount) AS s FROM t "
    "GROUP BY name ORDER BY name",
    # float arithmetic that rounds exactly: the reference's XLA divides
    # as x * (1/y), one ulp off the port's IEEE quotient (-2.5 / 3 ends
    # ...326 there, ...337 here), within the reference's own tolerance
    "SELECT id, amount * 2 AS a2, f * 2 AS f2, f + 1 AS f1 FROM t "
    "WHERE id < 3 ORDER BY id",
    "SELECT nope FROM t",
    "EXPLAIN SELECT id FROM t WHERE id > 1",
    "SELECT upper(name) AS u, length(name) AS n FROM t ORDER BY id",
    "SELECT count(*) AS c FROM t; SELECT max(id) AS m FROM t",
]


def _raw_exchange(port, statements):
    """Every message the server sends after the handshake, per statement,
    as raw bytes."""
    cl = MiniPgClient(port)
    out = []
    for sql in statements:
        q = sql.encode() + b"\x00"
        cl.sock.sendall(b"Q" + struct.pack("!I", len(q) + 4) + q)
        msgs = []
        while True:
            t, body = cl.read_message()
            msgs.append(t + body)
            if t == b"Z":
                break
        out.append(msgs)
    cl.close()
    return out


def test_reference_and_port_servers_send_equal_bytes():
    from ydb_tpu.api.pgwire import PgWireServer as RServer
    from ydb_tpu.kqp.session import Cluster as RCluster

    ref = RServer(RCluster()).start()
    port = PgWireServer(Cluster(device="cpu")).start()
    try:
        want = _raw_exchange(ref.port, _EQUAL_BYTES_SQL)
        got = _raw_exchange(port.port, _EQUAL_BYTES_SQL)
    finally:
        ref.stop()
        port.stop()
    for sql, g, w in zip(_EQUAL_BYTES_SQL, got, want):
        assert g == w, sql
    # the exchange covered rows, errors and plans
    kinds = {m[:1] for msgs in got for m in msgs}
    assert {b"T", b"D", b"C", b"E", b"Z"} <= kinds
