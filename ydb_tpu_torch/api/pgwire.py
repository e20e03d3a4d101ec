"""PostgreSQL wire-protocol frontend (protocol 3.0, simple query flow).

Mirror of the reference's pgwire compatibility layer
(ydb/core/local_pgwire/local_pgwire_connection.cpp, ydb/core/pgproxy):
a TCP listener that speaks the PostgreSQL v3 message protocol and
routes SQL text into the same in-process session layer the gRPC Query
service uses, so any stock PostgreSQL client (psql, psycopg, JDBC in
simple-query mode) can talk to the cluster.

Supported flow:
  * SSL/GSS negotiation requests (politely refused with 'N'),
  * StartupMessage with optional cleartext-password auth checked
    against the same token set as the gRPC request proxy,
  * ParameterStatus + BackendKeyData + ReadyForQuery handshake,
  * simple Query ('Q') with multi-statement strings, text-format
    results (RowDescription/DataRow/CommandComplete),
  * the extended query protocol: Parse/Bind/Describe/Execute/Close/
    Flush/Sync with text-format $n parameters (inlined at Bind by a
    quote-aware single-pass scanner; Parse-time type OIDs honored,
    the unspecified-OID numeric heuristic documented in
    _render_param), Execute row limits with PortalSuspended, portals
    surviving Sync inside explicit transactions. Describe(portal)
    returns the real row shape; Describe(statement) answers NoData
    (drivers needing statement-level metadata — JDBC default flow —
    must describe the portal). Describe(statement) answers the
    declared parameter oids plus the PLANNED row shape (the JDBC
    PreparedStatement.getMetaData path), and Bind may request binary
    result formats for int/float/bool/text columns (fixed-width
    network-order; text bytes are format-invariant). Binary parameter formats are
    rejected with clear errors,
  * CancelRequest (connection-level no-op), Terminate ('X').

Every connection owns one session. Cluster state is single-writer, so
DDL/DML/transaction statements serialize on the shared lock (the same
contract as api/server.RequestProxy.lock) — but read statements
(SELECT/EXPLAIN, outside an open transaction) execute WITHOUT it, so
concurrent connections co-occupy the cross-query batch window
(kqp/batch.py) and compatible SELECTs from different sockets share one
device dispatch. Tenancy: a ``tenant`` startup parameter (or the
authenticated principal's binding) resolves through the cluster front
door (serving/).

The port's own copy of ``ydb_tpu/api/pgwire.py``: the same messages,
byte for byte, over the port's ``Cluster``, with the leak sanitizer's
handle per connection.
"""

from __future__ import annotations

import itertools
import socket
import socketserver
import struct
import threading

import numpy as np

from ydb_tpu_torch import dtypes, serving
from ydb_tpu_torch.analysis import leaksan
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.tx.coordinator import TxResult

_PROTO_V3 = 196608        # 3.0
_SSL_REQUEST = 80877103
_GSSENC_REQUEST = 80877104
_CANCEL_REQUEST = 80877102

# (type oid, typlen) per logical kind; values always travel in text
# format, the oid is what drives client-side parsing
_PG_OID = {
    dtypes.Kind.BOOL: (16, 1),
    dtypes.Kind.INT8: (21, 2),
    dtypes.Kind.INT16: (21, 2),
    dtypes.Kind.INT32: (23, 4),
    dtypes.Kind.INT64: (20, 8),
    dtypes.Kind.UINT8: (21, 2),
    dtypes.Kind.UINT16: (23, 4),
    dtypes.Kind.UINT32: (20, 8),
    dtypes.Kind.UINT64: (20, 8),
    dtypes.Kind.FLOAT: (700, 4),
    dtypes.Kind.DOUBLE: (701, 8),
    dtypes.Kind.DATE: (1082, 4),
    dtypes.Kind.TIMESTAMP: (1114, 8),
    dtypes.Kind.DECIMAL: (1700, -1),
    dtypes.Kind.STRING: (25, -1),
}


class _PgError(Exception):
    def __init__(self, message: str, code: str = "XX000"):
        super().__init__(message)
        self.code = code


class _SkipToSync(Exception):
    """An ErrorResponse was already sent; discard until Sync."""


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def cstr(self) -> str:
        end = self.buf.index(b"\x00", self.off)
        s = self.buf[self.off:end].decode("utf-8", "surrogateescape")
        self.off = end + 1
        return s

    def u16(self) -> int:
        return struct.unpack("!H", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack("!i", self.take(4))[0]


import re as _re

_NUMERIC_RE = _re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?$")

# pg type OIDs whose text form may inline unquoted
_NUMERIC_OIDS = {20, 21, 23, 26, 700, 701, 1700}
_TEXTUAL_OIDS = {25, 1043, 1042, 18, 19}


def _render_param(raw: bytes, oid: int) -> str:
    if raw is None:
        return "NULL"
    text = raw.decode("utf-8", "surrogateescape")
    if oid in _NUMERIC_OIDS:
        if not _NUMERIC_RE.match(text):
            raise _PgError(f"invalid numeric parameter {text!r}",
                           "22P02")
        return text
    if oid == 0 and _NUMERIC_RE.match(text):
        # unspecified type: numeric-looking text inlines unquoted (a
        # documented heuristic — drivers that mean the STRING '42'
        # should declare a text OID at Parse time)
        return text
    return "'" + text.replace("'", "''") + "'"


def _substitute_params(query: str, params: list,
                       oids: list[int]) -> str:
    """Inline text-format parameters into $n placeholders with ONE
    linear scan that tracks quoting: placeholders inside string
    literals stay untouched, and inlined values are emitted as opaque
    units that are never re-scanned (no nested re-substitution, no
    quote breakout from parameter contents)."""
    rendered = [
        _render_param(p, oids[i] if i < len(oids) else 0)
        for i, p in enumerate(params)
    ]
    out = []
    i = 0
    n = len(query)
    in_quote = False
    while i < n:
        ch = query[i]
        if in_quote:
            out.append(ch)
            if ch == "'":
                # doubled quote = escaped quote inside the literal
                if i + 1 < n and query[i + 1] == "'":
                    out.append("'")
                    i += 1
                else:
                    in_quote = False
            i += 1
            continue
        if ch == "'":
            in_quote = True
            out.append(ch)
            i += 1
            continue
        if ch == "$" and i + 1 < n and query[i + 1].isdigit():
            j = i + 1
            while j < n and query[j].isdigit():
                j += 1
            idx = int(query[i + 1:j])
            if not 1 <= idx <= len(rendered):
                raise _PgError(
                    f"there is no parameter ${idx}", "08P01")
            out.append(rendered[idx - 1])
            i = j
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _msg(type_byte: bytes, payload: bytes) -> bytes:
    return type_byte + struct.pack("!I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode("utf-8", "surrogateescape") + b"\x00"


def _error(message: str, code: str = "XX000") -> bytes:
    fields = (b"S" + _cstr("ERROR") + b"V" + _cstr("ERROR")
              + b"C" + _cstr(code) + b"M" + _cstr(message) + b"\x00")
    return _msg(b"E", fields)


def _col_fmt(res_fmts, ci: int) -> int:
    """Per-column result format from Bind's codes: none = text, one =
    applies to all, else positional (pg protocol 3.0 semantics)."""
    if not res_fmts:
        return 0
    if len(res_fmts) == 1:
        return res_fmts[0]
    return res_fmts[ci] if ci < len(res_fmts) else 0


# binary result encodings per kind (JDBC's binary transfer mode):
# network-order fixed-width for ints/floats/bool; text (same bytes)
# for strings. Kinds absent here refuse binary with 0A000.
_BIN_PACK = {
    dtypes.Kind.INT8: "!h", dtypes.Kind.INT16: "!h",
    dtypes.Kind.UINT8: "!h", dtypes.Kind.INT32: "!i",
    dtypes.Kind.UINT16: "!i", dtypes.Kind.INT64: "!q",
    dtypes.Kind.UINT32: "!q",
    dtypes.Kind.FLOAT: "!f", dtypes.Kind.DOUBLE: "!d",
}


def _binary_value(kind: dtypes.Kind, v) -> bytes:
    pack = _BIN_PACK.get(kind)
    if pack is not None:
        return struct.pack(
            pack, float(v) if pack in ("!f", "!d") else int(v))
    if kind == dtypes.Kind.BOOL:
        return b"\x01" if v else b"\x00"
    # UINT64 deliberately absent: its advertised oid is 20 (signed
    # int8), so a '!Q' payload >= 2^63 would silently decode negative
    raise _PgError(
        f"binary result format not supported for {kind.name}", "0A000")


def _format_value(kind: dtypes.Kind, scale: int, v) -> bytes:
    if kind == dtypes.Kind.BOOL:
        return b"t" if v else b"f"
    if kind == dtypes.Kind.DATE:
        return str(np.datetime64(int(v), "D")).encode()
    if kind == dtypes.Kind.TIMESTAMP:
        return str(np.datetime64(int(v), "us")).encode().replace(
            b"T", b" ")
    if kind == dtypes.Kind.DECIMAL:
        import decimal as pydec

        return str(pydec.Decimal(int(v)).scaleb(-scale)).encode()
    if kind in (dtypes.Kind.FLOAT, dtypes.Kind.DOUBLE):
        return f"{float(v):.17g}".encode()
    return str(int(v)).encode()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):  # noqa: C901 - one protocol, one state machine
        srv: PgWireServer = self.server.pg  # type: ignore[attr-defined]
        sock = self.request
        sock.settimeout(srv.idle_timeout)
        try:
            if not self._startup(srv, sock):
                return
            self._session_loop(srv, sock)
        except (ConnectionError, socket.timeout, OSError):
            pass

    # -- startup / auth --

    def _read_exact(self, sock, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def _startup(self, srv, sock) -> bool:
        while True:
            (length,) = struct.unpack("!I", self._read_exact(sock, 4))
            payload = self._read_exact(sock, length - 4)
            (code,) = struct.unpack("!I", payload[:4])
            if code in (_SSL_REQUEST, _GSSENC_REQUEST):
                sock.sendall(b"N")  # not supported, retry in clear
                continue
            if code == _CANCEL_REQUEST:
                return False  # per protocol: no response, just close
            if code != _PROTO_V3:
                sock.sendall(_error(
                    f"unsupported protocol {code >> 16}.{code & 0xffff}",
                    "0A000"))
                return False
            params = payload[4:].split(b"\x00")
            kv = dict(zip(params[0::2], params[1::2]))
            self.user = kv.get(b"user", b"").decode()
            # arbitrary startup parameters ride here; "tenant" routes
            # the connection to its workload pool (serving/tenants.py)
            self.startup_kv = kv
            break
        self.principal = None
        if srv.auth_tokens is not None:
            sock.sendall(_msg(b"R", struct.pack("!I", 3)))  # cleartext
            t, body = self._read_message(sock)
            if t != b"p" or body[:-1].decode() not in srv.auth_tokens:
                sock.sendall(_error("password authentication failed",
                                    "28P01"))
                return False
            self.principal = body[:-1].decode()  # the ACL subject
        sock.sendall(_msg(b"R", struct.pack("!I", 0)))  # AuthenticationOk
        for k, v in (("server_version", "15.0 ydb-tpu"),
                     ("server_encoding", "UTF8"),
                     ("client_encoding", "UTF8"),
                     ("DateStyle", "ISO, YMD"),
                     ("integer_datetimes", "on")):
            sock.sendall(_msg(b"S", _cstr(k) + _cstr(v)))
        backend_id = next(srv._backend_ids)
        sock.sendall(_msg(b"K", struct.pack("!II", backend_id, 0)))
        self._ready(sock)
        return True

    def _read_message(self, sock):
        t = self._read_exact(sock, 1)
        (length,) = struct.unpack("!I", self._read_exact(sock, 4))
        return t, self._read_exact(sock, length - 4)

    def _ready(self, sock):
        sock.sendall(_msg(b"Z", b"I"))

    # -- query loop --

    def _session_loop(self, srv, sock):
        session = srv.cluster.session()
        session.principal = getattr(self, "principal", None)
        kv = getattr(self, "startup_kv", {})
        hint = kv.get(b"tenant", b"").decode() or None
        session.tenant = serving.resolve_tenant(
            srv.cluster, tenant=hint, principal=session.principal)
        conn = leaksan.track(
            "serving.conn", f"pgwire:{session.tenant}")
        try:
            self._message_loop(srv, sock, session)
        finally:
            leaksan.close(conn)

    def _message_loop(self, srv, sock, session):
        skip_to_sync = False
        statements: dict[str, dict] = {}  # Parse'd prepared statements
        portals: dict[str, dict] = {}     # Bind'd portals
        while True:
            t, body = self._read_message(sock)
            if t == b"X":
                return
            if skip_to_sync:
                if t == b"S":
                    skip_to_sync = False
                    if session._tx is None:
                        portals.clear()
                    self._ready(sock)
                continue
            try:
                if t == b"Q":
                    self._simple_query(srv, sock, session,
                                       body.rstrip(b"\x00").decode(
                                           "utf-8", "surrogateescape"))
                    self._ready(sock)
                elif t == b"P":
                    self._parse_msg(body, statements)
                    sock.sendall(_msg(b"1", b""))  # ParseComplete
                elif t == b"B":
                    self._bind_msg(body, statements, portals)
                    sock.sendall(_msg(b"2", b""))  # BindComplete
                elif t == b"D":
                    self._describe_msg(srv, sock, session, body,
                                       statements, portals)
                elif t == b"E":
                    self._execute_msg(srv, sock, session, body, portals)
                elif t == b"C":  # Close statement/portal
                    kind, name = body[0:1], body[1:-1].decode()
                    (statements if kind == b"S" else portals).pop(
                        name, None)
                    sock.sendall(_msg(b"3", b""))  # CloseComplete
                elif t == b"H":  # Flush: everything is already sent
                    pass
                elif t == b"S":
                    # Sync ends the implicit transaction and its
                    # portals; inside an explicit BEGIN they survive
                    # (libpq cursor-style fetch loops rely on this)
                    if session._tx is None:
                        portals.clear()
                    self._ready(sock)
            except _SkipToSync:
                skip_to_sync = True  # error already on the wire
            except _PgError as e:
                sock.sendall(_error(str(e), e.code))
                skip_to_sync = True
            except (ConnectionError, OSError):
                raise
            except Exception as e:  # noqa: BLE001 - wire it to client
                sock.sendall(_error(str(e), "XX000"))
                skip_to_sync = True
            # anything else (e.g. stray password): ignore

    # -- extended query protocol (Parse/Bind/Describe/Execute) --

    def _parse_msg(self, body: bytes, statements: dict) -> None:
        r = _Cursor(body)
        name = r.cstr()
        query = r.cstr()
        n_oids = r.u16()
        oids = [struct.unpack("!I", r.take(4))[0]
                for _ in range(n_oids)]
        statements[name] = {"query": query, "oids": oids}

    def _bind_msg(self, body: bytes, statements: dict,
                  portals: dict) -> None:
        r = _Cursor(body)
        portal = r.cstr()
        stmt_name = r.cstr()
        stmt = statements.get(stmt_name)
        if stmt is None:
            raise _PgError(f"unknown prepared statement "
                           f"{stmt_name!r}", "26000")
        n_fmt = r.u16()
        fmts = [r.u16() for _ in range(n_fmt)]
        n_params = r.u16()
        params = []
        for i in range(n_params):
            ln = r.i32()
            raw = None if ln == -1 else r.take(ln)
            fmt = fmts[i] if i < len(fmts) else (fmts[0] if fmts else 0)
            if raw is not None and fmt != 0:
                raise _PgError("binary parameters not supported",
                               "0A000")
            params.append(raw)
        n_res = r.u16()
        res_fmts = [r.u16() for _ in range(n_res)]
        sql = _substitute_params(stmt["query"], params, stmt["oids"])
        portals[portal] = {"sql": sql, "result": None, "done": False,
                           "described": stmt.get("described_s", False),
                           "sent": 0, "complete": False,
                           "res_fmts": res_fmts}

    def _exec_stmt(self, srv, session, sql: str):
        """Run one statement with the right concurrency contract:
        reads (outside an open transaction) execute without the
        server's write lock so concurrent connections can co-occupy
        the batch window; everything that can mutate cluster state
        keeps the single-writer lock."""
        if getattr(session, "_tx", None) is None \
                and serving.is_read_statement(sql):
            return session.execute(sql)
        with srv.lock:
            return session.execute(sql)

    def _run_portal(self, srv, session, portal: dict) -> None:
        if portal["done"]:
            return
        portal["result"] = self._exec_stmt(srv, session, portal["sql"])
        portal["done"] = True
        # reject unsupported binary columns NOW — a clean ErrorResponse
        # before any RowDescription/DataRow reaches the wire
        out = portal["result"]
        fmts = portal.get("res_fmts")
        if fmts and isinstance(out, OracleTable):
            for ci, f in enumerate(out.schema.fields):
                if _col_fmt(fmts, ci) == 1 and not f.type.is_string \
                        and f.type.kind not in _BIN_PACK \
                        and f.type.kind != dtypes.Kind.BOOL:
                    raise _PgError(
                        f"binary result format not supported for "
                        f"{f.type.kind.name}", "0A000")

    def _describe_msg(self, srv, sock, session, body, statements,
                      portals) -> None:
        kind, name = body[0:1], body[1:-1].decode()
        if kind == b"S":
            stmt = statements.get(name)
            if stmt is None:
                raise _PgError(f"unknown prepared statement {name!r}",
                               "26000")
            # ParameterDescription: the oids Parse declared
            oids = stmt["oids"]
            sock.sendall(_msg(b"t", struct.pack(
                "!H", len(oids)) + b"".join(
                struct.pack("!I", o) for o in oids)))
            cols = self._statement_row_shape(srv, stmt)
            if cols is None:
                sock.sendall(_msg(b"n", b""))  # NoData
            else:
                self._send_rowdesc(sock, cols)
                # the client HAS the shape: Execute on portals of this
                # statement must not inject a duplicate RowDescription
                stmt["described_s"] = True
            return
        portal = portals.get(name)
        if portal is None:
            raise _PgError(f"unknown portal {name!r}", "34000")
        # the portal runs here (once); Execute streams the cached
        # result — Describe must announce the real row shape
        self._run_portal(srv, session, portal)
        out = portal["result"]
        if isinstance(out, OracleTable):
            self._send_rowdesc(
                sock, [(f.name, f.type.kind,
                        getattr(f.type, "scale", 0))
                       for f in out.schema.fields],
                res_fmts=portal.get("res_fmts"))
            portal["described"] = True
        else:
            sock.sendall(_msg(b"n", b""))  # NoData (DML/DDL)

    def _statement_row_shape(self, srv, stmt):
        """Row shape of a prepared statement WITHOUT executing it (the
        JDBC PreparedStatement.getMetaData path): plan against the
        catalog with type-appropriate dummy parameters. Result column
        types come from the catalog, not the parameter values, so the
        dummies do not distort the shape. None = NoData (DML/DDL,
        or a shape we cannot plan without execution)."""
        try:
            from ydb_tpu_torch.sql import ast as _ast
            from ydb_tpu_torch.sql.parser import parse as _parse
            from ydb_tpu_torch.sql.planner import plan_select_full

            n_params = len(set(_re.findall(r"\$(\d+)",
                                           stmt["query"])))
            dummies = []
            for i in range(n_params):
                oid = (stmt["oids"][i]
                       if i < len(stmt["oids"]) else 25)
                dummies.append(b"" if oid == 25 else b"0")
            sql = _substitute_params(stmt["query"], dummies,
                                     stmt["oids"])
            parsed = _parse(sql)
            if not isinstance(parsed, (_ast.Select, _ast.UnionAll)):
                return None
            with srv.lock:
                pq = plan_select_full(parsed,
                                      srv.cluster.catalog())
            return [(n, pq.out_types[n].kind,
                     getattr(pq.out_types[n], "scale", 0))
                    for n in pq.out_names]
        except Exception:  # noqa: BLE001 - fall back to NoData
            return None

    def _execute_msg(self, srv, sock, session, body, portals) -> None:
        r = _Cursor(body)
        name = r.cstr()
        max_rows = r.i32()
        portal = portals.get(name)
        if portal is None:
            raise _PgError(f"unknown portal {name!r}", "34000")
        self._run_portal(srv, session, portal)
        out = portal["result"]
        if isinstance(out, OracleTable):
            if portal["complete"]:  # re-Execute after completion:
                sock.sendall(_msg(b"C", _cstr("SELECT 0")))
                return
            n = out.num_rows
            start = portal["sent"]
            take = (n - start if max_rows <= 0
                    else min(max_rows, n - start))
            self._send_table(sock, out,
                             with_rowdesc=not portal["described"],
                             start=start, limit=take,
                             send_complete=False,
                             res_fmts=portal.get("res_fmts"))
            portal["described"] = True  # shape announced at most once
            portal["sent"] = start + take
            if portal["sent"] >= n:
                portal["complete"] = True
                sock.sendall(_msg(b"C", _cstr(f"SELECT {take}")))
            else:
                sock.sendall(_msg(b"s", b""))  # PortalSuspended
            return
        if portal["complete"]:
            # effects applied exactly once; re-Execute re-acks only
            verb = (portal["sql"].split(None, 1)[0]
                    if portal["sql"].split() else "OK").upper()
            sock.sendall(_msg(b"C", _cstr(verb)))
            return
        ok = self._send_result(sock, portal["sql"], out,
                               with_rowdesc=False)
        portal["complete"] = True
        if not ok:
            raise _SkipToSync()

    def _simple_query(self, srv, sock, session, text: str):
        statements = [s.strip() for s in text.split(";")]
        statements = [s for s in statements if s]
        if not statements:
            sock.sendall(_msg(b"I", b""))  # EmptyQueryResponse
            return
        for stmt in statements:
            try:
                out = self._exec_stmt(srv, session, stmt)
            except Exception as e:  # noqa: BLE001 - wire it to client
                sock.sendall(_error(str(e), "42601"))
                return  # abort rest of the query string (pg semantics)
            if not self._send_result(sock, stmt, out):
                return  # failed DML also aborts the rest

    def _send_result(self, sock, stmt: str, out,
                     with_rowdesc: bool = True) -> bool:
        """Sends the per-statement response; False = error sent (the
        caller must abort the rest of the query string, pg semantics).
        ``with_rowdesc=False`` for the extended protocol, where
        RowDescription only answers Describe."""
        verb = (stmt.split(None, 1)[0] if stmt.split() else "").upper()
        if out is None:  # DDL
            sock.sendall(_msg(b"C", _cstr(verb or "OK")))
        elif isinstance(out, str):  # EXPLAIN text
            if with_rowdesc:
                self._send_rowdesc(
                    sock, [("QUERY PLAN", dtypes.Kind.STRING, 0)])
            for line in out.splitlines():
                v = line.encode()
                sock.sendall(_msg(
                    b"D", struct.pack("!H", 1)
                    + struct.pack("!I", len(v)) + v))
            sock.sendall(_msg(b"C", _cstr("EXPLAIN")))
        elif isinstance(out, OracleTable):
            self._send_table(sock, out, with_rowdesc=with_rowdesc)
        elif isinstance(out, TxResult):
            if not out.committed:
                sock.sendall(_error(out.error or "not committed",
                                    "40001"))
                return False
            tag = ("INSERT 0 0" if verb in ("INSERT", "UPSERT")
                   else verb or "OK")
            sock.sendall(_msg(b"C", _cstr(tag)))
        else:
            sock.sendall(_msg(b"C", _cstr(verb or "OK")))
        return True

    def _send_rowdesc(self, sock, cols, res_fmts=None):
        parts = [struct.pack("!H", len(cols))]
        for ci, (name, kind, _scale) in enumerate(cols):
            oid, typlen = _PG_OID[kind]
            fmt = _col_fmt(res_fmts, ci)
            parts.append(
                _cstr(name)
                + struct.pack("!IhIhih", 0, 0, oid, typlen, -1, fmt))
        sock.sendall(_msg(b"T", b"".join(parts)))

    def _send_table(self, sock, out: OracleTable,
                    with_rowdesc: bool = True, start: int = 0,
                    limit: int | None = None,
                    send_complete: bool = True,
                    res_fmts=None):
        fields = list(out.schema.fields)
        if with_rowdesc:
            self._send_rowdesc(
                sock,
                [(f.name, f.type.kind, getattr(f.type, "scale", 0))
                 for f in fields], res_fmts=res_fmts)
        n = out.num_rows
        hi = n if limit is None else min(n, start + limit)
        text_cols = []
        for ci, f in enumerate(fields):
            vals, valid = out.cols[f.name]
            valid = np.asarray(valid, dtype=bool)
            binary = _col_fmt(res_fmts, ci) == 1
            if f.type.is_string:
                # text and binary wire forms of text ARE the same bytes
                decoded = out.strings(f.name)
                col = [None if not valid[i] else
                       decoded[i] for i in range(start, hi)]
            elif binary:
                col = [None if not valid[i] else
                       _binary_value(f.type.kind, vals[i])
                       for i in range(start, hi)]
            else:
                scale = getattr(f.type, "scale", 0)
                col = [None if not valid[i] else
                       _format_value(f.type.kind, scale, vals[i])
                       for i in range(start, hi)]
            text_cols.append(col)
        for i in range(hi - start):
            parts = [struct.pack("!H", len(fields))]
            for col in text_cols:
                v = col[i]
                if v is None:
                    parts.append(struct.pack("!i", -1))
                else:
                    parts.append(struct.pack("!I", len(v)) + v)
            sock.sendall(_msg(b"D", b"".join(parts)))
        if send_complete:
            sock.sendall(_msg(b"C", _cstr(f"SELECT {hi - start}")))


class PgWireServer:
    """Threaded PostgreSQL-wire listener over a Cluster.

    ``lock`` serializes statement execution against other front doors;
    pass RequestProxy.lock to co-host with the gRPC server."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 auth_tokens: set[str] | None = None,
                 lock: threading.Lock | None = None,
                 idle_timeout: float = 300.0):
        self.cluster = cluster
        self.auth_tokens = auth_tokens
        self.lock = lock if lock is not None else threading.Lock()
        self.idle_timeout = idle_timeout
        self._backend_ids = itertools.count(1)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._server.pg = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> "PgWireServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="pgwire")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
