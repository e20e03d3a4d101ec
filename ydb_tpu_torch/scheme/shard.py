"""SchemeShard: the schema tablet.

Mirror of the reference's SchemeShard (TSchemeShard
tx/schemeshard/schemeshard_impl.h:75; one persisted operation per DDL in
schemeshard__operation_*.cpp; SURVEY.md §2.5): the single durable owner
of the path tree and every table description. All DDL runs as a tablet
transaction (ydb_tpu_torch.tablet.executor), so the whole schema survives
reboot-anywhere; each mutation is also journaled to an operations table
(the persisted multi-phase-operation analog — ops here commit in one
phase since shard creation is delegated to the hosting layer).

Publication: every successful DDL invokes the registered listeners with
(path, description-or-None, version) — the populator edge of the scheme
board (populator.h), which fans descriptions out to replicas and on to
per-node scheme caches (the reference's ``ydb_tpu/scheme/board.py``).

The port's own copy of ``ydb_tpu/scheme/shard.py``: ``SchemeError`` and
``SchemeShardCore`` (ACLs included), with the reference's table names,
keys and JSON encodings, so a schema written by either package boots in
the other, and the actor wrapper ``SchemeShardTablet``, which publishes
each DDL to the port's scheme board (``scheme/board.py``). Nothing of the
reference's module is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.scheme.model import TableDescription, type_from_str as _type
from ydb_tpu_torch.tablet.executor import TabletExecutor, Transaction, TxContext
from ydb_tpu_torch.tablet.hive import TabletActor


class SchemeError(Exception):
    pass


def _split(path: str) -> list[str]:
    return [p for p in path.strip("/").split("/") if p]


def _parent(path: str) -> str:
    parts = _split(path)
    return "/" + "/".join(parts[:-1]) if len(parts) > 1 else "/"


def _norm(path: str) -> str:
    return "/" + "/".join(_split(path))


class _DdlTx(Transaction):
    def __init__(self, fn: Callable[[TxContext], None]):
        self.fn = fn

    def execute(self, txc, tablet):
        self.fn(txc)


class SchemeShardCore:
    """Synchronous schema engine over a tablet executor. The actor-facing
    SchemeShardTablet wraps this; in-process clusters call it directly."""

    def __init__(self, executor: TabletExecutor):
        self.executor = executor
        self.listeners: list[Callable[[str, dict | None, int], None]] = []
        db = executor.db
        if db.table("paths").get(("/",)) is None:
            self._run(lambda txc: txc.put(
                "paths", ("/",), {"type": "dir", "version": 1}))

    # ---- internals ----

    def _run(self, fn) -> None:
        self.executor.execute(_DdlTx(fn))

    def _publish(self, path: str, desc: dict | None, version: int) -> None:
        for fn in self.listeners:
            fn(path, desc, version)

    def _next_op_id(self) -> int:
        row = self.executor.db.table("meta").get(("next_op",))
        return row["v"] if row else 1

    def _journal(self, txc: TxContext, kind: str, path: str,
                 detail: dict | None = None) -> int:
        """Persist the op; the returned op id doubles as the scheme
        board publish version — globally monotonic across ALL ops, so a
        replayed stale update can never beat a later delete/re-create."""
        op_id = self._next_op_id()
        txc.put("ops", (op_id,), {
            "kind": kind, "path": path, "detail": detail or {},
        })
        txc.put("meta", ("next_op",), {"v": op_id + 1})
        return op_id

    # ---- reads ----

    def describe(self, path: str) -> TableDescription | None:
        row = self.executor.db.table("tables").get((_norm(path),))
        return TableDescription.from_json(row) if row else None

    def exists(self, path: str) -> bool:
        return self.executor.db.table("paths").get((_norm(path),)) is not None

    def kind(self, path: str) -> str | None:
        row = self.executor.db.table("paths").get((_norm(path),))
        return row["type"] if row else None

    def children(self, path: str) -> list[str]:
        base = _norm(path)
        prefix = base if base.endswith("/") else base + "/"
        out = []
        for (p,), _row in self.executor.db.table("paths").range():
            if p != base and p.startswith(prefix) and \
                    "/" not in p[len(prefix):]:
                out.append(p)
        return out

    def list_tables(self) -> list[TableDescription]:
        return [TableDescription.from_json(row)
                for _k, row in self.executor.db.table("tables").range()]

    def operations_log(self) -> list[dict]:
        return [dict(row, op_id=k[0])
                for k, row in self.executor.db.table("ops").range()]

    # ---- DDL ops (one schemeshard__operation_*.cpp analog each) ----

    def mkdir(self, path: str) -> None:
        path = _norm(path)
        if self.exists(path):
            raise SchemeError(f"path {path} already exists")
        self._ensure_parent(path)

        def fn(txc):
            txc.put("paths", (path,), {"type": "dir", "version": 1})
            self._journal(txc, "mkdir", path)

        self._run(fn)

    def _ensure_parent(self, path: str) -> None:
        parent = _parent(path)
        k = self.kind(parent)
        if k is None:
            raise SchemeError(f"parent {parent} does not exist")
        if k != "dir":
            raise SchemeError(f"parent {parent} is not a directory")

    # ---- path ACLs (library/aclib + schemeshard ACL analog) ----

    PERMS = frozenset({"read", "write", "ddl", "grant", "full"})

    def grant(self, path: str, subject: str, perms) -> None:
        """Grant permissions on ``path`` (inherited by the subtree) to
        ``subject`` (an auth token / principal name)."""
        path = _norm(path)
        perms = {perms} if isinstance(perms, str) else set(perms)
        bad = perms - self.PERMS
        if bad:
            raise SchemeError(f"unknown permission(s) {sorted(bad)}")
        if path != "/" and not self.exists(path):
            raise SchemeError(f"no path {path}")

        def fn(txc):
            cur = txc.get("acl", (path, subject))
            have = set(cur["perms"]) if cur else set()
            txc.put("acl", (path, subject),
                    {"perms": sorted(have | perms)})
            self._journal(txc, "grant", path)
        self._run(fn)

    def revoke(self, path: str, subject: str, perms=None) -> None:
        """Revoke (some or all) permissions of ``subject`` on ``path``."""
        path = _norm(path)
        if perms is not None:
            drop = {perms} if isinstance(perms, str) else set(perms)
            bad = drop - self.PERMS
            if bad:  # a typo'd revoke must not silently keep access
                raise SchemeError(
                    f"unknown permission(s) {sorted(bad)}")

        def fn(txc):
            cur = txc.get("acl", (path, subject))
            if cur is None:
                return
            if perms is None:
                txc.erase("acl", (path, subject))
            else:
                drop = {perms} if isinstance(perms, str) else set(perms)
                left = sorted(set(cur["perms"]) - drop)
                if left:
                    txc.put("acl", (path, subject), {"perms": left})
                else:
                    txc.erase("acl", (path, subject))
            self._journal(txc, "revoke", path)
        self._run(fn)

    def access_list(self, path: str) -> dict[str, list[str]]:
        path = _norm(path)
        return {subj: row["perms"] for (p, subj), row in
                self.executor.db.table("acl").range()
                if p == path}

    def acl_enabled(self) -> bool:
        """Enforcement is on once ANY ACE exists (bootstrap-friendly:
        a cluster without configured ACLs keeps token-only auth)."""
        for _k, _row in self.executor.db.table("acl").range():
            return True
        return False

    def check_access(self, subject: str, path: str, perm: str) -> bool:
        """True when an ACE on ``path`` or any ancestor grants
        ``subject`` the permission (or "full")."""
        path = _norm(path)
        acl = self.executor.db.table("acl")
        probe = path
        while True:
            row = acl.get((probe, subject))
            if row is not None and (
                    perm in row["perms"] or "full" in row["perms"]):
                return True
            if probe == "/":
                return False
            probe = _parent(probe)

    def create_table(self, desc: TableDescription) -> None:
        path = _norm(desc.path)
        if self.exists(path):
            raise SchemeError(f"path {path} already exists")
        self._ensure_parent(path)
        for pk in desc.primary_key:
            if pk not in desc.schema:
                raise SchemeError(f"primary key column {pk} not in schema")
        desc = dataclasses.replace(desc, path=path, schema_version=1)
        d = desc.to_json()
        pub = {}

        def fn(txc):
            txc.put("paths", (path,), {"type": "table", "version": 1})
            txc.put("tables", (path,), d)
            pub["v"] = self._journal(txc, "create_table", path)

        self._run(fn)
        self._publish(path, d, pub["v"])

    def drop_table(self, path: str,
                   trash_prefixes: list[str] = ()) -> None:
        """``trash_prefixes``: blob-store prefixes of the table's shard
        state, recorded durably IN the drop transaction; the hosting
        layer deletes them and calls clear_trash, and sweeps leftovers
        on boot — a crash between drop and delete can never resurrect
        rows under a recreated name."""
        path = _norm(path)
        if self.kind(path) != "table":
            raise SchemeError(f"{path} is not a table")
        pub = {}

        def fn(txc):
            txc.erase("paths", (path,))
            txc.erase("tables", (path,))
            pub["v"] = self._journal(txc, "drop_table", path)
            if trash_prefixes:
                txc.put("trash", (pub["v"],),
                        {"prefixes": list(trash_prefixes)})

        self._run(fn)
        self._publish(path, None, pub["v"])

    # ---- trash (deferred storage cleanup) ----

    def trash(self) -> list[tuple[int, list[str]]]:
        return [(k[0], row["prefixes"])
                for k, row in self.executor.db.table("trash").range()]

    def clear_trash(self, op_id: int) -> None:
        self._run(lambda txc: txc.erase("trash", (op_id,)))

    # ---- pending column strips (crash-safe row DROP COLUMN) ----

    def mark_strip(self, path: str) -> None:
        self._run(lambda txc: txc.put("strips", (_norm(path),), {}))

    def clear_strip(self, path: str) -> None:
        self._run(lambda txc: txc.erase("strips", (_norm(path),)))

    def pending_strips(self) -> set[str]:
        return {k[0] for k, _ in
                self.executor.db.table("strips").range()}

    def alter_table(
        self,
        path: str,
        add_columns: list[dtypes.Field] = (),
        drop_columns: list[str] = (),
        ttl_column: str | None | bool = False,  # False = unchanged
    ) -> TableDescription:
        path = _norm(path)
        desc = self.describe(path)
        if desc is None:
            raise SchemeError(f"{path} is not a table")
        fields = list(desc.schema.fields)
        new_version = desc.schema_version + 1
        column_added = dict(desc.column_added)
        for f in add_columns:
            if f.name in desc.schema:
                raise SchemeError(f"column {f.name} already exists")
            if not f.nullable:
                raise SchemeError(
                    "added columns must be nullable (existing rows have "
                    "no value)")
            fields.append(f)
            column_added[f.name] = new_version
        for name in drop_columns:
            if name in desc.primary_key:
                raise SchemeError(f"cannot drop key column {name}")
            if name not in desc.schema:
                raise SchemeError(f"no column {name}")
            fields = [f for f in fields if f.name != name]
            column_added.pop(name, None)
        desc = dataclasses.replace(
            desc,
            schema=dtypes.Schema(tuple(fields)),
            ttl_column=(desc.ttl_column if ttl_column is False
                        else ttl_column),
            schema_version=new_version,
            column_added=column_added,
        )
        d = desc.to_json()
        pub = {}

        def fn(txc):
            row = dict(txc.get("paths", (path,)))
            row["version"] = desc.schema_version
            txc.put("paths", (path,), row)
            txc.put("tables", (path,), d)
            pub["v"] = self._journal(txc, "alter_table", path, {
                "add": [f.name for f in add_columns],
                "drop": list(drop_columns),
            })

        self._run(fn)
        self._publish(path, d, pub["v"])
        return desc

    def reshard_table(self, path: str, n_shards: int,
                      shard_gen: int) -> TableDescription:
        """Record a completed split/merge: the new shard count +
        generation become THE durable truth in one journaled DDL tx
        (the datashard split/merge commit point,
        schemeshard__operation_split_merge.cpp)."""
        path = _norm(path)
        desc = self.describe(path)
        if desc is None:
            raise SchemeError(f"{path} is not a table")
        if n_shards < 1:
            raise SchemeError("n_shards must be >= 1")
        if shard_gen <= desc.shard_gen:
            raise SchemeError(
                f"shard_gen must advance ({shard_gen} <="
                f" {desc.shard_gen})")
        desc = dataclasses.replace(
            desc, n_shards=n_shards, shard_gen=shard_gen)
        d = desc.to_json()
        pub = {}

        def fn(txc):
            row = dict(txc.get("paths", (path,)))
            row["version"] = row.get("version", 1) + 1
            txc.put("paths", (path,), row)
            txc.put("tables", (path,), d)
            pub["v"] = self._journal(txc, "reshard_table", path, {
                "n_shards": n_shards, "shard_gen": shard_gen,
            })

        self._run(fn)
        self._publish(path, d, pub["v"])
        return desc


class SchemeShardTablet(TabletActor):
    """Actor wrapper: DDL over tablet pipes; replies ("ok", result_json)
    or ("error", text)."""

    def __init__(self, tablet_id: str, executor: TabletExecutor):
        super().__init__(tablet_id, executor)
        self.core = SchemeShardCore(executor)
        self.core.listeners.append(self._on_publish)
        self.board: "ActorId | None" = None  # set post-register

    def _on_publish(self, path, desc, version):
        if self.board is not None:
            from ydb_tpu_torch.scheme.board import BoardPublish

            self.send(self.board, BoardPublish(path, desc, version))

    def handle(self, message, reply_to):
        op, args = message[0], message[1:]
        try:
            if op == "mkdir":
                self.core.mkdir(args[0])
                result = None
            elif op == "create_table":
                self.core.create_table(TableDescription.from_json(args[0]))
                result = None
            elif op == "drop_table":
                self.core.drop_table(args[0])
                result = None
            elif op == "alter_table":
                desc = self.core.alter_table(
                    args[0],
                    add_columns=[dtypes.Field(n, _type(ts), True)
                                 for n, ts in args[1]],
                    drop_columns=list(args[2]),
                )
                result = desc.to_json()
            elif op == "describe":
                desc = self.core.describe(args[0])
                result = desc.to_json() if desc else None
            elif op == "children":
                result = self.core.children(args[0])
            else:
                raise SchemeError(f"unknown op {op}")
            self.send(reply_to, ("ok", result))
        except SchemeError as e:
            self.send(reply_to, ("error", str(e)))
