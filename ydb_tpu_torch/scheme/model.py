"""Schema object model + JSON serialization.

The reference describes every scheme entity with protobuf path
descriptions flowing from SchemeShard through the scheme board to
per-node caches (TPathDescription; SURVEY.md §2.5). This is the
equivalent wire model: table descriptions as JSON-able dicts, so they
can live in tablet-executor state and cross the scheme board.

The port's own copy of ``ydb_tpu/scheme/model.py`` (the same JSON).
"""

from __future__ import annotations

import dataclasses

from ydb_tpu_torch import dtypes


def type_to_str(t: dtypes.LogicalType) -> str:
    if t.is_decimal:
        return f"decimal({t.scale})"
    return t.kind.value


def type_from_str(s: str) -> dtypes.LogicalType:
    if s.startswith("decimal("):
        return dtypes.decimal(int(s[8:-1]))
    return dtypes.LogicalType(dtypes.Kind(s))


def schema_to_json(schema: dtypes.Schema) -> list:
    return [[f.name, type_to_str(f.type), f.nullable]
            for f in schema.fields]


def schema_from_json(data: list) -> dtypes.Schema:
    return dtypes.Schema(tuple(
        dtypes.Field(name, type_from_str(ts), nullable)
        for name, ts, nullable in data
    ))


@dataclasses.dataclass
class TableDescription:
    path: str
    schema: dtypes.Schema
    primary_key: tuple[str, ...]
    n_shards: int = 4
    store: str = "column"          # "column" (OLAP) | "row" (OLTP)
    ttl_column: str | None = None
    schema_version: int = 1
    # column name -> schema version that (re)introduced it; absent means
    # the column existed from version 1 (guards DROP+ADD resurrection)
    column_added: dict = dataclasses.field(default_factory=dict)
    # row tables: emit a CDC changefeed topic "<name>_changefeed"
    changefeed: bool = False
    # column tables: PK upsert semantics (a re-written key shadows the
    # old row; scans merge by PK newest-wins) — the reference's OLAP
    # REPLACE/BulkUpsert write model
    upsert: bool = False
    # shard generation: bumped by RESHARD (split/merge); generation g>0
    # stores shard state under <name>/g<g>/<i> so the cutover is an
    # atomic descriptor update (datashard split/merge analog)
    shard_gen: int = 0

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "schema": schema_to_json(self.schema),
            "primary_key": list(self.primary_key),
            "n_shards": self.n_shards,
            "store": self.store,
            "ttl_column": self.ttl_column,
            "schema_version": self.schema_version,
            "column_added": dict(self.column_added),
            "changefeed": self.changefeed,
            "upsert": self.upsert,
            "shard_gen": self.shard_gen,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TableDescription":
        return cls(
            path=d["path"],
            schema=schema_from_json(d["schema"]),
            primary_key=tuple(d["primary_key"]),
            n_shards=d["n_shards"],
            store=d.get("store", "column"),
            ttl_column=d.get("ttl_column"),
            schema_version=d.get("schema_version", 1),
            column_added=dict(d.get("column_added", {})),
            changefeed=d.get("changefeed", False),
            upsert=d.get("upsert", False),
            shard_gen=d.get("shard_gen", 0),
        )
