"""Table backup / export-import against any blob store.

The reference exports tables to external storage as data files plus a
scheme manifest and imports them back
(ydb/core/tx/datashard/export_s3.cpp, schemeshard import/export ops;
SURVEY §2.14 backup row). TPU-era equivalent, against the BlobStore
abstraction (point it at a DirBlobStore for local files or an object
store adapter for S3/GCS):

  * ``export_table``  — at ONE consistent snapshot, stream every shard
    through the PK-merge/dedup reader (logical rows: shadowed versions
    drop, so a backup doubles as a full compaction) into chunked part
    blobs + a JSON manifest (schema, pk, sharding, dictionaries).
  * ``import_table``  — recreate a ShardedTable from the manifest and
    bulk-load the parts through the normal routed insert path, so the
    target may use a different shard count.

Every part blob carries row data with the SAME chunked container format
as portions (engine/portion.py), not a private encoding.

The port's own copy of ``ydb_tpu/engine/backup.py``: the same part
blobs and manifest, so a backup either package exported imports in
the other. ``import_table(device=)`` places the new table's shards
(CUDA unless the caller names another device).
"""

from __future__ import annotations

import json

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.engine.portion import read_portion_blob, write_portion_blob


def schema_to_json(schema: dtypes.Schema) -> list:
    return [
        {"name": f.name, "kind": f.type.kind.value,
         "scale": f.type.scale, "nullable": f.nullable}
        for f in schema.fields
    ]


def schema_from_json(spec: list) -> dtypes.Schema:
    return dtypes.Schema(tuple(
        dtypes.Field(
            s["name"],
            dtypes.LogicalType(dtypes.Kind(s["kind"]), s["scale"]),
            s["nullable"],
        )
        for s in spec
    ))


def export_table(table, dest: BlobStore, name: str,
                 snap: int | None = None,
                 part_rows: int = 1 << 20) -> dict:
    """Export a ShardedTable at one snapshot. Returns the manifest."""
    from ydb_tpu_torch.engine.reader import (
        PortionStreamSource,
        plan_clusters,
        rechunk,
    )

    snap = table.coordinator.read_snapshot() if snap is None else snap
    parts: list[dict] = []
    total_rows = 0
    for si, shard in enumerate(table.shards):
        src = PortionStreamSource(shard, shard.visible_portions(snap))
        names = shard.schema.names
        clusters_payloads = src.payload_stream(
            plan_clusters(src.metas, src.dedup), names)
        for pi, (cols, valid) in enumerate(
                rechunk(clusters_payloads, names, part_rows)):
            blob_id = f"backup/{name}/part/{si:04d}/{pi:06d}"
            write_portion_blob(dest, blob_id, cols, valid,
                               chunk_rows=part_rows)
            n = len(next(iter(cols.values())))
            parts.append({"blob_id": blob_id, "rows": n, "shard": si})
            total_rows += n
    manifest = {
        "name": name,
        "snapshot": snap,
        "schema": schema_to_json(table.schema),
        "pk_column": table.pk_column,
        "ttl_column": table.shards[0].ttl_column,
        "upsert": table.upsert,
        "n_shards": len(table.shards),
        "rows": total_rows,
        "parts": parts,
        "dicts": {
            col: [v.decode("latin1") for v in table.dicts[col].values]
            for col in table.dicts.columns()
        },
    }
    dest.put(f"backup/{name}/manifest",
             json.dumps(manifest).encode())
    return manifest


def read_manifest(src: BlobStore, name: str) -> dict:
    return json.loads(src.get(f"backup/{name}/manifest").decode())


def import_table(src: BlobStore, name: str, store: BlobStore,
                 coordinator, table_name: str | None = None,
                 n_shards: int | None = None, config=None,
                 device=None):
    """Recreate a ShardedTable from a backup (possibly resharded) on
    ``device``."""
    from ydb_tpu_torch.blocks.dictionary import DictionarySet
    from ydb_tpu_torch.tx.sharded import ShardedTable

    man = read_manifest(src, name)
    schema = schema_from_json(man["schema"])
    dicts = DictionarySet()
    for col, values in man["dicts"].items():
        d = dicts.for_column(col)
        for v in values:
            d.add(v.encode("latin1"))
    table = ShardedTable(
        table_name or man["name"], schema, store, coordinator,
        n_shards=n_shards or man["n_shards"],
        pk_column=man["pk_column"], upsert=man["upsert"],
        ttl_column=man.get("ttl_column"),
        dicts=dicts, config=config, device=device,
    )
    for part in man["parts"]:
        cols, valid = read_portion_blob(src, part["blob_id"])
        validity = valid if valid else None
        table.insert(cols, validity)
    return table
