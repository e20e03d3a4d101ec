"""Sharded tables: partition parallelism over ColumnShards with
coordinated commits and consistent cross-shard snapshots.

Reference shape (SURVEY.md §2.11 row 1): a table splits into tablets by PK
range (row) or hash sharding function (OLAP, tx/sharding/); writes route
by the sharding function, distributed commits ride coordinator plan steps,
and scans fan out per shard and merge. Here:

  * ``insert`` routes rows by hash(pk) % n_shards, writes each shard's
    slice, and commits everything at ONE coordinator plan step — readers
    at any step see all-or-nothing across shards
  * ``scan`` runs the partial program per shard (one compiled executable
    shared across shards — same schema, same block capacity) and merges
    partials with the final program, exactly the MeshScan dataflow with
    host-side shards standing in for mesh devices
  * dictionaries are table-level, shared by all shards, so ids agree in
    cross-shard merges

The port's own copy of ``ydb_tpu/tx/sharded.py``, over the port's
``ColumnShard`` (``device=`` for every shard) with the same routing
bits and blob layout.
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.block import concat_blocks
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.scan import ColumnSource, ScanExecutor
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.ssa.program import Program
from ydb_tpu_torch.tx.coordinator import Coordinator, TxResult


def _fnv_route(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Deterministic row -> shard routing (tx/sharding hash analog)."""
    h = keys.astype(np.uint64)
    h ^= h >> 33
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> 33
    return (h % np.uint64(n_shards)).astype(np.int64)


class ShardedTable:
    def __init__(
        self,
        name: str,
        schema: dtypes.Schema,
        store: BlobStore,
        coordinator: Coordinator,
        n_shards: int = 4,
        pk_column: str | None = None,
        ttl_column: str | None = None,
        config: ShardConfig | None = None,
        dicts: DictionarySet | None = None,
        boot: bool = False,
        upsert: bool = False,
        gen: int = 0,
        device=None,
    ):
        self.name = name
        #: where every shard's scans run (``ColumnShard(device=)``)
        self.device = device
        self.schema = schema
        self.store = store
        self.coordinator = coordinator
        self.pk_column = pk_column or schema.names[0]
        self.ttl_column = ttl_column
        self.config = config
        # upsert: PK rewrite shadows the old row. Rows route by PK hash,
        # so one key always lands on one shard and per-shard newest-wins
        # dedup (engine.reader) is globally correct.
        self.upsert = upsert
        # shard generation: RESHARD builds generation g+1 under
        # <name>/g<g+1>/<i> and cuts over atomically (scheme descriptor)
        self.gen = gen
        self.dicts = dicts if dicts is not None else DictionarySet()
        ids = [self._shard_id(gen, i) for i in range(n_shards)]
        if boot:
            # reboot from the blob store (snapshot + WAL per shard); the
            # shared dict set must already be recovered by the caller
            self.shards = [
                ColumnShard.boot(
                    sid, schema, store,
                    pk_column=self.pk_column, ttl_column=ttl_column,
                    config=config, dicts=self.dicts, device=device,
                )
                for sid in ids
            ]
            for s in self.shards:
                s.upsert = upsert
        else:
            self.shards = [
                ColumnShard(
                    sid, schema, store,
                    pk_column=self.pk_column, ttl_column=ttl_column,
                    config=config, dicts=self.dicts, upsert=upsert,
                    device=device,
                )
                for sid in ids
            ]
        for s in self.shards:
            s.snap_source = coordinator.background_plan
        # called after string encode but before any shard write: the
        # cluster journals dictionary growth here so no durable shard
        # state ever references a dict id that is not itself durable
        self.pre_commit = None

    def _shard_id(self, gen: int, i: int) -> str:
        return (f"{self.name}/g{gen}/{i}" if gen else f"{self.name}/{i}")

    def storage_prefixes(self) -> list[str]:
        """Blob-store prefixes owning this table's durable state (DROP
        TABLE deletes them so a same-name CREATE starts empty)."""
        return [f"{s.shard_id}/" for s in self.shards]

    # ---------------- split / merge (resharding) ----------------

    def reshard(self, n_new: int, batch_rows: int = 1 << 18) -> int:
        """SPLIT/MERGE: rebuild the table as generation gen+1 with
        ``n_new`` shards — stream every row (at one snapshot, deduped)
        out of the old shards and hash-route it into the new ones, then
        swap. Returns the new generation; the CALLER must durably record
        (n_new, gen) in the scheme (Cluster.reshard_table does) — until
        then a reboot sees the old generation, and the new one's blobs
        are swept as orphans. The datashard split/merge analog
        (schemeshard__operation_split_merge.cpp) collapsed to an offline
        copy: hash sharding moves most keys on a count change, so a
        range-style incremental split does not apply."""
        from ydb_tpu_torch.engine.reader import PortionStreamSource

        if n_new < 1:
            raise ValueError("reshard needs n_new >= 1")
        new_gen = self.gen + 1
        old_shards = self.shards
        snap = self.coordinator.read_snapshot()
        new_shards = [
            ColumnShard(
                self._shard_id(new_gen, i), self.schema, self.store,
                pk_column=self.pk_column, ttl_column=self.ttl_column,
                config=self.config, dicts=self.dicts, upsert=self.upsert,
                device=self.device,
            )
            for i in range(n_new)
        ]
        for s in new_shards:
            s.schema_version = old_shards[0].schema_version
            s.column_added = dict(old_shards[0].column_added)
        names = self.schema.names
        for old in old_shards:
            src = PortionStreamSource(old, old.visible_portions(snap))
            from ydb_tpu_torch.engine.reader import plan_clusters, rechunk

            payloads = src.payload_stream(
                plan_clusters(src.metas, src.dedup), names)
            for cols, valid in rechunk(payloads, names, batch_rows):
                route = _fnv_route(
                    np.asarray(cols[self.pk_column], dtype=np.int64),
                    n_new)
                for i in range(n_new):
                    mask = route == i
                    if not mask.any():
                        continue
                    wid = new_shards[i].write(
                        {k: v[mask] for k, v in cols.items()},
                        {k: v[mask] for k, v in valid.items()},
                    )
                    # commit at a coordinator background step: local
                    # snaps could run AHEAD of the plan clock, making
                    # copied rows invisible at the read barrier
                    new_shards[i].commit_at(
                        [wid], self.coordinator.background_plan())
        # cutover: swap in-memory; scheme records the new generation
        self.shards = new_shards
        self.gen = new_gen
        for s in new_shards:
            s.snap_source = self.coordinator.background_plan
        return new_gen

    def drop_generation_storage(self, gen: int, n_shards: int) -> None:
        """Delete a superseded generation's blobs (post-cutover GC)."""
        for i in range(n_shards):
            prefix = f"{self._shard_id(gen, i)}/"
            for bid in self.store.list(prefix):
                self.store.delete(bid)

    def sweep_stale_generations(self) -> int:
        """Boot-time sweep: delete blobs of any generation other than
        the current one (a crash mid-reshard leaves either the unborn
        new generation or the superseded old one as orphans)."""
        keep = tuple(f"{s.shard_id}/" for s in self.shards)
        swept = 0
        for bid in self.store.list(f"{self.name}/"):
            if not bid.startswith(keep):
                self.store.delete(bid)
                swept += 1
        return swept

    def alter_schema(
        self,
        schema: dtypes.Schema,
        schema_version: int = 1,
        column_added: dict[str, int] | None = None,
    ) -> None:
        """Apply an ALTER'd schema. ``column_added`` maps column name ->
        schema version that (re)introduced it; portions older than that
        version read the column as NULL, so DROP+ADD of one name cannot
        resurrect dropped bytes."""
        self.schema = schema
        for s in self.shards:
            s.schema = schema
            s.schema_version = schema_version
            s.column_added = dict(column_added or {})

    # ---------------- writes ----------------

    def insert(
        self,
        columns: dict[str, np.ndarray | list],
        validity: dict[str, np.ndarray] | None = None,
    ) -> TxResult:
        """Route rows by PK hash, write every shard, commit at one step."""
        enc = self.shards[0].encode_strings(columns)
        if self.pre_commit is not None:
            self.pre_commit()
        n = len(next(iter(enc.values())))
        route = _fnv_route(
            np.asarray(enc[self.pk_column], dtype=np.int64),
            len(self.shards),
        )
        participants, prepare_args = [], []
        for i, shard in enumerate(self.shards):
            mask = route == i
            if not mask.any():
                continue
            cols_i = {k: np.asarray(v)[mask] for k, v in enc.items()}
            val_i = (
                {k: np.asarray(v)[mask] for k, v in validity.items()}
                if validity else None
            )
            wid = shard.write(cols_i, val_i)
            participants.append(shard)
            prepare_args.append([wid])
        return self.coordinator.commit(participants, prepare_args)

    # ---------------- reads ----------------

    def scan(
        self,
        program: Program,
        snap: int | None = None,
        key_spaces: dict[str, int] | None = None,
        block_rows: int = 1 << 20,
    ) -> OracleTable:
        """Fan out per shard, merge partials (the DQ scan fan-out shape)."""
        snap = self.coordinator.read_snapshot() if snap is None else snap
        from ydb_tpu_torch.engine.reader import PortionStreamSource
        from ydb_tpu_torch.engine.scan import required_columns

        cols = required_columns(program, self.schema)
        sources = [
            PortionStreamSource(s, s.visible_portions(snap), columns=cols)
            for s in self.shards
        ]
        ex = ScanExecutor(program, sources[0], block_rows=block_rows,
                          device=self.device, key_spaces=key_spaces)
        partials = []
        for src in sources:
            if src.num_rows == 0:
                continue
            for b in src.blocks(block_rows, ex.read_cols,
                                device=ex.device):
                partials.append(ex.run_block(b))
        if not partials:
            # all shards empty at this snapshot: one empty padded block
            # through the already-compiled executor
            return ex.execute()
        if ex.final is None:
            return OracleTable.from_block(concat_blocks(partials))
        return OracleTable.from_block(ex.finalize(partials))

    # ---------------- background ----------------

    def run_background(self, ttl_cutoff: int | None = None,
                       conveyor=None) -> dict | list:
        """One background maintenance pass over all shards.

        Without a conveyor the pass runs inline (tests, small tables).
        With one, per-shard compaction/TTL jobs submit to the worker pool
        under broker quotas and run OFF the commit path — foreground
        scans/commits proceed concurrently (the conveyor/resource-broker
        plane, tx/conveyor/service/service.h:73); returns the task
        handles."""
        if conveyor is not None:
            handles = [
                conveyor.submit("compaction", s.maybe_compact)
                for s in self.shards
            ]
            if ttl_cutoff is not None:
                handles += [
                    conveyor.submit("ttl", s.evict_ttl, ttl_cutoff)
                    for s in self.shards
                ]
            return handles
        stats = {"compacted": 0, "evicted": 0}
        for s in self.shards:
            if s.maybe_compact():
                stats["compacted"] += 1
            if ttl_cutoff is not None:
                stats["evicted"] += s.evict_ttl(ttl_cutoff)
        return stats
