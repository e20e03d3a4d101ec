"""RowTable: a sharded row-store table (OLTP) behind the same surface as
the columnar ShardedTable, so SQL and the coordinator treat both alike.

Reference shape: DataShard tablets partitioned by PK with distributed
commits through the coordinator (SURVEY.md §2.6, §3.2 COMMIT); the
KQP-facing difference from the OLAP path is point/range row access and
in-place UPDATE/DELETE, which columnar portions don't do.

Strings are encoded through the cluster-shared DictionarySet before any
durable write (same id-agreement rule as ShardedTable), with the same
pre_commit journaling hook.

The port's own copy of ``ydb_tpu/datashard/table.py``: the same routing
bits (``tx.sharded._fnv_route``), shard and index tablet ids, row
encoding and dictionary ids, so a table written by either package boots
in the other. ``source_at`` builds the same columns as the reference's
walk, a column at a time, keeps the last one it built and hands it out
again while its snapshot, the shards' commits and the schema are the
same (the reference walks every time), and counts its walks, seconds
and reuses (``source_builds``, ``source_seconds``, ``source_hits``) so
a statement can tell what its row tables cost it; ``source_of_keys``
builds the same columns from point reads for row DML whose WHERE pins
the key. The change sender ``drain_changes_to`` ships the same messages
to the same partitions at the same offsets as the reference's, with the
same producer seqnos, in one write per shard and partition where the
reference makes one per change.
"""

from __future__ import annotations

import json
import time

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import host_ok
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.datashard.shard import DataShard, RowOp
from ydb_tpu_torch.tx.coordinator import Coordinator, TxResult
from ydb_tpu_torch.tx.sharded import _fnv_route


class RowTable:
    store_kind = "row"

    def __init__(
        self,
        name: str,
        schema: dtypes.Schema,
        store: BlobStore,
        coordinator: Coordinator,
        n_shards: int = 4,
        pk_column: str | None = None,
        pk_columns: tuple[str, ...] | None = None,
        dicts: DictionarySet | None = None,
        boot: bool = False,  # DataShard.boot is implicit (executor boot)
        ttl_column: str | None = None,
        gen: int = 0,
    ):
        self.name = name
        self.schema = schema
        self.coordinator = coordinator
        self.pk_columns = tuple(
            pk_columns if pk_columns else
            (pk_column or schema.names[0],))
        self.pk_column = self.pk_columns[0]
        self.ttl_column = ttl_column
        self.store = store
        self.gen = gen
        self.dicts = dicts if dicts is not None else DictionarySet()
        self.shards = [
            DataShard(self._shard_id(gen, i), schema, store,
                      self.pk_columns)
            for i in range(n_shards)
        ]
        self.schema_version = 1
        self.column_added: dict[str, int] = {}
        self.pre_commit = None
        # secondary indexes: name -> (column, [index DataShards keyed
        # (value, *pk)]); maintained ATOMICALLY with data writes — index
        # shards join the same 2PC (the reference maintains indeximpl
        # tables in the same distributed tx, datashard build_index /
        # change exchange for indexes)
        self.indexes: dict[str, tuple[str, list]] = {}
        #: ``source_at``'s walks and their seconds, summed (read by a
        #: statement's caller to split a statement's time), and the calls
        #: it answered with its last source (same snapshot, no commit and
        #: no schema change since)
        self.source_builds = 0
        self.source_seconds = 0.0
        self.source_hits = 0
        self._last_source = None
        #: ``source_of_keys`` calls (key-pinned row DML reads)
        self.pinned_reads = 0

    def post_boot_sweep(self) -> None:
        """Crash-safe DROP COLUMN: if a prior strip (alter_schema) died
        between the scheme commit and the rewrite, stale values would
        resurrect on a later re-ADD. The cluster calls this on boot only
        when the scheme tablet holds a pending-strip marker for this
        table (and once the real coordinator clock is installed)."""
        self._strip_columns(keep=set(self.schema.names))

    def _shard_id(self, gen: int, i: int) -> str:
        return (f"{self.name}/g{gen}/{i}" if gen else f"{self.name}/{i}")

    def storage_prefixes(self) -> list[str]:
        """Blob-store prefixes owning this table's durable state —
        INDEX shards included (DROP TABLE deletes them so a same-name
        CREATE + same-name index starts empty, no resurrection)."""
        out = [f"tablet/{s.executor.tablet_id}/" for s in self.shards]
        for _, idx_shards in self.indexes.values():
            out += [f"tablet/{s.executor.tablet_id}/"
                    for s in idx_shards]
        return out

    # ---- split / merge (resharding) ----

    def reshard(self, n_new: int) -> int:
        """SPLIT/MERGE for the row store: stream every row at one
        snapshot out of the old shards into ``n_new`` new DataShards
        (generation gen+1), then swap. The CALLER records (n_new, gen)
        durably in the scheme (Cluster.reshard_table); until then a
        reboot serves the old generation and sweeps the new one.
        Secondary indexes rebuild by re-registration after the swap
        (the backfill is index-build, already online)."""
        if n_new < 1:
            raise ValueError("reshard needs n_new >= 1")
        if self.indexes:
            raise ValueError(
                "drop secondary indexes before resharding (re-add to"
                " rebuild against the new shards)")
        new_gen = self.gen + 1
        snap = self.coordinator.read_snapshot()
        new_shards = [
            DataShard(self._shard_id(new_gen, i), self.schema,
                      self.store, self.pk_columns)
            for i in range(n_new)
        ]
        ops: list[RowOp] = []

        def flush():
            proposed = _route_propose(new_shards, ops)
            if proposed:
                self.coordinator.commit(
                    [s for s, _ in proposed], [[w] for _, w in proposed])
            ops.clear()

        for shard in self.shards:
            for page in shard.read(snap):
                for key, row in page:
                    ops.append(RowOp(tuple(key), dict(row)))
                if len(ops) >= 4096:
                    flush()
        flush()
        self.shards = new_shards
        self.gen = new_gen
        return new_gen

    def drop_generation_storage(self, gen: int, n_shards: int) -> None:
        """Delete a superseded generation's tablet state."""
        for i in range(n_shards):
            prefix = f"tablet/ds/{self._shard_id(gen, i)}/"
            for bid in self.store.list(prefix):
                self.store.delete(bid)

    def sweep_stale_generations(self) -> int:
        """Boot-time sweep of shard generations other than the current
        one (crash mid-reshard orphans)."""
        keep = tuple(f"tablet/{s.executor.tablet_id}/"
                     for s in self.shards)
        for _, idx_shards in self.indexes.values():
            keep += tuple(f"tablet/{s.executor.tablet_id}/"
                          for s in idx_shards)
        swept = 0
        for bid in self.store.list(f"tablet/ds/{self.name}/"):
            if "/idx_" in bid:
                # index storage is managed by add_index/DROP TABLE, and
                # index registrations are not (yet) scheme-durable — a
                # reboot must not garbage-collect them
                continue
            if not bid.startswith(keep):
                self.store.delete(bid)
                swept += 1
        return swept

    # ---- encode helpers (shared dict ids, scaled decimals) ----

    def _encode_columns(self, columns: dict, validity=None) -> list[dict]:
        """Columnar input -> list of physical row dicts (None = NULL)."""
        enc: dict[str, list] = {}
        for name in columns:
            f = self.schema.field(name)
            vals = columns[name]
            if f.type.is_string:
                d = self.dicts.for_column(name)
                enc[name] = [int(d.add(_as_bytes(v))) for v in vals]
            else:
                arr = np.asarray(vals)
                if arr.dtype == object:
                    enc[name] = [_py(v) for v in arr]
                else:
                    # ``tolist`` gives the plain python values ``_py``
                    # gives (bools as ints, as the WAL's JSON holds them)
                    enc[name] = (arr.astype(np.int64)
                                 if arr.dtype == np.bool_ else arr).tolist()
            if validity is not None and name in validity:
                enc[name] = [v if ok else None for v, ok in zip(
                    enc[name], np.asarray(validity[name]).tolist())]
        names = list(enc)
        return [dict(zip(names, vals)) for vals in zip(*enc.values())]

    def _key_of(self, row: dict) -> tuple:
        return tuple(row[c] for c in self.pk_columns)

    def _route(self, keys: list[tuple]) -> np.ndarray:
        first = np.asarray([k[0] for k in keys], dtype=np.int64)
        return _fnv_route(first, len(self.shards))

    # ---- writes (2PC across shards) ----

    @host_ok("row-store DML: routing, index maintenance and 2PC"
             " staging operate on host rows by design (the row table"
             " is the OLTP side; the analytic path never enters here)")
    def propose_ops(self, per_row_ops: list[RowOp],
                    lock_ids: dict[int, int] | None = None
                    ) -> tuple[list, list]:
        """Durably stage ops (and index maintenance) on their shards;
        returns (participants, prepare_args) for a coordinator commit.
        Interactive transactions combine several tables' proposals
        into ONE atomic commit this way."""
        if self.pre_commit is not None:
            self.pre_commit()
        route = self._route([op.key for op in per_row_ops])
        participants, prepare_args = [], []
        for i, shard in enumerate(self.shards):
            ops = [op for op, r in zip(per_row_ops, route) if r == i]
            if not ops and not (lock_ids and i in lock_ids):
                continue
            wid = shard.propose(
                ops, lock_id=lock_ids.get(i) if lock_ids else None)
            participants.append(shard)
            prepare_args.append([wid])
        if self.indexes and per_row_ops:
            # ONE old-row read serves every index
            old_rows = self.read_rows([op.key for op in per_row_ops])
            for col, idx_shards in self.indexes.values():
                idx_ops = self._index_ops(col, per_row_ops, old_rows)
                for shard, wid in _route_propose(idx_shards, idx_ops):
                    participants.append(shard)
                    prepare_args.append([wid])
        return participants, prepare_args

    def _commit_ops(self, per_row_ops: list[RowOp],
                    lock_ids: dict[int, int] | None = None) -> TxResult:
        """lock_ids: shard index -> optimistic lock the tx validated
        under; prepare fails (aborting the 2PC) if it broke."""
        participants, prepare_args = self.propose_ops(per_row_ops,
                                                      lock_ids)
        # multi-shard row commits take the volatile path: no prepare
        # round-trip under the coordinator's commit lock, outcomes
        # exchanged as readsets (volatile_tx.h; VERDICT missing #9)
        return self.coordinator.commit_volatile(participants,
                                                prepare_args)

    # ---- secondary indexes ----

    def _index_ops(self, col: str, per_row_ops, old_rows) -> list[RowOp]:
        """Index maintenance ops mirroring ``per_row_ops``: erase the
        old (value, pk) entry when the value changes or the row dies;
        put the new one. NULL values are not indexed. The same key
        appearing twice in one batch chains (last write wins, exactly
        like the data shard's apply order)."""
        idx_pk = (col,) + tuple(self.pk_columns)
        cur: dict[tuple, object] = {}  # key -> value as the batch runs
        idx_ops: list[RowOp] = []
        for op in per_row_ops:
            if op.key in cur:
                old_v = cur[op.key]
            else:
                old = old_rows.get(op.key)
                old_v = old.get(col) if old else None
            new_v = op.row.get(col) if op.row is not None else None
            cur[op.key] = new_v
            if old_v is not None and old_v != new_v:
                idx_ops.append(RowOp((old_v,) + op.key, None))
            if new_v is not None and new_v != old_v:
                idx_ops.append(
                    RowOp((new_v,) + op.key,
                          dict(zip(idx_pk, (new_v,) + op.key))))
        return idx_ops

    def add_index(self, name: str, column: str) -> None:
        """Create a global secondary index on ``column`` and backfill it
        online: the index registers FIRST (new writes maintain it), then
        existing rows backfill at a snapshot — the online index-build
        shape (datashard build_index.cpp)."""
        if column in self.pk_columns:
            raise ValueError("column is already the primary key")
        if name in self.indexes:
            raise ValueError(f"index {name} already exists")
        fields = [self.schema.field(column)] + [
            self.schema.field(c) for c in self.pk_columns
        ]
        idx_schema = dtypes.Schema(tuple(fields))
        idx_pk = (column,) + tuple(self.pk_columns)
        idx_shards = [
            DataShard(f"{self.name}/idx_{name}/{i}", idx_schema,
                      self.shards[0].executor.store, idx_pk)
            for i in range(len(self.shards))
        ]
        self.indexes[name] = (column, idx_shards)
        # online backfill at a snapshot; rows written after registration
        # are maintained by the normal write path (idempotent upserts)
        snap = self.coordinator.read_snapshot()
        backfill: list[RowOp] = []
        for shard in self.shards:
            for page in shard.read(snap):
                for key, row in page:
                    v = row.get(column)
                    if v is None:
                        continue
                    backfill.append(RowOp(
                        (v,) + key, dict(zip(idx_pk, (v,) + key))))
        proposed = _route_propose(idx_shards, backfill)
        if proposed:
            self.coordinator.commit(
                [s for s, _ in proposed], [[w] for _, w in proposed])

    def lookup_index(self, name: str, value) -> list[tuple]:
        """Primary keys of rows where the indexed column == value."""
        col, idx_shards = self.indexes[name]
        f = self.schema.field(col)
        if f.type.is_string and not isinstance(value, int):
            v = self.dicts.for_column(col).get(_as_bytes(value))
            if v is None:
                return []
        else:
            v = _py(np.asarray(value)) if not isinstance(value, int) \
                else value
        snap = self.coordinator.read_snapshot()
        shard = idx_shards[int(_fnv_route(
            np.asarray([v], dtype=np.int64), len(idx_shards))[0])]
        out = []
        for page in shard.read(snap, lo=(v,)):
            for key, _row in page:
                if key[0] != v:
                    return out
                out.append(tuple(key[1:]))
        return out

    def insert(self, columns: dict, validity=None) -> TxResult:
        """Upsert semantics (same surface as ShardedTable.insert)."""
        return self._commit_ops(self.insert_ops(columns, validity))

    def insert_ops(self, columns: dict, validity=None) -> list[RowOp]:
        """The insert's effects as RowOps, uncommitted (interactive-
        transaction buffering seam)."""
        rows = self._encode_columns(columns, validity)
        return [RowOp(self._key_of(r), r) for r in rows]

    def upsert_rows(self, rows: list[dict]) -> TxResult:
        return self._commit_ops(
            [RowOp(self._key_of(r), r) for r in rows])

    def delete_keys(self, keys: list[tuple]) -> TxResult:
        return self._commit_ops([RowOp(tuple(k), None) for k in keys])

    # ---- reads ----

    def read_row(self, key: tuple, snap: int | None = None) -> dict | None:
        rows = self.read_rows([tuple(key)], snap)
        return rows.get(tuple(key))

    def read_rows(self, keys: list[tuple],
                  snap: int | None = None) -> dict[tuple, dict]:
        """Batched point reads: one shard.read per shard, not per key."""
        snap = (self.coordinator.read_snapshot()
                if snap is None else snap)
        keys = [tuple(k) for k in keys]
        out: dict[tuple, dict] = {}
        if not keys:
            return out
        route = self._route(keys)
        for i, shard in enumerate(self.shards):
            mine = [k for k, r in zip(keys, route) if r == i]
            if not mine:
                continue
            for page in shard.read(snap, keys=mine):
                out.update(page)
        return out

    def lock_all_shards(self) -> dict[int, int]:
        """Full-range optimistic lock on every shard (the coarse
        serialization UPDATE/DELETE read-modify-write uses); returns
        shard index -> lock id."""
        locks = {}
        for i, shard in enumerate(self.shards):
            lk = shard.acquire_lock()
            shard.read(0, lock_id=lk)  # registers the (None, None) range
            locks[i] = lk
        return locks

    def release_locks(self, locks: dict[int, int]) -> None:
        for i, lk in locks.items():
            self.shards[i].release_lock(lk)

    def source_at(self, snap: int | None = None,
                  columns: tuple[str, ...] | None = None) -> ColumnSource:
        """Materialize visible rows as a ColumnSource: the seam that lets
        the OLAP scan/SSA path run over a row table."""
        t0 = time.perf_counter()
        snap = (self.coordinator.read_snapshot()
                if snap is None else snap)
        # the rows visible at ``snap`` change only through a commit of a
        # shard's executor (its version) or a new schema; a volatile
        # write that could fence this snapshot commits through it too
        key = (snap, columns, self.schema,
               tuple((s.executor.tablet_id, s.executor.version)
                     for s in self.shards))
        last = self._last_source
        if last is not None and last[0] == key:
            self.source_hits += 1
            return last[1]
        rows = [row for shard in self.shards
                for page in shard.read(snap) for _key, row in page]
        src = self._columns_of(rows, columns)
        self._last_source = (key, src)
        self.source_builds += 1
        self.source_seconds += time.perf_counter() - t0
        return src

    def source_of_keys(self, keys: list[tuple],
                       snap: int | None = None) -> ColumnSource:
        """The rows of ``keys`` visible at ``snap`` as a ColumnSource, in
        the order ``source_at`` would give them (shard, then key): what
        ``source_at`` holds for a statement whose WHERE pins the primary
        key (a port addition; the reference walks the whole table)."""
        snap = (self.coordinator.read_snapshot()
                if snap is None else snap)
        found = self.read_rows(sorted(set(tuple(k) for k in keys)), snap)
        route = self._route(list(found)) if found else []
        order = sorted(zip(route, found))
        self.pinned_reads += 1
        return self._columns_of([found[k] for _r, k in order], None)

    def _columns_of(self, rows: list[dict],
                    columns: tuple[str, ...] | None) -> ColumnSource:
        names = columns if columns is not None else self.schema.names
        names = tuple(n for n in names if n in self.schema)
        out_c = {}
        out_v = {}
        for n in names:
            f = self.schema.field(n)
            vals = [row.get(n) for row in rows]  # absent (pre-ALTER) = NULL
            out_v[n] = np.fromiter((v is not None for v in vals),
                                   dtype=bool, count=len(vals))
            out_c[n] = np.asarray([0 if v is None else v for v in vals],
                                  dtype=f.type.physical)
        return ColumnSource(out_c, self.schema.select(names), self.dicts,
                            out_v)

    # ---- schema evolution ----

    def alter_schema(self, schema, schema_version=1, column_added=None):
        had_drops = any(n not in schema for n in self.schema.names)
        self.schema = schema
        self.schema_version = schema_version
        self.column_added = dict(column_added or {})
        for s in self.shards:
            s.schema = schema
        # physically strip dropped columns so a later re-ADD of the name
        # cannot resurrect old values (row dicts would otherwise keep
        # them forever); the boot-time sweep repeats this if a crash
        # interrupts it here
        if had_drops:
            self._strip_columns(keep=set(schema.names))

    def _strip_columns(self, keep: set[str]) -> None:
        snap = self.coordinator.read_snapshot()
        for shard in self.shards:
            ops = []
            for page in shard.read(snap):
                for key, row in page:
                    if any(n not in keep for n in row):
                        ops.append(RowOp(
                            key,
                            {k: v for k, v in row.items() if k in keep}))
            if ops:
                # internal rewrite: must not emit changefeed events (a
                # consumer would see phantom updates that also leak the
                # dropped column's values)
                was_cdc = shard.cdc_enabled
                shard.cdc_enabled = False
                try:
                    wid = shard.propose(ops)
                    self.coordinator.commit([shard], [[wid]])
                finally:
                    shard.cdc_enabled = was_cdc

    # ---- CDC (change exchange; SURVEY.md §2.6) ----

    def enable_cdc(self) -> None:
        for s in self.shards:
            s.cdc_enabled = True

    def drain_changes_to(self, topic) -> int:
        """Change sender (change_sender*.cpp analog): ship each shard's
        durable change queue to the changefeed topic, then ack. The
        topic's producer-seqno dedup makes redelivery after a crash
        between write and ack exactly-once."""
        shipped = 0
        for shard in self.shards:
            changes = shard.pending_changes()
            if not changes:
                continue
            # a shard's seqs are monotonic but not contiguous per
            # partition: each message carries its own seqno
            by_part: dict[int, list[dict]] = {}
            for ch in changes:
                p = topic.partition_for(json.dumps(ch["key"]))
                by_part.setdefault(p, []).append(ch)
            for p, chs in sorted(by_part.items()):
                topic.partitions[p].write(
                    [{"data": json.dumps({
                        "key": ch["key"], "old": ch["old"],
                        "new": ch["new"], "step": ch["step"],
                    })} for ch in chs],
                    producer=f"cdc/{shard.shard_id}",
                    seqnos=[ch["seq"] for ch in chs],
                )
            shard.ack_changes(changes[-1]["seq"])
            shipped += len(changes)
        return shipped

    # ---- background ----

    def run_background(self, ttl_cutoff: int | None = None) -> dict:
        evicted = 0
        if ttl_cutoff is not None and self.ttl_column is not None:
            snap = self.coordinator.read_snapshot()
            for shard in self.shards:
                doomed = []
                for page in shard.read(snap):
                    for key, row in page:
                        v = row.get(self.ttl_column)
                        if v is not None and v < ttl_cutoff:
                            doomed.append(key)
                if doomed:
                    self.delete_keys(doomed)
                    evicted += len(doomed)
        horizon = self.coordinator.read_snapshot()
        for shard in self.shards:
            shard.compact(keep_after=horizon)
        return {"compacted": len(self.shards), "evicted": evicted}


def _route_propose(shards: list, ops: list[RowOp]) -> list[tuple]:
    """fnv-route ops by first key component and propose per shard;
    returns [(shard, write_id)] (shared by the commit path, index
    maintenance and index backfill)."""
    if not ops:
        return []
    first = np.asarray([op.key[0] for op in ops], dtype=np.int64)
    route = _fnv_route(first, len(shards))
    out = []
    for i, shard in enumerate(shards):
        mine = [op for op, r in zip(ops, route) if r == i]
        if mine:
            out.append((shard, shard.propose(mine)))
    return out


def _as_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode()
    return bytes(v)


def _py(v):
    """numpy scalar -> plain python (rows are JSON in the WAL)."""
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer, np.bool_)):
        return int(v)
    return v
