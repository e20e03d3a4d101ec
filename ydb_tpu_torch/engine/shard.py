"""ColumnShard: the OLAP partition tablet (host state plane).

The port's own copy of ``ydb_tpu/engine/shard.py``. A shard's scans run
on its ``device`` (CUDA unless the caller passes another), where its
block cache and resident tier hold their tensors. The pruning, stage and
pipeline counters stay plain attributes (``last_scan_pruning``,
``last_scan_stages``, ``last_scan_pipeline``, ``pruning_totals``); the
scan cache, its lock, the stats lock and ``pruning_totals`` are
thread-sanitizer tracked. Commits, scans (with their stage and pruning
counters) and compactions fire the ``columnshard.*`` probes, and a scan
under an active trace rides a ``shard.scan`` span.

Mirror of the reference's ColumnShard + column engine
(tx/columnshard/columnshard_impl.h:134; TColumnEngineForLogs
engines/column_engine_logs.h:40; SURVEY.md §2.7), redesigned for the TPU
split: ALL durable state is host-side (TPUs never own durability —
SURVEY.md §7.0 plane 3); scans hand device-ready blocks to the kernel
plane.

State machine:
  * ``write(batch)``       — buffered rows under a write id (insert table,
                             columnshard__write.cpp shape)
  * ``commit(write_ids)``  — assigns the next snapshot, flushes buffered
                             rows into an immutable *portion* (blob +
                             meta) and logs the change
  * ``scan(program, snap)``— plans visible portions at the snapshot (MVCC
                             window + PK-range pruning), streams blocks
                             through the compiled program
                             (ydb_tpu_torch.engine.scan)
  * ``compact()``          — merges small portions into one, sorted by PK
                             (general_compaction.cpp analog); old portions
                             get removed_snap, readers at older snapshots
                             still see them
  * ``evict_ttl(cutoff)``  — drops rows older than the TTL cutoff by
                             rewriting affected portions (ttl.cpp analog)
  * durability             — every mutation appends a WAL record; periodic
                             ``checkpoint()`` writes a full-state snapshot;
                             ``ColumnShard.boot`` = snapshot + WAL replay
                             (tablet_flat boot logic, flat_boot_*.h analog)

Local write ids stand in for the reference's long-tx writes; the
distributed coordinator (ydb_tpu_torch.tx) supplies cross-shard snapshots.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import OrderedDict

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import sanitizer
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.engine.blockcache import DeviceBlockCache
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.portion import (
    PortionMeta,
    column_stats,
    read_portion_blob,
    write_portion_blob,
)
from ydb_tpu_torch.engine.scan import ColumnSource, ScanExecutor
from ydb_tpu_torch.obs.probes import probe
from ydb_tpu_torch.ssa.program import Program

# lwtrace-style probes (ydb_tpu_torch.obs.probes): near-free when no
# trace session is attached
_P_COMMIT = probe("columnshard.commit")
_P_SCAN = probe("columnshard.scan")
_P_SCAN_STAGES = probe("columnshard.scan.stages")
_P_SCAN_PRUNING = probe("columnshard.scan.pruning")
_P_COMPACT = probe("columnshard.compact")


@dataclasses.dataclass
class ShardConfig:
    # compaction triggers when this many live portions exist
    compact_portion_threshold: int = 8
    # checkpoint every N WAL records
    checkpoint_interval: int = 64
    scan_block_rows: int = 1 << 20
    # compaction output portions are capped at this many rows so the
    # streaming reader's working set stays bounded (out-of-core scans)
    max_portion_rows: int = 1 << 20
    # row-group chunk size inside portion blobs: the K-way merge buffers
    # O(overlapping_portions x chunk_rows) rows, so smaller chunks bound
    # memory tighter for heavily-overlapping (random-upsert) workloads
    portion_chunk_rows: int = 1 << 16
    # device-resident decoded-block cache for repeated scans: the shared
    # page cache analog (shared_sausagecache.cpp:194) lifted into
    # accelerator HBM — warm scans skip blob IO, decode, PK merge and
    # the host->device transfer entirely. Keyed by the visible portion
    # ids (immutable blobs), so every commit/compaction/TTL rewrite
    # changes the key and stale entries age out by LRU; dictionary codes
    # are append-only, so cached code arrays stay valid as dicts grow.
    # None = auto (on for tpu/gpu backends, off on CPU where "device"
    # memory is host RSS); 0 = off; >0 = byte budget.
    scan_cache_bytes: int | None = None
    # compiled-executor cache cap (LRU entries): each entry pins a
    # traced XLA executable per distinct (program, key_spaces); ad-hoc
    # query workloads would otherwise grow it without bound
    scan_cache_entries: int = 32
    # HBM-resident column tier budget (engine.resident): per-(portion,
    # column) decoded device arrays shared across every scan shape.
    # None = auto (YDB_TPU_TORCH_RESIDENT_BYTES env valve, else on for
    # accelerator backends); 0 = off; >0 = byte budget.
    resident_bytes: int | None = None


class ColumnShard:
    def __init__(
        self,
        shard_id: str,
        schema: dtypes.Schema,
        store: BlobStore,
        pk_column: str | None = None,
        ttl_column: str | None = None,
        config: ShardConfig | None = None,
        dicts: DictionarySet | None = None,
        upsert: bool = False,
        device=None,
    ):
        self.shard_id = shard_id
        #: where scans run and the device tiers hold their tensors
        self.device = device
        self.schema = schema
        self.store = store
        self.pk_column = pk_column
        self.ttl_column = ttl_column
        # upsert: PK semantics — a re-written key shadows the old row;
        # scans merge portions by PK with newest-wins dedup
        # (plain_reader/iterator/merge.cpp:10 NArrow::NMerger analog)
        if upsert and not pk_column:
            raise ValueError("upsert semantics require a pk_column")
        self.upsert = upsert
        self.config = config or ShardConfig()
        # dicts may be shared table-wide across shards (ids must agree for
        # cross-shard merges); sharing implies single-process ingest
        self.dicts = dicts if dicts is not None else DictionarySet()
        # when part of a coordinated shard group, background operations
        # take their snapshots from the global plan-step clock so local
        # bumps never collide with coordinator-assigned steps
        self.snap_source = None  # Optional[Callable[[], int]]

        # schema evolution state (set by the owning table on ALTER):
        # current version + the version at which each column was added
        # (absent = original column, version 1)
        self.schema_version: int = 1
        self.column_added: dict[str, int] = {}

        self.snap: int = 0           # last committed snapshot
        self.next_portion_id = 1
        self.portions: dict[int, PortionMeta] = {}
        # bumped whenever a portion id VANISHES from the map (gc): lets
        # cluster-level cache pruning skip work while the set is stable
        self.meta_gen = 0
        # WAL-replay holding pen for staged compaction outputs: they only
        # activate when the cluster's compact_commit record arrives, so a
        # crash mid-compaction loses nothing and duplicates nothing
        self._staged: dict[int, PortionMeta] = {}
        self._in_compaction = False
        self._insert_buffer: dict[int, dict] = {}  # write_id -> batch
        self._next_write_id = 1
        # compiled-scan cache: (program, key_spaces) -> (executor, sizes)
        # LRU-bounded at config.scan_cache_entries: compiled executors
        # pin staged aux tensors, and ad-hoc workloads mint a fresh key
        # per distinct program — unbounded, that's a leak. Under
        # YDB_TPU_TORCH_TSAN=1 the cache and its lock are tracked;
        # per-INSTANCE state names (shard_id alone would fuse lockset
        # state across a reboot or two clusters reusing shard ids)
        self._scan_cache = sanitizer.share(
            OrderedDict(),
            f"columnshard.{shard_id}.{id(self):x}._scan_cache")
        self._scan_cache_lock = sanitizer.make_lock(
            f"columnshard.{shard_id}.{id(self):x}._scan_cache_lock")
        # stage snapshot of the most recent scan (read/merge/stage/
        # compute seconds) — obs surface for bench + the viewer
        self.last_scan_stages: dict = {}
        # morsel-pipeline stat snapshot of the most recent scan
        # (engine.stream_sched); None when the serialized path ran
        self.last_scan_pipeline: "dict | None" = None
        # resident-tier share of the most recent scan (portions and rows
        # served from device-resident columns) and its compiled executor
        # (whose group-by layout names the tier the scan took)
        self.last_scan_resident: dict = {}
        self.last_scan_executor: "ScanExecutor | None" = None
        # pruning effectiveness of the most recent scan plus cumulative
        # totals. Guarded by _stats_lock: concurrent scans update both.
        self._stats_lock = sanitizer.make_lock(
            f"columnshard.{shard_id}.{id(self):x}._stats_lock")
        self.last_scan_pruning: dict = {}
        self.pruning_totals: dict = sanitizer.share(
            {"scans": 0, "portions_total": 0, "portions_skipped": 0,
             "chunks_read": 0, "chunks_skipped": 0,
             "chunks_fastpath": 0, "filters_dropped": 0},
            f"columnshard.{shard_id}.{id(self):x}.pruning_totals")
        # HBM-resident decoded-block cache for warm scans, keyed by the
        # immutable (portion ids, read cols, block rows)
        self.block_cache = DeviceBlockCache(
            budget=self.config.scan_cache_bytes, device=device)
        # HBM-resident column tier (engine.resident): per-(portion,
        # column) decoded device arrays serving every scan shape —
        # where the block cache above keys whole streams on (portion
        # set, read cols, geometry, predicates) and rebuilds from host
        # bytes for any new combination. Per-shard so ROADMAP item 3
        # can slice it per-device.
        from ydb_tpu_torch.engine.resident import ResidentStore

        self.resident = ResidentStore(
            f"{shard_id}.{id(self):x}",
            budget=self.config.resident_bytes, device=device)
        # meta_gen stamp of the last cache prune (the Cluster
        # snapshot_db pattern): entries only die when a portion id
        # vanishes from the map, so steady-state scans skip the
        # every-entry prune walk entirely. Guarded by _meta_lock.
        self._prune_gen: "int | None" = None
        # serializes metadata mutations (portion map, WAL seq, snapshot)
        # so conveyor-driven background work (compaction/TTL/GC) can run
        # concurrently with foreground scans: critical sections cover
        # metadata only, never blob IO or merging
        self._meta_lock = threading.RLock()
        # serializes whole background OPERATIONS against each other:
        # compaction and TTL both rewrite the same visible portions, and
        # overlapping them would merge rows the other just evicted
        self._bg_lock = threading.Lock()
        self._wal_seq = 0
        self._records_since_checkpoint = 0
        # per-column dictionary size already made durable; portions carry
        # dict ids, so dictionary growth must be WAL-logged with the
        # portion that introduced it
        self._dict_durable_sizes: dict[str, int] = {}

    # ---------------- write path ----------------

    def write(
        self,
        columns: dict[str, np.ndarray],
        validity: dict[str, np.ndarray] | None = None,
    ) -> int:
        """Buffer a batch; returns the write id (uncommitted, invisible)."""
        for f in self.schema.fields:
            if f.name not in columns:
                raise KeyError(f"missing column {f.name}")
        n = len(next(iter(columns.values())))
        for name, arr in columns.items():
            if len(arr) != n:
                raise ValueError("ragged batch")
        batch = {
            "columns": {
                k: np.asarray(v, dtype=self.schema.field(k).type.physical)
                for k, v in columns.items()
            },
            "validity": {k: np.asarray(v) for k, v in (validity or {}).items()},
        }
        # id allocation + buffer insert share the metadata lock:
        # concurrent API sessions writing one shard must never mint the
        # same write id or interleave with a commit's buffer drain
        with self._meta_lock:
            wid = self._next_write_id
            self._next_write_id += 1
            self._insert_buffer[wid] = batch
        return wid

    def encode_strings(
        self, columns: dict[str, np.ndarray | list]
    ) -> dict[str, np.ndarray]:
        """Dictionary-encode raw bytes/str values for string columns."""
        out = {}
        for name, vals in columns.items():
            f = self.schema.field(name)
            if f.type.is_string and not (
                isinstance(vals, np.ndarray) and vals.dtype.kind == "i"
            ):
                out[name] = self.dicts.for_column(name).encode(list(vals))
            else:
                out[name] = np.asarray(vals)
        return out

    # -- distributed-commit participant protocol (ydb_tpu_torch.tx.Coordinator) --

    def prepare(self, write_ids: list[int]) -> list[int]:
        """Validate and lock write ids for a coordinated commit."""
        missing = [w for w in write_ids if w not in self._insert_buffer]
        if missing:
            raise KeyError(f"unknown write ids {missing}")
        return list(write_ids)

    def commit_at(self, write_ids: list[int], step: int) -> int:
        """Commit prepared writes at a coordinator-assigned plan step."""
        return self._commit(write_ids, step)

    def abort(self, write_ids: list[int]) -> None:
        with self._meta_lock:
            for w in write_ids:
                self._insert_buffer.pop(w, None)

    def commit(self, write_ids: list[int]) -> int:
        """Single-shard commit at the next local snapshot. Do not mix with
        coordinated commit_at on the same shard group — the coordinator
        owns global time there."""
        return self._commit(write_ids, None)

    def _commit(self, write_ids: list[int], snap: "int | None") -> int:
        # snapshot allocation, validation and advance happen in ONE
        # critical section: two concurrent commits reading snap outside
        # the lock would mint the same snapshot id, and background
        # compaction/TTL bump the same counter under _meta_lock
        with self._meta_lock:
            if snap is None:
                snap = self.snap + 1
            elif snap <= self.snap:
                raise ValueError(
                    f"plan step {snap} not ahead of shard snapshot "
                    f"{self.snap}")
            batches = [self._insert_buffer.pop(w) for w in write_ids]
            self.snap = snap
        if _P_COMMIT:
            _P_COMMIT.fire(shard=self.shard_id, snap=snap,
                           writes=len(write_ids))
        if not batches:
            self._log({"op": "noop", "snap": snap})
            return snap
        cols = {
            f.name: np.concatenate([b["columns"][f.name] for b in batches])
            for f in self.schema.fields
        }
        validity = {}
        for f in self.schema.fields:
            parts = []
            any_mask = False
            for b in batches:
                n = len(next(iter(b["columns"].values())))
                v = b["validity"].get(f.name)
                if v is None:
                    v = np.ones(n, dtype=bool)
                else:
                    any_mask = True
                parts.append(v)
            if any_mask:
                validity[f.name] = np.concatenate(parts)
        self._add_portion(cols, validity, snap)
        return snap

    def _add_portion(self, cols, validity, snap, removed=None,
                     staged=False) -> PortionMeta:
        # portions are PK-sorted on disk (the reference sorts at
        # indexation) so scans can K-way merge them without re-sorting;
        # under upsert, equal keys within one commit collapse last-wins
        if self.pk_column and self.pk_column in cols and \
                len(cols[self.pk_column]):
            pk = cols[self.pk_column]
            order = np.argsort(pk, kind="stable")
            if self.upsert:
                sorted_pk = pk[order]
                keep = np.r_[sorted_pk[1:] != sorted_pk[:-1], True]
                order = order[keep]
            cols = {n: a[order] for n, a in cols.items()}
            validity = {n: a[order] for n, a in (validity or {}).items()}
        with self._meta_lock:
            pid = self.next_portion_id
            self.next_portion_id += 1
        blob_id = f"{self.shard_id}/portion/{pid}"
        write_portion_blob(self.store, blob_id, cols, validity,
                           chunk_rows=self.config.portion_chunk_rows,
                           pk_column=self.pk_column)
        meta = PortionMeta(
            portion_id=pid,
            blob_id=blob_id,
            num_rows=len(next(iter(cols.values()))) if cols else 0,
            commit_snap=snap,
            schema_version=self.schema_version,
        )
        # portion-level zone maps for ALL columns (vectorized one-pass
        # min/max/null-count per column): planning prunes portions and
        # plans dense group tiers without touching blob storage
        from ydb_tpu_torch.stats.zonemap import column_zones

        if cols:
            meta.zones = column_zones(cols, validity)
        if self.pk_column and self.pk_column in cols:
            meta.pk_min, meta.pk_max = column_stats(cols[self.pk_column])
        if self.ttl_column and self.ttl_column in cols:
            meta.ttl_min, meta.ttl_max = column_stats(cols[self.ttl_column])
        with self._meta_lock:
            self.portions[pid] = meta
            rec = {"op": "add_portion", "meta": meta.to_json(),
                   "snap": snap, "removed": removed or [],
                   "dict_delta": self._dict_delta()}
            if staged:
                rec["staged"] = True
            self._log(rec)
        # eager resident promotion (write path AND compaction output):
        # the decoded columns are already in memory — pin them on the
        # device asynchronously so the FIRST scan is already warm.
        # Budget pressure evicts cold portions; a full valve spills.
        if self.resident.enabled() and meta.num_rows:
            pcols, pvalid = cols, validity

            def from_memory():
                return pcols, pvalid

            self.resident.promote_async(pid, meta.num_rows, from_memory)
        return meta

    def _dict_delta(self) -> dict:
        """New dictionary entries since last durable point (WAL payload)."""
        delta = {}
        for col in self.dicts.columns():
            d = self.dicts[col]
            done = self._dict_durable_sizes.get(col, 0)
            if len(d) > done:
                delta[col] = [
                    v.decode("latin1") for v in d.values[done:]
                ]
                self._dict_durable_sizes[col] = len(d)
        return delta

    # ---------------- scan path ----------------

    def visible_portions(
        self, snap: int | None = None,
        pk_range: tuple[int | None, int | None] | None = None,
        preds=None,
    ) -> list[PortionMeta]:
        """Portions visible at ``snap``, pruned by metadata statistics.

        ``pk_range`` is the legacy spelling of the general path: it
        lowers to ge/le predicates on the PK column and runs through
        the same zone intersection as ``preds`` (stats.zonemap.Pred
        conjuncts from a program's filters). Pre-stats portions carry
        only pk_min/pk_max — those still serve the PK case; other
        predicates read them unpruned (conservative)."""
        with self._meta_lock:
            snap = self.snap if snap is None else snap
            metas = list(self.portions.values())
        all_preds = list(preds or [])
        if pk_range and self.pk_column:
            from ydb_tpu_torch.stats.zonemap import Pred

            lo, hi = pk_range
            if lo is not None:
                all_preds.append(Pred(self.pk_column, "ge", lo))
            if hi is not None:
                all_preds.append(Pred(self.pk_column, "le", hi))
        out = []
        for meta in metas:
            if not meta.visible_at(snap):
                continue
            if all_preds and self._portion_pruned(meta, all_preds):
                continue
            out.append(meta)
        return sorted(out, key=lambda m: m.portion_id)

    def _meta_zones(self, meta: PortionMeta) -> dict | None:
        """A portion's zone dict for predicate matching. v0 metadata
        (pre-stats checkpoints) synthesizes the PK zone from
        pk_min/pk_max so old portions keep PK pruning through the
        general path."""
        zones = dict(meta.zones) if meta.zones else {}
        if self.pk_column and self.pk_column not in zones \
                and meta.pk_min is not None:
            # null count unknown on v0 metadata: claim "maybe all NULL"
            # so skip decisions (which ignore nulls) still fire but the
            # all-match fast path (which requires zero NULLs) never
            # trusts a synthesized zone
            zones[self.pk_column] = [meta.pk_min, meta.pk_max,
                                     meta.num_rows]
        return zones or None

    def _portion_pruned(self, meta: PortionMeta, preds) -> bool:
        """True when zone metadata proves no row of the portion can
        satisfy every conjunct."""
        from ydb_tpu_torch.stats.zonemap import zones_decide

        skip, _all = zones_decide(self._meta_zones(meta), preds)
        return skip

    def _materialize(
        self, metas: list[PortionMeta], columns: tuple[str, ...] | None = None
    ) -> tuple[dict, dict]:
        names = columns if columns is not None else self.schema.names
        cols = {n: [] for n in names}
        valid = {n: [] for n in names}
        for meta in metas:
            c, v = read_portion_blob(self.store, meta.blob_id)
            n_rows = len(next(iter(c.values()))) if c else 0
            for n in names:
                if n in c and meta.schema_version >= \
                        self.column_added.get(n, 1):
                    cols[n].append(c[n])
                    valid[n].append(
                        v.get(n, np.ones(len(c[n]), dtype=bool))
                    )
                else:
                    # column added by ALTER after this portion was
                    # written: old rows read as NULL
                    cols[n].append(np.zeros(
                        n_rows, dtype=self.schema.field(n).type.physical))
                    valid[n].append(np.zeros(n_rows, dtype=bool))
        out_c = {n: np.concatenate(cols[n]) if cols[n] else
                 np.empty(0, dtype=self.schema.field(n).type.physical)
                 for n in names}
        out_v = {n: np.concatenate(valid[n]) if valid[n] else
                 np.empty(0, dtype=bool) for n in names}
        return out_c, out_v

    def source_at(
        self, snap: int | None = None,
        columns: tuple[str, ...] | None = None,
        pk_range=None,
    ) -> ColumnSource:
        metas = self.visible_portions(snap, pk_range)
        cols, valid = self._materialize(metas, columns)
        sch = self.schema if columns is None else self.schema.select(columns)
        return ColumnSource(cols, sch, self.dicts, valid)

    def scan(
        self, program: Program, snap: int | None = None,
        key_spaces: dict[str, int] | None = None,
        table_stats=None,
    ) -> OracleTable:
        from ydb_tpu_torch.obs import tracing

        # profile surface: when a query trace is active the scan's
        # stage seconds / pruning counters / compile-cache status ride
        # a "shard.scan" span (the same numbers the probes fire)
        with tracing.span("shard.scan") as sp:
            return self._scan_profiled(program, snap, key_spaces,
                                       table_stats, sp)

    def _scan_profiled(
        self, program: Program, snap: int | None,
        key_spaces: dict[str, int] | None, table_stats, sp,
    ) -> OracleTable:
        """Streamed scan: portion-granular fetch -> (PK merge/dedup) ->
        fixed-capacity device blocks -> compiled program. Host memory is
        bounded by the largest PK-overlap cluster, not the table
        (fetching.h/scanner.h analog; ydb_tpu_torch.engine.reader).

        Statistics consumption (YDB_TPU_TORCH_STATS=0 disables, results stay
        bit-identical either way):

          * the program's conjunctive filter predicates evaluate against
            portion zone maps BEFORE any blob is touched — non-matching
            portions never stream, and chunk zones skip chunk fetches
            inside surviving portions (ydb_tpu_torch.stats.zonemap);
          * a FilterStep every surviving portion provably all-matches
            (zones inside the predicate, zero NULLs) is dropped from the
            compiled program — the skip-the-filter-kernel fast path;
          * integer group-by keys gain EXACT cardinality bounds from the
            zone maps (key_spaces), enabling the dense group tier, and
            ``table_stats`` (aggregator NDV) sizes the group capacity /
            tier choice (ssa.compiler group_est).

        Value-predicate portion pruning is skipped under upsert
        semantics: a pruned newer portion could resurrect the older row
        version it shadows. Chunk pruning stays safe there — it only
        runs on single-portion clusters, whose PKs are unique.

        Compiled executors cache per (program, key_spaces, hints) — the
        pattern-cache analog (mkql_computation_pattern_cache.h) — and
        invalidate when any dictionary grows (plan-time dict tables bake
        into the compiled aux)."""
        from ydb_tpu_torch import stats as stats_mod
        from ydb_tpu_torch.engine.reader import PortionStreamSource
        from ydb_tpu_torch.engine.scan import ScanExecutor, required_columns
        from ydb_tpu_torch.obs.probes import StageTimer
        from ydb_tpu_torch.stats import zonemap

        timer = StageTimer()
        use_stats = stats_mod.stats_enabled()
        preds: list = []
        full_steps: set = set()
        if use_stats:
            preds, full_steps = zonemap.extract_predicates(
                program, self.schema, self.dicts)
        visible = self.visible_portions(snap)
        metas = visible
        dropped: set = set()
        if preds and not self.upsert:
            metas = []
            all_steps = set(full_steps)
            for m in visible:
                skip, alls = zonemap.zones_decide(
                    self._meta_zones(m), preds)
                if skip:
                    # zone-skipped portions are poor HBM citizens: a
                    # resident copy would have served zero rows. Feed
                    # the eviction policy so they go first.
                    self.resident.note_pruned(m.portion_id)
                    continue
                metas.append(m)
                all_steps &= alls
            # fast path: a filter every SURVIVING portion all-matches
            # contributes nothing — drop it from the compiled program
            # (bit-identical: all its rows pass, and 'all' required
            # zero NULLs on the tested columns). Only for programs
            # whose output a GroupByStep pins: a bare-filter program's
            # implicit output IS its read set, and dropping the filter
            # would narrow it.
            dropped = all_steps if metas and \
                program.group_by is not None else set()
        eff_program = zonemap.drop_filter_steps(program, dropped)
        cols = required_columns(eff_program, self.schema)
        src = PortionStreamSource(
            self, metas, columns=cols, timer=timer, preds=preds
        )
        src.portions_skipped += len(visible) - len(metas)
        key_spaces = dict(key_spaces or {})
        group_est = None
        if use_stats and eff_program.group_by is not None:
            group_est = self._group_hints(
                eff_program, metas, key_spaces, table_stats)
        key = (eff_program, tuple(sorted(key_spaces.items())), group_est)
        sizes = tuple(
            (c, len(self.dicts[c])) for c in sorted(self.dicts.columns())
        )
        # the LRU bookkeeping (move_to_end / eviction) needs a lock:
        # concurrent scans race a hit-path touch against another
        # thread's eviction popitem; the expensive executor trace stays
        # OUTSIDE it (duplicate compiles on a racing miss are wasteful
        # but correct — last insert wins)
        with self._scan_cache_lock:
            hit = self._scan_cache.get(key)
            if hit is not None and hit[1] == sizes:
                self._scan_cache.move_to_end(key)
        fresh = not (hit is not None and hit[1] == sizes)
        if not fresh:
            ex = hit[0]
        else:
            ex = ScanExecutor(
                eff_program, src, self.config.scan_block_rows,
                device=self.device, key_spaces=key_spaces,
                group_est=group_est,
            ).detach()
            with self._scan_cache_lock:
                self._scan_cache[key] = (ex, sizes)
                self._scan_cache.move_to_end(key)
                while len(self._scan_cache) > max(
                        1, self.config.scan_cache_entries):
                    self._scan_cache.popitem(last=False)
        cache_key = None
        hit_before = self.block_cache.hits
        # the resident tier subsumes the whole-stream device cache:
        # caching the assembled stream AND pinning its source columns
        # would hold the same bytes twice against two budgets
        use_block_cache = (self.block_cache.budget() > 0
                           and not self.resident.enabled())
        if use_block_cache or self.resident.enabled():
            # entries referencing a portion that no longer exists
            # (compacted/TTL'd away and dropped from the portion map)
            # can never be keyed again by any snapshot: free their
            # device memory now instead of waiting for LRU. meta_gen
            # only moves when gc_blobs drops portions (the
            # Cluster.snapshot_db stamp pattern), so the steady state
            # is one int compare per scan instead of a full cache walk.
            with self._meta_lock:
                gen = self.meta_gen
                stale = gen != self._prune_gen
                live = set(self.portions) if stale else None
            if stale:
                self.block_cache.prune(lambda k: set(k[0]) <= live)
                self.resident.prune(live)
                # stamp with the gen read BEFORE pruning: a gc racing
                # us just forces one extra (harmless) re-prune
                with self._meta_lock:
                    self._prune_gen = gen
        if use_block_cache:
            # the predicate fingerprint is part of the identity: a
            # pruned stream holds fewer rows than an unpruned one over
            # the same portion set
            cache_key = (tuple(m.portion_id for m in src.metas),
                         tuple(ex.read_cols),
                         self.config.scan_block_rows,
                         zonemap.preds_fingerprint(preds))
        out = OracleTable.from_block(ex.run_stream(
            self.block_cache.stream(
                cache_key,
                lambda: src.blocks(self.config.scan_block_rows,
                                   ex.read_cols)),
            timer=timer, consumed_cb=src.note_block_consumed))
        # per-scan stage attribution (read/merge/stage/compute seconds);
        # bench.py surfaces this as metric extras
        self.last_scan_stages = timer.snapshot()
        # morsel-pipeline attribution (engine.stream_sched): stats are
        # set when the pipelined stream finishes; None on the
        # serialized path (YDB_TPU_TORCH_STREAM_PIPELINE=0) and cache replays
        self.last_scan_pipeline = src.last_pipeline
        self.last_scan_resident = {"portions": src.resident_hits,
                                   "rows": src.resident_rows}
        self.last_scan_executor = ex
        pruning = {
            "portions_total": len(visible),
            "portions_skipped": src.portions_skipped,
            "chunks_read": src.chunks_read,
            "chunks_skipped": src.chunks_skipped,
            # with a zone-proven filter dropped, every chunk read took
            # the skip-the-filter-kernel fast path
            "chunks_fastpath": src.chunks_read if dropped else 0,
            "filters_dropped": len(dropped),
        }
        with self._stats_lock:
            self.last_scan_pruning = pruning
            self.pruning_totals["scans"] += 1
            for k, v in pruning.items():
                if k != "portions_total":
                    self.pruning_totals[k] += v
            self.pruning_totals["portions_total"] += len(visible)
        if _P_SCAN_PRUNING:
            _P_SCAN_PRUNING.fire(shard=self.shard_id, **pruning)
        if _P_SCAN_STAGES:
            _P_SCAN_STAGES.fire(shard=self.shard_id,
                                **self.last_scan_stages)
        if _P_SCAN:
            _P_SCAN.fire(shard=self.shard_id,
                         portions=len(src.metas),
                         chunks_read=src.chunks_read,
                         compiled_fresh=fresh,
                         block_cache_hit=self.block_cache.hits
                         > hit_before,
                         resident_portions=src.resident_hits,
                         resident_rows=src.resident_rows)
        if sp.recording:
            sp.set(shard=self.shard_id, rows=int(out.num_rows),
                   compile_cache=("miss" if fresh else "hit"),
                   resident_portions=src.resident_hits,
                   resident_rows=src.resident_rows,
                   **{f"stage_{k}": v
                      for k, v in self.last_scan_stages.items()},
                   **pruning)
            if self.last_scan_pipeline is not None:
                sp.set(**{f"pipe_{k}": v
                          for k, v in self.last_scan_pipeline.items()})
            if fresh and ex.first_trace_seconds:
                sp.set(first_trace_seconds=round(
                    ex.first_trace_seconds, 6))
        return out

    def _group_hints(self, program: Program, metas, key_spaces: dict,
                     table_stats) -> float | None:
        """Stats-derived group-by planning hints, mutating key_spaces.

        Exact integer key bounds come from the zone maps of the
        portions this scan will actually read (max value over their
        union — a hard cardinality bound, so the dense tier stays
        exact); the advisory group-count estimate comes from aggregator
        NDV (table_stats) and only picks between equally-exact tiers.
        """
        from ydb_tpu_torch.stats import cost

        gb = program.group_by
        for k in gb.keys:
            if k in key_spaces or k not in self.schema:
                continue
            t = self.schema.field(k).type
            if not t.is_integer:
                continue  # strings bound via their dictionary already
            bound = 0
            ok = bool(metas)
            for m in metas:
                zone = (m.zones or {}).get(k)
                if zone is None or zone[0] is None or zone[0] < 0:
                    ok = False
                    break
                bound = max(bound, int(zone[1]))
            # cap: a huge bound would explode the dense mixed-radix
            # space; past it the sorted tier is the right plan anyway.
            # key_spaces bounds are EXCLUSIVE (cardinality-style:
            # values live in [0, b-1]), so the inclusive zone max
            # shifts by one.
            if ok and bound < (1 << 20):
                key_spaces[k] = bound + 1
        if table_stats is None:
            return None
        est = cost.estimate_group_count(gb.keys, table_stats)
        if est is None:
            return None
        # 2-significant-figure bucket: the executor cache keys on the
        # hint, and a raw NDV float would mint a fresh compile per
        # aggregator refresh
        return float(f"{est:.2g}")

    # ---------------- background: compaction / TTL ----------------

    def maybe_compact(self) -> bool:
        if len(self.visible_portions()) >= self.config.compact_portion_threshold:
            self.compact()
            return True
        return False

    def _advance_snap(self) -> int:
        with self._meta_lock:
            if self.snap_source is not None:
                s = self.snap_source()
                if s <= self.snap:
                    raise ValueError(
                        f"snapshot source went backwards: {s} <="
                        f" {self.snap}"
                    )
            else:
                s = self.snap + 1
            self.snap = s
            return s

    def compact(self) -> None:
        """Merge visible portions cluster-by-cluster, PK-sorted, into
        output portions of at most ``max_portion_rows`` rows.

        Only one PK-overlap cluster is resident at a time (the
        general_compaction.cpp granule-local pattern), so compaction is
        as out-of-core as the scan path; under upsert semantics the
        merge drops shadowed row versions for good. Background
        operations (compaction/TTL) serialize per shard via _bg_lock:
        overlapping them would merge rows the other just rewrote.
        """
        with self._bg_lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        from ydb_tpu_torch.engine.reader import PortionStreamSource, plan_clusters

        metas = self.visible_portions()
        if len(metas) <= 1:
            return
        cap = self.config.max_portion_rows
        # pack PK-adjacent clusters into jobs of ~cap rows: overlapping
        # clusters must merge, and runs of small disjoint portions
        # coalesce into fewer, bigger portions (small-portion merge)
        jobs: list[list] = []
        cur: list = []
        cur_rows = 0
        for c in plan_clusters(metas, dedup=bool(self.pk_column)):
            rows = sum(m.num_rows for m in c)
            if cur and cur_rows + rows > cap:
                jobs.append(cur)
                cur, cur_rows = [], 0
            cur.extend(c)
            cur_rows += rows
        if cur:
            jobs.append(cur)
        clusters = [
            job for job in jobs
            if len(job) > 1 or any(m.num_rows > cap for m in job)
        ]
        if not clusters:
            return  # every portion already compact and bounded
        from ydb_tpu_torch.engine.reader import rechunk

        self._in_compaction = True
        snap = self._advance_snap()
        if _P_COMPACT:
            _P_COMPACT.fire(shard=self.shard_id, snap=snap,
                            clusters=len(clusters),
                            portions=len(metas))
        # output portions are WAL-staged and only activate at the
        # cluster's compact_commit record, which also carries the removal
        # tombstones: a crash anywhere mid-stream replays to the exact
        # pre-compaction state (no lost rows, no duplicates). Checkpoints
        # are deferred while staged records are in flight.
        try:
            for cluster in clusters:
                reader = PortionStreamSource(
                    self, cluster, dedup=self.upsert, prefetch=False
                )
                names = self.schema.names
                if self.upsert and self.pk_column:
                    # streamed merge: payloads arrive globally PK-ordered,
                    # so output portions of <= cap rows are cut
                    # incrementally — an all-overlapping cluster never
                    # materializes
                    payloads = reader.payload_stream([cluster], names)
                else:
                    # append path: job size is bounded by cap (plan
                    # above), so a host sort of the materialized job is
                    # fine
                    cols, valid = reader._load_cluster(cluster, names)
                    if self.pk_column:
                        order = np.argsort(cols[self.pk_column],
                                           kind="stable")
                        cols = {n: a[order] for n, a in cols.items()}
                        valid = {n: a[order] for n, a in valid.items()}
                    payloads = iter([(cols, valid)])
                added = [
                    self._add_portion(chunk_c, chunk_v, snap,
                                      staged=True).portion_id
                    for chunk_c, chunk_v in rechunk(payloads, names, cap)
                ]
                removed = [m.portion_id for m in cluster]
                with self._meta_lock:
                    for m in cluster:
                        m.removed_snap = snap
                    self._log({"op": "compact_commit", "snap": snap,
                               "adds": added, "removed": removed})
        finally:
            self._in_compaction = False
        if self._records_since_checkpoint >= self.config.checkpoint_interval:
            self.checkpoint()

    def evict_ttl(self, cutoff: int) -> int:
        """Drop rows whose TTL column < cutoff. Returns rows evicted."""
        with self._bg_lock:
            return self._evict_ttl_locked(cutoff)

    def _evict_ttl_locked(self, cutoff: int) -> int:
        if not self.ttl_column:
            return 0
        evicted = 0
        metas = [
            m for m in self.visible_portions()
            if m.ttl_min is not None and m.ttl_min < cutoff
        ]
        if not metas:
            return 0
        snap = self._advance_snap()
        for meta in metas:
            cols, valid = self._materialize([meta])
            keep = cols[self.ttl_column] >= cutoff
            evicted += int((~keep).sum())
            if keep.any():
                kept_c = {n: a[keep] for n, a in cols.items()}
                kept_v = {n: a[keep] for n, a in valid.items()}
                # tombstone + replacement under ONE meta-lock section: a
                # concurrent scan must never see neither portion
                with self._meta_lock:
                    meta.removed_snap = snap
                    self._add_portion(kept_c, kept_v, snap,
                                      removed=[meta.portion_id])
            else:
                with self._meta_lock:
                    meta.removed_snap = snap
                    self._log({"op": "remove_portion", "snap": snap,
                               "portion_id": meta.portion_id})
        return evicted

    def evict_to_cold(self, max_snap: int) -> int:
        """Move blobs of portions committed at/before ``max_snap`` to the
        cold tier (the TTL/age-driven tier eviction of tx/tiering).
        Requires a TieredBlobStore; scans keep working transparently
        (reads fall through hot -> cold). Returns blobs moved."""
        from ydb_tpu_torch.engine.blobs import TieredBlobStore

        store = self.store
        # unwrap a page cache if one fronts the tiers
        base = getattr(store, "base", None)
        tiered = store if isinstance(store, TieredBlobStore) else (
            base if isinstance(base, TieredBlobStore) else None)
        if tiered is None:
            return 0
        ids = {
            m.blob_id for m in self.visible_portions()
            if m.commit_snap <= max_snap
        }
        return tiered.evict(lambda bid: bid in ids)

    def gc_blobs(self, keep_snap: int) -> int:
        """Delete blobs of portions invisible at and after keep_snap
        (BlobStorage collect-garbage analog). Returns blobs deleted."""
        # ONE critical section from the dead-list to the metadata drop:
        # a concurrent gc_blobs computing the same list would double-log
        # and KeyError on the second delete
        with self._meta_lock:
            dead = [
                pid for pid, m in self.portions.items()
                if m.removed_snap is not None
                and m.removed_snap <= keep_snap
            ]
            if not dead:
                return 0
            # log BEFORE deleting: a crash in between leaks blobs
            # (re-collected later) instead of leaving metadata pointing
            # at deleted blobs
            self._log({"op": "gc", "portions": dead, "snap": self.snap})
            blob_ids = [self.portions[pid].blob_id for pid in dead]
            for pid in dead:
                del self.portions[pid]
            self.meta_gen += 1
        for bid in blob_ids:
            self.store.delete(bid)
        # GC'd portion ids can never be named by any snapshot again:
        # free their resident device arrays now (outside _meta_lock —
        # the stores keep no lock-order edge between them)
        self.resident.invalidate(dead)
        return len(dead)

    # ---------------- durability: WAL + checkpoint + boot ----------------

    def _log(self, record: dict) -> None:
        with self._meta_lock:
            self._wal_seq += 1
            record["seq"] = self._wal_seq
            self.store.put(
                f"{self.shard_id}/wal/{self._wal_seq:012d}",
                json.dumps(record).encode(),
            )
            self._records_since_checkpoint += 1
            if self._records_since_checkpoint >= \
                    self.config.checkpoint_interval and \
                    not self._in_compaction:
                # a checkpoint between a staged add and its compact_commit
                # would persist half a compaction; defer until commit
                self.checkpoint()

    def checkpoint(self) -> None:
        with self._meta_lock:
            state = {
                "snap": self.snap,
                "next_portion_id": self.next_portion_id,
                "wal_seq": self._wal_seq,
                "portions": [
                    m.to_json() for m in self.portions.values()
                ],
                "dicts": {
                    col: [v.decode("latin1") for v in
                          self.dicts[col].values]
                    for col in self.dicts.columns()
                },
            }
            self.store.put(
                f"{self.shard_id}/checkpoint",
                json.dumps(state).encode(),
            )
            # WAL records up to wal_seq are now redundant
            for bid in self.store.list(f"{self.shard_id}/wal/"):
                self.store.delete(bid)
            self._records_since_checkpoint = 0
            for col in self.dicts.columns():
                self._dict_durable_sizes[col] = len(self.dicts[col])

    @staticmethod
    def boot(
        shard_id: str,
        schema: dtypes.Schema,
        store: BlobStore,
        pk_column: str | None = None,
        ttl_column: str | None = None,
        config: ShardConfig | None = None,
        dicts: DictionarySet | None = None,
        device=None,
    ) -> "ColumnShard":
        """Recover shard state: checkpoint + WAL replay (flat_boot analog).

        With ``dicts`` supplied (a table/cluster-shared DictionarySet the
        caller recovered from its own journal — Cluster's dict log), the
        shard trusts it and skips replaying its private dict state: ids
        must come from the shared global assignment order, not this
        shard's local view of it.
        """
        shard = ColumnShard(shard_id, schema, store, pk_column, ttl_column,
                            config, dicts=dicts, device=device)
        external_dicts = dicts is not None
        shard._external_dicts = external_dicts
        ckpt_id = f"{shard_id}/checkpoint"
        base_seq = 0
        if store.exists(ckpt_id):
            state = json.loads(store.get(ckpt_id).decode())
            shard.snap = state["snap"]
            shard.next_portion_id = state["next_portion_id"]
            shard._wal_seq = state["wal_seq"]
            base_seq = state["wal_seq"]
            for mj in state["portions"]:
                m = PortionMeta.from_json(mj)
                shard.portions[m.portion_id] = m
            if not external_dicts:
                for col, values in state.get("dicts", {}).items():
                    d = shard.dicts.for_column(col)
                    for v in values:
                        d.add(v.encode("latin1"))
        # replay WAL after the checkpoint
        for bid in store.list(f"{shard_id}/wal/"):
            rec = json.loads(store.get(bid).decode())
            if rec["seq"] <= base_seq:
                continue
            shard._replay(rec)
        for col in shard.dicts.columns():
            shard._dict_durable_sizes[col] = len(shard.dicts[col])
        # orphaned staged outputs = a compaction that never committed:
        # drop their blobs, the old portions are still fully live
        for meta in shard._staged.values():
            store.delete(meta.blob_id)
        shard._staged = {}
        return shard

    def _replay(self, rec: dict) -> None:
        # boot-time replay is single-threaded, but the metadata it
        # rewrites is the same state scans/compaction guard with
        # _meta_lock — holding it keeps the guard discipline uniform
        # (and replay-into-a-live-shard safe), at RLock cost only
        with self._meta_lock:
            self._replay_locked(rec)

    def _replay_locked(self, rec: dict) -> None:
        op = rec["op"]
        self._wal_seq = max(self._wal_seq, rec["seq"])
        self.snap = max(self.snap, rec.get("snap", 0))
        if op == "add_portion":
            meta = PortionMeta.from_json(rec["meta"])
            if rec.get("staged"):
                # compaction output: inert until compact_commit arrives
                self._staged[meta.portion_id] = meta
            else:
                self.portions[meta.portion_id] = meta
            self.next_portion_id = max(self.next_portion_id,
                                       meta.portion_id + 1)
            for pid in rec.get("removed", []):
                if pid in self.portions:
                    self.portions[pid].removed_snap = rec["snap"]
            if not getattr(self, "_external_dicts", False):
                for col, values in rec.get("dict_delta", {}).items():
                    d = self.dicts.for_column(col)
                    for v in values:
                        d.add(v.encode("latin1"))
        elif op == "compact_commit":
            for pid in rec["adds"]:
                meta = self._staged.pop(pid, None)
                if meta is not None:
                    self.portions[pid] = meta
            for pid in rec["removed"]:
                if pid in self.portions:
                    self.portions[pid].removed_snap = rec["snap"]
        elif op == "remove_portion":
            pid = rec["portion_id"]
            if pid in self.portions:
                self.portions[pid].removed_snap = rec["snap"]
        elif op == "gc":
            for pid in rec["portions"]:
                self.portions.pop(pid, None)
        elif op == "noop":
            pass
        else:
            raise ValueError(f"unknown WAL op {op}")
